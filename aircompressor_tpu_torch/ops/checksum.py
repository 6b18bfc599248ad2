"""Batched CRC32-C on a torch device: the CUDA kernel and its plain PyTorch
version, and the Snappy framing mask.

``crc32c(data, lengths)`` checksums row i of a (B, L) uint8 batch over its
first ``lengths[i]`` bytes, clamped to [0, L] (unmasked, zlib-style initial
value and final XOR) and returns (B,) int64 in [0, 2^32). It launches
``csrc/crc32c.cu`` for a CUDA tensor and uses ``crc32c_plain`` only for a
tensor on the CPU. The JAX package's ``checksum_jax.crc32c`` is XLA, not a
Pallas kernel; the kernel replaces it (one warp a row, 32 segments combined
over GF(2); ``tests/test_torch_crc32c.py`` models the split and the combine).

``crc32c_plain`` is the same GF(2)-linear formulation as the host copy
(``host.crc32c``): every byte's table term T[b_i] is advanced by A^(n-1-i)
in log2(L) rounds of masked 4x256-table lookups, then the terms are
XOR-reduced. Values are u32 bit patterns held in int32 tensors: XOR and
``(c >> k) & 0xFF`` give the same bytes under an arithmetic shift.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..host import crc32c as _host

# Kernel launches, for runs that must show the kernel was used. Only a
# launch of the CUDA kernel adds to it.
launches = 0

M32 = 0xFFFFFFFF


@functools.cache
def _tables(device: torch.device):
    """The byte table (256,) and power tables (32, 4, 256) on ``device``, as
    int32 bit patterns."""
    return (torch.from_numpy(_host.byte_table().view("int32")).to(device),
            torch.from_numpy(_host.power_tables().view("int32")).to(device))


def _apply_map(tabs: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Apply a 4x256-table linear map to the u32 bit patterns of ``c``."""
    return (tabs[0][c & 0xFF] ^ tabs[1][(c >> 8) & 0xFF]
            ^ tabs[2][(c >> 16) & 0xFF] ^ tabs[3][(c >> 24) & 0xFF])


def _check(data: torch.Tensor, lengths: torch.Tensor):
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise TypeError(f"data must be a 2-D uint8 tensor, got {data.dtype} "
                        f"{tuple(data.shape)}")
    if lengths.shape != (data.shape[0],) or lengths.device != data.device:
        raise ValueError("lengths must be (B,) on the device of data")
    return data.contiguous(), lengths.to(torch.int32).contiguous()


def crc32c(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """CRC32-C of each row's prefix; see the module doc."""
    global launches
    data, lengths = _check(data, lengths)
    if data.device.type == "cpu":
        return crc32c_plain(data, lengths)
    if data.device.type != "cuda":
        raise ValueError(f"no crc32c for device {data.device}")
    lib = _build.load()
    B, L = data.shape
    out = torch.empty(B, dtype=torch.int64, device=data.device)
    if B:
        with torch.cuda.device(data.device):
            err = lib.acx_crc32c(data.data_ptr(), lengths.data_ptr(), B, L,
                                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"crc32c kernel launch failed: CUDA error {err}")
        launches += 1
    return out


def crc32c_plain(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch CRC32-C, the function of
    ``aircompressor_tpu.ops.checksum_jax.crc32c``; see the module doc."""
    data, lengths = _check(data, lengths)
    B, L = data.shape
    byte, power = _tables(data.device)
    lengths = lengths.clamp(0, L)
    exps = lengths[:, None] - 1 - torch.arange(L, dtype=torch.int32,
                                               device=data.device)[None, :]
    c = torch.where(exps >= 0, byte[data.int()], 0)
    exps = exps.clamp(min=0)
    for j in range(max(1, L - 1).bit_length()):
        c = torch.where(((exps >> j) & 1).bool(), _apply_map(power[j], c), c)
    while c.shape[1] > 1:  # XOR-reduce the terms by halving
        if c.shape[1] % 2:
            c = torch.nn.functional.pad(c, (0, 1))
        c = c[:, 0::2] ^ c[:, 1::2]
    acc = c[:, 0] if L else torch.zeros(B, dtype=torch.int32, device=data.device)
    # advance the init state 0xFFFFFFFF (-1 as int32) across `lengths` bytes
    s = torch.full((B,), -1, dtype=torch.int32, device=data.device)
    for j in range(int(L).bit_length()):
        s = torch.where(((lengths >> j) & 1).bool(), _apply_map(power[j], s), s)
    return (~(acc ^ s)).to(torch.int64) & M32


def mask_crc(crc: torch.Tensor) -> torch.Tensor:
    """Snappy framing mask: rotate right by 15, add 0xa282ead8 (mod 2^32)."""
    crc = crc.to(torch.int64) & M32
    return ((((crc >> 15) | (crc << 17)) & M32) + 0xA282EAD8) & M32
