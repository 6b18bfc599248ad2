"""Argument checks and row helpers shared by the block codec ops.

Every codec op takes a (B, cap) uint8 batch with (B,) lengths; the checks
here raise on what the kernels do not take, and the plain versions share
the two row helpers below.
"""

from __future__ import annotations

import torch

MAX_CHUNK = 65536


# The encode kernels' shared-memory carveouts, percent of the most shared
# memory an SM has, with the chunks (a 32 KB table each) each holds an SM:
# the wide one 6 beside 28 KB of L1, the narrow one 3 beside 156 KB.
# chip_smoke.py times these and three more (PERF.md).
ENCODE_CARVEOUT_WIDE = 100
ENCODE_CARVEOUT_NARROW, ENCODE_NARROW_CHUNKS = 43, 3


def encode_carveout(batch: int, device: torch.device) -> int:
    """The Snappy and LZ4 encode kernels' carveout for a batch: the narrow
    one where the batch fits in one wave of ENCODE_NARROW_CHUNKS an SM,
    since its candidate loads then find more L1, else the wide one, since
    more chunks then run at once."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if batch <= ENCODE_NARROW_CHUNKS * sms:
        return ENCODE_CARVEOUT_NARROW
    return ENCODE_CARVEOUT_WIDE


def check_decode_args(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int):
    """Contiguous ``comp`` and int32 ``comp_lens``; raises on a bad batch or
    an ``out_cap`` outside [1, 65536]."""
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise TypeError(f"comp must be a 2-D uint8 tensor, got {comp.dtype} "
                        f"{tuple(comp.shape)}")
    if comp_lens.shape != (comp.shape[0],):
        raise ValueError(f"comp_lens must have shape ({comp.shape[0]},), got "
                         f"{tuple(comp_lens.shape)}")
    if comp_lens.device != comp.device:
        raise ValueError("comp and comp_lens lie on different devices")
    if not 0 < out_cap <= MAX_CHUNK:
        raise ValueError(f"out_cap must lie in [1, {MAX_CHUNK}], got {out_cap}")
    return comp.contiguous(), comp_lens.to(torch.int32).contiguous()


def check_encode_args(data: torch.Tensor, lengths: torch.Tensor):
    """Contiguous ``data`` and int32 ``lengths`` clamped to [0, cap]; raises
    on a bad batch or rows over 64 KB."""
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise TypeError(f"data must be a 2-D uint8 tensor, got {data.dtype} "
                        f"{tuple(data.shape)}")
    if data.shape[1] > MAX_CHUNK:
        raise ValueError(f"rows are capped at {MAX_CHUNK} bytes, got {data.shape[1]}")
    if lengths.shape != (data.shape[0],):
        raise ValueError(f"lengths must have shape ({data.shape[0]},), got "
                         f"{tuple(lengths.shape)}")
    if lengths.device != data.device:
        raise ValueError("data and lengths lie on different devices")
    lengths = lengths.to(torch.int32).clamp(0, data.shape[1])
    return data.contiguous(), lengths.contiguous()


def u32le(src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Little-endian 4-byte words of each row of ``src`` at ``pos``."""
    idx = pos[:, None] + torch.arange(4, device=src.device)
    b = src.gather(1, idx)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def put(out: torch.Tensor, op: torch.Tensor, vals: torch.Tensor,
        count: torch.Tensor) -> None:
    """out[b, op[b] + k] = vals[b, k] for k < count[b]. The last column of
    ``out`` is a sink: stores at or past it land there."""
    sink = out.shape[1] - 1
    k = torch.arange(vals.shape[1], device=out.device)[None, :]
    pos = op[:, None] + k
    pos = torch.where((k < count[:, None]) & (pos < sink), pos, sink)
    out.scatter_(1, pos, vals.to(torch.uint8))
