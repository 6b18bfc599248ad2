"""Batched XXH64 and XXH32: the CUDA kernels and their plain PyTorch versions.

``xxh64(data, lengths, seed=0)`` hashes row i of a (B, L) uint8 batch over
its first ``lengths[i]`` bytes and returns one (B,) int64 tensor that holds
each hash's 64 bits: the JAX functions' ``(hi << 32) | lo``, read as a
signed integer. ``xxh32(data, lengths, seed=0)`` does the same for XXH32
(the LZ4 frame's checksum) and returns (B,) int64 holding the 32 hash bits,
never negative. The seed is taken modulo 2^64 (2^32 for XXH32), as the
plain versions and the JAX functions take it. A length is clamped to [0,
L]. Any B and L are accepted. They launch ``csrc/xxh64.cu`` and
``csrc/xxh32.cu`` for a CUDA tensor and use ``xxh64_plain`` and
``xxh32_plain`` only for a tensor on the CPU.

The plain versions work on int64 tensors: XXH64's constants above 2^63 are
written as their negative bit patterns, right shifts are made logical by
masking, and products wrap modulo 2^64; XXH32 masks every value to 32 bits.
"""

from __future__ import annotations

import torch

from .. import _build

# Kernel launches (and the rows XXH32 hashed), for runs that must show the
# kernels were used. Only a launch of a CUDA kernel adds to them.
launches = 0
xxh32_launches = 0
xxh32_rows = 0


def _i64(c: int) -> int:
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= 1 << 63 else c


P64_1 = _i64(0x9E3779B185EBCA87)
P64_2 = _i64(0xC2B2AE3D27D4EB4F)
P64_3 = _i64(0x165667B19E3779F9)
P64_4 = _i64(0x85EBCA77C2B2AE63)
P64_5 = _i64(0x27D4EB2F165667C5)

M32 = 0xFFFFFFFF
P32_1 = 2654435761
P32_2 = 2246822519
P32_3 = 3266489917
P32_4 = 668265263
P32_5 = 374761393


def _check(data: torch.Tensor, lengths: torch.Tensor):
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise TypeError(f"data must be a 2-D uint8 tensor, got {data.dtype} "
                        f"{tuple(data.shape)}")
    if lengths.shape != (data.shape[0],):
        raise ValueError(f"lengths must have shape ({data.shape[0]},), got "
                         f"{tuple(lengths.shape)}")
    if lengths.device != data.device:
        raise ValueError("data and lengths lie on different devices")
    return data.contiguous(), lengths.to(torch.int32).contiguous()


def xxh64(data: torch.Tensor, lengths: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """XXH64 of each row's prefix; see the module doc."""
    global launches
    data, lengths = _check(data, lengths)
    if data.device.type == "cpu":
        return xxh64_plain(data, lengths, seed)
    if data.device.type != "cuda":
        raise ValueError(f"no xxh64 for device {data.device}")
    lib = _build.load()
    B, L = data.shape
    out = torch.empty(B, dtype=torch.int64, device=data.device)
    if B:
        with torch.cuda.device(data.device):
            err = lib.acx_xxh64(data.data_ptr(), lengths.data_ptr(), B, L,
                                seed & ((1 << 64) - 1), out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"xxh64 kernel launch failed: CUDA error {err}")
        launches += 1
    return out


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _round(acc, lane):
    return _rotl(acc + lane * P64_2, 31) * P64_1


def _le(buf: torch.Tensor, off: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Little-endian value of nbytes bytes at off in each row, as int64."""
    k = torch.arange(nbytes, device=buf.device)
    idx = (off[:, None] + k).clamp(max=buf.shape[1] - 1)
    return (buf.gather(1, idx).to(torch.int64) << (8 * k)).sum(1)


def xxh64_plain(data: torch.Tensor, lengths: torch.Tensor,
                seed: int = 0) -> torch.Tensor:
    """Plain PyTorch XXH64, a port of ``aircompressor_tpu.ops.xxhash_jax.xxh64``."""
    data, lengths = _check(data, lengths)
    B, L = data.shape
    n = lengths.to(torch.int64).clamp(0, L)
    width = max(32, -(-L // 32) * 32)
    buf = torch.zeros((B, width), dtype=torch.uint8, device=data.device)
    buf[:, :L] = data
    words = buf.view(torch.int64)  # little-endian 8-byte lanes

    inits = [seed + 0x9E3779B185EBCA87 + 0xC2B2AE3D27D4EB4F,
             seed + 0xC2B2AE3D27D4EB4F, seed, seed - 0x9E3779B185EBCA87]
    v = torch.tensor([_i64(c) for c in inits],
                     device=data.device).repeat(B, 1)
    stripes = n // 32
    for s in range(int(stripes.max()) if B else 0):
        nv = _round(v, words[:, 4 * s:4 * s + 4])
        v = torch.where((s < stripes)[:, None], nv, v)

    h = (_rotl(v[:, 0], 1) + _rotl(v[:, 1], 7) + _rotl(v[:, 2], 12)
         + _rotl(v[:, 3], 18))
    for k in range(4):
        h = (h ^ _round(torch.zeros_like(h), v[:, k])) * P64_1 + P64_4
    h = torch.where(n >= 32, h, _i64(seed + 0x27D4EB2F165667C5)) + n

    base = n - n % 32
    rem = n % 32
    for k in range(3):
        h2 = _rotl(h ^ _round(torch.zeros_like(h), _le(buf, base + 8 * k, 8)),
                   27) * P64_1 + P64_4
        h = torch.where(rem >= 8 * (k + 1), h2, h)
    h2 = _rotl(h ^ (_le(buf, base + rem - rem % 8, 4) * P64_1), 23) * P64_2 + P64_3
    h = torch.where(rem % 8 >= 4, h2, h)
    start = base + rem - rem % 4
    for k in range(3):
        h2 = _rotl(h ^ (_le(buf, start + k, 1) * P64_5), 11) * P64_1
        h = torch.where(rem % 4 > k, h2, h)

    h = h ^ _shr(h, 33)
    h = h * P64_2
    h = h ^ _shr(h, 29)
    h = h * P64_3
    return h ^ _shr(h, 32)


def xxh32(data: torch.Tensor, lengths: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """XXH32 of each row's prefix; see the module doc."""
    global xxh32_launches, xxh32_rows
    data, lengths = _check(data, lengths)
    if data.device.type == "cpu":
        return xxh32_plain(data, lengths, seed)
    if data.device.type != "cuda":
        raise ValueError(f"no xxh32 for device {data.device}")
    lib = _build.load()
    B, L = data.shape
    out = torch.empty(B, dtype=torch.int64, device=data.device)
    if B:
        with torch.cuda.device(data.device):
            err = lib.acx_xxh32(data.data_ptr(), lengths.data_ptr(), B, L,
                                seed & M32, out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"xxh32 kernel launch failed: CUDA error {err}")
        xxh32_launches += 1
        xxh32_rows += B
    return out


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def _mul32(x, c) -> torch.Tensor:
    return (x * c) & M32


def xxh32_plain(data: torch.Tensor, lengths: torch.Tensor,
                seed: int = 0) -> torch.Tensor:
    """Plain PyTorch XXH32, a port of ``aircompressor_tpu.ops.xxhash_jax.xxh32``."""
    data, lengths = _check(data, lengths)
    B, L = data.shape
    n = lengths.to(torch.int64).clamp(0, L)
    width = max(16, -(-L // 16) * 16)
    buf = torch.zeros((B, width), dtype=torch.uint8, device=data.device)
    buf[:, :L] = data
    words = buf.view(torch.int32).to(torch.int64) & M32  # little-endian lanes

    inits = [seed + P32_1 + P32_2, seed + P32_2, seed, seed - P32_1]
    v = torch.tensor([c & M32 for c in inits], device=data.device).repeat(B, 1)
    stripes = n // 16
    for s in range(int(stripes.max()) if B else 0):
        nv = _mul32(_rotl32((v + words[:, 4 * s:4 * s + 4] * P32_2) & M32, 13), P32_1)
        v = torch.where((s < stripes)[:, None], nv, v)

    h = (_rotl32(v[:, 0], 1) + _rotl32(v[:, 1], 7) + _rotl32(v[:, 2], 12)
         + _rotl32(v[:, 3], 18))
    h = (torch.where(n >= 16, h, (seed + P32_5) & M32) + n) & M32

    base = n - n % 16
    rem = n % 16
    for k in range(3):
        h2 = _mul32(_rotl32((h + _le(buf, base + 4 * k, 4) * P32_3) & M32, 17), P32_4)
        h = torch.where(rem >= 4 * (k + 1), h2, h)
    start = base + rem - rem % 4
    for k in range(3):
        h2 = _mul32(_rotl32((h + _le(buf, start + k, 1) * P32_5) & M32, 11), P32_1)
        h = torch.where(rem % 4 > k, h2, h)

    h = _mul32(h ^ (h >> 15), P32_2)
    h = _mul32(h ^ (h >> 13), P32_3)
    return h ^ (h >> 16)
