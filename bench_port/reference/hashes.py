"""Plain NumPy XXH64, XXH32 and CRC32-C over the rows of a batch, written
from the public specifications (xxHash's ``doc/xxhash_spec.md``; CRC-32C,
the Castagnoli polynomial 0x82F63B78 reflected, as RFC 3720 gives it) and
the Snappy framing format's checksum mask. Each function takes a (B, L)
uint8 array and (B,) lengths and works on all rows at once; unsigned
integer arrays wrap modulo 2^64 or 2^32 as the algorithms need.
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64
P64 = [U64(c) for c in (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
                         0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)]
P32 = [np.uint32(c) for c in (2654435761, 2246822519, 3266489917, 668265263, 374761393)]


def _rotl64(x, r):
    return (x << U64(r)) | (x >> U64(64 - r))


def _rotl32(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _round64(acc, lane):
    return _rotl64(acc + lane * P64[1], 31) * P64[0]


def _le(rows: np.ndarray, off: np.ndarray, nbytes: int, dtype) -> np.ndarray:
    """Little-endian ``nbytes`` at ``off`` in each row (0 past the row)."""
    width = rows.shape[1]
    out = np.zeros(len(rows), dtype)
    r = np.arange(len(rows))
    for k in range(nbytes):
        pos = off + k
        b = rows[r, np.minimum(pos, width - 1)].astype(dtype)
        out |= np.where(pos < width, b, 0).astype(dtype) << dtype(8 * k)
    return out


def _check(rows: np.ndarray, lengths: np.ndarray):
    rows = np.ascontiguousarray(rows, np.uint8)
    lengths = np.clip(np.asarray(lengths, np.int64), 0, rows.shape[1])
    return rows, lengths


def xxh64(rows: np.ndarray, lengths: np.ndarray, seed: int = 0) -> np.ndarray:
    """XXH64 of each row's first ``lengths[i]`` bytes, (B,) uint64."""
    rows, n = _check(rows, lengths)
    B, L = rows.shape
    pad = np.zeros((B, -(-L // 32) * 32 + 32), np.uint8)
    pad[:, :L] = rows
    words = pad.view("<u8")
    s = U64(seed % (1 << 64))
    with np.errstate(over="ignore"):
        v = np.stack([np.full(B, s + P64[0] + P64[1], U64), np.full(B, s + P64[1], U64),
                      np.full(B, s, U64), np.full(B, s - P64[0], U64)], 1)
        stripes = n // 32
        for k in range(int(stripes.max()) if B else 0):
            live = (k < stripes)[:, None]
            v = np.where(live, _round64(v, words[:, 4 * k:4 * k + 4]), v)
        h = _rotl64(v[:, 0], 1) + _rotl64(v[:, 1], 7) + _rotl64(v[:, 2], 12) + _rotl64(v[:, 3], 18)
        for k in range(4):
            h = (h ^ _round64(np.zeros(B, U64), v[:, k])) * P64[0] + P64[3]
        h = np.where(n >= 32, h, s + P64[4]) + n.astype(U64)
        pos = stripes * 32
        rem = n - pos
        while True:
            take = rem >= 8
            if not take.any():
                break
            lane = _le(pad, pos, 8, U64)
            h = np.where(take, _rotl64(h ^ _round64(np.zeros(B, U64), lane), 27) * P64[0]
                         + P64[3], h)
            pos, rem = np.where(take, pos + 8, pos), np.where(take, rem - 8, rem)
        take = rem >= 4
        lane = _le(pad, pos, 4, U64)
        h = np.where(take, _rotl64(h ^ (lane * P64[0]), 23) * P64[1] + P64[2], h)
        pos, rem = np.where(take, pos + 4, pos), np.where(take, rem - 4, rem)
        for _ in range(3):
            take = rem >= 1
            lane = _le(pad, pos, 1, U64)
            h = np.where(take, _rotl64(h ^ (lane * P64[4]), 11) * P64[0], h)
            pos, rem = np.where(take, pos + 1, pos), np.where(take, rem - 1, rem)
        h ^= h >> U64(33)
        h *= P64[1]
        h ^= h >> U64(29)
        h *= P64[2]
        h ^= h >> U64(32)
    return h


def xxh32(rows: np.ndarray, lengths: np.ndarray, seed: int = 0) -> np.ndarray:
    """XXH32 of each row's first ``lengths[i]`` bytes, (B,) uint32."""
    rows, n = _check(rows, lengths)
    B, L = rows.shape
    pad = np.zeros((B, -(-L // 16) * 16 + 16), np.uint8)
    pad[:, :L] = rows
    words = pad.view("<u4")
    s = np.uint32(seed % (1 << 32))
    u32 = np.uint32
    with np.errstate(over="ignore"):
        v = np.stack([np.full(B, s + P32[0] + P32[1], u32), np.full(B, s + P32[1], u32),
                      np.full(B, s, u32), np.full(B, s - P32[0], u32)], 1)
        stripes = n // 16
        for k in range(int(stripes.max()) if B else 0):
            live = (k < stripes)[:, None]
            nv = _rotl32(v + words[:, 4 * k:4 * k + 4] * P32[1], 13) * P32[0]
            v = np.where(live, nv, v)
        h = _rotl32(v[:, 0], 1) + _rotl32(v[:, 1], 7) + _rotl32(v[:, 2], 12) + _rotl32(v[:, 3], 18)
        h = np.where(n >= 16, h, s + P32[4]) + n.astype(u32)
        pos = stripes * 16
        rem = n - pos
        for _ in range(3):
            take = rem >= 4
            lane = _le(pad, pos, 4, u32)
            h = np.where(take, _rotl32(h + lane * P32[2], 17) * P32[3], h)
            pos, rem = np.where(take, pos + 4, pos), np.where(take, rem - 4, rem)
        for _ in range(3):
            take = rem >= 1
            lane = _le(pad, pos, 1, u32)
            h = np.where(take, _rotl32(h + lane * P32[4], 11) * P32[0], h)
            pos, rem = np.where(take, pos + 1, pos), np.where(take, rem - 1, rem)
        h ^= h >> u32(15)
        h *= P32[1]
        h ^= h >> u32(13)
        h *= P32[2]
        h ^= h >> u32(16)
    return h


def _crc_tables() -> np.ndarray:
    """Slicing-by-8 tables of CRC-32C, (8, 256) uint32."""
    t = np.zeros((8, 256), np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        t[0, i] = c
    for k in range(1, 8):
        t[k] = (t[k - 1] >> 8) ^ t[0][t[k - 1] & 0xFF]
    return t


_CRC = _crc_tables()


def crc32c(rows: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """CRC-32C of each row's first ``lengths[i]`` bytes, (B,) uint32:
    initial value and final XOR 0xFFFFFFFF, eight bytes a step."""
    rows, n = _check(rows, lengths)
    B, L = rows.shape
    pad = np.zeros((B, -(-L // 8) * 8 + 8), np.uint8)
    pad[:, :L] = rows
    c = np.full(B, 0xFFFFFFFF, np.uint32)
    t = _CRC
    steps = n // 8
    for k in range(int(steps.max()) if B else 0):
        b = pad[:, 8 * k:8 * k + 8]
        x = c ^ (b[:, 0].astype(np.uint32) | (b[:, 1].astype(np.uint32) << 8)
                 | (b[:, 2].astype(np.uint32) << 16) | (b[:, 3].astype(np.uint32) << 24))
        nc = (t[7][x & 0xFF] ^ t[6][(x >> 8) & 0xFF] ^ t[5][(x >> 16) & 0xFF]
              ^ t[4][x >> 24] ^ t[3][b[:, 4]] ^ t[2][b[:, 5]] ^ t[1][b[:, 6]] ^ t[0][b[:, 7]])
        c = np.where(k < steps, nc, c)
    r = np.arange(B)
    for k in range(7):
        pos = steps * 8 + k
        take = pos < n
        b = pad[r, np.minimum(pos, pad.shape[1] - 1)]
        c = np.where(take, (c >> np.uint32(8)) ^ t[0][(c ^ b) & 0xFF], c)
    return c ^ np.uint32(0xFFFFFFFF)


def mask_crc(crc: np.ndarray) -> np.ndarray:
    """The Snappy framing format's mask: rotate right by 15, add 0xA282EAD8."""
    crc = np.asarray(crc, np.uint32)
    with np.errstate(over="ignore"):
        return ((crc >> np.uint32(15)) | (crc << np.uint32(17))) + np.uint32(0xA282EAD8)
