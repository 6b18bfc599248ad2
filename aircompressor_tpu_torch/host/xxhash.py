"""Scalar XXH32 and XXH64 (the public xxHash spec): the one-shot hashes, the
oracles of the xxh32 and xxh64 kernels, and the streaming states of the LZ4
frame content checksum and the zstd frame checksum. Copies of
``aircompressor_tpu.xxhash._scalar``'s ``xxh32``, ``xxh64``,
``XxHash32State`` and ``XxHash64State``."""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF

P32_1 = 2654435761
P32_2 = 2246822519
P32_3 = 3266489917
P32_4 = 668265263
P32_5 = 374761393

P64_1 = 0x9E3779B185EBCA87
P64_2 = 0xC2B2AE3D27D4EB4F
P64_3 = 0x165667B19E3779F9
P64_4 = 0x85EBCA77C2B2AE63
P64_5 = 0x27D4EB2F165667C5


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _u32le(b: np.ndarray, i: int) -> int:
    return int(b[i]) | int(b[i + 1]) << 8 | int(b[i + 2]) << 16 | int(b[i + 3]) << 24


def _u64le(b: np.ndarray, i: int) -> int:
    return _u32le(b, i) | _u32le(b, i + 4) << 32


def _round32(acc: int, lane: int) -> int:
    return (_rotl32((acc + lane * P32_2) & M32, 13) * P32_1) & M32


def _round64(acc: int, lane: int) -> int:
    return (_rotl64((acc + lane * P64_2) & M64, 31) * P64_1) & M64


def _merge64(h: int, acc: int) -> int:
    h ^= _round64(0, acc)
    return (h * P64_1 + P64_4) & M64


def xxh32(data, seed: int = 0) -> int:
    """One-shot xxHash32 of a buffer. Returns unsigned 32-bit int."""
    b = data if isinstance(data, np.ndarray) else np.frombuffer(memoryview(data), dtype=np.uint8)
    n = b.size
    i = 0
    if n >= 16:
        n_stripes = n // 16
        words = b[: n_stripes * 16].view("<u4").reshape(n_stripes, 4)
        accs = [(seed + P32_1 + P32_2) & M32, (seed + P32_2) & M32, seed & M32,
                (seed - P32_1) & M32]
        for s in range(n_stripes):
            w = words[s]
            for k in range(4):
                accs[k] = _round32(accs[k], int(w[k]))
        h = (_rotl32(accs[0], 1) + _rotl32(accs[1], 7) + _rotl32(accs[2], 12)
             + _rotl32(accs[3], 18)) & M32
        i = n_stripes * 16
    else:
        h = (seed + P32_5) & M32
    h = (h + n) & M32
    while i + 4 <= n:
        h = (_rotl32((h + _u32le(b, i) * P32_3) & M32, 17) * P32_4) & M32
        i += 4
    while i < n:
        h = (_rotl32((h + int(b[i]) * P32_5) & M32, 11) * P32_1) & M32
        i += 1
    h ^= h >> 15
    h = (h * P32_2) & M32
    h ^= h >> 13
    h = (h * P32_3) & M32
    h ^= h >> 16
    return h


def xxh64(data, seed: int = 0) -> int:
    """One-shot xxHash64 of a buffer. Returns unsigned 64-bit int."""
    b = data if isinstance(data, np.ndarray) else np.frombuffer(memoryview(data), dtype=np.uint8)
    n = b.size
    i = 0
    if n >= 32:
        n_stripes = n // 32
        words = b[: n_stripes * 32].view("<u8").reshape(n_stripes, 4)
        accs = [(seed + P64_1 + P64_2) & M64, (seed + P64_2) & M64, seed & M64,
                (seed - P64_1) & M64]
        for s in range(n_stripes):
            w = words[s]
            for k in range(4):
                accs[k] = _round64(accs[k], int(w[k]))
        h = (_rotl64(accs[0], 1) + _rotl64(accs[1], 7) + _rotl64(accs[2], 12)
             + _rotl64(accs[3], 18)) & M64
        for a in accs:
            h = _merge64(h, a)
        i = n_stripes * 32
    else:
        h = (seed + P64_5) & M64
    h = (h + n) & M64
    while i + 8 <= n:
        h = (_rotl64(h ^ _round64(0, _u64le(b, i)), 27) * P64_1 + P64_4) & M64
        i += 8
    if i + 4 <= n:
        h = (_rotl64(h ^ (_u32le(b, i) * P64_1) & M64, 23) * P64_2 + P64_3) & M64
        i += 4
    while i < n:
        h = (_rotl64(h ^ (int(b[i]) * P64_5) & M64, 11) * P64_1) & M64
        i += 1
    h ^= h >> 33
    h = (h * P64_2) & M64
    h ^= h >> 29
    h = (h * P64_3) & M64
    h ^= h >> 32
    return h


class XxHash64State:
    """Streaming xxHash64 (reference: zstd/XxHash64.java:28-291 update/digest).

    Buffers partial stripes; digest() finalizes without disturbing state.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed & M64
        self.v1 = (seed + P64_1 + P64_2) & M64
        self.v2 = (seed + P64_2) & M64
        self.v3 = seed & M64
        self.v4 = (seed - P64_1) & M64
        self.total = 0
        self.buf = bytearray()

    def update(self, data) -> "XxHash64State":
        b = bytes(memoryview(data))
        self.total += len(b)
        self.buf += b
        usable = (len(self.buf) // 32) * 32
        if usable:
            chunk = np.frombuffer(bytes(self.buf[:usable]), dtype=np.uint8)
            words = chunk.view("<u8").reshape(-1, 4)
            v1, v2, v3, v4 = self.v1, self.v2, self.v3, self.v4
            for s in range(words.shape[0]):
                w = words[s]
                v1 = _round64(v1, int(w[0]))
                v2 = _round64(v2, int(w[1]))
                v3 = _round64(v3, int(w[2]))
                v4 = _round64(v4, int(w[3]))
            self.v1, self.v2, self.v3, self.v4 = v1, v2, v3, v4
            del self.buf[:usable]
        return self

    def digest(self) -> int:
        if self.total >= 32:
            h = (_rotl64(self.v1, 1) + _rotl64(self.v2, 7) + _rotl64(self.v3, 12) + _rotl64(self.v4, 18)) & M64
            for a in (self.v1, self.v2, self.v3, self.v4):
                h = _merge64(h, a)
        else:
            h = (self.seed + P64_5) & M64
        h = (h + self.total) & M64
        b = np.frombuffer(bytes(self.buf), dtype=np.uint8)
        n = b.size
        i = 0
        while i + 8 <= n:
            h = (_rotl64(h ^ _round64(0, _u64le(b, i)), 27) * P64_1 + P64_4) & M64
            i += 8
        if i + 4 <= n:
            h = (_rotl64(h ^ (_u32le(b, i) * P64_1) & M64, 23) * P64_2 + P64_3) & M64
            i += 4
        while i < n:
            h = (_rotl64(h ^ (int(b[i]) * P64_5) & M64, 11) * P64_1) & M64
            i += 1
        h ^= h >> 33
        h = (h * P64_2) & M64
        h ^= h >> 29
        h = (h * P64_3) & M64
        h ^= h >> 32
        return h


class XxHash32State:
    """Streaming xxHash32 (reference: xxhash/XxHash32JavaHasher.java)."""

    def __init__(self, seed: int = 0):
        self.seed = seed & M32
        self.v1 = (seed + P32_1 + P32_2) & M32
        self.v2 = (seed + P32_2) & M32
        self.v3 = seed & M32
        self.v4 = (seed - P32_1) & M32
        self.total = 0
        self.buf = bytearray()

    def update(self, data) -> "XxHash32State":
        b = bytes(memoryview(data))
        self.total += len(b)
        self.buf += b
        usable = (len(self.buf) // 16) * 16
        if usable:
            chunk = np.frombuffer(bytes(self.buf[:usable]), dtype=np.uint8)
            words = chunk.view("<u4").reshape(-1, 4)
            v1, v2, v3, v4 = self.v1, self.v2, self.v3, self.v4
            for s in range(words.shape[0]):
                w = words[s]
                v1 = _round32(v1, int(w[0]))
                v2 = _round32(v2, int(w[1]))
                v3 = _round32(v3, int(w[2]))
                v4 = _round32(v4, int(w[3]))
            self.v1, self.v2, self.v3, self.v4 = v1, v2, v3, v4
            del self.buf[:usable]
        return self

    def digest(self) -> int:
        if self.total >= 16:
            h = (_rotl32(self.v1, 1) + _rotl32(self.v2, 7) + _rotl32(self.v3, 12) + _rotl32(self.v4, 18)) & M32
        else:
            h = (self.seed + P32_5) & M32
        h = (h + self.total) & M32
        b = np.frombuffer(bytes(self.buf), dtype=np.uint8)
        n = b.size
        i = 0
        while i + 4 <= n:
            h = (_rotl32((h + _u32le(b, i) * P32_3) & M32, 17) * P32_4) & M32
            i += 4
        while i < n:
            h = (_rotl32((h + int(b[i]) * P32_5) & M32, 11) * P32_1) & M32
            i += 1
        h ^= h >> 15
        h = (h * P32_2) & M32
        h ^= h >> 13
        h = (h * P32_3) & M32
        h ^= h >> 16
        return h
