"""CRC32-C (Castagnoli), vectorised over GF(2), and the Snappy framing mask.

A copy of ``aircompressor_tpu.crc.crc32c``. CRC is linear over GF(2):

    crc_pre(M) = A^n(init) XOR  XOR_i  A^(n-1-i)( T[b_i] )

where A(c) = T[c & 0xff] ^ (c >> 8) advances the state by one byte and T is
the byte table. Each byte's term is advanced by A^(n-1-i) through the binary
digits of its exponent, one fixed map A^(2^j) a round, each map held as
4x256 u32 tables; the terms are then XOR-reduced. ``ops.checksum`` runs the
same rounds on (B, L) tensors with these tables. ``masked_crc32c`` and the
streaming ``Crc32C`` are the JAX module's too.
"""

from __future__ import annotations

import functools

import numpy as np

POLY_REFLECTED = 0x82F63B78  # iSCSI CRC32-C, reflected
MAX_LOG = 32  # power tables for inputs up to 2^32 bytes


@functools.cache
def byte_table() -> np.ndarray:
    """T: the (256,) uint32 table of the one-byte CRC step."""
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY_REFLECTED if (c & 1) else 0)
        table[i] = c
    return table


def _compose(m2: list[int], m1: list[int]) -> list[int]:
    """Compose linear maps given as basis images: (m2 ∘ m1)."""
    out = []
    for b in range(32):
        v = m1[b]
        r = 0
        while v:
            low = v & -v
            r ^= m2[low.bit_length() - 1]
            v ^= low
        out.append(r)
    return out


def _map_to_tables(m: list[int]) -> np.ndarray:
    """Materialise a GF(2) linear map (basis images) as 4x256 u32 tables."""
    tabs = np.zeros((4, 256), dtype=np.uint32)
    for k in range(4):
        for byte in range(256):
            r = 0
            v = byte
            while v:
                low = v & -v
                r ^= m[8 * k + low.bit_length() - 1]
                v ^= low
            tabs[k, byte] = r
    return tabs


@functools.cache
def power_tables() -> np.ndarray:
    """(MAX_LOG, 4, 256) uint32: entry j holds the tables of A^(2^j)."""
    t = byte_table()
    tabs = np.zeros((MAX_LOG, 4, 256), dtype=np.uint32)
    m = [int(t[(1 << b) & 0xFF]) ^ ((1 << b) >> 8) for b in range(32)]
    for j in range(MAX_LOG):
        tabs[j] = _map_to_tables(m)
        m = _compose(m, m)
    return tabs


def _apply_map_scalar(tabs: np.ndarray, v: int) -> int:
    return int(tabs[0, v & 0xFF] ^ tabs[1, (v >> 8) & 0xFF]
               ^ tabs[2, (v >> 16) & 0xFF] ^ tabs[3, (v >> 24) & 0xFF])


def crc32c_raw(data, crc: int = 0) -> int:
    """CRC32-C without the Snappy mask. ``crc`` is a previous unmasked crc to
    continue from (init and final xor handled inside, like zlib.crc32)."""
    b = data if isinstance(data, np.ndarray) else np.frombuffer(memoryview(data), dtype=np.uint8)
    n = int(b.size)
    state = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    if n == 0:
        return (state ^ 0xFFFFFFFF) & 0xFFFFFFFF
    power = power_tables()
    c = byte_table()[b]
    exps = np.arange(n - 1, -1, -1, dtype=np.int64)
    j = 0
    while n > 1 and (1 << j) <= n - 1:
        tabs = power[j]
        mapped = (tabs[0][c & 0xFF] ^ tabs[1][(c >> 8) & 0xFF]
                  ^ tabs[2][(c >> 16) & 0xFF] ^ tabs[3][(c >> 24) & 0xFF])
        c = np.where(((exps >> j) & 1).astype(bool), mapped, c)
        j += 1
    acc = int(np.bitwise_xor.reduce(c))
    # advance the initial state across n bytes: A^n(state)
    s = state
    k = n
    j = 0
    while k:
        if k & 1:
            s = _apply_map_scalar(power[j], s)
        k >>= 1
        j += 1
    return ((acc ^ s) ^ 0xFFFFFFFF) & 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    """Snappy framing-format CRC mask: rotate right by 15, add 0xa282ead8."""
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def masked_crc32c(data) -> int:
    return mask_crc(crc32c_raw(data))


class Crc32C:
    """Streaming CRC32-C with an update/digest interface."""

    def __init__(self) -> None:
        self._crc = 0

    def update(self, data) -> "Crc32C":
        self._crc = crc32c_raw(data, self._crc)
        return self

    def digest(self) -> int:
        return self._crc

    def masked_digest(self) -> int:
        return mask_crc(self._crc)
