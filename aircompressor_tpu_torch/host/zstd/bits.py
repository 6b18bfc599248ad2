"""Zstd bitstream readers/writers.

The port's copy of ``aircompressor_tpu.zstd.bits``.

Zstd uses two bitstream styles (RFC 8878 §4.1):
- the *backward* bitstream: written LSB-first, read starting from the END
  after locating the end-mark bit (highest set bit of the last byte). Used by
  FSE-coded streams, Huffman literal streams, and the sequences section.
  (Reference behavior: zstd/BitInputStream.java Initializer/Loader.)
- the *forward* little-endian bitstream used only by FSE table descriptions
  (normalized counts).

Our reader addresses bits positionally over the byte buffer (O(1) per read,
no big-int shifting), tolerating bounded over-read with zero-fill below the
stream start — matching the semantics decoders rely on for final-state reads.
"""

from __future__ import annotations

import numpy as np

from ...errors import MalformedInputException


class BackwardBitReader:
    """Reads bits MSB-down from a [start, end) byte range of ``buf``."""

    __slots__ = ("buf", "start", "remaining")

    def __init__(self, buf, start: int, end: int):
        # accept numpy or bytes. numpy becomes a ZERO-COPY memoryview:
        # converting with .tobytes() copied the whole backing buffer per
        # reader — ~60% of zstd device-decode host planning time when the
        # backing buffer is the flat multi-frame batch (VERDICT r4 #5)
        self.buf = (buf.data if isinstance(buf, np.ndarray)
                    else buf if isinstance(buf, bytes) else bytes(buf))
        if end <= start or end > len(self.buf):
            raise MalformedInputException(start, "empty or invalid bitstream")
        self.start = start
        last = self.buf[end - 1]
        if last == 0:
            raise MalformedInputException(end - 1, "bitstream end mark missing")
        # bits below the end-mark bit are payload
        self.remaining = (end - start - 1) * 8 + (last.bit_length() - 1)

    def peek(self, n: int) -> int:
        """Top n bits (zero-padded at the bottom on over-read)."""
        if n == 0:
            return 0
        r = self.remaining
        if r <= 0:
            return 0
        if r < n:
            return self._extract(0, r) << (n - r)
        return self._extract(r - n, n)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.remaining -= n
        return v

    def skip(self, n: int) -> None:
        self.remaining -= n

    def is_overflowed(self) -> bool:
        return self.remaining < 0

    def is_fully_consumed(self) -> bool:
        return self.remaining == 0

    def _extract(self, lo_bit: int, n: int) -> int:
        lo = self.start + (lo_bit >> 3)
        hi = self.start + ((lo_bit + n + 7) >> 3)
        word = int.from_bytes(self.buf[lo:hi], "little")
        return (word >> (lo_bit & 7)) & ((1 << n) - 1)


class ForwardBitReader:
    """Forward little-endian bit reader (FSE normalized-count descriptions)."""

    __slots__ = ("buf", "base", "bit_pos", "limit_bits")

    def __init__(self, buf, start: int, end: int):
        # zero-copy for numpy (see BackwardBitReader.__init__)
        self.buf = (buf.data if isinstance(buf, np.ndarray)
                    else buf if isinstance(buf, bytes) else bytes(buf))
        self.base = start
        self.bit_pos = 0
        self.limit_bits = (end - start) * 8

    def peek(self, n: int) -> int:
        lo = self.base + (self.bit_pos >> 3)
        hi = min(self.base + ((self.bit_pos + n + 7) >> 3), len(self.buf))
        word = int.from_bytes(self.buf[lo:hi], "little")
        return (word >> (self.bit_pos & 7)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.bit_pos += n
        return v

    def skip(self, n: int) -> None:
        self.bit_pos += n

    def bytes_consumed(self) -> int:
        return (self.bit_pos + 7) >> 3

    def overflowed(self) -> bool:
        return self.bit_pos > self.limit_bits


def pack_backward(vals: np.ndarray, nbits: np.ndarray) -> bytes:
    """Vectorized BackwardBitWriter: pack (vals[i], nbits[i]) ops appended
    LSB-first in order, then the end-mark bit. Equivalent to feeding every op
    through BackwardBitWriter.add and calling close(), but O(1) numpy passes.

    Bit ranges of distinct ops are disjoint, so per-byte contributions combine
    with bitwise-or (no carries). Each op spans ≤ ceil((nbits+7)/8)+1 bytes;
    nbits must be ≤ 56 so value<<7 still fits in int64.
    """
    nbits = np.asarray(nbits, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.int64)
    if nbits.size == 0:
        return b"\x01"
    vals = vals & ((np.int64(1) << nbits) - np.int64(1))
    offs = np.zeros(nbits.size, dtype=np.int64)
    np.cumsum(nbits[:-1], out=offs[1:])
    total = int(offs[-1] + nbits[-1])
    buf = np.zeros((total + 1 + 7) >> 3, dtype=np.uint8)
    byte0 = offs >> 3
    shift = offs & 7
    shifted = vals << shift
    max_span = int((int(nbits.max()) + 7 + 7) >> 3)
    for k in range(max_span):
        live = (8 * k) < (shift + nbits)
        if not live.any():
            break
        contrib = ((shifted[live] >> (8 * k)) & 0xFF).astype(np.uint8)
        np.bitwise_or.at(buf, byte0[live] + k, contrib)
    buf[total >> 3] |= np.uint8(1 << (total & 7))
    return buf.tobytes()


class BackwardBitWriter:
    """Writes a backward bitstream: bits appended LSB-first, closed with the
    end-mark bit (reference behavior: zstd/BitOutputStream.java:49-89)."""

    __slots__ = ("acc", "nbits", "out")

    def __init__(self):
        self.acc = 0
        self.nbits = 0
        self.out = bytearray()

    def add(self, value: int, n: int) -> None:
        if n:
            self.acc |= (value & ((1 << n) - 1)) << self.nbits
            self.nbits += n
            while self.nbits >= 8:
                self.out.append(self.acc & 0xFF)
                self.acc >>= 8
                self.nbits -= 8

    def close(self) -> bytes:
        # end mark
        self.acc |= 1 << self.nbits
        self.nbits += 1
        while self.nbits > 0:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.nbits -= 8
        return bytes(self.out)
