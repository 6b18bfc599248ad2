"""Snappy block codec, reference tier: scalar control flow over numpy.

A copy of ``aircompressor_tpu.snappy.block_ref`` and its constants (format:
google/snappy format_description.txt; parity: the reference's
SnappyRawCompressor / SnappyRawDecompressor). It runs at about 1 MB/s, so
the port uses it as an oracle on small inputs, not on a corpus.
"""

from __future__ import annotations

import numpy as np

from ..errors import MalformedInputException

LITERAL = 0b00
COPY_1_BYTE_OFFSET = 0b01
COPY_2_BYTE_OFFSET = 0b10

BLOCK_SIZE = 1 << 16     # matches never cross 64KB block restarts
MIN_MATCH = 4
INPUT_MARGIN = 15        # tail handled as literals
MAX_HASH_TABLE_BITS = 14  # 16K entries


def max_compressed_length(n: int) -> int:
    """Worst-case bound 32 + n + n/6."""
    if n < 0:
        raise ValueError("negative length")
    return 32 + n + n // 6


def compress(data: bytes) -> bytes:
    """One Snappy block of ``data``."""
    src = np.frombuffer(memoryview(data), np.uint8)
    dst = np.empty(max_compressed_length(src.size), np.uint8)
    return dst[:compress_into(src, dst)].tobytes()


def decompress(blob: bytes, max_len: int) -> bytes:
    """The bytes of one Snappy block of at most ``max_len`` decoded bytes;
    raises MalformedInputException on a malformed block."""
    dst = np.empty(int(max_len), np.uint8)
    return dst[:decompress_into(np.frombuffer(memoryview(blob), np.uint8), dst)].tobytes()


# --------------------------------------------------------------------- varint
def write_uncompressed_length(dst: np.ndarray, op: int, n: int) -> int:
    while n >= 0x80:
        dst[op] = (n & 0x7F) | 0x80
        op += 1
        n >>= 7
    dst[op] = n
    return op + 1


def read_uncompressed_length(src: np.ndarray, ip: int = 0) -> tuple[int, int]:
    """Returns (length, end offset of the varint); at most 5 bytes."""
    result = 0
    shift = 0
    while True:
        if shift > 32 or ip >= src.size:
            raise MalformedInputException(ip, "invalid uncompressed length varint")
        b = int(src[ip])
        ip += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            break
        shift += 7
    if result < 0 or result > 0xFFFFFFFF:
        raise MalformedInputException(ip, "invalid uncompressed length")
    return result, ip


# --------------------------------------------------------------------- encode
def _hash_block(src: np.ndarray, lo: int, hi: int, bits: int) -> np.ndarray:
    n = hi - lo
    if n < 4:
        return np.zeros(0, dtype=np.int64)
    s = src[lo:hi]
    v = (
        s[: n - 3].astype(np.uint32)
        | (s[1 : n - 2].astype(np.uint32) << 8)
        | (s[2 : n - 1].astype(np.uint32) << 16)
        | (s[3:n].astype(np.uint32) << 24)
    )
    h = (v * np.uint32(0x1E35A7BD)) >> np.uint32(32 - bits)
    return h.astype(np.int64)


def _table_bits(block_len: int) -> int:
    bits = 8
    while (1 << bits) < block_len and bits < MAX_HASH_TABLE_BITS:
        bits += 1
    return bits


def _emit_literal(dst: np.ndarray, op: int, src: np.ndarray, lo: int, hi: int) -> int:
    n = hi - lo
    if n == 0:
        return op
    if n <= 60:
        dst[op] = LITERAL | ((n - 1) << 2)
        op += 1
    else:
        m = n - 1
        extra = (m.bit_length() + 7) // 8
        dst[op] = LITERAL | ((59 + extra) << 2)
        op += 1
        for k in range(extra):
            dst[op] = (m >> (8 * k)) & 0xFF
            op += 1
    dst[op : op + n] = src[lo:hi]
    return op + n


def _emit_copy(dst: np.ndarray, op: int, offset: int, length: int) -> int:
    """Copies in pieces of 64, then 60 where 64 < rest < 68, then the rest."""
    while length >= 68:
        dst[op] = COPY_2_BYTE_OFFSET | (63 << 2)
        dst[op + 1] = offset & 0xFF
        dst[op + 2] = (offset >> 8) & 0xFF
        op += 3
        length -= 64
    if length > 64:
        dst[op] = COPY_2_BYTE_OFFSET | (59 << 2)
        dst[op + 1] = offset & 0xFF
        dst[op + 2] = (offset >> 8) & 0xFF
        op += 3
        length -= 60
    if length >= 4 and length <= 11 and offset < 2048:
        dst[op] = COPY_1_BYTE_OFFSET | ((length - 4) << 2) | ((offset >> 8) << 5)
        dst[op + 1] = offset & 0xFF
        op += 2
    else:
        dst[op] = COPY_2_BYTE_OFFSET | ((length - 1) << 2)
        dst[op + 1] = offset & 0xFF
        dst[op + 2] = (offset >> 8) & 0xFF
        op += 3
    return op


def compress_into(src: np.ndarray, dst: np.ndarray) -> int:
    """Compress ``src`` into ``dst``; returns bytes written."""
    n = int(src.size)
    if dst.size < max_compressed_length(n):
        raise ValueError("output buffer smaller than max_compressed_length")
    op = write_uncompressed_length(dst, 0, n)
    for block_lo in range(0, max(n, 1), BLOCK_SIZE):
        block_hi = min(block_lo + BLOCK_SIZE, n)
        op = _compress_block(src, block_lo, block_hi, dst, op)
    return op


def _compress_block(src: np.ndarray, lo: int, hi: int, dst: np.ndarray, op: int) -> int:
    n = hi - lo
    if n < INPUT_MARGIN + 1:
        return _emit_literal(dst, op, src, lo, hi)
    bits = _table_bits(n)
    hashes = _hash_block(src, lo, hi, bits)
    table = np.full(1 << bits, -1, dtype=np.int64)  # positions relative to lo
    limit = n - INPUT_MARGIN
    anchor = 0
    pos = 0
    while True:
        # skip heuristic: 32-byte window then accelerate
        p = pos
        skip = 32
        found = -1
        while True:
            if p >= limit:
                return _emit_literal(dst, op, src, lo + anchor, hi)
            h = int(hashes[p])
            cand = int(table[h])
            table[h] = p
            if cand >= 0 and (
                src[lo + cand] == src[lo + p]
                and src[lo + cand + 1] == src[lo + p + 1]
                and src[lo + cand + 2] == src[lo + p + 2]
                and src[lo + cand + 3] == src[lo + p + 3]
            ):
                found = cand
                break
            step = skip >> 5
            skip += 1
            p += step
        pos = p
        op = _emit_literal(dst, op, src, lo + anchor, lo + pos)
        # extend match forward (within block)
        cand = found
        span = n - pos - MIN_MATCH
        a = src[lo + cand + MIN_MATCH : lo + cand + MIN_MATCH + span]
        b = src[lo + pos + MIN_MATCH : lo + pos + MIN_MATCH + span]
        neq = a != b
        idx = int(np.argmax(neq)) if neq.size else 0
        mlen = MIN_MATCH + (span if neq.size and not neq[idx] else idx)
        op = _emit_copy(dst, op, pos - cand, mlen)
        pos += mlen
        anchor = pos
        if pos >= limit:
            return _emit_literal(dst, op, src, lo + anchor, hi)
        # re-index position pos-1 and continue from pos
        table[int(hashes[pos - 1])] = pos - 1


# --------------------------------------------------------------------- decode
def decompress_into(src: np.ndarray, dst: np.ndarray) -> int:
    n = int(src.size)
    declared, ip = read_uncompressed_length(src)
    if declared > dst.size:
        raise MalformedInputException(0, "uncompressed length exceeds output buffer")
    op = 0
    while ip < n:
        tag = int(src[ip])
        ip += 1
        kind = tag & 0b11
        if kind == LITERAL:
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if ip + extra > n:
                    raise MalformedInputException(ip, "truncated literal length")
                length = 0
                for k in range(extra):
                    length |= int(src[ip + k]) << (8 * k)
                length += 1
                ip += extra
            if ip + length > n:
                raise MalformedInputException(ip, "literal exceeds input")
            if op + length > dst.size:
                raise MalformedInputException(ip, "literal exceeds output buffer")
            dst[op : op + length] = src[ip : ip + length]
            ip += length
            op += length
            continue
        if kind == COPY_1_BYTE_OFFSET:
            length = 4 + ((tag >> 2) & 0x7)
            if ip >= n:
                raise MalformedInputException(ip, "truncated copy")
            offset = ((tag >> 5) << 8) | int(src[ip])
            ip += 1
        elif kind == COPY_2_BYTE_OFFSET:
            length = (tag >> 2) + 1
            if ip + 2 > n:
                raise MalformedInputException(ip, "truncated copy")
            offset = int(src[ip]) | (int(src[ip + 1]) << 8)
            ip += 2
        else:
            length = (tag >> 2) + 1
            if ip + 4 > n:
                raise MalformedInputException(ip, "truncated copy")
            offset = (
                int(src[ip])
                | (int(src[ip + 1]) << 8)
                | (int(src[ip + 2]) << 16)
                | (int(src[ip + 3]) << 24)
            )
            ip += 4
        if offset == 0 or offset > op:
            raise MalformedInputException(ip, "copy offset outside buffer")
        if op + length > dst.size:
            raise MalformedInputException(ip, "copy exceeds output buffer")
        start = op - offset
        if offset >= length:
            dst[op : op + length] = dst[start : start + length]
        else:
            idx = start + (np.arange(length) % offset)
            dst[op : op + length] = dst[idx]
        op += length
    if op != declared:
        raise MalformedInputException(ip, f"decoded size {op} != declared {declared}")
    return op
