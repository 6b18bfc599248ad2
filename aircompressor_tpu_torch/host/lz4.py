"""LZ4 block codec, reference tier: scalar control flow over numpy.

A copy of ``aircompressor_tpu.lz4.block_ref`` and its constants (format:
lz4_Block_format.md; parity: the reference's Lz4RawCompressor /
Lz4RawDecompressor). Its matcher hashes 5 bytes into a 2^15-entry table and
indexes every position a match covers, so its blocks differ from the
kernel's and are often smaller. It runs at about 1 MB/s, so the port uses
it as an oracle on small inputs, not on a corpus.
"""

from __future__ import annotations

import numpy as np

from ..errors import MalformedInputException

MIN_MATCH = 4
LAST_LITERALS = 5          # the last 5 bytes of a block are always literals
MF_LIMIT = 12              # matches must not start within this distance of the end
MAX_DISTANCE = 65535       # 16-bit offsets
ML_MASK = 15
RUN_MASK = ML_MASK
MAX_INPUT_SIZE = 0x7E000000
HASH_LOG = 15
SKIP_TRIGGER = 6


def max_compressed_length(n: int) -> int:
    """Exact LZ4 worst-case bound."""
    if n < 0:
        raise ValueError("negative length")
    return n + n // 255 + 16


def compress(data: bytes) -> bytes:
    """One LZ4 block of ``data``."""
    src = np.frombuffer(memoryview(data), np.uint8)
    dst = np.empty(max_compressed_length(src.size), np.uint8)
    return dst[:compress_into(src, dst)].tobytes()


def decompress(blob: bytes, max_len: int) -> bytes:
    """The bytes of one LZ4 block of at most ``max_len`` decoded bytes;
    raises MalformedInputException on a malformed block."""
    dst = np.empty(int(max_len), np.uint8)
    return dst[:decompress_into(np.frombuffer(memoryview(blob), np.uint8), dst)].tobytes()


def _hash_all(src: np.ndarray) -> np.ndarray:
    """Multiplicative hash of the 5 bytes at every position."""
    n = src.size
    if n < 8:
        return np.zeros(0, dtype=np.int64)
    v = np.zeros(n - 7, dtype=np.uint64)
    for k in range(5):
        v |= src[k : n - 7 + k].astype(np.uint64) << np.uint64(8 * k)
    h = ((v << np.uint64(24)) * np.uint64(0x9E3779B185EBCA87)) >> np.uint64(64 - HASH_LOG)
    return h.astype(np.int64)


def _match_forward(src: np.ndarray, a: int, b: int, limit: int) -> int:
    """Length of the common run src[a:] == src[b:], b < limit."""
    span = limit - b
    if span <= 0:
        return 0
    neq = src[a : a + span] != src[b : b + span]
    idx = int(np.argmax(neq))
    return idx if neq[idx] else span


def compress_into(src: np.ndarray, dst: np.ndarray, acceleration: int = 1) -> int:
    """Compress ``src`` (uint8) into ``dst``; returns bytes written."""
    n = int(src.size)
    if n > MAX_INPUT_SIZE:
        raise ValueError("input too large for LZ4")
    if dst.size < max_compressed_length(n):
        raise ValueError("output buffer smaller than max_compressed_length")
    out = dst
    op = 0

    def emit_length(rest: int) -> None:
        nonlocal op
        while rest >= 255:
            out[op] = 255
            op += 1
            rest -= 255
        out[op] = rest
        op += 1

    def emit_sequence(anchor: int, pos: int, match_len_minus4: int, offset: int) -> None:
        nonlocal op
        lit_len = pos - anchor
        token_pos = op
        op += 1
        if lit_len >= RUN_MASK:
            emit_length(lit_len - RUN_MASK)
        if lit_len:
            out[op : op + lit_len] = src[anchor:pos]
            op += lit_len
        token = min(lit_len, RUN_MASK) << 4
        if offset >= 0:
            out[op] = offset & 0xFF
            out[op + 1] = (offset >> 8) & 0xFF
            op += 2
            if match_len_minus4 >= ML_MASK:
                emit_length(match_len_minus4 - ML_MASK)
            token |= min(match_len_minus4, ML_MASK)
        out[token_pos] = token

    if n < MF_LIMIT + 1:
        emit_sequence(0, n, 0, -1)
        return op

    hashes = _hash_all(src)
    table = np.full(1 << HASH_LOG, -1, dtype=np.int64)
    match_limit = n - LAST_LITERALS
    mf_limit = n - MF_LIMIT
    anchor = 0
    pos = 0
    acceleration = max(int(acceleration), 1)

    while True:
        # Find a match: greedy, skip-accelerated.
        p = pos
        step_counter = acceleration << SKIP_TRIGGER
        found = -1
        while True:
            if p > mf_limit:
                emit_sequence(anchor, n, 0, -1)
                return op
            h = int(hashes[p])
            cand = int(table[h])
            table[h] = p
            if cand >= 0 and p - cand <= MAX_DISTANCE and (
                src[cand] == src[p]
                and src[cand + 1] == src[p + 1]
                and src[cand + 2] == src[p + 2]
                and src[cand + 3] == src[p + 3]
            ):
                found = cand
                break
            step = step_counter >> SKIP_TRIGGER
            step_counter += 1
            p += step
        pos = p
        match = found
        # Backward extension ("catch up"), then forward.
        while pos > anchor and match > 0 and src[pos - 1] == src[match - 1]:
            pos -= 1
            match -= 1
        mlen = MIN_MATCH + _match_forward(src, match + MIN_MATCH, pos + MIN_MATCH, match_limit)
        emit_sequence(anchor, pos, mlen - MIN_MATCH, pos - match)
        pos += mlen
        anchor = pos
        if pos > mf_limit:
            emit_sequence(anchor, n, 0, -1)
            return op
        # Index every position the match covers, in order (last one wins).
        lo = max(match + 1, pos - mlen)
        if pos - lo > 1:
            idx = np.arange(lo, pos)
            table[hashes[idx]] = idx


def decompress_into(src: np.ndarray, dst: np.ndarray) -> int:
    """Decompress an LZ4 block into ``dst``; returns bytes written. Raises
    MalformedInputException with the input offset of the problem."""
    n = int(src.size)
    out_cap = int(dst.size)
    if n == 0:
        raise MalformedInputException(0, "input is empty")
    ip = 0
    op = 0

    def read_length(length: int, what: str) -> int:
        nonlocal ip
        while True:
            if ip >= n:
                raise MalformedInputException(ip, f"unexpected end of input in {what}")
            b = int(src[ip])
            ip += 1
            length += b
            if b != 255:
                return length

    while True:
        if ip >= n:
            raise MalformedInputException(ip, "unexpected end of input")
        token = int(src[ip])
        ip += 1
        lit_len = token >> 4
        if lit_len == RUN_MASK:
            lit_len = read_length(lit_len, "literal length")
        if ip + lit_len > n:
            raise MalformedInputException(ip, "literal length exceeds input")
        if op + lit_len > out_cap:
            raise MalformedInputException(ip, "output buffer too small")
        dst[op : op + lit_len] = src[ip : ip + lit_len]
        ip += lit_len
        op += lit_len
        if ip == n:  # the final sequence: literals only
            return op
        if ip + 2 > n:
            raise MalformedInputException(ip, "truncated match offset")
        offset = int(src[ip]) | (int(src[ip + 1]) << 8)
        ip += 2
        if offset == 0 or offset > op:
            raise MalformedInputException(ip, "offset outside buffer")
        match_len = token & ML_MASK
        if match_len == ML_MASK:
            match_len = read_length(match_len, "match length")
        match_len += MIN_MATCH
        if op + match_len > out_cap:
            raise MalformedInputException(ip, "output buffer too small")
        start = op - offset
        if offset >= match_len:
            dst[op : op + match_len] = dst[start : start + match_len]
        else:  # overlapping copy
            dst[op : op + match_len] = dst[start + (np.arange(match_len) % offset)]
        op += match_len
