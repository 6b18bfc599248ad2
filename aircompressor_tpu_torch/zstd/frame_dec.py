"""Zstd frame decompression (RFC 8878) — reference tier, on the host: the
port's counterpart of ``aircompressor_tpu.zstd.frame_dec``.

Full frame decode: header parsing, raw/RLE/compressed blocks, literals
(raw/RLE/Huffman/treeless), FSE sequence tables (predefined/RLE/compressed/
repeat), interleaved 3-state sequence decode with repcodes carried across a
frame's blocks, and xxh64 frame checksums. Parity target: reference
zstd/ZstdFrameDecompressor.java:135-962.

The frame-header and sequence-table readers are the planner's
(``host/zstd/device_prep.py``), one copy for both: the card's decode plans
frames with them, and this decoder is its host oracle.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..errors import MalformedInputException
from ..host.xxhash import XxHash64State
from ..host.zstd import constants as C
from ..host.zstd import fse, huffman
from ..host.zstd.bits import BackwardBitReader
from ..host.zstd.device_prep import (
    FrameHeader, _read_seq_table, _u24le, _u32le, read_frame_header)

__all__ = ["FrameHeader", "decode_block_into", "decompress", "get_decompressed_size",
           "new_frame_context", "read_frame_header"]


@dataclass
class _FrameContext:
    """Cross-block state within one frame: repeat tables + treeless Huffman."""

    huffman: huffman.HuffmanTable | None = None
    ll_table: fse.FseTable | None = None
    of_table: fse.FseTable | None = None
    ml_table: fse.FseTable | None = None
    rep: list = field(default_factory=lambda: list(C.REP_INIT))


def get_decompressed_size(src: np.ndarray) -> int:
    """Declared content size of the first frame, or -1 if unknown."""
    ip = 0
    while ip + 4 <= src.size:
        magic = _u32le(src, ip)
        if (magic & C.MAGIC_SKIPPABLE_MASK) == C.MAGIC_SKIPPABLE_BASE:
            ip += 8 + _u32le(src, ip + 4)
            continue
        if magic != C.MAGIC:
            raise MalformedInputException(ip, "invalid magic")
        return read_frame_header(src, ip + 4).content_size
    raise MalformedInputException(0, "no zstd frame found")


def decompress(src: np.ndarray, dst: np.ndarray) -> int:
    """Decode one or more concatenated frames into dst. Returns bytes written."""
    n = int(src.size)
    ip = 0
    op = 0
    saw_frame = False
    while ip < n:
        if ip + 4 > n:
            raise MalformedInputException(ip, "truncated magic")
        magic = _u32le(src, ip)
        ip += 4
        if (magic & C.MAGIC_SKIPPABLE_MASK) == C.MAGIC_SKIPPABLE_BASE:
            if ip + 4 > n:
                raise MalformedInputException(ip, "truncated skippable frame")
            skip = _u32le(src, ip)
            ip += 4 + skip
            if ip > n:
                raise MalformedInputException(ip, "truncated skippable frame")
            continue
        if magic == C.MAGIC_V07:
            raise MalformedInputException(ip - 4, "legacy zstd v0.7 frames are not supported")
        if magic != C.MAGIC:
            raise MalformedInputException(ip - 4, f"invalid magic: 0x{magic:08x}")
        saw_frame = True
        ip, op = _decompress_frame(src, ip, dst, op)
    if not saw_frame:
        raise MalformedInputException(0, "no zstd frame found")
    return op


def _decompress_frame(src: np.ndarray, ip: int, dst: np.ndarray, op: int) -> tuple[int, int]:
    n = int(src.size)
    header = read_frame_header(src, ip)
    if header.dictionary_id:
        raise MalformedInputException(ip, "dictionaries are not supported")
    if not header.single_segment and header.window_size > C.MAX_WINDOW_SIZE:
        raise MalformedInputException(ip, f"window size too large: {header.window_size}")
    ip += header.header_size

    ctx = _FrameContext()
    frame_base = op
    hasher = XxHash64State(0) if header.has_checksum else None
    block_max = min(header.window_size if header.window_size > 0 else C.MAX_BLOCK_SIZE,
                    C.MAX_BLOCK_SIZE)

    while True:
        if ip + 3 > n:
            raise MalformedInputException(ip, "truncated block header")
        bh = _u24le(src, ip)
        ip += 3
        last = bh & 1
        block_type = (bh >> 1) & 3
        block_size = bh >> 3

        if block_type == C.RAW_BLOCK:
            if ip + block_size > n:
                raise MalformedInputException(ip, "truncated raw block")
            if op + block_size > dst.size:
                raise MalformedInputException(ip, "output buffer too small")
            dst[op : op + block_size] = src[ip : ip + block_size]
            ip += block_size
            op += block_size
        elif block_type == C.RLE_BLOCK:
            if ip >= n:
                raise MalformedInputException(ip, "truncated RLE block")
            if block_size > block_max:
                raise MalformedInputException(ip, "RLE block too large")
            if op + block_size > dst.size:
                raise MalformedInputException(ip, "output buffer too small")
            dst[op : op + block_size] = src[ip]
            ip += 1
            op += block_size
        elif block_type == C.COMPRESSED_BLOCK:
            if block_size > block_max:
                raise MalformedInputException(ip, "compressed block exceeds maximum")
            if ip + block_size > n:
                raise MalformedInputException(ip, "truncated compressed block")
            op = _decode_compressed_block(src, ip, ip + block_size, dst, op, frame_base, ctx)
            ip += block_size
        else:
            raise MalformedInputException(ip, "reserved block type")

        if last:
            break

    if header.content_size >= 0 and op - frame_base != header.content_size:
        raise MalformedInputException(ip, "decoded size does not match content size")
    if header.has_checksum:
        if ip + 4 > n:
            raise MalformedInputException(ip, "truncated frame checksum")
        expected = _u32le(src, ip)
        ip += 4
        hasher.update(dst[frame_base:op])
        if hasher.digest() & 0xFFFFFFFF != expected:
            raise MalformedInputException(ip - 4, "frame checksum mismatch")
    return ip, op


# --------------------------------------------------------------------- blocks
def _decode_compressed_block(src: np.ndarray, lo: int, hi: int, dst: np.ndarray,
                             op: int, frame_base: int, ctx: _FrameContext) -> int:
    literals, lit_len, seq_lo = _decode_literals(src, lo, hi, ctx)
    return _decode_and_execute_sequences(
        src, seq_lo, hi, literals, lit_len, dst, op, frame_base, ctx)


def _decode_literals(src: np.ndarray, lo: int, hi: int,
                     ctx: _FrameContext) -> tuple[np.ndarray, int, int]:
    """Returns (literals buffer, literal count, offset after literals section)."""
    if lo >= hi:
        raise MalformedInputException(lo, "empty compressed block")
    b0 = int(src[lo])
    lit_type = b0 & 3
    size_format = (b0 >> 2) & 3

    if lit_type in (C.RAW_LITERALS, C.RLE_LITERALS):
        if size_format in (0, 2):
            regen = b0 >> 3
            header = 1
        elif size_format == 1:
            if lo + 2 > hi:
                raise MalformedInputException(lo, "truncated literals header")
            regen = (b0 >> 4) | (int(src[lo + 1]) << 4)
            header = 2
        else:
            if lo + 3 > hi:
                raise MalformedInputException(lo, "truncated literals header")
            regen = (b0 >> 4) | (int(src[lo + 1]) << 4) | (int(src[lo + 2]) << 12)
            header = 3
        if lit_type == C.RAW_LITERALS:
            if lo + header + regen > hi:
                raise MalformedInputException(lo, "raw literals exceed block")
            return src[lo + header : lo + header + regen], regen, lo + header + regen
        if lo + header >= hi:
            raise MalformedInputException(lo, "truncated RLE literal")
        out = np.full(regen, int(src[lo + header]), dtype=np.uint8)
        return out, regen, lo + header + 1

    # compressed / treeless
    if size_format == 0:
        streams = 1
    else:
        streams = 4
    if size_format in (0, 1):
        if lo + 3 > hi:
            raise MalformedInputException(lo, "truncated literals header")
        b1, b2 = int(src[lo + 1]), int(src[lo + 2])
        regen = (b0 >> 4) | ((b1 & 0x3F) << 4)
        comp = (b1 >> 6) | (b2 << 2)
        header = 3
    elif size_format == 2:
        if lo + 4 > hi:
            raise MalformedInputException(lo, "truncated literals header")
        b1, b2, b3 = int(src[lo + 1]), int(src[lo + 2]), int(src[lo + 3])
        regen = (b0 >> 4) | (b1 << 4) | ((b2 & 3) << 12)
        comp = (b2 >> 2) | (b3 << 6)
        header = 4
    else:
        if lo + 5 > hi:
            raise MalformedInputException(lo, "truncated literals header")
        b1, b2, b3, b4 = (int(src[lo + 1]), int(src[lo + 2]), int(src[lo + 3]),
                          int(src[lo + 4]))
        regen = (b0 >> 4) | (b1 << 4) | ((b2 & 0x3F) << 12)
        comp = (b2 >> 6) | (b3 << 2) | (b4 << 10)
        header = 5
    payload_lo = lo + header
    payload_hi = payload_lo + comp
    if payload_hi > hi:
        raise MalformedInputException(lo, "compressed literals exceed block")

    if lit_type == C.COMPRESSED_LITERALS:
        table, consumed = huffman.read_table(src, payload_lo, payload_hi)
        ctx.huffman = table
        stream_lo = payload_lo + consumed
    else:
        if ctx.huffman is None:
            raise MalformedInputException(lo, "treeless literals without a previous Huffman table")
        table = ctx.huffman
        stream_lo = payload_lo

    out = np.zeros(regen, dtype=np.uint8)
    if streams == 1:
        huffman.decode_single_stream(table, src, stream_lo, payload_hi, out, 0, regen)
    else:
        huffman.decode_4_streams(table, src, stream_lo, payload_hi, out, 0, regen)
    return out, regen, payload_hi


def _decode_and_execute_sequences(src: np.ndarray, lo: int, hi: int,
                                  literals: np.ndarray, lit_len: int,
                                  dst: np.ndarray, op: int, frame_base: int,
                                  ctx: _FrameContext) -> int:
    if lo >= hi:
        raise MalformedInputException(lo, "missing sequences section")
    b0 = int(src[lo])
    ip = lo + 1
    if b0 < 128:
        n_seq = b0
    elif b0 < 255:
        if ip >= hi:
            raise MalformedInputException(ip, "truncated sequence count")
        n_seq = ((b0 - 128) << 8) + int(src[ip])
        ip += 1
    else:
        if ip + 2 > hi:
            raise MalformedInputException(ip, "truncated sequence count")
        n_seq = int(src[ip]) + (int(src[ip + 1]) << 8) + 0x7F00
        ip += 2

    if n_seq == 0:
        # all-literal block
        if op + lit_len > dst.size:
            raise MalformedInputException(ip, "output buffer too small")
        dst[op : op + lit_len] = literals[:lit_len]
        return op + lit_len

    if ip >= hi:
        raise MalformedInputException(ip, "missing sequence compression modes")
    modes = int(src[ip])
    ip += 1
    if modes & 0b11:
        raise MalformedInputException(ip - 1, "reserved sequence mode bits set")
    ll_mode = (modes >> 6) & 3
    of_mode = (modes >> 4) & 3
    ml_mode = (modes >> 2) & 3

    ll_table, ip = _read_seq_table(src, ip, hi, ll_mode, "ll", C.MAX_LL_SYMBOL,
                                   C.LL_TABLE_LOG_MAX, ctx.ll_table)
    of_table, ip = _read_seq_table(src, ip, hi, of_mode, "of", C.MAX_OF_SYMBOL,
                                   C.OF_TABLE_LOG_MAX, ctx.of_table)
    ml_table, ip = _read_seq_table(src, ip, hi, ml_mode, "ml", C.MAX_ML_SYMBOL,
                                   C.ML_TABLE_LOG_MAX, ctx.ml_table)
    ctx.ll_table, ctx.of_table, ctx.ml_table = ll_table, of_table, ml_table

    reader = BackwardBitReader(src, ip, hi)
    ll_state = reader.read(ll_table.log2_size)
    of_state = reader.read(of_table.log2_size)
    ml_state = reader.read(ml_table.log2_size)
    if reader.is_overflowed():
        raise MalformedInputException(ip, "sequence bitstream too short")

    rep = ctx.rep
    lit_pos = 0
    out_cap = dst.size
    ll_sym, ll_nb, ll_ns = ll_table.symbol, ll_table.num_bits, ll_table.new_state
    of_sym, of_nb, of_ns = of_table.symbol, of_table.num_bits, of_table.new_state
    ml_sym, ml_nb, ml_ns = ml_table.symbol, ml_table.num_bits, ml_table.new_state
    ll_base, ll_bits = C.LL_BASE, C.LL_BITS
    ml_base, ml_bits = C.ML_BASE, C.ML_BITS

    for seq_i in range(n_seq):
        ll_code = int(ll_sym[ll_state])
        of_code = int(of_sym[of_state])
        ml_code = int(ml_sym[ml_state])

        # read order: OF extra bits, then ML, then LL (RFC 8878 §3.1.1.4)
        offset_value = (1 << of_code) + reader.read(of_code)
        match_len = int(ml_base[ml_code]) + reader.read(int(ml_bits[ml_code]))
        lit_run = int(ll_base[ll_code]) + reader.read(int(ll_bits[ll_code]))

        # repcode resolution (reference: ZstdFrameDecompressor L416-450)
        if offset_value > 3:
            offset = offset_value - 3
            rep[2] = rep[1]
            rep[1] = rep[0]
            rep[0] = offset
        else:
            idx = offset_value - 1 + (1 if lit_run == 0 else 0)
            if idx == 0:
                offset = rep[0]
            else:
                offset = rep[0] - 1 if idx == 3 else rep[idx]
                if offset <= 0:
                    raise MalformedInputException(ip, "invalid repeated offset")
                if idx != 1:
                    rep[2] = rep[1]
                rep[1] = rep[0]
                rep[0] = offset

        # state updates (order LL, ML, OF), skipped after the final sequence
        if seq_i != n_seq - 1:
            ll_state = int(ll_ns[ll_state]) + reader.read(int(ll_nb[ll_state]))
            ml_state = int(ml_ns[ml_state]) + reader.read(int(ml_nb[ml_state]))
            of_state = int(of_ns[of_state]) + reader.read(int(of_nb[of_state]))
            if reader.is_overflowed():
                raise MalformedInputException(ip, "sequence bitstream exhausted")

        # execute: literals then match
        if lit_pos + lit_run > lit_len:
            raise MalformedInputException(ip, "literal run exceeds literals")
        if op + lit_run + match_len > out_cap:
            raise MalformedInputException(ip, "output buffer too small")
        if lit_run:
            dst[op : op + lit_run] = literals[lit_pos : lit_pos + lit_run]
            lit_pos += lit_run
            op += lit_run
        if match_len:
            if offset > op - frame_base:
                raise MalformedInputException(ip, "match offset before start of frame")
            start = op - offset
            if offset >= match_len:
                dst[op : op + match_len] = dst[start : start + match_len]
            else:
                idx_arr = start + (np.arange(match_len) % offset)
                dst[op : op + match_len] = dst[idx_arr]
            op += match_len

    if not reader.is_fully_consumed():
        raise MalformedInputException(ip, "sequence bitstream not fully consumed")

    # trailing literals
    rest = lit_len - lit_pos
    if rest:
        if op + rest > out_cap:
            raise MalformedInputException(ip, "output buffer too small")
        dst[op : op + rest] = literals[lit_pos:lit_len]
        op += rest
    return op


# ----------------------------------------------------------- incremental API
def new_frame_context() -> "_FrameContext":
    """Fresh cross-block state for one frame (incremental decode path,
    reference: ZstdIncrementalFrameDecompressor's per-frame reset)."""
    return _FrameContext()


def decode_block_into(block_type: int, block_size: int, payload: np.ndarray,
                      dst: np.ndarray, op: int, frame_base: int,
                      ctx: "_FrameContext") -> int:
    """Decode one block whose payload bytes are fully available.

    ``dst[..op]`` holds the frame's decoded history (window); ``frame_base``
    may be negative when older history has been dropped (its magnitude is the
    count of dropped bytes). Returns the new ``op``.
    """
    if block_type == C.RAW_BLOCK:
        if op + block_size > dst.size:
            raise MalformedInputException(0, "output buffer too small")
        dst[op : op + block_size] = payload[:block_size]
        return op + block_size
    if block_type == C.RLE_BLOCK:
        if block_size > C.MAX_BLOCK_SIZE:
            raise MalformedInputException(0, "RLE block too large")
        if op + block_size > dst.size:
            raise MalformedInputException(0, "output buffer too small")
        dst[op : op + block_size] = payload[0]
        return op + block_size
    if block_type == C.COMPRESSED_BLOCK:
        if block_size > C.MAX_BLOCK_SIZE:
            raise MalformedInputException(0, "compressed block exceeds maximum")
        return _decode_compressed_block(payload, 0, block_size, dst, op, frame_base, ctx)
    raise MalformedInputException(0, "reserved block type")
