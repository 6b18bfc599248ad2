"""LZ4 frame format (spec: lz4_Frame_format.md v1.6.x): the port's
counterpart of ``aircompressor_tpu.lz4.frame``, on the host (the JAX package
has no device path for it either).

Shared frame engine used by every tier — framing is cheap, sequential host
work; the block codec is injected (same architecture as the reference, where
framing is always Java even over the native block codec:
lz4/Lz4FrameCompression.java:48-60). Behavioral parity targets:
- compress: 7-byte header (magic, FLG=version|block-independence, BD=4MB,
  header checksum), per-4MB-block compress-or-store decision, end mark
  (Lz4FrameCompression.java:86-131).
- decompress: multi-frame loop, skippable frames, linked-block/dictionary
  rejection, reserved-bit and header/block/content checksum validation,
  content-size check (Lz4FrameCompression.java:155-317).
"""

from __future__ import annotations

import numpy as np

from ..errors import MalformedInputException
from ..host.lz4 import max_compressed_length as block_max_compressed_length
from ..xxhash import xxh32

MAGIC = 0x184D2204
SKIPPABLE_BASE = 0x184D2A50
SKIPPABLE_MASK = 0xFFFFFFF0

FLG_VERSION = 0b0100_0000
FLG_BLOCK_INDEPENDENCE = 0b0010_0000
FLG_BLOCK_CHECKSUM = 0b0001_0000
FLG_CONTENT_SIZE = 0b0000_1000
FLG_CONTENT_CHECKSUM = 0b0000_0100
FLG_RESERVED = 0b0000_0010
FLG_DICT_ID = 0b0000_0001

BD_RESERVED_MASK = 0b1000_1111

UNCOMPRESSED_FLAG = 0x80000000
END_MARK = 0

BLOCK_SIZES = {4: 64 * 1024, 5: 256 * 1024, 6: 1024 * 1024, 7: 4 * 1024 * 1024}
DEFAULT_BLOCK_MAX_ID = 7  # 4MB, like the reference


def block_maximum_size(bd_id: int) -> int:
    if bd_id not in BLOCK_SIZES:
        raise MalformedInputException(0, f"invalid block maximum size id: {bd_id}")
    return BLOCK_SIZES[bd_id]


def _u32le(src: np.ndarray, i: int) -> int:
    if i + 4 > src.size:
        raise MalformedInputException(i, "truncated frame")
    return int(src[i]) | int(src[i + 1]) << 8 | int(src[i + 2]) << 16 | int(src[i + 3]) << 24


def _put_u32le(dst: np.ndarray, i: int, v: int) -> None:
    dst[i] = v & 0xFF
    dst[i + 1] = (v >> 8) & 0xFF
    dst[i + 2] = (v >> 16) & 0xFF
    dst[i + 3] = (v >> 24) & 0xFF


def max_compressed_length(n: int, block_max_id: int = DEFAULT_BLOCK_MAX_ID,
                          block_checksums: bool = False,
                          content_checksum: bool = False,
                          content_size: bool = False) -> int:
    bs = block_maximum_size(block_max_id)
    n_blocks = max(1, (n + bs - 1) // bs)
    per_block = 4 + (4 if block_checksums else 0)
    header = 7 + (8 if content_size else 0)
    trailer = 4 + (4 if content_checksum else 0)  # end mark + checksum
    # worst case every block stored uncompressed
    return header + n_blocks * per_block + n + trailer


def compress(block_compress_into, src: np.ndarray, dst: np.ndarray,
             block_max_id: int = DEFAULT_BLOCK_MAX_ID,
             block_checksums: bool = False,
             content_checksum: bool = False,
             content_size: bool = False) -> int:
    """Write a single LZ4 frame. ``block_compress_into(src, dst) -> int`` is
    the injected block codec."""
    n = int(src.size)
    bs = block_maximum_size(block_max_id)
    flg = FLG_VERSION | FLG_BLOCK_INDEPENDENCE
    if block_checksums:
        flg |= FLG_BLOCK_CHECKSUM
    if content_checksum:
        flg |= FLG_CONTENT_CHECKSUM
    if content_size:
        flg |= FLG_CONTENT_SIZE
    bd = block_max_id << 4
    op = 0
    _put_u32le(dst, op, MAGIC)
    op += 4
    header_start = op
    dst[op] = flg
    dst[op + 1] = bd
    op += 2
    if content_size:
        v = n
        for k in range(8):
            dst[op + k] = (v >> (8 * k)) & 0xFF
        op += 8
    hc = (xxh32(dst[header_start:op]) >> 8) & 0xFF
    dst[op] = hc
    op += 1
    scratch = np.empty(block_max_compressed_length(min(bs, n)), dtype=np.uint8) if n else None
    for start in range(0, n, bs):
        chunk = src[start : min(start + bs, n)]
        size_pos = op
        op += 4
        written = block_compress_into(chunk, scratch)
        if written >= chunk.size:
            # incompressible: store raw (reference: Lz4FrameCompression.java:109-128)
            dst[op : op + chunk.size] = chunk
            _put_u32le(dst, size_pos, chunk.size | UNCOMPRESSED_FLAG)
            op += chunk.size
            stored = chunk.size
        else:
            dst[op : op + written] = scratch[:written]
            _put_u32le(dst, size_pos, written)
            op += written
            stored = written
        if block_checksums:
            _put_u32le(dst, op, xxh32(dst[op - stored : op]))
            op += 4
    _put_u32le(dst, op, END_MARK)
    op += 4
    if content_checksum:
        _put_u32le(dst, op, xxh32(src))
        op += 4
    return op


def decompress(block_decompress_into, src: np.ndarray, dst: np.ndarray) -> int:
    """Decode one or more concatenated frames (+ skippable frames)."""
    n = int(src.size)
    ip = 0
    op = 0
    saw_frame = False
    while ip < n:
        magic = _u32le(src, ip)
        ip += 4
        if (magic & SKIPPABLE_MASK) == SKIPPABLE_BASE:
            skip = _u32le(src, ip)
            ip += 4 + skip
            if ip > n:
                raise MalformedInputException(ip, "truncated skippable frame")
            continue
        if magic != MAGIC:
            raise MalformedInputException(ip - 4, f"invalid magic: 0x{magic:08x}")
        saw_frame = True
        header_start = ip
        if ip + 2 > n:
            raise MalformedInputException(ip, "truncated frame header")
        flg = int(src[ip])
        bd = int(src[ip + 1])
        ip += 2
        if (flg & 0b1100_0000) != FLG_VERSION:
            raise MalformedInputException(header_start, "unsupported frame version")
        if flg & FLG_RESERVED:
            raise MalformedInputException(header_start, "reserved FLG bit set")
        if bd & BD_RESERVED_MASK:
            raise MalformedInputException(header_start + 1, "reserved BD bits set")
        if not flg & FLG_BLOCK_INDEPENDENCE:
            raise MalformedInputException(header_start, "linked blocks are not supported")
        if flg & FLG_DICT_ID:
            raise MalformedInputException(header_start, "dictionaries are not supported")
        bs = block_maximum_size((bd >> 4) & 0x7)
        declared_size = -1
        if flg & FLG_CONTENT_SIZE:
            if ip + 8 > n:
                raise MalformedInputException(ip, "truncated content size")
            declared_size = 0
            for k in range(8):
                declared_size |= int(src[ip + k]) << (8 * k)
            ip += 8
        if ip >= n:
            raise MalformedInputException(ip, "truncated header checksum")
        expected_hc = (xxh32(src[header_start:ip]) >> 8) & 0xFF
        if int(src[ip]) != expected_hc:
            raise MalformedInputException(ip, "header checksum mismatch")
        ip += 1
        frame_out_start = op
        while True:
            block_header = _u32le(src, ip)
            ip += 4
            if block_header == END_MARK:
                break
            stored_size = block_header & ~UNCOMPRESSED_FLAG
            is_uncompressed = bool(block_header & UNCOMPRESSED_FLAG)
            if stored_size > bs:
                raise MalformedInputException(ip - 4, "block larger than block maximum size")
            if ip + stored_size > n:
                raise MalformedInputException(ip, "truncated block")
            block = src[ip : ip + stored_size]
            ip += stored_size
            if flg & FLG_BLOCK_CHECKSUM:
                expected = _u32le(src, ip)
                ip += 4
                if xxh32(block) != expected:
                    raise MalformedInputException(ip - 4, "block checksum mismatch")
            if is_uncompressed:
                if op + stored_size > dst.size:
                    raise MalformedInputException(ip, "output buffer too small")
                dst[op : op + stored_size] = block
                op += stored_size
            else:
                op += block_decompress_into(block, dst[op:])
        if flg & FLG_CONTENT_CHECKSUM:
            expected = _u32le(src, ip)
            ip += 4
            if xxh32(dst[frame_out_start:op]) != expected:
                raise MalformedInputException(ip - 4, "content checksum mismatch")
        if declared_size >= 0 and op - frame_out_start != declared_size:
            raise MalformedInputException(ip, "content size mismatch")
    if not saw_frame:
        raise MalformedInputException(0, "no LZ4 frame found")
    return op
