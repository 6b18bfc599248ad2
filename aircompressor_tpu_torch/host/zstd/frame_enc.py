"""Zstd frame compression — reference tier.

The port's copy of ``aircompressor_tpu.zstd.frame_enc``.

Parity target (behavior): reference zstd/ZstdFrameCompressor.java:52-378 —
magic, frame header (content size, single-segment when the full input is the
window), ≤128KB blocks, literals section (raw/RLE/Huffman with raw fallback),
sequences section, minimum-gain raw-block fallback, xxhash64-low32 content
checksum.

Differences by design: match finding is the vectorized pass in block_enc
(single-segment window = whole input, so matches may reach across block
boundaries legitimately). Repeat-offset codes are emitted wherever an
offset equals a repeat offset (``_apply_repcodes``), with the repeat state
carried from block to block of a frame; an input of at most one block
(128 KB) gives a frame of one block, so only the repcodes within it.
"""

from __future__ import annotations

import numpy as np

from ..xxhash import xxh64 as _xxh64  # native-first dispatch
from . import block_enc, constants as C, huff_enc, seq_enc

MAGIC = C.MAGIC


def max_compressed_length(n: int) -> int:
    # the reference's exact bound (zstd/ZstdJavaCompressor.java:30-40, itself
    # ZSTD_compressBound): n + n/256, plus margin for small inputs. Frame
    # overhead (header<=14, checksum 4, 3B/block) fits inside the n>>8 /
    # small-input margin: the margin is >=64B at n=0 and >=512B per 128KB block.
    result = n + (n >> 8)
    if n < 128 * 1024:
        result += (128 * 1024 - n) >> 11
    return result


def _write_frame_header(out: bytearray, content_size: int) -> None:
    # single-segment: window == content; content-size descriptor by size
    if content_size < 256:
        fhd = (0 << 6) | 0x20  # FCS code 0 + single-segment flag
        out.append(fhd | 0x04)  # + checksum flag
        out.append(content_size)
    elif content_size < 65536 + 256:
        fhd = (1 << 6) | 0x20 | 0x04
        out.append(fhd)
        out += int(content_size - 256).to_bytes(2, "little")
    elif content_size < (1 << 32):
        fhd = (2 << 6) | 0x20 | 0x04
        out.append(fhd)
        out += int(content_size).to_bytes(4, "little")
    else:
        fhd = (3 << 6) | 0x20 | 0x04
        out.append(fhd)
        out += int(content_size).to_bytes(8, "little")


class EncoderContext:
    """Cross-block entropy-table reuse within one frame (reference:
    HuffmanCompressionContext double-buffer + repeat-mode sequence tables,
    committed two-phase like CompressionContext.commit — a raw-block
    fallback leaves the decoder's tables, and therefore this context,
    untouched)."""

    __slots__ = ("huff", "fields")

    def __init__(self):
        self.huff = None  # HuffmanCTable the decoder currently holds
        self.fields = None  # (f_ll, f_of, f_ml) the decoder currently holds


def _lit_header(btype: int, header_len: int, size_format: int, regen: int,
                comp: int) -> bytes:
    out = bytearray()
    b0 = btype | (size_format << 2) | ((regen & 0xF) << 4)
    if header_len == 3:
        out.append(b0)
        out.append(((regen >> 4) & 0x3F) | ((comp & 3) << 6))
        out.append(comp >> 2)
    elif header_len == 4:
        out.append(b0)
        out.append((regen >> 4) & 0xFF)
        out.append(((regen >> 12) & 3) | ((comp & 0x3F) << 2))
        out.append(comp >> 6)
    else:
        out.append(b0)
        out.append((regen >> 4) & 0xFF)
        out.append(((regen >> 12) & 0x3F) | ((comp & 3) << 6))
        out.append((comp >> 2) & 0xFF)
        out.append(comp >> 10)
    return bytes(out)


def _fit_format(single: bool, regen: int, comp: int):
    if single:
        return (3, 0) if (regen < 1 << 10 and comp < 1 << 10) else None
    if regen < 1 << 10 and comp < 1 << 10:
        return 3, 1
    if regen < 1 << 14 and comp < 1 << 14:
        return 4, 2
    if regen < 1 << 18 and comp < 1 << 18:
        return 5, 3
    return None


def _literals_section(literals: np.ndarray, ctx: EncoderContext | None = None):
    """Returns (section bytes, huffman table the decoder holds AFTER this
    section) — raw/RLE sections leave the previous table valid."""
    n = literals.size
    prev_ct = ctx.huff if ctx is not None else None
    raw = _raw_literals(literals)
    if n == 0:
        return raw, prev_ct
    first = int(literals[0])
    if np.all(literals == first):
        return _rle_literals(first, n), prev_ct
    if n < 32:
        return raw, prev_ct
    counts = np.bincount(literals, minlength=256)
    if np.count_nonzero(counts) < 2:
        return raw, prev_ct
    ct = huff_enc.build_ctable(counts)
    est_bits = huff_enc.estimate_compressed_bits(counts, ct)
    # treeless reuse is viable only when the previous table codes every
    # present symbol (reference: HuffmanCompressionTable.isValid)
    prev_covers = prev_ct is not None and bool(
        np.all(prev_ct.nbits[np.nonzero(counts)[0]] > 0))
    # quick reject: must beat raw with some margin — but literals that
    # compress poorly under a FRESH table may still win treeless under the
    # previous block's table (reference: estimateCompressedSize-based reuse
    # check), so the treeless estimate gets its own (table-free) margin
    if est_bits // 8 + 16 >= n and not (
            prev_covers and huff_enc.estimate_compressed_bits(
                counts, prev_ct) // 8 + 5 < n):
        return raw, prev_ct
    single = n < 256
    best = (len(raw), raw, prev_ct)

    def consider(btype, table, use_ct, after):
        nonlocal best
        try:
            payload = (huff_enc.encode_single_stream(literals, use_ct)
                       if single
                       else huff_enc.encode_4_streams(literals, use_ct))
        except ValueError:
            return
        comp = len(table) + len(payload)
        fmt = _fit_format(single, n, comp)
        if fmt is None:
            return
        sec = _lit_header(btype, fmt[0], fmt[1], n, comp) + table + payload
        if len(sec) < best[0]:
            best = (len(sec), sec, after)

    consider(C.COMPRESSED_LITERALS, huff_enc.write_table(ct), ct, ct)
    # treeless reuse of the previous table (reference: treeless literals +
    # HuffmanCompressionTable.estimateCompressedSize gain check)
    if prev_covers:
        consider(C.TREELESS_LITERALS, b"", prev_ct, prev_ct)
    return best[1], best[2]


def _raw_literals(literals: np.ndarray) -> bytes:
    n = literals.size
    out = bytearray()
    if n <= 31:
        out.append(C.RAW_LITERALS | (n << 3))
    elif n <= 4095:
        out.append(C.RAW_LITERALS | (1 << 2) | ((n & 0xF) << 4))
        out.append(n >> 4)
    else:
        out.append(C.RAW_LITERALS | (3 << 2) | ((n & 0xF) << 4))
        out.append((n >> 4) & 0xFF)
        out.append(n >> 12)
    return bytes(out) + literals.tobytes()


def _rle_literals(byte: int, n: int) -> bytes:
    out = bytearray()
    if n <= 31:
        out.append(C.RLE_LITERALS | (n << 3))
    elif n <= 4095:
        out.append(C.RLE_LITERALS | (1 << 2) | ((n & 0xF) << 4))
        out.append(n >> 4)
    else:
        out.append(C.RLE_LITERALS | (3 << 2) | ((n & 0xF) << 4))
        out.append((n >> 4) & 0xFF)
        out.append(n >> 12)
    out.append(byte)
    return bytes(out)


def _block_header(last: int, btype: int, size: int) -> bytes:
    v = last | (btype << 1) | (size << 3)
    return int(v).to_bytes(3, "little")


def compress(src: np.ndarray, dst: np.ndarray, level: int = 3) -> int:
    """Compress ``src`` into ``dst`` as one zstd frame; returns bytes written.

    ``level`` resolves through the own tier's level table
    (zstd/params.compute — reference: CompressionParameters.compute,
    zstd/CompressionParameters.java:256-299) to match-finder depth/width;
    the entropy pipeline is shared across levels (like the reference's
    single DFAST strategy, zstd/ZstdCompressor.java:25-43).
    """
    from .params import compute as _params

    n = src.size
    out = bytearray()
    out += int(MAGIC).to_bytes(4, "little")
    _write_frame_header(out, n)

    # sequence production over the WHOLE input (single-segment window),
    # then blocks are emitted per ≤128KB of regenerated output
    ll, offsets, ml, literals = block_enc.find_sequences(src, _params(level, n))
    blocks = _partition_blocks(src, ll, offsets, ml, literals)
    if not blocks:
        out += _block_header(1, C.RAW_BLOCK, 0)
    rep = list(C.REP_INIT)
    ctx = EncoderContext()
    for bi, blk in enumerate(blocks):
        last = 1 if bi == len(blocks) - 1 else 0
        out += _encode_block(last, *blk, rep, ctx)

    digest = _xxh64(src.tobytes())
    out += int(digest & 0xFFFFFFFF).to_bytes(4, "little")
    if dst.size < len(out):
        raise ValueError("output buffer too small")
    dst[: len(out)] = np.frombuffer(bytes(out), dtype=np.uint8)
    return len(out)


def compress_bytes(data: bytes, level: int = 3) -> bytes:
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(max_compressed_length(src.size), dtype=np.uint8)
    n = compress(src, dst, level)
    return dst[:n].tobytes()


MIN_WIRE_MATCH = 3  # smallest match length the sequence format can express


def _partition_blocks(src, ll, offsets, ml, literals):
    """Split the global sequence list into ≤128KB-of-output blocks.

    Returns a list of (block_bytes, ll, of_values, ml, literals) tuples.
    Sequences that straddle a boundary are split: the literal run can cut
    anywhere; a match is split into two matches at the same distance (valid
    because the window is the whole frame), each part ≥ MIN_WIRE_MATCH.
    """
    n = src.size
    if n == 0:
        return []
    max_block = C.MAX_BLOCK_SIZE
    # python lists: the per-sequence loop below is much faster on ints
    ll = ll.astype(np.int64).tolist()
    ml = ml.astype(np.int64).tolist()
    offsets = offsets.astype(np.int64).tolist()
    n_seq = len(ll)
    blocks = []
    seq_i = 0
    lit_pos = 0
    src_pos = 0
    while src_pos < n:
        room = min(max_block, n - src_pos)
        b_ll, b_of, b_ml = [], [], []
        lit_start = lit_pos  # literal consumption is contiguous per block
        b_size = 0
        while seq_i < n_seq and b_size < room:
            l, m = ll[seq_i], ml[seq_i]
            if b_size + l + m <= room:
                b_ll.append(l)
                b_of.append(offsets[seq_i] + 3)
                b_ml.append(m)
                lit_pos += l
                b_size += l + m
                seq_i += 1
                continue
            # split this sequence at the block boundary
            lit_take = min(l, room - b_size)
            if lit_take == room - b_size:
                # only (part of) the literal run fits
                lit_pos += lit_take
                ll[seq_i] -= lit_take
                b_size += lit_take
                break
            part = room - b_size - l
            if m - part < MIN_WIRE_MATCH:
                part = m - MIN_WIRE_MATCH
            if part < MIN_WIRE_MATCH:
                # cannot place any of the match here; flush literals and close
                lit_pos += lit_take
                ll[seq_i] -= lit_take
                b_size += lit_take
                break
            b_ll.append(l)
            b_of.append(offsets[seq_i] + 3)
            b_ml.append(part)
            lit_pos += l
            ll[seq_i] = 0
            ml[seq_i] = m - part
            b_size += l + part
            break
        if seq_i >= n_seq and b_size < room:
            take = room - b_size
            lit_pos += take
            b_size += take
        blk_lits = literals[lit_start:lit_pos]
        blocks.append(
            (
                src[src_pos : src_pos + b_size],
                np.array(b_ll, dtype=np.int64),
                np.array(b_of, dtype=np.int64),
                np.array(b_ml, dtype=np.int64),
                blk_lits,
            )
        )
        src_pos += b_size
        if b_size == 0:
            raise AssertionError("block made no progress")
    return blocks


def _apply_repcodes(ll, of_values, rep):
    """Convert wire offset values (real+3) to repcode form where possible,
    mirroring the decoder's repeated-offset semantics exactly (reference:
    ZstdFrameDecompressor L416-450; decoder mirror: the repcode step of
    ops/zstd_decode.fse_sequences_plain). Mutates ``rep`` (len-3 list) in place;
    returns the new offset-value array."""
    out = of_values.copy()
    of_list = of_values.tolist()
    ll_list = ll.tolist() if isinstance(ll, np.ndarray) else list(ll)
    for i in range(len(of_list)):
        o = of_list[i] - 3
        l = ll_list[i]
        if l > 0:
            if o == rep[0]:
                out[i] = 1
                continue
            if o == rep[1]:
                out[i] = 2
                rep[0], rep[1] = rep[1], rep[0]
                continue
            if o == rep[2]:
                out[i] = 3
                rep[0], rep[1], rep[2] = rep[2], rep[0], rep[1]
                continue
        else:
            if o == rep[1]:
                out[i] = 1
                rep[0], rep[1] = rep[1], rep[0]
                continue
            if o == rep[2]:
                out[i] = 2
                rep[0], rep[1], rep[2] = rep[2], rep[0], rep[1]
                continue
            if o == rep[0] - 1 and o > 0:
                out[i] = 3
                rep[0], rep[1], rep[2] = o, rep[0], rep[1]
                continue
        rep[0], rep[1], rep[2] = o, rep[0], rep[1]
    return out


def _encode_block(last: int, block: np.ndarray, ll, of_values, ml, literals,
                  rep, ctx: EncoderContext | None = None) -> bytes:
    n = block.size
    # RLE block shortcut (leaves entropy tables + reps untouched)
    if n > 0 and np.all(block == block[0]):
        return _block_header(last, C.RLE_BLOCK, n) + bytes([int(block[0])])
    rep_before = list(rep)
    of_wire = _apply_repcodes(ll, of_values, rep)
    lit_sec, huff_after = _literals_section(literals, ctx)
    seq_sec, fields_after = seq_enc.compress_sequences(
        ll, of_wire, ml, ctx.fields if ctx is not None else None)
    body = lit_sec + seq_sec
    # minimum-gain check → raw fallback (reference: ZstdFrameCompressor L245-254)
    if len(body) + 3 >= n + 3 or len(body) >= n:
        rep[:] = rep_before  # raw block leaves decoder rep state untouched
        return _block_header(last, C.RAW_BLOCK, n) + block.tobytes()
    if ctx is not None:  # two-phase commit on success only
        ctx.huff = huff_after
        ctx.fields = fields_after
    return _block_header(last, C.COMPRESSED_BLOCK, len(body)) + body
