"""Host-side planner for the zstd device decode.

The reference of the C++ planner that ``ops/zstd_decode.py`` runs
(``decode_plan.cc``), which gives the same plan as ``zstd_decode.pack``
lays this one out, and the same errors.

The port's copy of ``aircompressor_tpu.zstd.device_prep``: the same plan,
field for field, with one addition (``plan_batch(..., item_errors=True)``).
It holds the port's one copy of the frame-header and sequence-table readers
of the JAX package's host decoder; the port's host decoder
(``zstd.frame_dec``) takes them from here.

Only headers and table descriptions are parsed here; the entropy-coded
payloads stay in the one flat input buffer for the kernels
(``ops/zstd_decode.py``):

- frame and block headers, literals-section headers, Huffman table
  descriptions and FSE normalized counts are parsed with the host parsers
  of ``huffman.py`` and ``fse.py``;
- a Huffman table becomes canonical-walk parameters: the start of each
  weight's region of the table, the symbols of lower weight, and the
  symbol permutation in canonical order;
- an FSE table becomes one int32 per state (sym | nbits<<6 |
  newStateBase<<10);
- every bitstream is (byte base, initial ``remaining`` bit count), read
  backward over the original buffer as bits.BackwardBitReader reads it.

Literal and sequence slots are rounded up to 128 per stream, and each
frame's output slot to a multiple of 128, as in the JAX package's planner.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...errors import MalformedInputException
from . import constants as C
from . import fse, huffman

LANES = 128

# literal-piece kinds for the execute kernel's piecewise literal map
PIECE_HUFF = 0  # bytes come from the remapped (padded) literal buffer
PIECE_RAW = 1  # bytes come from the source buffer (raw literals / raw block)
PIECE_RLE = 2  # a repeated byte


def _align(n: int, m: int = LANES) -> int:
    return ((n + m - 1) // m) * m


@dataclass
class HuffStream:
    """One Huffman-coded literal stream (device kernel A unit of work)."""

    byte_lo: int  # absolute byte offset of the stream in the flat input
    rem_init: int  # payload bits (after the end-mark)
    nsym: int  # symbols to decode
    out_base: int  # 128-aligned slot in the padded rank/byte output
    table_log: int
    rank_start: np.ndarray  # (13,) table-space region starts per weight 1..12
    cum_syms: np.ndarray  # (12,) symbols with weight < w
    perm: np.ndarray  # (256,) canonical rank -> byte


@dataclass
class SeqStream:
    """One block's sequences section (device kernel C unit of work)."""

    byte_lo: int
    rem_init: int  # after the 3 initial state reads
    nseq: int
    out_base: int  # 128-aligned slot in the ll/ml/of output arrays
    ll_state: int
    of_state: int
    ml_state: int
    ll_log: int
    of_log: int
    ml_log: int
    ll_entries: np.ndarray  # (512,) packed
    of_entries: np.ndarray  # (256,) packed
    ml_entries: np.ndarray  # (512,) packed


@dataclass
class BlockPlan:
    n_seq: int
    seq_out_base: int  # where this block's (ll, ml, of) triples start (-1 if none)
    lit_total: int
    # piecewise literal source map: up to 4 pieces (stream sub-boundaries)
    piece_kind: list  # (4,) PIECE_*
    piece_src: list  # (4,) byte base in litpad (HUFF) / flat input (RAW) / byte value (RLE)
    piece_end: list  # (4,) literal-position (exclusive) where each piece ends


@dataclass
class FramePlan:
    out_base: int  # 128-aligned output slot
    content_size: int  # declared (-1 unknown)
    has_checksum: bool
    checksum: int
    blocks: list = field(default_factory=list)


@dataclass
class BatchPlan:
    src: np.ndarray  # flat u8 of all frames' bytes
    frames: list = field(default_factory=list)
    huff_streams: list = field(default_factory=list)
    seq_streams: list = field(default_factory=list)
    litpad_size: int = 0  # padded literal buffer (ranks/bytes) total slots
    seq_size: int = 0  # padded (ll, ml, of) total slots
    out_cap: int = 0  # per-frame output capacity


# ------------------------------------------- frame headers and sequence tables
# The header and table readers of the JAX package's host decoder
# (``zstd/frame_dec.py``); ``zstd.frame_dec`` imports them from here.

_PREDEFINED = {}


def _predefined(kind: str) -> fse.FseTable:
    if kind not in _PREDEFINED:
        norm, log = {
            "ll": (C.LL_DEFAULT_NORM, C.LL_DEFAULT_LOG),
            "ml": (C.ML_DEFAULT_NORM, C.ML_DEFAULT_LOG),
            "of": (C.OF_DEFAULT_NORM, C.OF_DEFAULT_LOG),
        }[kind]
        _PREDEFINED[kind] = fse.build_decode_table(norm, log)
    return _PREDEFINED[kind]


@dataclass
class FrameHeader:
    header_size: int
    window_size: int
    content_size: int  # -1 if unknown
    has_checksum: bool
    single_segment: bool
    dictionary_id: int


def _u24le(src: np.ndarray, i: int) -> int:
    return int(src[i]) | (int(src[i + 1]) << 8) | (int(src[i + 2]) << 16)


def _u32le(src: np.ndarray, i: int) -> int:
    return _u24le(src, i) | (int(src[i + 3]) << 24)


def read_frame_header(src: np.ndarray, ip: int) -> FrameHeader:
    """Parse a frame header at src[ip:] (after the magic).
    Reference: ZstdFrameDecompressor.readFrameHeader L860-940."""
    n = src.size
    if ip >= n:
        raise MalformedInputException(ip, "truncated frame header")
    fhd = int(src[ip])
    pos = ip + 1
    fcs_flag = fhd >> 6
    single_segment = bool(fhd & 0x20)
    if fhd & 0x08:
        raise MalformedInputException(ip, "reserved frame header bit set")
    has_checksum = bool(fhd & 0x04)
    dict_flag = fhd & 0x03

    window_size = -1
    if not single_segment:
        if pos >= n:
            raise MalformedInputException(pos, "truncated window descriptor")
        wd = int(src[pos])
        pos += 1
        exponent = wd >> 3
        mantissa = wd & 7
        base = 1 << (C.MIN_WINDOW_LOG + exponent)
        window_size = base + (base // 8) * mantissa

    dict_bytes = {0: 0, 1: 1, 2: 2, 3: 4}[dict_flag]
    dictionary_id = 0
    if dict_bytes:
        if pos + dict_bytes > n:
            raise MalformedInputException(pos, "truncated dictionary id")
        for k in range(dict_bytes):
            dictionary_id |= int(src[pos + k]) << (8 * k)
        pos += dict_bytes

    fcs_bytes = {0: 1 if single_segment else 0, 1: 2, 2: 4, 3: 8}[fcs_flag]
    content_size = -1
    if fcs_bytes:
        if pos + fcs_bytes > n:
            raise MalformedInputException(pos, "truncated content size")
        content_size = 0
        for k in range(fcs_bytes):
            content_size |= int(src[pos + k]) << (8 * k)
        if fcs_bytes == 2:
            content_size += 256
        pos += fcs_bytes

    if single_segment:
        window_size = content_size
    return FrameHeader(pos - ip, window_size, content_size, has_checksum,
                       single_segment, dictionary_id)


def _read_seq_table(src: np.ndarray, ip: int, hi: int, mode: int, kind: str,
                    max_symbol: int, max_log: int,
                    prev: fse.FseTable | None) -> tuple[fse.FseTable, int]:
    if mode == C.SEQ_PREDEFINED:
        return _predefined(kind), ip
    if mode == C.SEQ_RLE:
        if ip >= hi:
            raise MalformedInputException(ip, "truncated RLE sequence table")
        symbol = int(src[ip])
        if symbol > max_symbol:
            raise MalformedInputException(ip, "RLE sequence symbol out of range")
        return fse.build_rle_table(symbol), ip + 1
    if mode == C.SEQ_FSE:
        counts, table_log, consumed = fse.read_normalized_counts(
            src, ip, hi, max_symbol, max_log)
        return fse.build_decode_table(counts, table_log), ip + consumed
    # repeat
    if prev is None:
        raise MalformedInputException(ip, "repeat sequence table without a previous table")
    return prev, ip


# ------------------------------------------------------------------ the plan
def _pack_fse(table: fse.FseTable, cap: int) -> np.ndarray:
    """Pack (symbol, num_bits, new_state) as i32 sym | nb<<6 | ns<<10."""
    n = table.symbol.size
    out = np.zeros(cap, dtype=np.int32)
    out[:n] = (
        table.symbol.astype(np.int32)
        | (table.num_bits.astype(np.int32) << 6)
        | (table.new_state.astype(np.int32) << 10)
    )
    return out


def _walk_params(table: huffman.HuffmanTable):
    """Canonical-walk parameters from an expanded Huffman decode table.

    The table places each symbol once as a contiguous run of 2^(w-1) cells in
    weight-ascending order (huffman.build_table), so runs recover the
    canonical (weight asc, symbol asc) permutation and the per-weight region
    starts."""
    syms = table.symbols
    bits = table.num_bits
    log = table.table_log
    size = syms.size
    # run starts: cell 0 plus every symbol change
    change = np.nonzero(np.diff(syms) != 0)[0] + 1
    starts = np.concatenate([[0], change])
    run_w = log + 1 - bits[starts]  # weight of each run
    perm = np.zeros(256, dtype=np.int32)
    perm[: starts.size] = syms[starts]
    rank_start = np.zeros(13, dtype=np.int32)
    cum = np.zeros(12, dtype=np.int32)
    pos = 0
    run_i = 0
    for w in range(1, 13):
        rank_start[w] = pos
        cum[w - 1] = run_i
        while run_i < starts.size and run_w[run_i] == w:
            pos += 1 << (w - 1)
            run_i += 1
    if pos != size:
        raise MalformedInputException(0, "huffman table runs inconsistent")
    return rank_start, cum, perm


def _backward_init(src: np.ndarray, lo: int, hi: int) -> int:
    """Payload bits of a backward stream [lo, hi) (BackwardBitReader init)."""
    if hi <= lo or hi > src.size:
        raise MalformedInputException(lo, "empty or invalid bitstream")
    last = int(src[hi - 1])
    if last == 0:
        raise MalformedInputException(hi - 1, "bitstream end mark missing")
    return (hi - lo - 1) * 8 + (last.bit_length() - 1)


def _bits_read(src: np.ndarray, lo: int, rem: int, n: int) -> int:
    """Mirror BackwardBitReader.read on the flat buffer (host side)."""
    if n == 0:
        return 0
    if rem <= 0:
        return 0
    take = min(n, rem)
    lo_bit = rem - take
    b0 = lo * 8 + lo_bit
    word = 0
    for k in range((take + (b0 & 7) + 7) // 8 + 1):
        idx = (b0 >> 3) + k
        if 0 <= idx < src.size:
            word |= int(src[idx]) << (8 * k)
    v = (word >> (b0 & 7)) & ((1 << take) - 1)
    return v << (n - take)


class _Planner:
    def __init__(self, src: np.ndarray, out_cap: int):
        self.src = src
        self.out_cap = out_cap
        self.plan = BatchPlan(src=src, out_cap=out_cap)
        self.lit_cursor = 0
        self.seq_cursor = 0

    # ---------------------------------------------------------------- frames
    def add_frame(self, lo: int, hi: int, out_base: int) -> None:
        src = self.src
        if hi - lo < 4 or _u32le(src, lo) != C.MAGIC:
            raise MalformedInputException(lo, "invalid magic")
        ip = lo + 4
        header = read_frame_header(src, ip)
        if header.dictionary_id:
            raise MalformedInputException(ip, "dictionaries are not supported")
        if header.content_size > self.out_cap:
            raise MalformedInputException(ip, "frame exceeds batch out_cap")
        ip += header.header_size
        fp = FramePlan(
            out_base=out_base,
            content_size=header.content_size,
            has_checksum=header.has_checksum,
            checksum=0,
        )
        ctx_huff = None  # (table params) for treeless reuse
        ctx_tables: dict = {"ll": None, "of": None, "ml": None}
        while True:
            if ip + 3 > hi:
                raise MalformedInputException(ip, "truncated block header")
            bh = _u24le(src, ip)
            ip += 3
            last = bh & 1
            btype = (bh >> 1) & 3
            bsize = bh >> 3
            if btype == C.RAW_BLOCK:
                if ip + bsize > hi:
                    raise MalformedInputException(ip, "truncated raw block")
                fp.blocks.append(
                    BlockPlan(0, -1, bsize, [PIECE_RAW], [ip], [bsize])
                )
                ip += bsize
            elif btype == C.RLE_BLOCK:
                if ip >= hi or bsize > C.MAX_BLOCK_SIZE:
                    raise MalformedInputException(ip, "bad RLE block")
                fp.blocks.append(
                    BlockPlan(0, -1, bsize, [PIECE_RLE], [int(src[ip])], [bsize])
                )
                ip += 1
            elif btype == C.COMPRESSED_BLOCK:
                if bsize > C.MAX_BLOCK_SIZE or ip + bsize > hi:
                    raise MalformedInputException(ip, "bad compressed block")
                ctx_huff = self._add_compressed_block(
                    fp, ip, ip + bsize, ctx_huff, ctx_tables
                )
                ip += bsize
            else:
                raise MalformedInputException(ip, "reserved block type")
            if last:
                break
        if header.has_checksum:
            if ip + 4 > hi:
                raise MalformedInputException(ip, "truncated frame checksum")
            fp.checksum = _u32le(src, ip)
            ip += 4
        if ip != hi:
            raise MalformedInputException(ip, "trailing bytes after frame")
        self.plan.frames.append(fp)

    # ---------------------------------------------------------------- blocks
    def _add_compressed_block(self, fp, lo, hi, ctx_huff, ctx_tables):
        src = self.src
        pieces_kind: list = []
        pieces_src: list = []
        pieces_end: list = []
        lit_total, seq_lo, ctx_huff = self._plan_literals(
            src, lo, hi, pieces_kind, pieces_src, pieces_end, ctx_huff
        )
        n_seq, seq_out_base = self._plan_sequences(src, seq_lo, hi, ctx_tables)
        fp.blocks.append(
            BlockPlan(n_seq, seq_out_base, lit_total, pieces_kind, pieces_src, pieces_end)
        )
        return ctx_huff

    def _plan_literals(self, src, lo, hi, pk, ps, pe, ctx_huff):
        if lo >= hi:
            raise MalformedInputException(lo, "empty compressed block")
        b0 = int(src[lo])
        lit_type = b0 & 3
        size_format = (b0 >> 2) & 3

        if lit_type in (C.RAW_LITERALS, C.RLE_LITERALS):
            if size_format in (0, 2):
                regen, header = b0 >> 3, 1
            elif size_format == 1:
                if lo + 2 > hi:
                    raise MalformedInputException(lo, "truncated literals header")
                regen, header = (b0 >> 4) | (int(src[lo + 1]) << 4), 2
            else:
                if lo + 3 > hi:
                    raise MalformedInputException(lo, "truncated literals header")
                regen = (b0 >> 4) | (int(src[lo + 1]) << 4) | (int(src[lo + 2]) << 12)
                header = 3
            if lit_type == C.RAW_LITERALS:
                if lo + header + regen > hi:
                    raise MalformedInputException(lo, "raw literals exceed block")
                pk.append(PIECE_RAW)
                ps.append(lo + header)
                pe.append(regen)
                return regen, lo + header + regen, ctx_huff
            if lo + header >= hi:
                raise MalformedInputException(lo, "truncated RLE literal")
            pk.append(PIECE_RLE)
            ps.append(int(src[lo + header]))
            pe.append(regen)
            return regen, lo + header + 1, ctx_huff

        # compressed / treeless literals
        streams = 1 if size_format == 0 else 4
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
            params = (table.table_log,) + _walk_params(table)
            ctx_huff = params
            stream_lo = payload_lo + consumed
        else:
            if ctx_huff is None:
                raise MalformedInputException(
                    lo, "treeless literals without a previous Huffman table")
            params = ctx_huff
            stream_lo = payload_lo

        table_log, rank_start, cum, perm = params
        if streams == 1:
            bounds = [stream_lo, payload_hi]
            sizes = [regen]
        else:
            if payload_hi - stream_lo < 6 + 4:
                raise MalformedInputException(stream_lo, "4-stream literals too short")
            s1 = int(src[stream_lo]) | (int(src[stream_lo + 1]) << 8)
            s2 = int(src[stream_lo + 2]) | (int(src[stream_lo + 3]) << 8)
            s3 = int(src[stream_lo + 4]) | (int(src[stream_lo + 5]) << 8)
            p = stream_lo + 6
            bounds = [p, p + s1, p + s1 + s2, p + s1 + s2 + s3, payload_hi]
            if bounds[3] > payload_hi:
                raise MalformedInputException(stream_lo, "jump table exceeds input")
            seg = (regen + 3) // 4
            sizes = [seg, seg, seg, regen - 3 * seg]
            if sizes[3] < 0:
                raise MalformedInputException(stream_lo, "regenerated size too small")
        lit_pos = 0
        for k, nsym in enumerate(sizes):
            out_base = self.lit_cursor
            self.lit_cursor += _align(max(nsym, 1))
            rem = _backward_init(src, bounds[k], bounds[k + 1])
            self.plan.huff_streams.append(
                HuffStream(bounds[k], rem, nsym, out_base, table_log,
                           rank_start, cum, perm)
            )
            lit_pos += nsym
            pk.append(PIECE_HUFF)
            ps.append(out_base)
            pe.append(lit_pos)
        return regen, payload_hi, ctx_huff

    def _plan_sequences(self, src, lo, hi, ctx_tables):
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
            return 0, -1

        if ip >= hi:
            raise MalformedInputException(ip, "missing sequence compression modes")
        modes = int(src[ip])
        ip += 1
        if modes & 0b11:
            raise MalformedInputException(ip - 1, "reserved sequence mode bits set")

        ll_table, ip = _read_seq_table(src, ip, hi, (modes >> 6) & 3, "ll",
                                       C.MAX_LL_SYMBOL, C.LL_TABLE_LOG_MAX,
                                       ctx_tables["ll"])
        of_table, ip = _read_seq_table(src, ip, hi, (modes >> 4) & 3, "of",
                                       C.MAX_OF_SYMBOL, C.OF_TABLE_LOG_MAX,
                                       ctx_tables["of"])
        ml_table, ip = _read_seq_table(src, ip, hi, (modes >> 2) & 3, "ml",
                                       C.MAX_ML_SYMBOL, C.ML_TABLE_LOG_MAX,
                                       ctx_tables["ml"])
        ctx_tables["ll"], ctx_tables["of"], ctx_tables["ml"] = (
            ll_table, of_table, ml_table)

        rem = _backward_init(src, ip, hi)
        ll_state = _bits_read(src, ip, rem, ll_table.log2_size)
        rem -= ll_table.log2_size
        of_state = _bits_read(src, ip, rem, of_table.log2_size)
        rem -= of_table.log2_size
        ml_state = _bits_read(src, ip, rem, ml_table.log2_size)
        rem -= ml_table.log2_size
        if rem < 0:
            raise MalformedInputException(ip, "sequence bitstream too short")

        out_base = self.seq_cursor
        self.seq_cursor += _align(n_seq)
        self.plan.seq_streams.append(
            SeqStream(ip, rem, n_seq, out_base, ll_state, of_state, ml_state,
                      ll_table.log2_size, of_table.log2_size, ml_table.log2_size,
                      _pack_fse(ll_table, 512), _pack_fse(of_table, 256),
                      _pack_fse(ml_table, 512))
        )
        return n_seq, out_base


def plan_batch(items: list, out_cap: int, *, item_errors: bool = False) -> BatchPlan:
    """Build the device plan for a batch of single-frame zstd items.

    items: list of bytes-like, each exactly one zstd frame (the batch-API
    contract; multi-frame payloads stay on the host tier). out_cap: per-item
    decompressed capacity. A malformed item raises MalformedInputException
    at a byte offset in the flat input, or, with ``item_errors``, at the
    item's index in ``items``."""
    total = sum(len(b) for b in items)
    src = np.zeros(_align(max(total, 1)), dtype=np.uint8)
    pos = 0
    bounds = []
    for b in items:
        src[pos : pos + len(b)] = np.frombuffer(bytes(b), np.uint8)
        bounds.append((pos, pos + len(b)))
        pos += len(b)
    planner = _Planner(src, out_cap)
    for i, (lo, hi) in enumerate(bounds):
        try:
            planner.add_frame(lo, hi, i * _align(out_cap))
        except MalformedInputException as e:
            if not item_errors:
                raise
            raise MalformedInputException(i, e.reason) from e
    planner.plan.litpad_size = _align(max(planner.lit_cursor, LANES))
    planner.plan.seq_size = _align(max(planner.seq_cursor, LANES))
    return planner.plan
