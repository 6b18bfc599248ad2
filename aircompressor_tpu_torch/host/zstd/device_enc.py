"""The host half of batched zstd compress: plans, packing and frame assembly.

The reference of the C++ planner that ``ops/zstd_encode.py`` runs
(``encode_plan.cc``), which gives the same plans, rows and frames.

The port's copy of the host functions of
``aircompressor_tpu.ops.zstd_encode_jax``: ``_verify_proposals``,
``_extract_literals``, ``_Plan``, ``_plan_chunk``, ``_pack_field`` and
``_assemble``, with the caps of its launch layout. ``pack_plans`` lays the
plans of a batch out as the emission kernel's arrays (the packing loop of
``zstd_encode_jax.compress_batch``, with the literals as uint8 and the
fields grouped), and ``_assemble`` takes the frame checksum as an argument:
the caller hashes the batch at once (on the card, by the xxh64 kernel)
where the JAX function hashes each chunk with the scalar XXH64; the frame
bytes are the same.

A plan is marked ``device`` when its one compressed block can take four
Huffman literal streams and an FSE sequences section that the emission
kernel writes; otherwise ``reason`` says why, and the chunk is written by
``frame_enc.compress_bytes`` (raw or RLE literals, raw blocks: the format's
own choices).
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from . import block_enc, frame_enc, huff_enc, seq_enc
from .params import compute as _params

LIT_CAP = 65536  # literal bytes per block
SEG_CAP = LIT_CAP // 4  # symbols per Huffman stream
LSTREAM_CAP = 24576  # bytes per packed Huffman stream (16384 * 11 bits + mark)
S_CAP = 8192  # sequences per block
SSTREAM_CAP = 98304  # bytes per packed sequences bitstream
NS_CAP = 512  # FSE next_state rows (table_log <= 9)
SYM_CAP = 64  # FSE symbols per field (LL 36, OF 32, ML 53)

# The emission kernel's sequence fields, in their order in ``seq``.
SEQ_FIELDS = ("llc", "mlc", "ofc", "llx", "mlx", "ofx", "llxb", "mlxb", "ofxb")


def _verify_proposals(data: np.ndarray, ll: np.ndarray, ml: np.ndarray,
                      of: np.ndarray, last: int, min_match: int) -> bool:
    """Full soundness check of matcher proposals against ``data``:
    structure (non-negative lit lens, match lens >= min_match, offsets in
    range, coverage == len) and content (data[j] == data[j - offset]
    across every match span — exact LZ77 incl. overlapping copies)."""
    if (ll < 0).any() or (ml < min_match).any() or (of <= 0).any():
        return False
    if int(ll.sum() + ml.sum()) + last != data.size:
        return False
    pos = np.cumsum(np.concatenate([[0], (ll + ml)[:-1]]))
    if (of > pos + ll).any():
        return False
    seg0 = np.cumsum(ml) - ml
    span = np.arange(int(ml.sum()), dtype=np.int64)
    dst = np.repeat(pos + ll, ml) + (span - np.repeat(seg0, ml))
    return bool(np.array_equal(data[dst], data[dst - np.repeat(of, ml)]))


class _Plan:
    __slots__ = ("data", "ll", "ofw", "ml", "literals", "ct", "fields",
                 "device", "reason")

    def __init__(self):
        self.device = False
        self.reason = ""


def _extract_literals(data: np.ndarray, ll: np.ndarray, ml: np.ndarray,
                      last_lit: int) -> np.ndarray:
    """Vectorized gather of the literal runs (+trailing) from ``data``
    given per-sequence (lit_len, match_len) — the ragged-ranges trick."""
    ll_full = np.concatenate([ll, [last_lit]]).astype(np.int64)
    seq_adv = np.concatenate([ll + ml, [last_lit]]).astype(np.int64)
    data_starts = np.concatenate([[0], np.cumsum(seq_adv[:-1])])
    lit_starts = np.concatenate([[0], np.cumsum(ll_full[:-1])])
    total = int(ll_full.sum())
    idx = np.arange(total, dtype=np.int64)
    delta = np.repeat(data_starts - lit_starts, ll_full)
    return data[idx + delta]


def _plan_chunk(data: bytes, level: int, pre=None) -> _Plan:
    """Host side of one chunk: matcher, tables, mode decisions. ``pre``
    carries the device matcher's (ll, offsets, ml, literals), skipping the
    host matcher."""
    p = _Plan()
    p.data = np.frombuffer(data, np.uint8)
    n = p.data.size
    if n == 0 or n > LIT_CAP:
        p.reason = "size"
        return p
    if pre is not None:
        ll, offsets, ml, literals = pre
    else:
        ll, offsets, ml, literals = block_enc.find_sequences(
            p.data, _params(level, n))
    if ll.size == 0 or ll.size > S_CAP:
        p.reason = "nseq"
        return p
    if literals.size < 256:
        p.reason = "small-literals"
        return p
    counts = np.bincount(literals, minlength=256)
    if np.count_nonzero(counts) < 2 or np.all(literals == literals[0]):
        p.reason = "literal-shape"
        return p
    ct = huff_enc.build_ctable(counts)
    est = huff_enc.estimate_compressed_bits(counts, ct)
    if est // 8 + 16 >= literals.size:
        p.reason = "incompressible-literals"
        return p
    # wire offsets (repcodes): fresh frame, one block
    rep = list(C.REP_INIT)
    ofw = frame_enc._apply_repcodes(ll, offsets + 3, rep)
    llc = seq_enc.ll_code(ll.astype(np.int64))
    mlc = seq_enc.ml_code(ml.astype(np.int64))
    ofc = seq_enc.of_code(ofw.astype(np.int64))
    f_ll = seq_enc._select_field(llc, C.MAX_LL_SYMBOL, C.LL_TABLE_LOG_MAX,
                                 C.LL_DEFAULT_NORM, C.LL_DEFAULT_LOG)
    f_of = seq_enc._select_field(ofc, C.MAX_OF_SYMBOL, C.OF_TABLE_LOG_MAX,
                                 C.OF_DEFAULT_NORM, C.OF_DEFAULT_LOG)
    f_ml = seq_enc._select_field(mlc, C.MAX_ML_SYMBOL, C.ML_TABLE_LOG_MAX,
                                 C.ML_DEFAULT_NORM, C.ML_DEFAULT_LOG)
    p.ll, p.ofw, p.ml, p.literals = ll, ofw, ml, literals
    p.ct, p.fields = ct, (f_ll, f_of, f_ml)
    p.device = True
    return p


def _pack_field(ct) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    dnb = np.zeros(SYM_CAP, np.int32)
    dfs = np.zeros(SYM_CAP, np.int32)
    ns = np.zeros(NS_CAP, np.int32)
    k = min(ct.delta_nb_bits.size, SYM_CAP)
    dnb[:k] = ct.delta_nb_bits[:k]
    dfs[:k] = ct.delta_find_state[:k]
    k = min(ct.next_state.size, NS_CAP)
    ns[:k] = ct.next_state[:k]
    return dnb, dfs, ns


def pack_plans(plans) -> dict:
    """The emission kernel's inputs for ``plans`` (each marked ``device``),
    one row a plan, as numpy arrays:

    - ``lit`` (B, LIT_CAP) uint8, the literals;
    - ``lit_seg`` (B, 4, 2) int32, each Huffman stream's [start, count);
    - ``huff`` (B, 2, 256) int32, the Huffman codes and their bit counts;
    - ``seq`` (B, 9, S_CAP) int32, the fields of ``SEQ_FIELDS``: the LL,
      ML and OF codes, their extra values and extra bit counts;
    - ``nseq`` (B,) int32;
    - ``fse_sym`` (B, 3, 2, SYM_CAP) int32, the LL, ML and OF tables'
      ``delta_nb_bits`` and ``delta_find_state``;
    - ``fse_ns`` (B, 3, NS_CAP) int32, their ``next_state``;
    - ``flush_bits`` (B, 3) int32, the ML, OF and LL table logs, in the
      order the final states are flushed.
    """
    B = len(plans)
    lit = np.zeros((B, LIT_CAP), np.uint8)
    lit_seg = np.zeros((B, 4, 2), np.int32)
    huff = np.zeros((B, 2, 256), np.int32)
    seq = np.zeros((B, len(SEQ_FIELDS), S_CAP), np.int32)
    nseq = np.zeros(B, np.int32)
    fse_sym = np.zeros((B, 3, 2, SYM_CAP), np.int32)
    fse_ns = np.zeros((B, 3, NS_CAP), np.int32)
    flush_bits = np.zeros((B, 3), np.int32)
    for r, p in enumerate(plans):
        lits = p.literals
        lit[r, : lits.size] = lits
        seg = (lits.size + 3) // 4
        for s in range(4):
            st = s * seg
            lit_seg[r, s] = (st, max(0, min(seg, lits.size - st)))
        huff[r] = p.ct.codes, p.ct.nbits
        m = p.ll.size
        nseq[r] = m
        llc = seq_enc.ll_code(p.ll.astype(np.int64))
        mlc = seq_enc.ml_code(p.ml.astype(np.int64))
        ofc = seq_enc.of_code(p.ofw.astype(np.int64))
        seq[r, :, :m] = (llc, mlc, ofc, p.ll - C.LL_BASE[llc],
                         p.ml - C.ML_BASE[mlc], p.ofw - (np.int64(1) << ofc),
                         C.LL_BITS[llc], C.ML_BITS[mlc], ofc)
        f_ll, f_of, f_ml = p.fields
        for k, f in enumerate((f_ll, f_ml, f_of)):
            dnb, dfs, ns = _pack_field(f.ctable)
            fse_sym[r, k] = dnb, dfs
            fse_ns[r, k] = ns
        flush_bits[r] = (f_ml.ctable.table_log, f_of.ctable.table_log,
                         f_ll.ctable.table_log)
    return dict(lit=lit, lit_seg=lit_seg, huff=huff, seq=seq, nseq=nseq,
                fse_sym=fse_sym, fse_ns=fse_ns, flush_bits=flush_bits)


def _assemble(p: _Plan, lit_by, lit_tot, seq_by, seq_tot, checksum: int) -> bytes:
    """Frame assembly from device stream bytes (host headers/tables), with
    ``checksum`` the chunk's XXH64. Returns b"" where the block would not
    gain."""
    n = p.data.size
    literals, ct = p.literals, p.ct
    f_ll, f_of, f_ml = p.fields

    parts = []
    lens = []
    for s in range(4):
        nbytes = (int(lit_tot[s]) + 1 + 7) >> 3
        parts.append(lit_by[s, :nbytes].tobytes())
        lens.append(nbytes)
    table = huff_enc.write_table(ct)
    jump = b"".join(ln.to_bytes(2, "little") for ln in lens[:3])
    payload = jump + b"".join(parts)
    comp = len(table) + len(payload)
    regen = literals.size
    if any(ln > 0xFFFF for ln in lens[:3]):
        return b""
    if regen < 1 << 10 and comp < 1 << 10:
        header_len, size_format = 3, 1
    elif regen < 1 << 14 and comp < 1 << 14:
        header_len, size_format = 4, 2
    elif regen < 1 << 18 and comp < 1 << 18:
        header_len, size_format = 5, 3
    else:
        return b""
    raw_len = regen + (1 if regen <= 31 else 2 if regen <= 4095 else 3)
    if header_len + comp >= raw_len:
        return b""
    hdr = bytearray()
    b0 = C.COMPRESSED_LITERALS | (size_format << 2) | ((regen & 0xF) << 4)
    if header_len == 3:
        hdr += bytes([b0, ((regen >> 4) & 0x3F) | ((comp & 3) << 6),
                      comp >> 2])
    elif header_len == 4:
        hdr += bytes([b0, (regen >> 4) & 0xFF,
                      ((regen >> 12) & 3) | ((comp & 0x3F) << 2), comp >> 6])
    else:
        hdr += bytes([b0, (regen >> 4) & 0xFF,
                      ((regen >> 12) & 0x3F) | ((comp & 3) << 6),
                      (comp >> 2) & 0xFF, comp >> 10])
    lit_sec = bytes(hdr) + table + payload

    seq_hdr = bytearray()
    seq_enc._write_count_header(seq_hdr, int(p.ll.size))
    seq_hdr.append((f_ll.mode << 6) | (f_of.mode << 4) | (f_ml.mode << 2))
    for f in (f_ll, f_of, f_ml):
        seq_hdr += f.desc
    nbytes = (int(seq_tot) + 1 + 7) >> 3
    seq_sec = bytes(seq_hdr) + seq_by[:nbytes].tobytes()

    body = lit_sec + seq_sec
    if len(body) >= n:  # min-gain raw fallback
        return b""
    out = bytearray()
    out += int(frame_enc.MAGIC).to_bytes(4, "little")
    frame_enc._write_frame_header(out, n)
    out += frame_enc._block_header(1, C.COMPRESSED_BLOCK, len(body))
    out += body
    out += int(checksum & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(out)
