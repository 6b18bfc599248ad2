"""Zstd sequences-section encoder (RFC 8878 §3.1.1.3.2).

The port's copy of ``aircompressor_tpu.zstd.seq_enc``.

Own implementation. Parity target (behavior only): reference
zstd/SequenceEncoder.java:66-297 — count header, per-field mode selection
(PREDEFINED / RLE / FSE_COMPRESSED), interleaved 3-state reverse-order FSE
encode with extra bits.

Bit order is the exact inverse of the decoder's (ops/zstd_decode.fse_sequences_plain):
reader order is [ll_init, of_init, ml_init], then per sequence
[of_extra, ml_extra, ll_extra] and (except after the last sequence)
transitions [llT, mlT, ofT] — so the writer appends extras of the LAST
sequence first, walks backward encoding (of, ml, ll) + appending extras,
then flushes ml, of, ll states in that order.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from . import fse_enc
from .bits import BackwardBitWriter, pack_backward

OF_BITS_OF = None  # offset extra bits == code itself


def ll_code(ll: np.ndarray) -> np.ndarray:
    return np.searchsorted(C.LL_BASE, ll, side="right") - 1


def ml_code(ml: np.ndarray) -> np.ndarray:
    return np.searchsorted(C.ML_BASE, ml, side="right") - 1


def of_code(of_value: np.ndarray) -> np.ndarray:
    """offset code = highest bit of the offset VALUE (rep-adjusted)."""
    v = np.asarray(of_value, dtype=np.int64)
    return (np.frexp(v.astype(np.float64))[1] - 1).astype(np.int64)


def _write_count_header(out: bytearray, n: int) -> None:
    if n < 128:
        out.append(n)
    elif n < 0x7F00:
        out.append(128 + (n >> 8))
        out.append(n & 0xFF)
    else:
        out.append(255)
        rest = n - 0x7F00
        out.append(rest & 0xFF)
        out.append((rest >> 8) & 0xFF)


def _field_cost_bits(counts: np.ndarray, norm: np.ndarray, log: int) -> float:
    """Approximate encoded bits for counts under a normalized distribution."""
    p = np.where(norm == -1, 0.5, norm.astype(np.float64))
    with np.errstate(divide="ignore"):
        bits = log - np.log2(np.maximum(p, 1e-9))
    sel = counts[: norm.size] > 0
    return float(np.sum(counts[: norm.size][sel] * bits[sel]))


class _Field:
    __slots__ = ("mode", "ctable", "rle_symbol", "desc", "norm", "log")

    def __init__(self, mode, ctable, rle_symbol=0, desc=b"", norm=None,
                 log=0):
        self.mode = mode
        self.ctable = ctable
        self.rle_symbol = rle_symbol
        self.desc = desc
        # normalized distribution + log kept for REPEAT-mode cost checks
        # by LATER blocks (reference estimateCompressedSize reuse heuristic)
        self.norm = norm
        self.log = log


def _select_field(codes: np.ndarray, max_symbol: int, max_log: int,
                  default_norm: np.ndarray, default_log: int,
                  prev: "_Field | None" = None) -> _Field:
    counts = np.bincount(codes, minlength=max_symbol + 1)
    present = np.nonzero(counts)[0]
    if present.size == 1 and prev is None:
        ct = fse_enc.build_ctable(
            _rle_norm(int(present[0]), max_symbol), 0
        )
        sym = int(present[0])
        return _Field(C.SEQ_RLE, ct, rle_symbol=sym, desc=bytes([sym]),
                      norm=_rle_norm(sym, max_symbol), log=0)
    total = int(counts.sum())
    cands = []
    # candidate: RLE (single present symbol)
    if present.size == 1:
        sym = int(present[0])
        cands.append((8.0, _Field(
            C.SEQ_RLE, fse_enc.build_ctable(_rle_norm(sym, max_symbol), 0),
            rle_symbol=sym, desc=bytes([sym]),
            norm=_rle_norm(sym, max_symbol), log=0)))
    else:
        # candidate: predefined (FIRST: ties keep the pre-reuse behavior
        # of preferring predefined over a serialized table)
        if int(present[-1]) < default_norm.size:
            cands.append((
                _field_cost_bits(counts, default_norm, default_log),
                _Field(C.SEQ_PREDEFINED, None,
                       norm=default_norm.astype(np.int64), log=default_log)))
        # candidate: FSE-compressed table
        log = fse_enc.optimal_table_log(max_log, total, int(present[-1]))
        norm = fse_enc.normalize_counts(
            counts[: int(present[-1]) + 1], log, total)
        desc = fse_enc.write_normalized_counts(norm, log)
        cands.append((_field_cost_bits(counts, norm, log) + 8 * len(desc),
                      _Field(C.SEQ_FSE, None, desc=desc, norm=norm, log=log)))
    # candidate: REPEAT the table the decoder currently holds (reference:
    # repeat-mode sequences tables, SequenceEncoder selectEncodingType)
    if (prev is not None and prev.norm is not None
            and int(present[-1]) < prev.norm.size
            and np.all(prev.norm[present] != 0)):
        cands.append((
            _field_cost_bits(counts, prev.norm, prev.log),
            _Field(C.SEQ_REPEAT, prev.ctable, norm=prev.norm,
                   log=prev.log)))
    best = min(cands, key=lambda t: t[0])[1]
    if best.ctable is None:
        best.ctable = fse_enc.build_ctable(
            best.norm.astype(np.int64), best.log)
    return best


def _rle_norm(symbol: int, max_symbol: int) -> np.ndarray:
    # single-state table: norm for log 0 — handled specially in build_ctable
    n = np.zeros(symbol + 1, dtype=np.int64)
    n[symbol] = 1
    return n


def compress_sequences(ll: np.ndarray, of_values: np.ndarray, ml: np.ndarray,
                       prev_fields=None):
    """Encode the sequences section. ``of_values`` are wire offset values
    (rep-adjusted: 1-3 = repcodes, else real_offset+3).

    ``prev_fields`` = (f_ll, f_of, f_ml) the decoder currently holds from an
    earlier block in the same frame — enables REPEAT mode (reference:
    cross-block table reuse, SequenceEncoder + CompressionContext.commit).
    Returns (bytes, used_fields) so the caller can two-phase-commit."""
    n = int(ll.size)
    out = bytearray()
    _write_count_header(out, n)
    if n == 0:
        return bytes(out), prev_fields

    llc = ll_code(ll.astype(np.int64))
    mlc = ml_code(ml.astype(np.int64))
    ofc = of_code(of_values.astype(np.int64))

    p_ll, p_of, p_ml = prev_fields or (None, None, None)
    f_ll = _select_field(llc, C.MAX_LL_SYMBOL, C.LL_TABLE_LOG_MAX,
                         C.LL_DEFAULT_NORM, C.LL_DEFAULT_LOG, p_ll)
    f_of = _select_field(ofc, C.MAX_OF_SYMBOL, C.OF_TABLE_LOG_MAX,
                         C.OF_DEFAULT_NORM, C.OF_DEFAULT_LOG, p_of)
    f_ml = _select_field(mlc, C.MAX_ML_SYMBOL, C.ML_TABLE_LOG_MAX,
                         C.ML_DEFAULT_NORM, C.ML_DEFAULT_LOG, p_ml)

    modes = (f_ll.mode << 6) | (f_of.mode << 4) | (f_ml.mode << 2)
    out.append(modes)
    for f in (f_ll, f_of, f_ml):
        out += f.desc

    # extra-bit payloads per sequence
    ll_extra = ll.astype(np.int64) - C.LL_BASE[llc]
    ll_xbits = C.LL_BITS[llc]
    ml_extra = ml.astype(np.int64) - C.ML_BASE[mlc]
    ml_xbits = C.ML_BITS[mlc]
    of_extra = of_values.astype(np.int64) - (np.int64(1) << ofc)
    of_xbits = ofc

    # Writer-order op stream (see module docstring):
    #   [ll_x, ml_x, of_x](last), then per i = n-2..0:
    #   [of_state, ml_state, ll_state, ll_x, ml_x, of_x](i),
    #   then flushes [ml, of, ll].
    # The FSE state walks are the only sequential part — run them as a tight
    # Python-int loop over pre-gathered per-sequence deltas, then assemble all
    # (value, nbits) ops into arrays and bit-pack vectorized (pack_backward).
    last = n - 1
    m = n - 1  # number of state-emission steps per field

    def _state_walk(codes, ct):
        """Init from codes[last], then encode codes[n-2..0]; returns
        (vals, bits) per step in walk order plus the final state."""
        dnb = ct.delta_nb_bits[codes].tolist()
        dfs = ct.delta_find_state[codes].tolist()
        ns = ct.next_state.tolist()
        s0 = int(codes[last])
        nb0 = (int(dnb[last]) + (1 << 15)) >> 16
        sub = ((nb0 << 16) - int(dnb[last])) >> nb0
        st = ns[sub + int(dfs[last])]
        vals = [0] * m
        bits = [0] * m
        for j in range(m):
            i = last - 1 - j
            nb = (st + dnb[i]) >> 16
            vals[j] = st
            bits[j] = nb
            st = ns[(st >> nb) + dfs[i]]
        return vals, bits, st

    of_v, of_b, of_fin = _state_walk(ofc, f_of.ctable)
    ml_v, ml_b, ml_fin = _state_walk(mlc, f_ml.ctable)
    ll_v, ll_b, ll_fin = _state_walk(llc, f_ll.ctable)

    n_ops = 3 + 6 * m + 3
    vals = np.zeros(n_ops, dtype=np.int64)
    bits = np.zeros(n_ops, dtype=np.int64)
    # last sequence's extras
    vals[0:3] = (ll_extra[last], ml_extra[last], of_extra[last])
    bits[0:3] = (ll_xbits[last], ml_xbits[last], of_xbits[last])
    if m:
        rev = np.arange(last - 1, -1, -1)
        body_v = vals[3 : 3 + 6 * m]
        body_b = bits[3 : 3 + 6 * m]
        body_v[0::6] = of_v
        body_b[0::6] = of_b
        body_v[1::6] = ml_v
        body_b[1::6] = ml_b
        body_v[2::6] = ll_v
        body_b[2::6] = ll_b
        body_v[3::6] = ll_extra[rev]
        body_b[3::6] = ll_xbits[rev]
        body_v[4::6] = ml_extra[rev]
        body_b[4::6] = ml_xbits[rev]
        body_v[5::6] = of_extra[rev]
        body_b[5::6] = of_xbits[rev]
    vals[-3:] = (ml_fin, of_fin, ll_fin)
    bits[-3:] = (
        f_ml.ctable.table_log,
        f_of.ctable.table_log,
        f_ll.ctable.table_log,
    )
    return bytes(out) + pack_backward(vals, bits), (f_ll, f_of, f_ml)
