"""Zstd LZ77 sequence production — reference tier (vectorized numpy).

The port's copy of ``aircompressor_tpu.zstd.block_enc``.

Role parity: reference zstd/DoubleFastBlockCompressor.java:28-180 (the level-3
match finder) + zstd/SequenceStore.java. The ALGORITHM is redesigned for
data-parallel hardware instead of the reference's pointer-chasing loop:

  1. hash a 5-byte window at EVERY position at once,
  2. candidate = nearest previous position with the same hash, found by one
     stable argsort over (hash) — adjacent entries in sort order with equal
     hash and ascending position give each position its immediate
     predecessor (no mutable hash table, no sequential dependency),
  3. match lengths for all candidates at once: 8-byte word compares extended
     round-by-round over the still-matching mask,
  4. one greedy left-to-right commit pass over accepted matches only
     (the only sequential part, O(#sequences) not O(n)).

The same 4-phase shape is what the Pallas tier implements on device; this
module is the oracle for it.

Output sequences use wire offset VALUES (real offset + 3; repcodes are
intentionally not emitted by this tier — format-valid, slightly larger).
"""

from __future__ import annotations

import numpy as np

HASH_LOG = 17
MIN_MATCH = 4
# keep a tail of literals so wild 8-byte reads stay in range
TAIL_MARGIN = 12
MAX_MATCH_CAP = 1 << 17

# _match_lengths long-match policy: survivors of LONG_ROUNDS 8-byte word
# rounds may resolve via a _PeriodBreaks closed form, ONE O(n) pass per
# distinct distance — taken only when ≥ CF_MIN survivors share the distance
# (amortizes the pass) and at most CF_BUDGET passes per call (bounds
# adversarial many-distinct-distance inputs).
LONG_ROUNDS = 8
CF_MIN = 1024  # measured: word rounds beat an O(n) pass below ~1K sharers
CF_BUDGET = 64


def _u64_windows(block: np.ndarray) -> np.ndarray:
    """w8[i] = little-endian u64 read at i, for i in [0, n-8]."""
    n = block.size
    a = block.astype(np.uint64)
    w = np.zeros(n - 7, dtype=np.uint64)
    for k in range(8):
        w |= a[k : n - 7 + k] << np.uint64(8 * k)
    return w


class _PeriodBreaks:
    """First position ≥ x where data[x] != data[x-d], for d in 1..8.

    Gives CLOSED-FORM match lengths for overlapping (dist ≤ 8) matches —
    the pathological case (long runs / tiny periods) that would otherwise
    cost O(run_length) extension rounds."""

    def __init__(self, block: np.ndarray):
        self._block = block
        self._cache: dict[int, np.ndarray] = {}
        self._idx = np.arange(block.size, dtype=np.int32)

    def get(self, d: int) -> np.ndarray:
        brk = self._cache.get(d)
        if brk is None:
            brk = self._compute(d)
            if d <= 8:  # only the small-distance path repeats across calls
                self._cache[d] = brk
        return brk

    def _compute(self, d: int) -> np.ndarray:
        block = self._block
        n = block.size
        brk = np.empty(n, dtype=np.int32)
        neq = block[d:] != block[:-d]
        b = np.where(neq, self._idx[d:], np.int32(n))
        # suffix minimum → first break at or after x
        brk[d:] = np.minimum.accumulate(b[::-1])[::-1]
        brk[:d] = brk[d] if n > d else n
        return brk


def _match_lengths(w8: np.ndarray, pos: np.ndarray, cand: np.ndarray, n: int,
                   breaks: "_PeriodBreaks",
                   hard_cap: np.ndarray | None = None) -> np.ndarray:
    """Vectorized common-prefix lengths: closed form for dist ≤ 8, 8-byte
    word extension rounds for the rest (total work ∝ Σ match length / 8).

    Shared by the zstd and LZO matchers (lzo/block_ref.py passes its own
    ``hard_cap`` for the LZO format's margin and 16KB length limit)."""
    mlen = np.zeros(pos.size, dtype=np.int64)
    dist = pos - cand
    if hard_cap is None:
        hard_cap = np.minimum(np.int64(n - 8) - pos, MAX_MATCH_CAP)
    else:
        hard_cap = np.minimum(hard_cap, np.int64(n - 8) - pos)

    small = dist <= 8
    if np.any(small):
        si = np.nonzero(small)[0]
        m = np.zeros(si.size, dtype=np.int64)
        for d in range(1, 9):
            dd = dist[si] == d
            if np.any(dd):
                m[dd] = breaks.get(d)[pos[si[dd]]] - pos[si[dd]]
        mlen[si] = np.minimum(np.maximum(m, 0), hard_cap[si])

    # the index set COMPACTS each round: per-round cost tracks the still-
    # growing candidates only.  Matches that survive LONG_ROUNDS word rounds
    # (≥ 8*LONG_ROUNDS bytes) MAY switch to the _PeriodBreaks closed form,
    # which is valid for ANY distance — but each distinct distance costs one
    # O(n) pass, so it only pays when ≥ CF_MIN survivors share the distance
    # (the pathological case: thousands of candidates inside one multi-KB
    # repetition).  Low-count distances keep word-extending: their total
    # work is Σ mlen/8 small-indexed ops, cheaper than an O(n) pass each.
    ai = np.nonzero(~small)[0]
    rounds = 0
    cf_left = CF_BUDGET
    while ai.size:
        if rounds >= LONG_ROUNDS and cf_left and ai.size >= CF_MIN:
            d_act = dist[ai]
            uniq, counts = np.unique(d_act, return_counts=True)
            heavy = uniq[counts >= CF_MIN]
            if heavy.size == 0:
                # survivor counts only shrink as matches finish, so no
                # distance can qualify later either — stop re-checking
                cf_left = 0
            else:
                order_u = np.argsort(-counts[counts >= CF_MIN])
                resolved = np.zeros(ai.size, dtype=bool)
                for u in order_u[:cf_left]:
                    d = int(heavy[u])
                    sel = d_act == d
                    idx = ai[sel]
                    full_len = breaks.get(d)[pos[idx]] - pos[idx]
                    mlen[idx] = np.minimum(
                        np.maximum(full_len, mlen[idx]), hard_cap[idx])
                    resolved |= sel
                cf_left -= min(heavy.size, cf_left)
                ai = ai[~resolved]
                if ai.size == 0:
                    break
        p = pos[ai] + mlen[ai]
        c = cand[ai] + mlen[ai]
        x = w8[np.minimum(p, n - 8)] ^ w8[np.minimum(c, n - 8)]
        full = (x == 0) & (mlen[ai] + 8 <= hard_cap[ai])
        mlen[ai[full]] += 8
        done = ai[~full]
        if done.size:
            xd = x[~full]
            add = np.zeros(done.size, dtype=np.int64)
            still = np.ones(done.size, dtype=bool)
            for k in range(8):
                byte_eq = ((xd >> np.uint64(8 * k)) & np.uint64(0xFF)) == 0
                still = still & byte_eq
                add += still.astype(np.int64)
            mlen[done] += np.minimum(add, np.maximum(hard_cap[done] - mlen[done], 0))
        ai = ai[full]
        rounds += 1
    return mlen


def find_sequences(block: np.ndarray, params=None, start: int = 0):
    """Returns (lit_lens, offsets, match_lens, literals) arrays.

    Concatenating per sequence [literals run, match] then trailing literals
    reproduces ``block[start:]``. offsets are REAL distances (not wire
    values). ``start`` marks the emission boundary for streaming: bytes
    below it are match CONTEXT only (the reference's slid window,
    BlockCompressionState.java:35-49) — no sequence starts before it, but
    matches may point into it.

    ``params`` (zstd/params.CompressionParameters) tunes the matcher: hash
    width, predecessor-chain depth per hash, and whether the long (8-byte)
    hash runs — the own tier's level axis (reference analogue:
    CompressionParameters.compute, zstd/CompressionParameters.java:256-299).
    """
    n = block.size
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64))
    if n < start + MIN_MATCH + TAIL_MARGIN + 8:
        return (*empty, block[start:].copy())
    if params is None:
        from .params import compute

        params = compute(3, n)
    hash_log = min(params.hash_log, 30)

    w8 = _u64_windows(block)
    limit = n - TAIL_MARGIN  # last position allowed to start a match

    # dfast-style two hash lengths (reference: DoubleFastBlockCompressor's
    # long/short tables); each hash contributes its depth-1..depth-k
    # predecessors — depth-d links fall out of the SAME stable argsort
    # (order[i] ↔ order[i-d] when d consecutive hash-equal flags hold)
    w5 = w8[:limit] & np.uint64(0xFFFFFFFFFF)
    hashes = [(w5 * np.uint64(0x9E3779B185EBCA87)) >> np.uint64(64 - hash_log)]
    depths = [params.depth]
    if params.use_long_hash:
        hashes.append(
            (w8[:limit] * np.uint64(0xCF1BBCDCB7A56463)) >> np.uint64(64 - hash_log))
        depths.append(max(1, params.depth // 2))
    cands = []
    for h, depth in zip(hashes, depths):
        # hash_log <= 30: uint32 keys take numpy's radix path (uint64 does
        # twice the passes) — ~2x faster stable argsort
        order = np.argsort(h.astype(np.uint32), kind="stable")
        same = h[order[1:]] == h[order[:-1]]
        win = same
        for d in range(1, depth + 1):
            prev_d = np.full(limit, -1, dtype=np.int64)
            prev_d[order[d:][win]] = order[:-d][win]
            cands.append(prev_d)
            if d < depth:
                win = win[1:] & same[: limit - 1 - d]

    breaks = _PeriodBreaks(block)
    best_len = np.zeros(limit, dtype=np.int64)
    best_cand = np.full(limit, -1, dtype=np.int64)
    for prev in cands:
        pos_c = np.nonzero(prev >= 0)[0]
        cand_c = prev[pos_c]
        m4 = (w8[pos_c] & np.uint64(0xFFFFFFFF)) == (w8[cand_c] & np.uint64(0xFFFFFFFF))
        pos_c, cand_c = pos_c[m4], cand_c[m4]
        if pos_c.size == 0:
            continue
        mlen_c = _match_lengths(w8, pos_c, cand_c, n, breaks)
        better = (mlen_c > best_len[pos_c]) | (
            (mlen_c == best_len[pos_c]) & (pos_c - cand_c < pos_c - best_cand[pos_c])
        )
        upd = pos_c[better]
        best_len[upd] = mlen_c[better]
        best_cand[upd] = cand_c[better]

    sel = best_len >= MIN_MATCH
    pos = np.nonzero(sel)[0]
    cand = best_cand[pos]
    mlen = best_len[pos]
    if pos.size == 0:
        return (*empty, block[start:].copy())

    # greedy left-to-right commit (python ints + bisect: the only sequential
    # pass, O(#matches log #matches))
    from bisect import bisect_left

    pos_l = pos.tolist()
    cand_l = cand.tolist()
    mlen_l = mlen.tolist()
    c_pos, c_off, c_ml = [], [], []
    k = len(pos_l)
    cur = start
    hard_end = limit + TAIL_MARGIN - 8
    i = 0
    while True:
        i = bisect_left(pos_l, cur, i)
        if i >= k:
            break
        p = pos_l[i]
        ml = mlen_l[i]
        if p + ml > hard_end:
            ml = hard_end - p
            if ml < MIN_MATCH:
                cur = p + 1
                continue
        c_pos.append(p)
        c_off.append(p - cand_l[i])
        c_ml.append(ml)
        cur = p + ml
    p_arr = np.array(c_pos, dtype=np.int64)
    ml_arr = np.array(c_ml, dtype=np.int64)
    of_arr = np.array(c_off, dtype=np.int64)
    # literal runs precede each match; extract all of them in one masked pass
    ends = p_arr + ml_arr
    lit_lens = p_arr.copy()
    if lit_lens.size:
        lit_lens[0] -= start
    lit_lens[1:] -= ends[:-1]
    inside = np.zeros(n + 1, dtype=np.int64)
    np.add.at(inside, p_arr, 1)
    np.add.at(inside, ends, -1)
    lit_mask = np.cumsum(inside[:n]) == 0
    literals = block[start:][lit_mask[start:]]
    return (lit_lens, of_arr, ml_arr, literals)
