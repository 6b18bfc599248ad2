"""Batched zstd decode: three CUDA kernels, their plain PyTorch versions, and
``decode_batch``, the counterpart of ``aircompressor_tpu.ops.zstd_jax.decode_batch``.

The host planner parses the frame, block and table headers of a batch and
lays its plan out as tensors, one launch of each kernel for the whole
batch, with no fixed geometry. ``plan`` runs the C++ planner
(``host/zstd/decode_plan.cc``, built with g++ by ``_build.build_host``);
``pack`` lays out the plan of the Python planner
(``host.zstd.device_prep.plan_batch``), which stays as its reference: the
two give the same tensors. The kernels:

- ``huffman_decode`` (``csrc/zstd_huffman.cu``): every Huffman literal
  stream into one literal buffer, and each stream's final bit count;
- ``fse_sequences`` (``csrc/zstd_fse.cu``): every sequences section into
  (literal length, match length, offset) triples, a frame's sections in
  block order with the repeat offsets carried across them, and each
  section's final bit count and error flag. A group of 8 lanes (four
  frames a warp) walks a frame over its tables staged in shared memory and
  a backward ring of the section's bytes;
- ``execute`` (``csrc/zstd_execute.cu``): each frame's blocks and sequences
  into its output row, with its length and ok flag. It takes a block's
  sequences in rounds of up to 32 and keeps each frame's recent output in a
  shared-memory window (``EXECUTE_WINDOWS``, two instantiations of one
  template): 32 KB up to ``EXECUTE_SMALL_BATCH`` frames, 4 KB above, so
  that 4096 frames fit the card in one wave. ``offset_reach`` (the farthest
  match offset it reads from its window) and ``offset_shares`` (the share
  of matches, and of their bytes, within a reach) describe that choice on
  real data.

``decode_plan`` runs the three and then validates as ``zstd_jax`` does: a
Huffman or sequences stream that did not end exactly on its first bit, a
sequences error, or an output length other than the declared content size
makes the frame not ok. Frame checksums go through the xxh64 kernel.

Differences from ``zstd_jax.decode_batch``, by design:

- there is no host fallback: every frame of the batch goes through the
  kernels, whose launch is sized from the plan;
- every MalformedInputException carries the item's index, also for a frame
  that fails planning (``zstd_jax`` raises those at a byte offset, ROADMAP
  F8);
- the repeat offsets carry across the blocks of a frame, as the format and
  the JAX package's host decoder have it (the Pallas kernel restarts them
  at every block, ROADMAP F7).

Each wrapper launches its kernel for CUDA tensors and runs its plain version
only for tensors on the CPU. The plain versions step through symbols and
sequences with tensors that run across all streams or frames at once, and
resolve output bytes by pointer doubling as ``lz4_decode.decode_plain``
does; they are slow by design.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..errors import MalformedInputException
from ..host.zstd import constants as C
from ..host.zstd import device_prep as dp
from . import xxhash

MAX_OUT = 65536
H_WORDS = 32  # a Huffman stream: byte_lo, rem, nsym, out_base, table_log, 3 x 0,
H_RANK_START = 8  # rank_start[1..12] at words 8..19,
H_CUM_SYMS = 20  # cum_syms[0..11] at words 20..31
S_WORDS = 8  # a sequences section: byte_lo, rem, nseq, out_base, ll, of, ml states,
S_LOGS = 7  # and its table logs: ll_log | of_log << 8 | ml_log << 16
S_TABLE = 1280  # its FSE entries: LL 512, OF 256, ML 512
B_WORDS = 16  # a block: n_seq, seq_base, lit_total, 0, kind[4], src[4], end[4]
SRC_PAD = 8  # zero bytes after the input: the kernels' 8-byte windows

EXECUTE_WINDOWS = (4096, 32768)  # the execute kernel's output windows, in bytes
EXECUTE_SMALL_BATCH = 792  # the most frames that take the 32 KB window (kSmallBatchFrames)

# Kernel launches, and the frames the execute kernel ran, for runs that must
# show the kernels were used. Only a launch of a CUDA kernel adds to them.
huffman_launches = 0
fse_launches = 0
execute_launches = 0
execute_frames = 0


def _cuda_call(name: str, tensor: torch.Tensor, *args) -> None:
    """Launch C entry ``name`` on ``tensor``'s device and current stream."""
    if tensor.device.type != "cuda":
        raise ValueError(f"no zstd {name} for device {tensor.device}")
    with torch.cuda.device(tensor.device):
        err = getattr(_build.load(), f"acx_zstd_{name}")(
            *args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"zstd {name} kernel launch failed: CUDA error {err}")


def _check(**specs) -> None:
    """Raise unless each (tensor, dtype, width) is contiguous, of its dtype,
    1-D where width is None and else 2-D with that many columns, and all
    lie on one device."""
    devices = {t.device for t, _, _ in specs.values()}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {devices}")
    for name, (t, dtype, width) in specs.items():
        shape = (t.shape[0], width) if width else t.shape[:1]
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                             f"{('N', width) if width else ('N',)}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _byte_at(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 src[idx] where idx is inside src, else 0."""
    n = src.numel()
    if n == 0:
        return torch.zeros_like(idx)
    inside = (idx >= 0) & (idx < n)
    return torch.where(inside, src[idx.clamp(0, n - 1)].to(torch.int64), 0)


def _le_word(src: torch.Tensor, at: torch.Tensor, nbytes: int) -> torch.Tensor:
    """int64 little-endian value of the nbytes bytes of src from each at
    (bytes outside src read as 0)."""
    k = torch.arange(nbytes, device=at.device)
    return (_byte_at(src, at[:, None] + k) << (8 * k)).sum(1)


# ---------------------------------------------------------------- kernel A
def huffman_decode(src: torch.Tensor, params: torch.Tensor, perm: torch.Tensor,
                   lit_size: int):
    """Decode every Huffman literal stream of a batch.

    ``src`` (N,) uint8 is the flat input, ``params`` (H, 32) int32 one row a
    stream (see H_WORDS), ``perm`` (H, 256) uint8 each stream's canonical
    permutation. Returns ``(lit, rem)``: (lit_size,) uint8 with stream h's
    nsym bytes from its out_base (the planner's slots are 128-aligned;
    every other byte 0), and (H,) int32 final bit counts, 0 for a stream
    consumed exactly, positive for one with bits left, negative for one
    read past its start. The kernel decodes a stream with a warp, by
    synchronised sub-ranges over a decode table in shared memory
    (``csrc/zstd_huffman.cu``)."""
    global huffman_launches
    _check(src=(src, torch.uint8, None), params=(params, torch.int32, H_WORDS),
           perm=(perm, torch.uint8, 256))
    if src.device.type == "cpu":
        return huffman_decode_plain(src, params, perm, lit_size)
    H = params.shape[0]
    lit = torch.zeros(lit_size, dtype=torch.uint8, device=src.device)
    rem = torch.empty(H, dtype=torch.int32, device=src.device)
    if H:
        _cuda_call("huffman", src, src.data_ptr(), src.numel(), params.data_ptr(),
                   perm.data_ptr(), H, lit.data_ptr(), rem.data_ptr())
        huffman_launches += 1
    return lit, rem


def huffman_decode_plain(src, params, perm, lit_size: int):
    """Plain PyTorch ``huffman_decode``: one symbol of every stream a step."""
    dev = src.device
    p = params.to(torch.int64)
    byte_lo, rem, nsym, out_base, log = (p[:, k] for k in range(5))
    rs = p[:, H_RANK_START:H_RANK_START + 12]  # weight w + 1 at column w
    cum = p[:, H_CUM_SYMS:H_CUM_SYMS + 12]
    weights = torch.arange(12, device=dev)
    lit = torch.zeros(lit_size, dtype=torch.uint8, device=dev)
    for i in range(int(nsym.max()) if len(nsym) else 0):
        # the top `log` bits, zero-padded below the stream's start
        take = torch.minimum(rem.clamp(min=0), log)
        lo = rem - take
        word = _le_word(src, byte_lo + (lo >> 3), 3)
        st = ((word >> (lo & 7)) & ((1 << take) - 1)) << (log - take)
        # canonical walk: the largest weight whose region starts at or below
        w = torch.where(st[:, None] >= rs, weights, -1).max(1).values
        wc = w.clamp(min=0)[:, None]
        found = w >= 0
        rank = torch.where(
            found, (cum.gather(1, wc) + ((st[:, None] - rs.gather(1, wc)) >> wc))[:, 0], 0)
        live = i < nsym
        lit[(out_base + i)[live]] = perm.gather(1, (rank & 255)[:, None])[live, 0]
        rem = torch.where(live & found, rem - (log - w), rem)
    return lit, rem.to(torch.int32)


# ---------------------------------------------------------------- kernel C

def fse_waves(n_frames: int, device=None) -> int:
    """Waves of blocks the FSE kernel runs on the card for ``n_frames``
    frames: its blocks (one warp, four frames) over the SMs times the blocks
    an SM holds."""
    per_sm = _build.load().acx_zstd_fse_blocks_per_sm()
    if per_sm <= 0:
        raise RuntimeError(f"zstd fse occupancy query failed: CUDA error {-per_sm}")
    sms = torch.cuda.get_device_properties(device or 0).multi_processor_count
    return -(-n_frames // (4 * per_sm * sms))


def fse_sequences(src: torch.Tensor, params: torch.Tensor, tabs: torch.Tensor,
                  frames: torch.Tensor, seq_slots: int):
    """Decode every sequences section of a batch, a frame's sections in order.

    ``params`` (S, 8) int32 one row a section (see S_WORDS, S_LOGS), ``tabs``
    (S, 1280) int32 its packed FSE entries (a table of log L uses its first
    2^L), ``frames`` (F, 2) int32 each frame's first section and count;
    every section holds at least one sequence. The repeat offsets start at
    (1, 4, 8) once per frame. Returns ``(seq3, rem, err)``: (seq_slots, 3)
    int32 (literal length, match length, offset) with section s's triples
    from its out_base, and (S,) int32 final bit counts and error flags."""
    global fse_launches
    _check(src=(src, torch.uint8, None), params=(params, torch.int32, S_WORDS),
           tabs=(tabs, torch.int32, S_TABLE), frames=(frames, torch.int32, 2))
    if src.device.type == "cpu":
        return fse_sequences_plain(src, params, tabs, frames, seq_slots)
    if tabs.data_ptr() % 16:
        raise ValueError("the zstd fse kernel stages tabs by 16-byte copies: align it")
    S, F = params.shape[0], frames.shape[0]
    seq3 = torch.zeros((seq_slots, 3), dtype=torch.int32, device=src.device)
    rem = torch.zeros(S, dtype=torch.int32, device=src.device)
    err = torch.zeros(S, dtype=torch.int32, device=src.device)
    if F:
        _cuda_call("fse", src, src.data_ptr(), src.numel(), params.data_ptr(),
                   tabs.data_ptr(), frames.data_ptr(), F,
                   seq3.data_ptr(), rem.data_ptr(), err.data_ptr())
        fse_launches += 1
    return seq3, rem, err


def _bits(src, byte_lo, pos, n):
    """Bits [pos, pos + n) of each stream (n <= 23), bits below the stream's
    start read as 0."""
    lo = pos.clamp(min=0)
    count = (pos + n - lo).clamp(min=0)
    word = _le_word(src, byte_lo + (lo >> 3), 4)
    return ((word >> (lo & 7)) & ((1 << count) - 1)) << (lo - pos)


def fse_sequences_plain(src, params, tabs, frames, seq_slots: int):
    """Plain PyTorch ``fse_sequences``: one sequence of every frame a step."""
    dev = src.device
    p = params.to(torch.int64)
    tab = tabs.to(torch.int64)
    first, count = frames.to(torch.int64).unbind(1)
    S, F = p.shape[0], first.shape[0]
    nseq = p[:, 2]
    if bool((nseq < 1).any()):
        raise ValueError("every sequences section must hold a sequence")
    seq3 = torch.zeros((seq_slots, 3), dtype=torch.int32, device=dev)
    rem_out = torch.zeros(S, dtype=torch.int32, device=dev)
    err_out = torch.zeros(S, dtype=torch.int32, device=dev)
    if S == 0 or F == 0:
        return seq3, rem_out, err_out
    csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), nseq.cumsum(0)])
    total = csum[first + count] - csum[first]

    def table(vals):  # indexed by a 6-bit code; codes past the table give 0
        return torch.tensor(vals.tolist() + [0] * (64 - len(vals)), device=dev)

    ll_base, ll_bits, ml_base, ml_bits = map(
        table, (C.LL_BASE, C.LL_BITS, C.ML_BASE, C.ML_BITS))
    zero = torch.zeros(F, dtype=torch.int64, device=dev)
    sec, i = first.clone(), zero.clone()
    rem, lls, ofs, mls, err = zero.clone(), zero.clone(), zero.clone(), zero.clone(), zero.clone()
    rep0, rep1, rep2 = zero + 1, zero + 4, zero + 8
    for t in range(int(total.max())):
        live = t < total
        s = sec.clamp(max=S - 1)
        ps = p[s]
        start = live & (i == 0)
        rem = torch.where(start, ps[:, 1], rem)
        lls = torch.where(start, ps[:, 4], lls)
        ofs = torch.where(start, ps[:, 5], ofs)
        mls = torch.where(start, ps[:, 6], mls)
        err = torch.where(start, 0, err)
        byte_lo = ps[:, 0]

        le = tab[s, lls & 511]
        oe = tab[s, 512 + (ofs & 255)]
        me = tab[s, 768 + (mls & 511)]
        llc, ofc, mlc = le & 63, oe & 63, me & 63
        err = err | (ofc > 23).long()
        ofc = ofc.clamp(max=23)
        pos = rem - ofc
        of_value = (1 << ofc) + _bits(src, byte_lo, pos, ofc)
        pos = pos - ml_bits[mlc]
        ml = ml_base[mlc] + _bits(src, byte_lo, pos, ml_bits[mlc])
        pos = pos - ll_bits[llc]
        ll = ll_base[llc] + _bits(src, byte_lo, pos, ll_bits[llc])

        direct = of_value > 3
        idx = of_value - 1 + (ll == 0).long()
        rsel = torch.where(idx == 0, rep0, torch.where(
            idx == 1, rep1, torch.where(idx == 2, rep2, rep0 - 1)))
        offset = torch.where(direct, of_value - 3, rsel)
        err = err | (~direct & (idx > 0) & (rsel <= 0)).long()
        keep = ~direct & (idx == 0)
        n_rep0 = torch.where(keep, rep0, offset)
        n_rep1 = torch.where(keep, rep1, rep0)
        n_rep2 = torch.where(keep | (~direct & (idx == 1)), rep2, rep1)

        last = i == nseq[s] - 1
        nbits = [(e >> 6) & 15 for e in (le, me, oe)]
        states = []
        for e, nb in zip((le, me, oe), nbits):  # order LL, ML, OF
            pos = pos - torch.where(last, 0, nb)
            states.append((e >> 10) + _bits(src, byte_lo, pos, torch.where(last, 0, nb)))
        err = err | (pos < 0).long()

        slot = (p[s, 3] + i)[live]
        seq3[slot] = torch.stack([ll, ml, offset], 1)[live].to(torch.int32)
        lls = torch.where(live & ~last, states[0], lls)
        mls = torch.where(live & ~last, states[1], mls)
        ofs = torch.where(live & ~last, states[2], ofs)
        rem = torch.where(live, pos, rem)
        rep0 = torch.where(live, n_rep0, rep0)
        rep1 = torch.where(live, n_rep1, rep1)
        rep2 = torch.where(live, n_rep2, rep2)
        done = live & last
        rem_out[s[done]] = rem[done].to(torch.int32)
        err_out[s[done]] = err[done].to(torch.int32)
        sec = torch.where(done, sec + 1, sec)
        i = torch.where(done, 0, torch.where(live, i + 1, i))
    return seq3, rem_out, err_out


# ---------------------------------------------------------------- kernel D
def execute(src: torch.Tensor, lit: torch.Tensor, seq3: torch.Tensor,
            frames: torch.Tensor, blocks: torch.Tensor, out_cap: int = MAX_OUT):
    """Execute every frame's blocks: literals through each block's pieces,
    then matches from the frame's output.

    ``lit`` (L,) uint8 is ``huffman_decode``'s output, ``seq3`` (slots, 3)
    int32 ``fse_sequences``', ``frames`` (F, 2) int32 each frame's first
    block and count, ``blocks`` (NB, 16) int32 one row a block (see
    B_WORDS). Returns ``(out, out_len, ok)``: (F, out_cap) uint8 with zeros
    past each length, (F,) int32 and (F,) bool; a frame that is not ok has
    out_len -1 and a row of zeros."""
    global execute_launches, execute_frames
    _check(src=(src, torch.uint8, None), lit=(lit, torch.uint8, None),
           seq3=(seq3, torch.int32, 3), frames=(frames, torch.int32, 2),
           blocks=(blocks, torch.int32, B_WORDS))
    if not 0 < out_cap <= MAX_OUT:
        raise ValueError(f"out_cap must lie in [1, {MAX_OUT}], got {out_cap}")
    if src.device.type == "cpu":
        return execute_plain(src, lit, seq3, frames, blocks, out_cap)
    F = frames.shape[0]
    out = torch.empty((F, out_cap), dtype=torch.uint8, device=src.device)
    out_len = torch.empty(F, dtype=torch.int32, device=src.device)
    ok = torch.empty(F, dtype=torch.bool, device=src.device)
    if F:
        _cuda_call("execute", src, src.data_ptr(), src.numel(), lit.data_ptr(),
                   lit.numel(), seq3.data_ptr(), frames.data_ptr(),
                   blocks.data_ptr(), F, out.data_ptr(), out_cap,
                   out_len.data_ptr(), ok.data_ptr())
        execute_launches += 1
        execute_frames += F
    return out, out_len, ok


def execute_round(window: int) -> int:
    """The most output bytes one round of sequences adds with a window of
    this size (kRound)."""
    return min(window // 4, 4096)


def offset_reach(window: int) -> int:
    """The farthest match offset the execute kernel reads from a window of
    this size; a farther match reads device memory."""
    return window - execute_round(window)


def offset_shares(seq3: torch.Tensor, frames: torch.Tensor, blocks: torch.Tensor,
                  reaches=tuple(offset_reach(w) for w in EXECUTE_WINDOWS)) -> dict:
    """For each reach, the share of the matches (ml > 0) of every frame's
    blocks whose offset is at most that reach, and the share of their
    bytes; with the counts behind them."""
    s = seq3.cpu().numpy().astype(np.int64)
    fr = frames.cpu().numpy().astype(np.int64)
    bl = blocks.cpu().numpy().astype(np.int64)
    rows = [b for first, n in fr for b in range(first, first + max(n, 0))]
    parts = [s[max(bl[b, 1], 0):max(bl[b, 1], 0) + max(bl[b, 0], 0)] for b in rows]
    t = np.concatenate(parts) if parts else np.zeros((0, 3), np.int64)
    ml, of = t[:, 1], t[:, 2]
    live = ml > 0
    n_matches, n_bytes = int(live.sum()), int(ml[live].sum())
    shares = {}
    for reach in reaches:
        near = live & (of <= reach)
        shares[reach] = {
            "matches": int(near.sum()) / n_matches if n_matches else 0.0,
            "bytes": int(ml[near].sum()) / n_bytes if n_bytes else 0.0}
    return {"matches": n_matches, "match_bytes": n_bytes, "within": shares}


def _segment_start(values: torch.Tensor, seg: torch.Tensor, seg_first: torch.Tensor):
    """Exclusive prefix sums of ``values`` that restart at each segment."""
    excl = values.cumsum(0) - values
    return excl - excl[seg_first[seg]]


def execute_plain(src, lit, seq3, frames, blocks, out_cap: int = MAX_OUT):
    """Plain PyTorch ``execute``: every literal run and match of every frame
    as one event table (a block's sequences, then its trailing literals),
    output offsets by prefix sums, each output byte's event by searchsorted,
    and match copies by pointer doubling."""
    dev = src.device
    i64 = torch.int64
    first, nblk = frames.to(i64).unbind(1)
    F = first.shape[0]
    nblk = nblk.clamp(min=0)
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
    # the frames' blocks in order, then their events
    blk_frame = torch.repeat_interleave(ar(F), nblk)
    blk_first = nblk.cumsum(0) - nblk
    d = blocks.to(i64)[first[blk_frame] + ar(len(blk_frame)) - blk_first[blk_frame]]
    n_seq = d[:, 0].clamp(min=0)
    n_ev = n_seq + 1
    ev_blk = torch.repeat_interleave(ar(len(d)), n_ev)
    ev_blk_first = n_ev.cumsum(0) - n_ev
    ev_i = ar(len(ev_blk)) - ev_blk_first[ev_blk]
    tail = ev_i == n_seq[ev_blk]
    if seq3.shape[0]:
        slot = (d[ev_blk, 1] + ev_i).clamp(0, seq3.shape[0] - 1)
        ll, ml, dist = seq3.to(i64)[slot].unbind(1)
    else:
        ll = ml = dist = torch.zeros(len(ev_blk), dtype=i64, device=dev)
    ll, ml, dist = (torch.where(tail, 0, x) for x in (ll, ml, dist))
    litpos = _segment_start(ll, ev_blk, ev_blk_first)
    lit_total = d[ev_blk, 2]
    bad = ~tail & ((ml < 0) | (ll < 0) | (litpos + ll > lit_total))
    run = torch.where(tail, lit_total - litpos, ll).clamp(min=0)
    ml = ml.clamp(min=0)
    bad |= (run > 0) & (litpos + run > d[ev_blk, 12:16].max(1).values)
    ev_frame = blk_frame[ev_blk]
    adv = run + ml
    op = _segment_start(adv, ev_frame, torch.searchsorted(ev_frame, ar(F)))
    bad |= (ml > 0) & ((dist <= 0) | (dist > op + run))
    total = torch.zeros(F, dtype=i64, device=dev).index_add_(0, ev_frame, adv)
    n_bad = torch.zeros(F, dtype=i64, device=dev).index_add_(0, ev_frame, bad.long())
    ok = (n_bad == 0) & (total <= out_cap)

    out = torch.zeros((F, out_cap), dtype=torch.uint8, device=dev)
    W = int(total[ok].max()) if bool(ok.any()) else 0
    if W:
        big = out_cap + 2  # ends clamped to out_cap + 1 keep their order
        key_end = ev_frame * big + (op + adv).clamp(max=out_cap + 1)
        j = ar(W)[None, :].expand(F, W)
        f = ar(F)[:, None].expand(F, W)
        e = torch.searchsorted(key_end, (f * big + j).reshape(-1), right=True)
        e = e.clamp(max=len(key_end) - 1).reshape(F, W)
        produced = (j < total[:, None]) & ok[:, None]
        r = j - op[e]
        in_lit = r < run[e]
        pos = litpos[e] + r
        ends = d[ev_blk[e], 12:16]
        k = (pos[..., None] < ends[..., :3]).long()
        k = torch.where(k.any(-1), k.argmax(-1), 3)
        prev = torch.where(k > 0, ends.gather(-1, (k - 1).clamp(min=0)[..., None])[..., 0], 0)
        kind = d[ev_blk[e]].gather(-1, (4 + k)[..., None])[..., 0]
        psrc = d[ev_blk[e]].gather(-1, (8 + k)[..., None])[..., 0]
        at = psrc + pos - prev
        val = torch.where(kind == dp.PIECE_HUFF, _byte_at(lit, at), torch.where(
            kind == dp.PIECE_RAW, _byte_at(src, at), psrc & 255))
        flat = f * W + j
        ptr = torch.where(in_lit | ~produced, flat, flat - dist[e]).clamp(0, F * W - 1)
        ptr = ptr.reshape(-1)
        for _ in range(W.bit_length()):
            ptr = ptr[ptr]
        val = val.reshape(-1)[ptr].reshape(F, W)
        out[:, :W] = torch.where(produced, val, 0).to(torch.uint8)
    out_len = torch.where(ok, total, -1).to(torch.int32)
    return out, out_len, ok


# ------------------------------------------------------------ the batch path
@dataclass
class Packed:
    """A batch plan as the kernels' tensors, on one device."""

    src: torch.Tensor  # (N + SRC_PAD,) uint8, the flat input
    h_params: torch.Tensor  # (H, H_WORDS) int32
    h_perm: torch.Tensor  # (H, 256) uint8
    s_params: torch.Tensor  # (S, S_WORDS) int32
    s_tabs: torch.Tensor  # (S, S_TABLE) int32
    s_frames: torch.Tensor  # (F, 2) int32: first section, count
    blocks: torch.Tensor  # (NB, B_WORDS) int32
    b_frames: torch.Tensor  # (F, 2) int32: first block, count
    h_frame: torch.Tensor  # (H,) int64: the frame of each Huffman stream
    s_frame: torch.Tensor  # (S,) int64: the frame of each section
    content_size: torch.Tensor  # (F,) int64, -1 where not declared
    checksum: torch.Tensor  # (F,) int64, -1 where the frame has none
    lit_size: int
    seq_slots: int
    out_cap: int


def _first_count(counts: list) -> np.ndarray:
    counts = np.asarray(counts, np.int64).reshape(-1)
    return np.stack([np.cumsum(counts) - counts, counts], 1).astype(np.int32)


def pack(plan: dp.BatchPlan, device) -> Packed:
    """Lay ``plan`` out as the kernels' tensors on ``device``."""
    hs, ss = plan.huff_streams, plan.seq_streams
    h_params = np.zeros((len(hs), H_WORDS), np.int32)
    if hs:
        h_params[:, :5] = [[h.byte_lo, h.rem_init, h.nsym, h.out_base, h.table_log]
                           for h in hs]
        h_params[:, H_RANK_START:H_RANK_START + 12] = np.stack(
            [h.rank_start[1:13] for h in hs])
        h_params[:, H_CUM_SYMS:H_CUM_SYMS + 12] = np.stack([h.cum_syms for h in hs])
    h_perm = np.stack([h.perm for h in hs]).astype(np.uint8) if hs else np.zeros(
        (0, 256), np.uint8)
    s_params = np.zeros((len(ss), S_WORDS), np.int32)
    s_tabs = np.zeros((len(ss), S_TABLE), np.int32)
    if ss:
        s_params[:] = [[s.byte_lo, s.rem_init, s.nseq, s.out_base, s.ll_state,
                        s.of_state, s.ml_state, s.ll_log | s.of_log << 8 | s.ml_log << 16]
                       for s in ss]
        s_tabs[:] = [np.concatenate([s.ll_entries, s.of_entries, s.ml_entries])
                     for s in ss]
    rows, h_frame, s_frame, h_counts, s_counts = [], [], [], [], []
    for f, fp in enumerate(plan.frames):
        n_huff = n_sec = 0
        for bp in fp.blocks:
            k = len(bp.piece_kind)
            rows.append([bp.n_seq, bp.seq_out_base, bp.lit_total, 0,
                         *bp.piece_kind, *[0] * (4 - k), *bp.piece_src, *[0] * (4 - k),
                         *bp.piece_end, *[0] * (4 - k)])
            n_huff += bp.piece_kind.count(dp.PIECE_HUFF)
            n_sec += bp.n_seq > 0
        h_frame += [f] * n_huff
        s_frame += [f] * n_sec
        h_counts.append(n_huff)
        s_counts.append(n_sec)
    frames = plan.frames
    src = np.zeros(plan.src.size + SRC_PAD, np.uint8)
    src[:plan.src.size] = plan.src

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return Packed(
        src=t(src), h_params=t(h_params), h_perm=t(h_perm), s_params=t(s_params),
        s_tabs=t(s_tabs), s_frames=t(_first_count(s_counts)),
        blocks=t(np.array(rows, np.int32).reshape(-1, B_WORDS)),
        b_frames=t(_first_count([len(fp.blocks) for fp in frames])),
        h_frame=t(h_frame, np.int64), s_frame=t(s_frame, np.int64),
        content_size=t([fp.content_size for fp in frames], np.int64),
        checksum=t([fp.checksum if fp.has_checksum else -1 for fp in frames], np.int64),
        lit_size=plan.litpad_size, seq_slots=plan.seq_size, out_cap=plan.out_cap)


def plan(items, out_cap: int, device) -> Packed:
    """Plan a batch of single-frame items with the C++ planner into the
    kernels' tensors on ``device``: ``pack(device_prep.plan_batch(items,
    out_cap, item_errors=True), device)``, tensor for tensor. Raises
    MalformedInputException with the first malformed item's index and the
    Python planner's reason."""
    lib = _build.load_host()
    bounds = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(b) for b in items], out=bounds[1:])
    total = int(bounds[-1])
    n_src = dp._align(max(total, 1))
    src = np.frombuffer(bytearray().join([*items, bytes(n_src + SRC_PAD - total)]), np.uint8)
    sizes = np.zeros(6, np.int64)
    err_item = np.zeros(1, np.int64)
    reason = ctypes.create_string_buffer(256)
    handle = lib.acx_zstd_decode_plan(src.ctypes.data, n_src, bounds.ctypes.data, len(items),
                                      out_cap, sizes.ctypes.data, err_item.ctypes.data,
                                      reason, len(reason))
    if not handle:
        if err_item[0] < 0:
            raise MemoryError(f"zstd decode planner: {reason.value.decode()}")
        raise MalformedInputException(int(err_item[0]), reason.value.decode())
    H, S, NB, F, lit_size, seq_slots = (int(v) for v in sizes)
    arrays = dict(
        h_params=np.zeros((H, H_WORDS), np.int32), h_perm=np.zeros((H, 256), np.uint8),
        s_params=np.zeros((S, S_WORDS), np.int32), s_tabs=np.zeros((S, S_TABLE), np.int32),
        s_frames=np.zeros((F, 2), np.int32), blocks=np.zeros((NB, B_WORDS), np.int32),
        b_frames=np.zeros((F, 2), np.int32), h_frame=np.zeros(H, np.int64),
        s_frame=np.zeros(S, np.int64), content_size=np.zeros(F, np.int64),
        checksum=np.zeros(F, np.int64))
    try:
        lib.acx_zstd_decode_plan_write(handle, *(a.ctypes.data for a in arrays.values()))
    finally:
        lib.acx_zstd_decode_plan_free(handle)
    device = torch.device(device)
    tensors = {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}
    return Packed(src=torch.from_numpy(src).to(device), **tensors, lit_size=lit_size,
                  seq_slots=seq_slots, out_cap=out_cap)


def decode_plan(pk: Packed, verify_checksums: bool = True) -> dict:
    """Run the three kernels on a packed batch and validate each frame.

    Returns a dict of tensors on the batch's device: ``out`` (F, out_cap)
    uint8, ``out_len`` (F,) int32, ``ok`` (F,) bool after the stream and
    content-size checks, ``checksum_ok`` (F,) bool (True where the frame has
    no checksum or it was not verified; only meaningful where ok),
    ``digest`` (F,) int64, each output's XXH64 (None when not verified), and
    the first two kernels' ``lit``, ``h_rem``, ``s_rem`` and ``s_err``."""
    lit, h_rem = huffman_decode(pk.src, pk.h_params, pk.h_perm, pk.lit_size)
    seq3, s_rem, s_err = fse_sequences(pk.src, pk.s_params, pk.s_tabs, pk.s_frames,
                                       pk.seq_slots)
    out, out_len, exec_ok = execute(pk.src, lit, seq3, pk.b_frames, pk.blocks,
                                    pk.out_cap)
    F = out.shape[0]
    bad = torch.zeros(F, dtype=torch.int64, device=out.device)
    bad.index_add_(0, pk.h_frame, (h_rem != 0).long())
    bad.index_add_(0, pk.s_frame, ((s_rem != 0) | (s_err != 0)).long())
    ok = exec_ok & (bad == 0) & (
        (pk.content_size < 0) | (out_len.long() == pk.content_size))
    checksum_ok, digest = torch.ones_like(ok), None
    if verify_checksums:
        digest = xxhash.xxh64(out, out_len.clamp(min=0))
        checksum_ok = (pk.checksum < 0) | ((digest & 0xFFFFFFFF) == pk.checksum)
    return dict(out=out, out_len=out_len, ok=ok, checksum_ok=checksum_ok,
                digest=digest, lit=lit, h_rem=h_rem, s_rem=s_rem, s_err=s_err)


def decode_batch(items, out_cap: int = MAX_OUT, verify_checksums: bool = True, *,
                 device="cuda") -> list[bytes]:
    """Decode a batch of single-frame zstd payloads on ``device``.

    Returns list[bytes]. Raises MalformedInputException with the index of
    the first malformed item: one that fails planning, one the kernels or
    the stream checks reject ("malformed zstd frame in device batch"), and
    then one whose checksum differs ("frame checksum mismatch (device
    decode)"). Raises ValueError for ``out_cap`` over 65536."""
    if out_cap > MAX_OUT:
        raise ValueError(f"device zstd decode caps frames at {MAX_OUT} bytes")
    if not items:
        return []
    res = decode_plan(plan(list(items), out_cap, device), verify_checksums)
    ok = res["ok"].cpu().numpy()
    bad = np.nonzero(~ok)[0]
    if bad.size:
        raise MalformedInputException(int(bad[0]), "malformed zstd frame in device batch")
    bad = np.nonzero(~res["checksum_ok"].cpu().numpy())[0]
    if bad.size:
        raise MalformedInputException(int(bad[0]), "frame checksum mismatch (device decode)")
    lens = res["out_len"].cpu().numpy()
    out = res["out"][:, :int(lens.max())].cpu().numpy()
    return [out[i, :n].tobytes() for i, n in enumerate(lens)]
