"""Batched zstd DFAST match finding: the CUDA kernel and its plain PyTorch version.

Contract of ``aircompressor_tpu.ops.zstd_dfast_pallas.find_sequences_batch``,
output for output: ``data`` is a (B, L) uint8 batch with L <= 65536 and
``lengths`` the (B,) chunk lengths, clamped to [0, L]. The result is
``(ll, ml, of, nseq, last_lit, ok)``: (B, 16384) int32 literal lengths,
match lengths and real match distances, zero at and past each chunk's
``nseq``; (B,) int32 sequence counts and trailing literal counts; (B,) bool.
Bytes past a chunk's length do not change its result.

The matcher is the Pallas kernel's (zstd level 3, "dfast"): a long table
(8-byte hash) and a short one (5-byte hash), 2^14 entries each a chunk,

    hL = ((lo * 0x1E35A7BD) ^ (hi3 * 0x9E3779B9) ^ (b4 * 0x85EBCA77)) >> 18
    hS = ((lo * 0x9E3779B9) ^ (b4 * 0x1E35A7BD)) >> 18

in 32-bit arithmetic, where ``lo`` is the little-endian word of bytes 0-3
at ``ip``, ``b4`` byte 4 and ``hi3`` bytes 5-7. While ``ip < len - 12``,
each scan step reads both tables' entries at ``ip`` and then writes ``ip``
into both. A match is, in order of priority: the repeat offset at ``ip +
1`` (``rep0 > 0``, the position at or after 0, 4 bytes equal); the long
candidate; the short one (each below ``ip`` with 4 bytes equal to ``lo``;
there is no long probe at ``ip + 1``). A miss advances ``ip`` by ``1 +
((ip - anchor) >> 8)``. A match extends forward up to the chunk's length
(into the 12-byte tail margin too) and backward by at most ``min(mstart -
anchor, cand, 127)`` bytes, which moves its start back and keeps its
offset; then ``ip = anchor =`` its end. ``rep0`` starts at 1 and takes a
match's offset where it differs. A chunk shorter than 24 bytes has no
sequences. Positions inside a match never enter the tables.

``ok`` is False on more than 16384 sequences or a bad offset, neither of
which a chunk of 64 KB or less reaches, and where a chunk would take more
than ``STEP_CAP`` steps (a probe or a match each; a chunk takes fewer than
2 x 65536). The Pallas kernel shares one such cap among the 8 chunks of a
grid step and reports a chunk cut by it as ok; here each chunk has its own.

``with_steps=True`` adds a seventh result, (B,) int32: each chunk's steps
of the serial scan above, one for each probe and one for each match, as
the cap counts them (a chunk the cap cut has ``STEP_CAP``, or one more
where a match took it there). The count is
the port's own: the JAX kernel's ``meta`` counts the loop of a grid step of
8 chunks.

``find_sequences`` launches ``csrc/zstd_dfast.cu`` for a CUDA tensor and
uses ``find_sequences_plain`` only for a tensor on the CPU.
"""

from __future__ import annotations

import torch

from .. import _build
from ._rows import check_encode_args

HASH_LOG = 14
SEQ_CAP = 16384
TAIL_MARGIN = 12
MIN_MATCH = 4
STEP_CAP = 4 * 65536
M32 = 0xFFFFFFFF

# Kernel launches and the chunks they matched, for runs that must show the
# kernel was used. Only a launch of the CUDA kernel adds to them.
launches = 0
rows = 0


def find_sequences(data: torch.Tensor, lengths: torch.Tensor, with_steps: bool = False):
    """DFAST match finding for B chunks of at most 64 KB; see the module doc."""
    global launches, rows
    data, lengths = check_encode_args(data, lengths)
    if data.device.type == "cpu":
        return find_sequences_plain(data, lengths, with_steps)
    if data.device.type != "cuda":
        raise ValueError(f"no zstd DFAST matcher for device {data.device}")
    lib = _build.load()
    B, L = data.shape
    dev = data.device
    ll, ml, of = (torch.empty((B, SEQ_CAP), dtype=torch.int32, device=dev)
                  for _ in range(3))
    nseq = torch.empty(B, dtype=torch.int32, device=dev)
    last_lit = torch.empty(B, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    steps = torch.empty(B, dtype=torch.int32, device=dev) if with_steps else None
    if B:
        with torch.cuda.device(dev):
            err = lib.acx_zstd_dfast(
                data.data_ptr(), lengths.data_ptr(), B, L, ll.data_ptr(),
                ml.data_ptr(), of.data_ptr(), nseq.data_ptr(), last_lit.data_ptr(),
                ok.data_ptr(), steps.data_ptr() if with_steps else None,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"zstd DFAST kernel launch failed: CUDA error {err}")
        launches += 1
        rows += B
    result = (ll, ml, of, nseq, last_lit, ok)
    return result + (steps,) if with_steps else result


def _first(diff: torch.Tensor, width: int) -> torch.Tensor:
    """Index of each row's first True in ``diff``, ``width`` where none."""
    return torch.where(diff.any(1), diff.to(torch.uint8).argmax(1), width)


def find_sequences_plain(data: torch.Tensor, lengths: torch.Tensor,
                         with_steps: bool = False):
    """Plain PyTorch DFAST matcher with the kernel's results, for tests and
    checks.

    The 4-byte word and both hashes at every position are computed at once;
    then all B chunks step in lockstep with masks, one probe of every live
    chunk a step. A chunk whose probe hits extends its match forward and
    backward and records its sequence in that same step, over windows of
    its row.
    """
    data, lengths = check_encode_args(data, lengths)
    B, L = data.shape
    dev = data.device
    i64 = torch.int64
    n = lengths.to(i64)
    col = torch.arange(L, device=dev)[None, :]
    width = L + 8  # zero columns past the row: the 8-byte window at each position
    src = torch.zeros((B, width), dtype=i64, device=dev)
    src[:, :L] = torch.where(col < n[:, None], data.to(i64), 0)
    last_col = L - 1
    # At every position p < L: the word of bytes p..p+3, and both hashes.
    words = sum(src[:, k:k + L] << (8 * k) for k in range(4))
    b4 = src[:, 4:4 + L]
    hi3 = sum(src[:, 5 + k:5 + k + L] << (8 * k) for k in range(3))
    hashes = torch.stack([
        (((words * 0x1E35A7BD) ^ (hi3 * 0x9E3779B9) ^ (b4 * 0x85EBCA77)) & M32) >> 18,
        (((words * 0x9E3779B9) ^ (b4 * 0x1E35A7BD)) & M32) >> 18], 1)  # (B, 2, L)
    seqs = torch.zeros((3, B, SEQ_CAP + 1), dtype=i64, device=dev)  # + a sink
    tables = torch.full((B, 2, 1 << HASH_LOG), -1, dtype=i64, device=dev)  # long, short
    zero = torch.zeros(B, dtype=i64, device=dev)
    ip, anchor, nseq, steps = zero.clone(), zero.clone(), zero.clone(), zero.clone()
    rep0 = torch.ones(B, dtype=i64, device=dev)
    err = torch.zeros(B, dtype=torch.bool, device=dev)
    limit = n - TAIL_MARGIN
    live = n >= TAIL_MARGIN + MIN_MATCH + 8
    back_k = torch.arange(1, 128, device=dev)[None, :]
    while True:
        live = live & (ip < limit)
        err = err | (live & (steps >= STEP_CAP))
        live = live & ~err
        if not bool(live.any()):
            break
        steps = steps + live.to(i64)
        at = ip.clamp(max=last_col)[:, None, None].expand(B, 2, 1)
        h = hashes.gather(2, at)
        cands = tables.gather(2, h)[:, :, 0]  # (B, 2): the long and short entries
        tables.scatter_(2, h, torch.where(live[:, None], ip[:, None], cands)[:, :, None])
        cand_l, cand_s = cands[:, 0], cands[:, 1]

        ip1 = ip + 1
        rep_pos = ip1 - rep0
        w = words.gather(1, torch.stack([ip, ip1, rep_pos, cand_l, cand_s], 1).clamp(0, last_col))
        lo = w[:, 0]
        hit_rep = (rep0 > 0) & (rep_pos >= 0) & (w[:, 2] == w[:, 1])
        hit_l = (cand_l >= 0) & (cand_l < ip) & (w[:, 3] == lo)
        hit_s = (cand_s >= 0) & (cand_s < ip) & (w[:, 4] == lo)
        hit = live & (hit_rep | hit_l | hit_s)
        miss = live & ~hit
        ip = torch.where(miss, ip + 1 + ((ip - anchor) >> 8), ip)
        if not bool(hit.any()):
            continue
        mstart = torch.where(hit_rep, ip1, ip)
        cand = torch.where(hit_rep, rep_pos, torch.where(hit_l, cand_l, cand_s))

        # Forward extension up to the chunk's length, in growing windows.
        mlen = torch.full((B,), MIN_MATCH, dtype=i64, device=dev)
        done = ~hit
        win = 64
        while not bool(done.all()):
            k = torch.arange(win, device=dev)[None, :]
            a = (mstart + mlen)[:, None] + k
            c = (cand + mlen)[:, None] + k
            diff = (a >= n[:, None]) | (src.gather(1, a.clamp(max=width - 1))
                                        != src.gather(1, c.clamp(0, width - 1)))
            run = _first(diff, win)
            mlen = torch.where(done, mlen, mlen + run)
            done = done | (run < win)
            win = min(2 * win, 65536)

        # Backward extension by at most min(mstart - anchor, cand, 127) bytes.
        room = torch.minimum(mstart - anchor, cand).clamp(0, 127)
        a = (mstart[:, None] - back_k).clamp(min=0)
        c = (cand[:, None] - back_k).clamp(min=0)
        diff = (back_k > room[:, None]) | (src.gather(1, a) != src.gather(1, c))
        back = torch.where(hit, _first(diff, 127), 0)

        f_start = mstart - back
        f_len = mlen + back
        f_ll = f_start - anchor
        moff = mstart - cand
        slot = torch.where(hit, nseq.clamp(max=SEQ_CAP), SEQ_CAP)[None, :, None]
        seqs.scatter_(2, slot.expand(3, B, 1),
                      torch.stack([f_ll, f_len, moff])[:, :, None])
        nseq = nseq + hit.to(i64)
        rep0 = torch.where(hit, moff, rep0)
        ip = torch.where(hit, f_start + f_len, ip)
        anchor = torch.where(hit, f_start + f_len, anchor)
        steps = steps + hit.to(i64)
        err = err | (hit & ((nseq > SEQ_CAP) | (f_ll < 0) | (moff <= 0) | (moff > f_start)))

    seqs = seqs[:, :, :SEQ_CAP].to(torch.int32)
    result = (seqs[0], seqs[1], seqs[2], nseq.to(torch.int32),
              (n - anchor).to(torch.int32), ~err)
    return result + (steps.to(torch.int32),) if with_steps else result
