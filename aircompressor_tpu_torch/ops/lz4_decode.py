"""Batched LZ4 block decode: the CUDA kernel and its plain PyTorch version.

Contract of ``aircompressor_tpu.ops.lz4_pallas_w.decode``: ``comp`` is a
(B, cap) uint8 batch of zero-padded LZ4 blocks, ``comp_lens`` the (B,)
compressed lengths. The result is ``(out, out_lens, ok)``: (B, out_cap)
uint8 with zeros at and past each output length, (B,) int32 and (B,) bool.

The rules are the Pallas kernel's. Each sequence is a token (a 4-bit
literal length and a 4-bit match length less 4; a nibble of 15 is followed
by 255-extension bytes ended by the first byte that is not 0xFF), the
literals, a 2-byte little-endian offset and the match. A chunk is malformed
where its length is not in [1, cap], where a parse reads past its length,
where an offset is 0 or points before the output, or where a run would take
the output past 64 KB. ``ok`` requires the block to end right after a
literal run (the last sequence is literals only) and ``out_lens <=
out_cap``. A malformed chunk stops where the parse failed; its ``out_lens``
counts the bytes produced before that, the literals of the failing sequence
included when only its match part failed.

``with_steps=True`` adds a fourth result, (B,) int32: the iterations of
the kernel's sequence loop for each chunk, that is the sequences it parsed,
the failing one included; 0 for a chunk rejected before its first
sequence. The JAX kernel's ``steps`` count its TPU loop bodies over grid
steps of many chunks; that is TPU machinery, so the port counts its own
loop instead.

``decode`` launches ``csrc/lz4_decode.cu`` for a CUDA tensor and uses
``decode_plain`` only for a tensor on the CPU. The kernel keeps each
chunk's recent output in a shared-memory window (``WINDOWS``; two
instantiations of one template): 32 KB up to ``SMALL_BATCH`` chunks, 4 KB
above, so that 4096 chunks fit the card in one wave. ``step_bytes`` (the
most output bytes a step moves), ``copy_reach`` (the farthest match
distance the kernel reads from its window) and ``distance_shares`` (the
share of matches, and of their bytes, within a reach) describe that choice
on real data.
"""

from __future__ import annotations

import torch

from .. import _build
from ._rows import MAX_CHUNK as MAX_OUT, check_decode_args

# Kernel launches and the chunks they decoded, for runs that must show the
# kernel was used. Only a launch of the CUDA kernel adds to them.
launches = 0
rows = 0

WINDOWS = (4096, 32768)  # the kernel's output windows, in bytes
SMALL_BATCH = 792  # the most chunks that take the 32 KB window (kSmallBatchChunks)


def step_bytes(window: int) -> int:
    """The most output bytes one step of the kernel moves with a window of
    this size (kStep)."""
    return window // 16


def copy_reach(window: int) -> int:
    """The farthest match distance the kernel reads from a window of this
    size; a farther match reads device memory."""
    return window - step_bytes(window)


def decode(comp: torch.Tensor, comp_lens: torch.Tensor,
           out_cap: int = MAX_OUT, with_steps: bool = False):
    """Decode B LZ4 blocks of at most 64 KB each; see the module doc."""
    global launches, rows
    comp, comp_lens = check_decode_args(comp, comp_lens, out_cap)
    if comp.device.type == "cpu":
        return decode_plain(comp, comp_lens, out_cap, with_steps)
    if comp.device.type != "cuda":
        raise ValueError(f"no LZ4 decode for device {comp.device}")
    lib = _build.load()
    B, cap = comp.shape
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    out_lens = torch.empty(B, dtype=torch.int32, device=comp.device)
    ok = torch.empty(B, dtype=torch.bool, device=comp.device)
    steps = torch.empty(B, dtype=torch.int32, device=comp.device) if with_steps else None
    if B:
        with torch.cuda.device(comp.device):
            err = lib.acx_lz4_decode(
                comp.data_ptr(), comp_lens.data_ptr(), B, cap, out.data_ptr(),
                out_lens.data_ptr(), ok.data_ptr(), out_cap,
                steps.data_ptr() if with_steps else None,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lz4 decode kernel launch failed: CUDA error {err}")
        launches += 1
        rows += B
    result = (out, out_lens, ok & (out_lens <= out_cap))
    return result + (steps,) if with_steps else result


def distance_shares(comp: torch.Tensor, comp_lens: torch.Tensor,
                    reaches=tuple(copy_reach(w) for w in WINDOWS)) -> dict:
    """For each reach, the share of the matches of every chunk's sequence
    chain (those moved before its failing sequence, if any) whose dist is at
    most that reach, and the share of their output bytes; with the counts
    behind them."""
    comp, comp_lens = check_decode_args(comp, comp_lens, MAX_OUT)
    c = _chain(comp, comp_lens)
    moved = c["is_seq"] & ~c["is_last"] & (~c["any_bad"][:, None] | (c["pos"] < c["first"]))
    dist, length = c["dist"][moved], c["ml"][moved]
    n_matches, n_bytes = int(dist.numel()), int(length.sum())
    shares = {}
    for reach in reaches:
        near = dist <= reach
        shares[reach] = {
            "matches": int(near.sum()) / n_matches if n_matches else 0.0,
            "bytes": int(length[near].sum()) / n_bytes if n_bytes else 0.0}
    return {"matches": n_matches, "match_bytes": n_bytes, "within": shares}


def decode_plain(comp: torch.Tensor, comp_lens: torch.Tensor,
                 out_cap: int = MAX_OUT, with_steps: bool = False):
    """Plain PyTorch decode with the kernel's results, for tests and checks.

    The geometry of a sequence that would start at every position (the ends
    of 255-extension strings by a reverse running minimum), the sequence
    chain from position 0 by doubling jump tables, output offsets by cumsum,
    the first malformed sequence over all of them, the covering sequence of
    each output byte by searchsorted, and copy chains by pointer doubling.
    The step count is the sequences of the chain up to the first malformed
    one, included.
    """
    comp, comp_lens = check_decode_args(comp, comp_lens, out_cap)
    B, cap = comp.shape
    dev = comp.device
    c = _chain(comp, comp_lens)
    raw, lit, lit_start, dist = c["raw"], c["lit"], c["lit_start"], c["dist"]
    op_at, incl, op = c["op_at"], c["incl"], c["op"]
    any_bad, first = c["any_bad"], c["first"]
    width = cap + 3

    def at(table, idx):
        return table.gather(1, idx.clamp(0, width - 1))

    ok = ~c["err0"] & ~any_bad & c["ended"] & (op <= out_cap)

    # Output bytes: covering sequence by searchsorted, copies by pointer
    # doubling.
    j = torch.arange(out_cap, device=dev).expand(B, out_cap).contiguous()
    p = torch.searchsorted(incl, j, right=True).clamp_(max=cap)
    produced = j < op.clamp(max=out_cap)[:, None]
    jr = j - op_at.gather(1, p)
    in_lit = jr < lit.gather(1, p)
    lit_src = lit_start.gather(1, p) + jr
    resolved = in_lit | ~produced
    ptr = torch.where(resolved, j, j - dist.gather(1, p))
    for _ in range(out_cap.bit_length()):
        ptr = ptr.gather(1, ptr)
    out = torch.where(produced, at(raw, lit_src.gather(1, ptr)), 0).to(torch.uint8)
    if not with_steps:
        return out, op.to(torch.int32), ok
    last = torch.where(any_bad, first[:, 0], cap)
    steps = (c["is_seq"] & (c["pos"] <= last[:, None])).sum(1)
    return out, op.to(torch.int32), ok, steps.to(torch.int32)


def _chain(comp: torch.Tensor, comp_lens: torch.Tensor) -> dict:
    """The sequence chain of every chunk (``decode_plain``'s parse): for each
    position, the fields of a sequence starting there, whether the chain
    reaches it, and the output offsets; the first malformed sequence."""
    B, cap = comp.shape
    dev = comp.device
    i64 = torch.int64
    clen = comp_lens.to(i64)[:, None]
    err0 = (clen[:, 0] <= 0) | (clen[:, 0] > cap)
    width = cap + 3  # bytes read as 0 past clen; columns cap.. are sinks
    col = torch.arange(width, device=dev)[None, :]
    raw = torch.zeros((B, width), dtype=i64, device=dev)
    raw[:, :cap] = comp
    raw.masked_fill_(col >= clen, 0)

    def at(table, idx):
        return table.gather(1, idx.clamp(0, width - 1))

    # The first byte at or after each position that is not 0xFF: where a
    # 255-extension string starting there ends. Past clen every byte is 0.
    stop = torch.where(raw != 255, col, width - 1).flip(1).cummin(1).values.flip(1)

    def ext(start, nibble):
        """A length with a 4-bit nibble whose extension starts at start:
        (length, position after it, extension runs past clen)."""
        t = at(stop, start)
        long = nibble == 15
        length = torch.where(long, 15 + 255 * (t - start) + at(raw, t), nibble)
        return length, torch.where(long, t + 1, start), long & (t >= clen)

    pos = col[:, :cap + 1].expand(B, cap + 1)
    token = raw[:, :cap + 1]
    lit, lit_start, lit_unended = ext(pos + 1, token >> 4)
    lit_end = lit_start + lit
    is_last = ~lit_unended & (lit_end == clen)
    dist = at(raw, lit_end) | (at(raw, lit_end + 1) << 8)
    ml, nxt, ml_unended = ext(lit_end + 2, token & 15)
    ml = ml + 4
    chain_ends = lit_unended | (lit_end + 2 > clen) | ml_unended
    nxt = torch.where(chain_ends | (pos >= clen), cap, nxt.clamp(max=cap))

    # The sequence chain from 0: positions reached in 2^k steps, by scatter
    # along jump tables that double each round.
    reached = torch.zeros((B, cap + 1), dtype=i64, device=dev)
    reached.scatter_(1, torch.where(err0, cap, 0)[:, None], 1)
    jump = nxt
    for _ in range((cap + 1).bit_length()):
        hit = torch.zeros_like(reached).scatter_add_(1, jump, reached)
        reached = ((reached + hit) > 0).to(i64)
        jump = jump.gather(1, jump)
    is_seq = (reached > 0) & (pos < clen)

    # Output offsets; the first malformed sequence ends the chunk, after
    # its literals where only its match part is malformed.
    adv = torch.where(is_seq, torch.where(is_last, lit, lit + ml), 0).clamp(min=0)
    incl = adv.cumsum(1)
    op_at = incl - adv
    bad_lit = is_seq & (lit_unended | (lit_end > clen) | (op_at + lit > MAX_OUT))
    bad_match = is_seq & ~is_last & (
        (lit_end + 2 > clen) | (dist == 0) | (dist > op_at + lit) | ml_unended
        | (op_at + lit + ml > MAX_OUT))
    bad = bad_lit | bad_match
    any_bad = bad.any(1)
    first = bad.to(torch.uint8).argmax(1, keepdim=True)
    stopped_at = (op_at.gather(1, first)
                  + torch.where(bad_lit.gather(1, first), 0, lit.gather(1, first)))[:, 0]
    op = torch.where(any_bad, stopped_at, incl[:, -1])
    ended = (is_seq & is_last).any(1)
    return dict(raw=raw, pos=pos, is_seq=is_seq, is_last=is_last, lit=lit,
                lit_start=lit_start, dist=dist, ml=ml, op_at=op_at, incl=incl, op=op,
                err0=err0, any_bad=any_bad, first=first, ended=ended)
