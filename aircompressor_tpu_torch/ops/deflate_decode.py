"""Batched raw-deflate decode: the CUDA kernel and its plain PyTorch version.

Contract of ``aircompressor_tpu.ops.deflate_pallas_w.decode``: ``comp`` is
a (B, cap) uint8 batch of zero-padded raw-deflate (RFC 1951) chunks,
``comp_lens`` the (B,) compressed lengths, and ``plan`` the host planner's
blocks and tables for them (``host.deflate.plan``, on the device by
``upload``). The result is ``(out, out_lens, ok)``: (B, out_cap) uint8 with
zeros at and past each output length, (B,) int32 and (B,) bool.

The rules are the Pallas kernel's (``aircompressor_tpu.deflate.
device_prep.simulate_chunk`` models them); ``csrc/deflate_decode.cu`` lists
them. Symbols are looked up in 15 bits with the two-level tables, bits past
a chunk's length read as 0, and a chunk fails on an invalid entry, a symbol
of the wrong kind, bits that end past its length, a distance before the
output's start, a stored extent outside it, a block past its plan, or
output past 64 KB. A failed chunk stops at the failing symbol or block, and
``out_lens`` counts the bytes produced before it. ``ok`` requires the final
block's end and ``out_lens <= out_cap``.

``with_steps=True`` adds a fourth result, (B,) int32: the iterations of
the kernel's symbol loop for each chunk, summed over its Huffman blocks:
one for each literal/length symbol looked up (a length with its distance is
one), the end-of-block symbol and the failing one included; stored blocks
add none. The JAX kernel's ``steps`` count its TPU loop bodies; the port
counts its own loop.

``decode`` launches ``csrc/deflate_decode.cu`` for a CUDA tensor and uses
``decode_plain`` only for a tensor on the CPU. The kernel keeps each
chunk's block tables (``SLOT`` entries), its input and its recent output
in shared memory; two instantiations, picked by the batch, differ in the
output window (``WINDOWS``): 32 KB up to ``SMALL_BATCH`` chunks, 1 KB
above, so that 4096 chunks fit the card in one wave. ``copy_reach`` (the
farthest copy distance the kernel reads from its window) and
``distance_shares`` (the share of copies, and of their bytes, within a
reach) describe that choice on real data.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ._rows import MAX_CHUNK as MAX_OUT, check_decode_args, put

OP_LIT, OP_LEN, OP_DIST, OP_EOB, OP_SUB = 1, 2, 3, 4, 5
ROOT_BITS = 9
WINDOWS = (1024, 32768)  # the kernel's output windows, in bytes
SMALL_BATCH = 660  # the most chunks that take the 32 KB window (kSmallBatchChunks)
SLOT = 1280  # table entries the kernel keeps in shared memory for a block (kSlot)
MAX_COPY = 258  # the longest copy a planner's table gives, and a copy step's bytes


def copy_reach(window: int) -> int:
    """The farthest copy distance the kernel reads from a window of this
    size; a farther copy reads device memory."""
    return window - MAX_COPY


# Kernel launches and the chunks they decoded, for runs that must show the
# kernel was used. Only a launch of the CUDA kernel adds to them.
launches = 0
rows = 0


class DevicePlan(NamedTuple):
    """A packed plan (``host.deflate.plan.Plan``) as int32 tensors on one
    device: ``desc`` (NB, 8), ``tabs`` (NT,) and ``index`` (B, 4)."""

    desc: torch.Tensor
    tabs: torch.Tensor
    index: torch.Tensor


def upload(plan, device) -> DevicePlan:
    """The kernel's part of a packed plan, on ``device``."""
    def put_on(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return DevicePlan(put_on(plan.desc), put_on(plan.tabs), put_on(plan.index))


def _check_plan(plan: DevicePlan, comp: torch.Tensor) -> DevicePlan:
    desc, tabs, index = (t.to(torch.int32).contiguous() for t in plan)
    if desc.dim() != 2 or desc.shape[1] != 8 or tabs.dim() != 1:
        raise ValueError(f"plan needs desc (NB, 8) and tabs (NT,), got "
                         f"{tuple(desc.shape)} and {tuple(tabs.shape)}")
    if index.shape != (comp.shape[0], 4):
        raise ValueError(f"plan index must have shape ({comp.shape[0]}, 4), got "
                         f"{tuple(index.shape)}")
    if any(t.device != comp.device for t in (desc, tabs, index)):
        raise ValueError("comp and the plan lie on different devices")
    if index.numel():
        nb, nt = index[:, 0] + index[:, 1], index[:, 2] + index[:, 3]
        if bool((index < 0).any() | (nb > desc.shape[0]).any() | (nt > tabs.shape[0]).any()):
            raise ValueError("plan index points outside its blocks or tables")
    return DevicePlan(desc, tabs, index)


def decode(comp: torch.Tensor, comp_lens: torch.Tensor, plan: DevicePlan,
           out_cap: int = MAX_OUT, with_steps: bool = False):
    """Decode B raw-deflate chunks of at most 64 KB out each with their
    plan; see the module doc."""
    global launches, rows
    comp, comp_lens = check_decode_args(comp, comp_lens, out_cap)
    plan = _check_plan(plan, comp)
    if comp.device.type == "cpu":
        return decode_plain(comp, comp_lens, plan, out_cap, with_steps)
    if comp.device.type != "cuda":
        raise ValueError(f"no deflate decode for device {comp.device}")
    lib = _build.load()
    B, cap = comp.shape
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    out_lens = torch.empty(B, dtype=torch.int32, device=comp.device)
    ok = torch.empty(B, dtype=torch.bool, device=comp.device)
    steps = torch.empty(B, dtype=torch.int32, device=comp.device) if with_steps else None
    if B:
        with torch.cuda.device(comp.device):
            err = lib.acx_deflate_decode(
                comp.data_ptr(), comp_lens.data_ptr(), B, cap,
                plan.desc.data_ptr(), plan.tabs.data_ptr(), plan.index.data_ptr(),
                out.data_ptr(), out_lens.data_ptr(), ok.data_ptr(), out_cap,
                steps.data_ptr() if with_steps else None,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"deflate decode kernel launch failed: CUDA error {err}")
        launches += 1
        rows += B
    result = (out, out_lens, ok & (out_lens <= out_cap))
    return result + (steps,) if with_steps else result


def decode_plain(comp: torch.Tensor, comp_lens: torch.Tensor, plan: DevicePlan,
                 out_cap: int = MAX_OUT, with_steps: bool = False):
    """Plain PyTorch decode with the kernel's results, for tests and checks.

    Block by block for every chunk at once. A stored block is one copy. For
    a Huffman block, the symbol that would start at every bit position of
    the chunk is decoded with the block's tables (a length with its
    distance), giving the position after it; the chain from the block's
    start by doubling jump tables; output offsets by cumsum; the first
    failing symbol on the chain; the covering symbol of each output byte by
    searchsorted, and copies resolved by pointer doubling. A block's step
    count is its chain's symbols up to the first failing one, included.
    """
    comp, comp_lens = check_decode_args(comp, comp_lens, out_cap)
    plan = _check_plan(plan, comp)
    out, op, ok, steps = _walk(comp, comp_lens, plan, out_cap)
    result = (out, op, ok)
    return result + (steps,) if with_steps else result


def distance_shares(comp: torch.Tensor, comp_lens: torch.Tensor, plan: DevicePlan,
                    reaches=tuple(copy_reach(w) for w in WINDOWS)) -> dict:
    """For each reach, the share of the copies of every chunk's symbol chain
    (up to its first failing symbol) whose distance is at most that reach,
    and the share of their output bytes; with the counts behind them. Rows
    go 32 at a time: the plain version's memory grows with the rows."""
    comp, comp_lens = check_decode_args(comp, comp_lens, MAX_OUT)
    plan = _check_plan(plan, comp)
    copies = []
    for a in range(0, comp.shape[0], 32):
        rows = slice(a, a + 32)
        _walk(comp[rows], comp_lens[rows], DevicePlan(plan.desc, plan.tabs, plan.index[rows]),
              MAX_OUT, copies)
    dist = torch.cat([d for d, _ in copies]) if copies else torch.zeros(0, dtype=torch.int64)
    length = torch.cat([n for _, n in copies]) if copies else torch.zeros(0, dtype=torch.int64)
    n_copies, n_bytes = int(dist.numel()), int(length.sum())
    within = {}
    for reach in reaches:
        near = dist <= reach
        within[reach] = {"copies": int(near.sum()) / max(n_copies, 1),
                         "bytes": int(length[near].sum()) / max(n_bytes, 1)}
    return {"copies": n_copies, "copy_bytes": n_bytes, "within": within}


def _walk(comp, comp_lens, plan, out_cap, copies=None):
    """decode_plain's walk: (out, out_lens, ok, steps) as int32 and bool
    tensors; with a list ``copies``, each Huffman block appends the (dist,
    length) of the copies on its chains."""
    B, cap = comp.shape
    dev = comp.device
    i64 = torch.int64
    clen = comp_lens.to(i64)
    width = cap + 8  # bytes read as 0 past clen
    col = torch.arange(width, device=dev)[None, :]
    raw = torch.zeros((B, width), dtype=i64, device=dev)
    raw[:, :cap] = comp
    raw.masked_fill_(col >= clen[:, None], 0)
    # The little-endian 4-byte word at every byte.
    word = raw[:, :-3] | (raw[:, 1:-2] << 8) | (raw[:, 2:-1] << 16) | (raw[:, 3:] << 24)
    desc = torch.cat([plan.desc.to(i64), torch.zeros((1, 8), dtype=i64, device=dev)])
    tabs = torch.cat([plan.tabs.to(i64), torch.zeros(1, dtype=i64, device=dev)])
    d_start, n_blocks, t_start, n_tab = plan.index.to(i64).unbind(1)
    out = torch.zeros((B, out_cap + 1), dtype=torch.uint8, device=dev)  # + a sink
    op = torch.zeros(B, dtype=i64, device=dev)
    err = (clen <= 0) | (clen > cap)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    steps = torch.zeros(B, dtype=i64, device=dev)
    n_bits = 8 * cap + 1  # the bit positions a chain can hold; past them it failed

    for blk in range(int(n_blocks.max()) + 1 if B else 0):
        live = ~err & ~done
        if not bool(live.any()):
            break
        err |= live & (blk >= n_blocks)
        live &= ~err
        d = desc[torch.where(live, d_start + blk, desc.shape[0] - 1)]
        last = d[:, 6] != 0

        stored = live & (d[:, 0] == 0)
        s_from, s_len = d[:, 4], d[:, 5]
        bad = stored & ((s_from < 0) | (s_len < 0) | (s_from > clen - s_len)
                        | (op + s_len > MAX_OUT))
        err |= bad
        stored &= ~bad
        n = torch.where(stored, s_len, 0)
        w = int(n.max())
        if w > 0:
            k = torch.arange(w, device=dev)[None, :]
            put(out, op, raw.gather(1, (s_from[:, None] + k).clamp(0, width - 1)), n)
        op = op + n
        done |= stored & last

        huff = live & (d[:, 0] != 0)
        bad = huff & ((d[:, 1] < 0) | (d[:, 1] >= n_bits))
        steps += (bad & (d[:, 1] >= 0)).to(i64)  # past the chunk: its first symbol fails
        err |= bad
        huff &= ~bad
        h = torch.nonzero(huff)[:, 0]
        if h.numel():
            h_out, h_op, h_bad, h_steps = _huffman_block(
                word[h], 8 * clen[h], tabs, t_start[h], n_tab[h], d[h],
                out[h, :out_cap], op[h], n_bits, out_cap, copies)
            out[h, :out_cap] = h_out
            op[h] = h_op
            err[h] |= h_bad
            done[h] |= ~h_bad & last[h]
            steps[h] += h_steps
    return (out[:, :out_cap], op.to(torch.int32), done & ~err & (op <= out_cap),
            steps.to(torch.int32))


def _huffman_block(word, end_bit, tabs, t_start, n_tab, d, out, op0, n_bits, out_cap,
                   copies=None):
    """One Huffman block of h chunks (rows of the arguments): (out with the
    block's bytes, output length after it, whether it failed, the symbols
    its loop looked up). With a list ``copies``, append the (dist, length)
    of the copies its chains make before their first failing symbol."""
    h = word.shape[0]
    dev = word.device
    i64 = torch.int64

    def bits(pos, k):
        w = word.gather(1, (pos >> 3).clamp(0, word.shape[1] - 1))
        return (w >> (pos & 7)) & ((1 << k) - 1)

    def entry(i):
        valid = (i >= 0) & (i < n_tab[:, None])
        return torch.where(valid, tabs[(t_start[:, None] + i).clamp(0, tabs.shape[0] - 1)], 0)

    def lookup(root, pos):
        """(entry, code bits, bad) of the symbol at pos."""
        peek = bits(pos, 15)
        e = entry(root + (peek & ((1 << ROOT_BITS) - 1)))
        sbits = ((e >> 22) & 63).clamp(max=15 - ROOT_BITS)
        sub = entry((e & 0x3FFFFF) + ((peek >> ROOT_BITS) & ((1 << sbits) - 1)))
        e = torch.where((e >> 28) == OP_SUB, sub, e)
        nbits = (e >> 22) & 63
        return e, nbits, ((e >> 28) == 0) | (nbits == 0) | (nbits > 15)

    # The symbol at every bit position, with the block's tables.
    p = torch.arange(n_bits, device=dev)[None, :].expand(h, n_bits)
    eb = end_bit[:, None]
    e, nbits, bad = lookup(d[:, 2:3], p)
    kind = torch.where(bad, 0, e >> 28)
    val = e & 0x3FFFFF
    p1 = p + nbits
    is_lit, is_eob, is_len = kind == OP_LIT, kind == OP_EOB, kind == OP_LEN
    l_extra = (val >> 9) & 15
    length = (val & 511) + bits(p1, l_extra)
    p2 = p1 + l_extra
    de, d_nbits, d_bad = lookup(d[:, 3:4], p2)
    dval = de & 0x3FFFFF
    p3 = p2 + d_nbits
    d_extra = (dval >> 16) & 15
    dist = (dval & 0xFFFF) + bits(p3, d_extra)
    p4 = p3 + d_extra
    fail = (~(is_lit | is_eob | is_len) | (~is_len & (p1 > eb))
            | (is_len & ((p2 > eb) | d_bad | ((de >> 28) != OP_DIST) | (p4 > eb)
                         | (dist <= 0))))
    nxt = torch.where(fail | is_eob, n_bits, torch.where(is_len, p4, p1)).clamp(max=n_bits)

    # The chain from the block's start: positions reached in 2^k steps, by
    # scatter along jump tables that double each round.
    reached = torch.zeros((h, n_bits + 1), dtype=i64, device=dev)
    reached.scatter_(1, d[:, 1:2], 1)
    jump = torch.cat([nxt, torch.full((h, 1), n_bits, dtype=i64, device=dev)], 1)
    for _ in range((n_bits + 1).bit_length()):
        hit = torch.zeros_like(reached).scatter_add_(1, jump, reached)
        reached = ((reached + hit) > 0).to(i64)
        jump = jump.gather(1, jump)
    on = reached[:, :n_bits] > 0

    # Output offsets and the first failing symbol on the chain.
    prod = torch.where(on & ~fail, torch.where(is_lit, 1, torch.where(is_len, length, 0)), 0)
    incl = prod.cumsum(1)
    op_at = op0[:, None] + incl - prod
    stop = on & (fail | (is_lit & (op_at + 1 > MAX_OUT))
                 | (is_len & ((dist > op_at) | (op_at + length > MAX_OUT))))
    failed = stop.any(1)
    first = stop.to(torch.uint8).argmax(1, keepdim=True)
    op_end = torch.where(failed, op_at.gather(1, first)[:, 0], op0 + incl[:, -1])
    steps = (on & (~failed[:, None] | (p <= first))).sum(1)
    if copies is not None:
        made = on & is_len & ~fail & (~failed[:, None] | (p < first))
        copies.append((dist[made], length[made]))

    # Output bytes: covering symbol by searchsorted, copies by pointer
    # doubling (through bytes of earlier blocks too).
    j = torch.arange(out_cap, device=dev)[None, :].expand(h, out_cap).contiguous()
    in_blk = (j >= op0[:, None]) & (j < op_end[:, None])
    node = torch.searchsorted(incl, j - op0[:, None], right=True).clamp_(max=n_bits - 1)
    lit_here = in_blk & is_lit.gather(1, node)
    vals = torch.where(lit_here, val.gather(1, node) & 255, out.to(i64))
    ptr = torch.where(in_blk & ~lit_here, j - dist.gather(1, node), j).clamp(0, out_cap - 1)
    for _ in range(out_cap.bit_length()):
        ptr = ptr.gather(1, ptr)
    out = torch.where(in_blk, vals.gather(1, ptr), out.to(i64)).to(torch.uint8)
    return out, op_end, failed, steps
