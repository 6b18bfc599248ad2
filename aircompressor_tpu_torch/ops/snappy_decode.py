"""Batched Snappy block decode: the CUDA kernel and its plain PyTorch version.

Contract of ``aircompressor_tpu.ops.snappy_pallas_w.decode``: ``comp`` is a
(B, cap) uint8 batch of zero-padded chunks that each start with the varint
uncompressed length, ``comp_lens`` the (B,) compressed lengths. The result
is ``(out, out_lens, ok)``: (B, out_cap) uint8 with zeros at and past each
output length, (B,) int32 and (B,) bool. A malformed chunk stops at its
first bad token; its ``out_lens`` is the count of bytes produced before it
and its ``ok`` is False. ``ok`` also requires ``out_lens <= out_cap``.

``with_steps=True`` adds a fourth result, (B,) int32: the iterations of
the kernel's token loop for each chunk, that is the tokens it parsed, the
failing one included; 0 for a chunk rejected before its first token. The
JAX kernel's ``steps`` count its TPU loop bodies of 8 tokens over 64-chunk
grid steps; that is TPU machinery, so the port counts its own loop instead.

``decode`` launches ``csrc/snappy_decode.cu`` for a CUDA tensor and uses
``decode_plain`` only for a tensor on the CPU. The kernel keeps each
chunk's recent output in a shared-memory window (``WINDOWS``; two
instantiations of one template): 32 KB up to ``SMALL_BATCH`` chunks, 4 KB
above, so that 4096 chunks fit the card in one wave. ``copy_reach`` (the
farthest copy distance the kernel reads from its window) and
``distance_shares`` (the share of copies, and of their bytes, within a
reach) describe that choice on real data.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from .. import _build
from ._rows import MAX_CHUNK as MAX_OUT, check_decode_args

# Kernel launches and the chunks they decoded, for runs that must show the
# kernel was used. Only a launch of the CUDA kernel adds to them.
launches = 0
rows = 0

WINDOWS = (4096, 32768)  # the kernel's output windows, in bytes
SMALL_BATCH = 792  # the most chunks that take the 32 KB window (kSmallBatchChunks)


def copy_reach(window: int) -> int:
    """The farthest copy distance the kernel reads from a window of this
    size; a farther copy reads device memory."""
    return window - 64


def decode(comp: torch.Tensor, comp_lens: torch.Tensor,
           out_cap: int = MAX_OUT, with_steps: bool = False):
    """Decode B Snappy blocks of at most 64 KB each; see the module doc."""
    global launches, rows
    comp, comp_lens = check_decode_args(comp, comp_lens, out_cap)
    if comp.device.type == "cpu":
        return decode_plain(comp, comp_lens, out_cap, with_steps)
    if comp.device.type != "cuda":
        raise ValueError(f"no Snappy decode for device {comp.device}")
    lib = _build.load()
    B, cap = comp.shape
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    out_lens = torch.empty(B, dtype=torch.int32, device=comp.device)
    ok = torch.empty(B, dtype=torch.bool, device=comp.device)
    steps = torch.empty(B, dtype=torch.int32, device=comp.device) if with_steps else None
    if B:
        with torch.cuda.device(comp.device):
            err = lib.acx_snappy_decode(
                comp.data_ptr(), comp_lens.data_ptr(), B, cap, out.data_ptr(),
                out_lens.data_ptr(), ok.data_ptr(), out_cap,
                steps.data_ptr() if with_steps else None,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"snappy decode kernel launch failed: CUDA error {err}")
        launches += 1
        rows += B
    result = (out, out_lens, ok & (out_lens <= out_cap))
    return result + (steps,) if with_steps else result


def token_table(comp: torch.Tensor, comp_lens: torch.Tensor) -> SimpleNamespace:
    """The token chain of every chunk, as the kernel walks it, in (B, cap + 1)
    tables over byte positions (column ``cap`` is a sink past the row).

    ``is_tok`` marks the positions where a token of the chain starts;
    ``is_lit``, ``tok`` (header bytes), ``length``, ``dist`` and ``op_at``
    (output offset) describe a token that would start there; ``bad`` marks
    a token of the chain that fails its checks, ``first_bad`` (B, 1) the
    first of them (``any_bad`` says whether there is one). ``op`` is each
    chunk's output length, ``err0`` a rejection before the first token,
    ``declared`` the varint length truncated to 32 bits, ``vlen`` its size,
    ``raw`` the bytes as int64 with zeros past each length.
    """
    B, cap = comp.shape
    dev = comp.device
    i64 = torch.int64
    clen = comp_lens.to(i64)[:, None]
    pos = torch.arange(cap + 1, device=dev)[None, :]
    raw = torch.zeros((B, cap + 5), dtype=i64, device=dev)
    raw[:, :cap] = comp
    raw[:, :cap].masked_fill_(pos[:, :cap] >= clen, 0)  # read 0 past clen
    tag, b1, b2, b3, b4 = (raw[:, k:k + cap + 1] for k in range(5))

    # Varint uncompressed length, at most 5 bytes, truncated to 32 bits.
    v = [x[:, 0] for x in (tag, b1, b2, b3, b4)]
    declared = v[0] & 0x7F
    vlen = torch.ones(B, dtype=i64, device=dev)
    more = v[0] >= 128
    for k in range(1, 5):
        declared = torch.where(more, declared | ((v[k] & 0x7F) << (7 * k)),
                               declared)
        vlen = vlen + more.to(i64)
        if k < 4:
            more = more & (v[k] >= 128)
    declared = (declared & 0xFFFFFFFF)[:, None]
    err0 = (declared[:, 0] > MAX_OUT) | (vlen > clen[:, 0]) | (clen[:, 0] > cap)

    # Geometry of a token that would start at every position.
    ttype = tag & 3
    n = tag >> 2
    is_lit = ttype == 0
    extra = (n - 59).clamp(0, 4)
    word = b1 | (b2 << 8) | (b3 << 16) | (b4 << 24)
    masks = torch.tensor([0, 0xFF, 0xFFFF, 0xFFFFFF, 0xFFFFFFFF], device=dev)
    lit_len = torch.where(extra == 0, n, word & masks[extra]) + 1
    tok = torch.where(is_lit, 1 + extra, torch.where(
        ttype == 1, 2, torch.where(ttype == 2, 3, 5)))
    length = torch.where(is_lit, lit_len,
                         torch.where(ttype == 1, 4 + (n & 7), n + 1))
    dist = torch.where(ttype == 1, ((tag >> 5) << 8) | b1,
                       torch.where(ttype == 2, word & 0xFFFF, word))
    step = tok + torch.where(is_lit, lit_len, 0)

    # The token chain from vlen: position sets reached in 2^k steps, by
    # scatter along jump tables that double each round.
    nxt = torch.where(pos < clen, (pos + step).clamp(max=cap), cap)
    start = torch.where(err0, cap, vlen)[:, None]
    reached = torch.zeros((B, cap + 1), dtype=i64, device=dev)
    reached.scatter_(1, start, 1)
    jump = nxt
    for _ in range((cap + 1).bit_length()):
        hit = torch.zeros_like(reached).scatter_add_(1, jump, reached)
        reached = ((reached + hit) > 0).to(i64)
        jump = jump.gather(1, jump)
    is_tok = (reached > 0) & (pos < clen)

    # Output offsets; the first bad token ends the chunk.
    adv = torch.where(is_tok, length, 0)
    incl = adv.cumsum(1)
    op_at = incl - adv
    bad = is_tok & ((op_at + length > declared) | torch.where(
        is_lit,
        (length > MAX_OUT) | (pos + tok + length > clen),
        (pos + tok > clen) | (dist <= 0) | (dist > op_at)))
    any_bad = bad.any(1)
    first_bad = bad.to(torch.uint8).argmax(1, keepdim=True)
    op = torch.where(any_bad, op_at.gather(1, first_bad)[:, 0], incl[:, -1])
    return SimpleNamespace(
        raw=raw, pos=pos, declared=declared[:, 0], vlen=vlen, err0=err0,
        is_tok=is_tok, is_lit=is_lit, tok=tok, length=length, dist=dist,
        op_at=op_at, incl=incl, bad=bad, any_bad=any_bad, first_bad=first_bad,
        op=op)


def distance_shares(comp: torch.Tensor, comp_lens: torch.Tensor,
                    reaches=tuple(copy_reach(w) for w in WINDOWS)) -> dict:
    """For each reach, the share of the copies of every chunk's chain (up to
    its first bad token) whose dist is at most that reach, and the share of
    their output bytes; with the counts behind them."""
    comp, comp_lens = check_decode_args(comp, comp_lens, MAX_OUT)
    t = token_table(comp, comp_lens)
    last = torch.where(t.any_bad, t.first_bad[:, 0] - 1, t.pos.shape[1] - 1)
    copy = t.is_tok & ~t.is_lit & (t.pos <= last[:, None])
    n_copies = int(copy.sum())
    n_bytes = int(t.length[copy].sum())
    shares = {}
    for reach in reaches:
        near = copy & (t.dist <= reach)
        shares[reach] = {
            "copies": int(near.sum()) / n_copies if n_copies else 0.0,
            "bytes": int(t.length[near].sum()) / n_bytes if n_bytes else 0.0}
    return {"copies": n_copies, "copy_bytes": n_bytes, "within": shares}


def results(t: SimpleNamespace, out_cap: int):
    """``(out, out_lens, ok)`` of a token table: the covering token of each
    output byte by searchsorted, copy chains resolved by pointer doubling,
    zeros at and past each output length."""
    B, cap = t.raw.shape[0], t.pos.shape[1] - 1
    j = torch.arange(out_cap, device=t.raw.device).expand(B, out_cap).contiguous()
    p = torch.searchsorted(t.incl, j, right=True).clamp_(max=cap)
    produced = j < t.op.clamp(max=out_cap)[:, None]
    lit_src = p + t.tok.gather(1, p) + j - t.op_at.gather(1, p)
    resolved = t.is_lit.gather(1, p) | ~produced
    ptr = torch.where(resolved, j, j - t.dist.gather(1, p))
    for _ in range(out_cap.bit_length()):
        ptr = ptr.gather(1, ptr)
    src = lit_src.gather(1, ptr).clamp(0, cap + 4)
    out = torch.where(produced, t.raw.gather(1, src), 0).to(torch.uint8)
    ok = ~t.err0 & ~t.any_bad & (t.op == t.declared) & (t.op <= out_cap)
    return out, t.op.to(torch.int32), ok


def decode_plain(comp: torch.Tensor, comp_lens: torch.Tensor,
                 out_cap: int = MAX_OUT, with_steps: bool = False):
    """Plain PyTorch decode with the kernel's results, for tests and checks.

    A port of the vectorised ``aircompressor_tpu.ops.snappy_jax.decode``:
    token geometry at every byte, the token chain by doubling jump tables,
    output offsets by cumsum, the covering token of each output byte by
    searchsorted, and copy chains resolved by pointer doubling. The step
    count is the tokens of the chain up to the first bad one, included.
    """
    comp, comp_lens = check_decode_args(comp, comp_lens, out_cap)
    t = token_table(comp, comp_lens)
    result = results(t, out_cap)
    if not with_steps:
        return result
    last = torch.where(t.any_bad, t.first_bad[:, 0], t.pos.shape[1] - 1)
    steps = (t.is_tok & (t.pos <= last[:, None])).sum(1)
    return result + (steps.to(torch.int32),)
