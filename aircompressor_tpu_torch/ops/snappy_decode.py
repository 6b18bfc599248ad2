"""Batched Snappy block decode: the CUDA kernel and its plain PyTorch version.

Contract of ``aircompressor_tpu.ops.snappy_pallas_w.decode``: ``comp`` is a
(B, cap) uint8 batch of zero-padded chunks that each start with the varint
uncompressed length, ``comp_lens`` the (B,) compressed lengths. The result
is ``(out, out_lens, ok)``: (B, out_cap) uint8 with zeros at and past each
output length, (B,) int32 and (B,) bool. A malformed chunk stops at its
first bad token; its ``out_lens`` is the count of bytes produced before it
and its ``ok`` is False. ``ok`` also requires ``out_lens <= out_cap``.

``decode`` launches ``csrc/snappy_decode.cu`` for a CUDA tensor and uses
``decode_plain`` only for a tensor on the CPU.
"""

from __future__ import annotations

import torch

from .. import _build
from ._rows import MAX_CHUNK as MAX_OUT, check_decode_args

# Kernel launches and the chunks they decoded, for runs that must show the
# kernel was used. Only a launch of the CUDA kernel adds to them.
launches = 0
rows = 0


def decode(comp: torch.Tensor, comp_lens: torch.Tensor,
           out_cap: int = MAX_OUT):
    """Decode B Snappy blocks of at most 64 KB each; see the module doc."""
    global launches, rows
    comp, comp_lens = check_decode_args(comp, comp_lens, out_cap)
    if comp.device.type == "cpu":
        return decode_plain(comp, comp_lens, out_cap)
    if comp.device.type != "cuda":
        raise ValueError(f"no Snappy decode for device {comp.device}")
    lib = _build.load()
    B, cap = comp.shape
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    out_lens = torch.empty(B, dtype=torch.int32, device=comp.device)
    ok = torch.empty(B, dtype=torch.bool, device=comp.device)
    if B:
        with torch.cuda.device(comp.device):
            err = lib.acx_snappy_decode(
                comp.data_ptr(), comp_lens.data_ptr(), B, cap, out.data_ptr(),
                out_lens.data_ptr(), ok.data_ptr(), out_cap,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"snappy decode kernel launch failed: CUDA error {err}")
        launches += 1
        rows += B
    return out, out_lens, ok & (out_lens <= out_cap)


def decode_plain(comp: torch.Tensor, comp_lens: torch.Tensor,
                 out_cap: int = MAX_OUT):
    """Plain PyTorch decode with the kernel's results, for tests and checks.

    A port of the vectorised ``aircompressor_tpu.ops.snappy_jax.decode``:
    token geometry at every byte, the token chain by doubling jump tables,
    output offsets by cumsum, the covering token of each output byte by
    searchsorted, and copy chains resolved by pointer doubling.
    """
    comp, comp_lens = check_decode_args(comp, comp_lens, out_cap)
    B, cap = comp.shape
    dev = comp.device
    i64 = torch.int64
    clen = comp_lens.to(i64)[:, None]
    # Column `cap` of every per-position table is a sink past the row.
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
    ok = ~err0 & ~any_bad & (op == declared[:, 0]) & (op <= out_cap)

    # Output bytes: covering token by searchsorted, copies by pointer doubling.
    j = torch.arange(out_cap, device=dev).expand(B, out_cap).contiguous()
    p = torch.searchsorted(incl, j, right=True).clamp_(max=cap)
    produced = j < op.clamp(max=out_cap)[:, None]
    lit_src = p + tok.gather(1, p) + j - op_at.gather(1, p)
    resolved = is_lit.gather(1, p) | ~produced
    ptr = torch.where(resolved, j, j - dist.gather(1, p))
    for _ in range(out_cap.bit_length()):
        ptr = ptr.gather(1, ptr)
    src = lit_src.gather(1, ptr).clamp(0, cap + 4)
    out = torch.where(produced, raw.gather(1, src), 0).to(torch.uint8)
    return out, op.to(torch.int32), ok
