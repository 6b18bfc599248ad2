"""Batched LZO1X block decode: the CUDA kernel and its plain PyTorch version.

Contract of ``aircompressor_tpu.ops.lzo_pallas_w.decode``: ``comp`` is a
(B, cap) uint8 batch of zero-padded LZO1X blocks, ``comp_lens`` the (B,)
compressed lengths. The result is ``(out, out_lens, ok)``: (B, out_cap)
uint8 with zeros at and past each output length, (B,) int32 and (B,) bool.

The rules are those of the host decoder (``host.lzo.decompress_into``) as
the Pallas kernel keeps them; ``csrc/lzo_decode.cu`` lists them. A chunk
is malformed where its length is not in [1, cap], where a command, a
literal run or trailing literals read past its length, where a zero run
reaches its end, where a match starts before the output, or where the
output would pass 64 KB. A malformed chunk stops at the failing step, and
``out_lens`` counts the bytes produced before it (a match's trailing
literals are a step of their own). ``ok`` requires the stop command and
``out_lens <= out_cap``; bytes after the stop command are ignored.

``with_steps=True`` adds a fourth result, (B,) int32: the iterations of
the kernel's command loop for each chunk, that is the commands it parsed
after the first-byte literal run, the stop command and the failing one
included (a missing stop command is one failing iteration); 0 for a chunk
rejected before the loop. The JAX kernel's ``steps`` count its TPU loop
bodies; the port counts its own loop.

``decode`` launches ``csrc/lzo_decode.cu`` for a CUDA tensor and uses
``decode_plain`` only for a tensor on the CPU. The kernel keeps each
chunk's recent output in a shared-memory window (``WINDOWS``; two
instantiations of one template): 32 KB up to ``SMALL_BATCH`` chunks, 4 KB
above, so that 4096 chunks fit the card in one wave. ``copy_reach`` (the
farthest match distance the kernel reads from its window) and
``distance_shares`` (the share of matches, and of their bytes, within a
reach) describe that choice on real data.
"""

from __future__ import annotations

import torch

from .. import _build
from ._rows import MAX_CHUNK as MAX_OUT, check_decode_args, put

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
    """Decode B LZO1X blocks of at most 64 KB each; see the module doc."""
    global launches, rows
    comp, comp_lens = check_decode_args(comp, comp_lens, out_cap)
    if comp.device.type == "cpu":
        return decode_plain(comp, comp_lens, out_cap, with_steps)
    if comp.device.type != "cuda":
        raise ValueError(f"no LZO decode for device {comp.device}")
    lib = _build.load()
    B, cap = comp.shape
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    out_lens = torch.empty(B, dtype=torch.int32, device=comp.device)
    ok = torch.empty(B, dtype=torch.bool, device=comp.device)
    steps = torch.empty(B, dtype=torch.int32, device=comp.device) if with_steps else None
    if B:
        with torch.cuda.device(comp.device):
            err = lib.acx_lzo_decode(
                comp.data_ptr(), comp_lens.data_ptr(), B, cap, out.data_ptr(),
                out_lens.data_ptr(), ok.data_ptr(), out_cap,
                steps.data_ptr() if with_steps else None,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lzo decode kernel launch failed: CUDA error {err}")
        launches += 1
        rows += B
    result = (out, out_lens, ok & (out_lens <= out_cap))
    return result + (steps,) if with_steps else result


def distance_shares(comp: torch.Tensor, comp_lens: torch.Tensor,
                    reaches=tuple(copy_reach(w) for w in WINDOWS)) -> dict:
    """For each reach, the share of the matches of every chunk's command
    chain (those moved before its failing step, if any) whose dist is at
    most that reach, and the share of their output bytes; with the counts
    behind them."""
    comp, comp_lens = check_decode_args(comp, comp_lens, MAX_OUT)
    dists, lengths = [], []

    def on_match(match, dist, length):
        dists.append(dist[match])
        lengths.append(length[match])

    _plain(comp, comp_lens, 1, False, on_match)
    dist = torch.cat(dists) if dists else torch.zeros(0, dtype=torch.int64)
    length = torch.cat(lengths) if lengths else torch.zeros(0, dtype=torch.int64)
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

    One command of every live chunk a step, with its trailing literals: the
    command's fields by gathers at its position, the end of a zero run from
    a table of the first nonzero byte at or after each position (a reverse
    running minimum), the literals and the match by one scatter each, a
    match as out[op+k] = out[op-dist + k % dist]. The loop ends when every
    chunk has stopped; a chunk's step count is the steps it was live in.
    """
    comp, comp_lens = check_decode_args(comp, comp_lens, out_cap)
    return _plain(comp, comp_lens, out_cap, with_steps)


def _plain(comp, comp_lens, out_cap, with_steps, on_match=None):
    """``decode_plain``; ``on_match(match, dist, length)``, where given, sees
    each step's (B,) mask of the chunks whose match moved, with its fields."""
    B, cap = comp.shape
    dev = comp.device
    i64 = torch.int64
    clen = comp_lens.to(i64)
    width = cap + 3  # bytes read as 0 past clen; the last column is a sink
    col = torch.arange(width, device=dev)[None, :]
    raw = torch.zeros((B, width), dtype=i64, device=dev)
    raw[:, :cap] = comp
    raw.masked_fill_(col >= clen[:, None], 0)
    # The first nonzero byte at or after each position; past clen every byte
    # is 0, so a zero run reaches the end of its chunk where this is >= clen.
    nonzero = torch.where(raw != 0, col, width - 1).flip(1).cummin(1).values.flip(1)
    out = torch.zeros((B, out_cap + 1), dtype=torch.uint8, device=dev)

    def at(table, idx):
        return table.gather(1, idx.clamp(0, width - 1)[:, None])[:, 0]

    def zero_run(p):
        """(length of the zero run at p capped at 258 zeros, its last byte,
        the position after it, whether it reaches the end of the chunk)."""
        z = at(nonzero, p)
        return (z - p).clamp(max=258), at(raw, z), z + 1, z >= clen

    def copy(live, op, src_pos, count, from_out):
        """Copy count[b] bytes to out at op[b] for the live rows: from raw at
        src_pos, or from out at op - dist (src_pos holds dist) where
        from_out."""
        n = torch.where(live, count, 0)
        w = int(n.max()) if B else 0
        if w <= 0:
            return
        k = torch.arange(w, device=dev)[None, :]
        dist = src_pos.clamp(min=1)[:, None]
        lit_vals = raw.gather(1, (src_pos[:, None] + k).clamp(0, width - 1))
        out_idx = (op[:, None] - dist + k % dist).clamp(0, out_cap)
        match_vals = out.gather(1, out_idx).to(i64)
        put(out, op, torch.where(from_out[:, None], match_vals, lit_vals), n)

    zero = torch.zeros(B, dtype=i64, device=dev)
    no = torch.zeros(B, dtype=torch.bool, device=dev)
    err = (clen <= 0) | (clen > cap)
    done = no.clone()
    op, ip, state, steps = zero.clone(), zero.clone(), zero.clone(), zero.clone()

    # The first-byte literal run.
    t0 = raw[:, 0]
    first = ~err & (t0 > 17)
    n0 = torch.where(first, t0 - 17, 0)
    err |= first & (1 + n0 > clen)
    first &= ~err
    copy(first, op, torch.ones_like(op), n0, no)
    op += torch.where(first, n0, 0)
    ip = torch.where(first, 1 + n0, ip)
    state = torch.where(first, n0.clamp(max=4), state)

    while True:
        live = ~err & ~done
        steps += live.to(i64)
        err |= live & (ip >= clen)  # missing stop command
        live &= ~err
        if not bool(live.any()):
            break
        t, next_b = at(raw, ip), at(raw, ip + 1)
        lit_cmd = (t < 16) & (state == 0)
        short = (t < 16) | (t >= 64)
        m4 = (t >= 16) & (t < 32)

        # A literal-run command.
        lit = live & lit_cmd
        zn, zb, zafter, zend = zero_run(ip + 1)
        ext = t == 0
        run = torch.where(ext, 255 * zn + zb + 18, t + 3)
        run_from = torch.where(ext, zafter, ip + 1)
        bad = lit & ((ext & zend) | (run_from + run > clen) | (op + run > MAX_OUT))
        err |= bad
        lit &= ~bad
        copy(lit, op, run_from, run, no)
        op += torch.where(lit, run, 0)
        ip = torch.where(lit, run_from + run, ip)
        state = torch.where(lit, 4, state)

        # A match command: M1/M1' and M2 take 2 bytes, M3 and M4 a length
        # (zero-extended where its low bits are 0) and a 2-byte word.
        match = live & ~lit_cmd
        low = torch.where(m4, t & 7, t & 31)
        lext = ~short & (low == 0)
        word_at = torch.where(lext, zafter, ip + 1)
        word = at(raw, word_at) | (at(raw, word_at + 1) << 8)
        length = torch.where(
            t >= 64, (t >> 5) + 1, torch.where(
                t < 16, torch.where(state < 4, 2, 3), torch.where(
                    lext, 255 * zn + zb + torch.where(m4, 9, 33), low + 2)))
        dist = torch.where(
            t >= 64, ((t >> 2) & 7) + (next_b << 3) + 1, torch.where(
                t < 16, (t >> 2) + (next_b << 2) + torch.where(state < 4, 1, 2049),
                torch.where(m4, 16384 + ((t & 8) << 11) + (word >> 2), (word >> 2) + 1)))
        end = torch.where(short, ip + 2, word_at + 2)
        trailing = torch.where(short, t & 3, word & 3)
        bad = match & ((lext & zend) | (end > clen))
        err |= bad
        match &= ~bad
        stop = match & m4 & (dist == 16384)
        done |= stop
        match &= ~stop
        bad = match & ((dist > op) | (op + length > MAX_OUT))
        err |= bad
        match &= ~bad
        copy(match, op, dist, length, ~no)
        if on_match is not None:
            on_match(match, dist, length)
        op += torch.where(match, length, 0)
        ip = torch.where(match, end, ip)

        # Its trailing literals, which set the next state.
        tail = match & (trailing > 0)
        bad = tail & ((ip + trailing > clen) | (op + trailing > MAX_OUT))
        err |= bad
        tail &= ~bad
        copy(tail, op, ip, trailing, no)
        op += torch.where(tail, trailing, 0)
        ip = torch.where(tail, ip + trailing, ip)
        state = torch.where(match, trailing, state)

    j = torch.arange(out_cap, device=dev)[None, :]
    out = torch.where(j < op[:, None], out[:, :out_cap], 0)
    ok = done & ~err & (op <= out_cap)
    result = (out, op.to(torch.int32), ok)
    return result + (steps.to(torch.int32),) if with_steps else result
