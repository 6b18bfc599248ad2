"""Batched Snappy block encode: the CUDA kernel and its plain PyTorch version.

Contract of ``aircompressor_tpu.ops.snappy_encode_pallas.encode``, byte for
byte: ``data`` is a (B, cap) uint8 batch with cap <= 65536 and ``lengths``
the (B,) input lengths, clamped to [0, cap]. The result is ``(comp,
comp_lens, ok)``: (B, OUT_CAP) uint8 Snappy blocks, zero at and past each
length, (B,) int32 and (B,) bool. Bytes past a chunk's length do not change
its result. ``ok`` is False where the output would come within 8 bytes of
OUT_CAP, which no chunk of 64 KB or less reaches.

The matcher is the Pallas kernel's: a varint length header; one 2^14-entry
hash table per chunk, hash ``(u32le(p) * 0x1E35A7BD) >> 18``; a scan while
``ip < len - 15`` that inserts every probed ``ip`` and reads the entry
before the insert as its candidate, with ``ip += skip >> 5`` and ``skip +=
1`` on a miss (``skip`` starts at 32); a hit needs ``cand < ip`` and equal
4-byte words; forward extension up to the chunk's length; backward
extension by at most ``min(ip - anchor, cand, 127)`` bytes, which moves the
match start back and keeps the offset; copies in pieces of 64 while the
rest is at least 68, one piece of 60 where it is 65-67, then the rest,
COPY_1 where the piece is at most 11 bytes and the offset under 2048;
after a match ``mend - 1`` goes into the table and ``ip = anchor = mend``,
``skip = 32``; the tail from ``anchor`` is one literal run.

``with_steps=True`` adds a fourth result, (B,) int32: the iterations of
the kernel's match-search loop for each chunk, that is the probes of its
scan (a probe that hits, with the extension and the sequence it emits, is
one). The JAX kernel's ``steps`` count its TPU loop bodies; the port counts
its own loop.

``encode`` launches ``csrc/snappy_encode.cu`` for a CUDA tensor and uses
``encode_plain`` only for a tensor on the CPU. The kernel runs the scan in
rounds of 32 probes (lane k the k-th position, each reading the table as
the probes before it left it) and extends 128 bytes a ballot, with the
serial scan's results and step counts (``tests/test_torch_encode_rounds.py``
models the rounds).
"""

from __future__ import annotations

import torch

from .. import _build
from ._rows import check_encode_args, encode_carveout, put, u32le

OUT_CAP = 76800
HASH_LOG = 14
INPUT_MARGIN = 15
_PAD = 160  # zero columns past the row, so every window below reads in bounds

# Kernel launches and the chunks they encoded, for runs that must show the
# kernel was used. Only a launch of the CUDA kernel adds to them.
launches = 0
rows = 0


def encode(data: torch.Tensor, lengths: torch.Tensor, with_steps: bool = False):
    """Encode B chunks of at most 64 KB each; see the module doc."""
    global launches, rows
    data, lengths = check_encode_args(data, lengths)
    if data.device.type == "cpu":
        return encode_plain(data, lengths, with_steps)
    if data.device.type != "cuda":
        raise ValueError(f"no Snappy encode for device {data.device}")
    lib = _build.load()
    B, cap = data.shape
    comp = torch.empty((B, OUT_CAP), dtype=torch.uint8, device=data.device)
    comp_lens = torch.empty(B, dtype=torch.int32, device=data.device)
    ok = torch.empty(B, dtype=torch.bool, device=data.device)
    steps = torch.empty(B, dtype=torch.int32, device=data.device) if with_steps else None
    if B:
        with torch.cuda.device(data.device):
            err = lib.acx_snappy_encode(
                data.data_ptr(), lengths.data_ptr(), B, cap, comp.data_ptr(),
                comp_lens.data_ptr(), ok.data_ptr(),
                steps.data_ptr() if with_steps else None, encode_carveout(B, data.device),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"snappy encode kernel launch failed: CUDA error {err}")
        launches += 1
        rows += B
    return (comp, comp_lens, ok, steps) if with_steps else (comp, comp_lens, ok)


def _hash(u: torch.Tensor) -> torch.Tensor:
    return ((u * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - HASH_LOG)


def _emit_literal(out, op, src, mask, start, length):
    """A literal run of ``length`` bytes from ``start`` where ``mask``;
    returns the new ``op``."""
    n1 = length - 1
    one, two = n1 < 60, n1 < 256
    hdr = torch.stack([torch.where(one, n1 << 2, torch.where(two, 60 << 2, 61 << 2)),
                       n1 & 255, n1 >> 8], 1)
    hlen = torch.where(mask, torch.where(one, 1, torch.where(two, 2, 3)), 0)
    put(out, op, hdr, hlen)
    op = op + hlen
    count = torch.where(mask, length, 0)
    width = int(count.max())
    if width:
        idx = (start[:, None] + torch.arange(width, device=src.device)).clamp(
            max=src.shape[1] - 1)
        put(out, op, src.gather(1, idx), count)
    return op + count


def _emit_copy(out, op, mask, length, dist):
    """The copy pieces of a match of ``length`` at ``dist`` where ``mask``;
    returns the new ``op``."""
    n64 = torch.where(length >= 68, (length - 68) // 64 + 1, 0)
    rest = length - 64 * n64
    mid = rest > 64
    last = torch.where(mid, rest - 60, rest)
    c1 = (last <= 11) & (dist < 2048)
    head = 3 * n64 + 3 * mid.long()
    count = torch.where(mask, head + torch.where(c1, 2, 3), 0)
    width = int(count.max())
    t = torch.arange(width, device=out.device)[None, :]
    last_tag = torch.where(c1, 1 | ((last - 4) << 2) | ((dist >> 8) << 5),
                           2 | ((last - 1) << 2))[:, None]
    tag = torch.where(t < 3 * n64[:, None], 2 | (63 << 2),
                      torch.where(t < head[:, None], 2 | (59 << 2), last_tag))
    phase = t % 3  # every piece starts at a multiple of 3
    vals = torch.where(phase == 0, tag, torch.where(
        phase == 1, (dist & 255)[:, None], (dist >> 8)[:, None]))
    put(out, op, vals, count)
    return op + count


def encode_plain(data: torch.Tensor, lengths: torch.Tensor, with_steps: bool = False):
    """Plain PyTorch encode with the kernel's results, for tests and checks.

    Steps all B chunks in lockstep with masks, as the Pallas kernel's loop
    does, one probe per chunk a step. A chunk whose probe hits runs its
    forward and backward extension and emits its literal run and copy in
    that same step, over windows of its row.
    """
    data, lengths = check_encode_args(data, lengths)
    B, cap = data.shape
    dev = data.device
    i64 = torch.int64
    n = lengths.to(i64)
    col = torch.arange(cap, device=dev)[None, :]
    src = torch.zeros((B, cap + _PAD), dtype=i64, device=dev)
    src[:, :cap] = torch.where(col < n[:, None], data.to(i64), 0)
    out = torch.zeros((B, OUT_CAP + 1), dtype=torch.uint8, device=dev)
    rows_b = torch.arange(B, device=dev)
    zero = torch.zeros(B, dtype=i64, device=dev)

    # Varint length header, at most 3 bytes.
    rest = n >> 7
    hdr = torch.stack([torch.where(n < 128, n, (n & 127) | 128),
                       torch.where(rest < 128, rest, (rest & 127) | 128),
                       rest >> 7], 1)
    op = torch.where(n < 128, 1, torch.where(rest < 128, 2, 3))
    put(out, zero, hdr, op)

    table = torch.full((B, 1 << HASH_LOG), -1, dtype=i64, device=dev)
    ip = zero.clone()
    anchor = zero.clone()
    skip = torch.full((B,), 32, dtype=i64, device=dev)
    steps = zero.clone()
    live = n > 0
    back_k = torch.arange(1, 128, device=dev)[None, :]
    while True:
        scan = live & (ip < n - INPUT_MARGIN)
        tail = live & ~scan
        if tail.any():
            op = _emit_literal(out, op, src, tail & (n > anchor), anchor,
                               n - anchor)
            live = live & ~tail
        if not scan.any():
            break
        steps += scan.to(i64)
        u = u32le(src, ip)
        h = _hash(u)
        cand = table.gather(1, h[:, None])[:, 0]
        table[rows_b[scan], h[scan]] = ip[scan]
        hit = scan & (cand >= 0) & (cand < ip) & (u32le(src, cand.clamp(min=0)) == u)
        miss = scan & ~hit
        ip = torch.where(miss, ip + (skip >> 5), ip)
        skip = torch.where(miss, skip + 1, skip)
        if not hit.any():
            continue

        # Forward extension up to the chunk's length, in growing windows.
        mlen = torch.where(hit, 4, 0)
        done = ~hit
        width = 64
        while not bool(done.all()):
            k = torch.arange(width, device=dev)[None, :]
            a = (ip + mlen)[:, None] + k
            b = (cand + mlen)[:, None] + k
            last = src.shape[1] - 1
            diff = (a >= n[:, None]) | (src.gather(1, a.clamp(max=last))
                                        != src.gather(1, b.clamp(0, last)))
            run = torch.where(diff.any(1), diff.to(torch.uint8).argmax(1), width)
            mlen = torch.where(done, mlen, mlen + run)
            done = done | (run < width)
            width = min(2 * width, 8192)
        mend = ip + mlen

        # Backward extension by at most min(ip - anchor, cand, 127) bytes.
        room = torch.minimum(ip - anchor, cand).clamp(0, 127)
        a = (ip[:, None] - back_k).clamp(min=0)
        b = (cand[:, None] - back_k).clamp(min=0)
        diff = (back_k > room[:, None]) | (src.gather(1, a) != src.gather(1, b))
        back = torch.where(hit & diff.any(1), diff.to(torch.uint8).argmax(1),
                           torch.where(hit, 127, 0))

        lit = ip - back - anchor
        op = _emit_literal(out, op, src, hit & (lit > 0), anchor, lit)
        op = _emit_copy(out, op, hit, mlen + back, ip - cand)
        h_end = _hash(u32le(src, (mend - 1).clamp(min=0)))
        table[rows_b[hit], h_end[hit]] = (mend - 1)[hit]
        ip = torch.where(hit, mend, ip)
        anchor = torch.where(hit, mend, anchor)
        skip = torch.where(hit, 32, skip)

    ok = op + 8 <= OUT_CAP
    result = (out[:, :OUT_CAP].contiguous(), op.clamp(max=OUT_CAP).to(torch.int32), ok)
    return result + (steps.to(torch.int32),) if with_steps else result
