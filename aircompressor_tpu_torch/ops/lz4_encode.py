"""Batched LZ4 block encode: the CUDA kernel and its plain PyTorch version.

Contract of ``aircompressor_tpu.ops.lz4_encode_pallas.encode``, byte for
byte: ``data`` is a (B, cap) uint8 batch with cap <= 65536 and ``lengths``
the (B,) input lengths, clamped to [0, cap]. The result is ``(comp,
comp_lens, ok)``: (B, OUT_CAP) uint8 LZ4 blocks, zero at and past each
length, (B,) int32 and (B,) bool. Bytes past a chunk's length do not change
its result. ``ok`` is False where the output would come within 8 bytes of
OUT_CAP, which no chunk of 64 KB or less reaches.

The matcher is the Pallas kernel's: one 2^14-entry hash table per chunk,
hash ``(u32le(p) * 2654435761) >> 18``; a scan while ``ip < len - 12`` that
inserts every probed ``ip`` and reads the entry before the insert as its
candidate, with ``ip += skip >> 6`` and ``skip += 1`` on a miss (``skip``
starts at 64); a hit needs ``cand < ip`` and equal 4-byte words; forward
extension from 4 bytes up to ``len - 5``; backward extension ("catch up")
by at most ``min(ip - anchor, cand, 127)`` bytes, which moves the match
start back and keeps the offset. Each sequence is a token ``min(lit, 15) <<
4 | min(ml - 4, 15)``, a length of 15 or more followed by ``(n - 15) //
255`` bytes of 0xFF and one last byte ``(n - 15) % 255`` (written even
when it is 0), the literals, the offset as LE16 ``ip - cand`` and the match
length's extension. After a match, ``mend - 2`` goes into the table and
``ip = anchor = mend``, ``skip = 64``. The tail from ``anchor`` is one
literals-only sequence (match nibble 0); an empty chunk is the one byte 0.

``with_steps=True`` adds a fourth result, (B,) int32: the iterations of
the kernel's match-search loop for each chunk, that is the probes of its
scan (a probe that hits, with the extension and the sequence it emits, is
one). The JAX kernel's ``steps`` count its TPU loop bodies; the port counts
its own loop.

``encode`` launches ``csrc/lz4_encode.cu`` for a CUDA tensor and uses
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

OUT_CAP = 66560
HASH_LOG = 14
MATCH_FIND_LIMIT = 12  # matches may not start within this tail margin
LAST_LITERALS = 5  # matches may not end within this tail margin
MIN_MATCH = 4
BACK_CAP = 127
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
        raise ValueError(f"no LZ4 encode for device {data.device}")
    lib = _build.load()
    B, cap = data.shape
    comp = torch.empty((B, OUT_CAP), dtype=torch.uint8, device=data.device)
    comp_lens = torch.empty(B, dtype=torch.int32, device=data.device)
    ok = torch.empty(B, dtype=torch.bool, device=data.device)
    steps = torch.empty(B, dtype=torch.int32, device=data.device) if with_steps else None
    if B:
        with torch.cuda.device(data.device):
            err = lib.acx_lz4_encode(
                data.data_ptr(), lengths.data_ptr(), B, cap, comp.data_ptr(),
                comp_lens.data_ptr(), ok.data_ptr(),
                steps.data_ptr() if with_steps else None, encode_carveout(B, data.device),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lz4 encode kernel launch failed: CUDA error {err}")
        launches += 1
        rows += B
    return (comp, comp_lens, ok, steps) if with_steps else (comp, comp_lens, ok)


def _hash(u: torch.Tensor) -> torch.Tensor:
    return ((u * 2654435761) & 0xFFFFFFFF) >> (32 - HASH_LOG)


def _emit_length(out, op, mask, n):
    """The 255-extension of a length n >= 15 where ``mask``: (n - 15) // 255
    bytes of 0xFF, then (n - 15) % 255; returns the new ``op``."""
    rest = (n - 15).clamp(min=0)
    fills = rest // 255
    count = torch.where(mask, fills + 1, 0)
    width = int(count.max())
    if width:
        k = torch.arange(width, device=out.device)[None, :]
        put(out, op, torch.where(k < fills[:, None], 255, (rest % 255)[:, None]),
            count)
    return op + count


def _emit_sequence(out, op, src, mask, anchor, lit, ml, dist):
    """One sequence where ``mask``: ``lit`` literals from ``anchor``, then a
    match of ``ml`` bytes at ``dist``, or none where ``ml`` is 0 (the last
    sequence); returns the new ``op``."""
    match = mask & (ml > 0)
    token = (lit.clamp(max=15) << 4) | torch.where(match, (ml - 4).clamp(0, 15), 0)
    put(out, op, token[:, None], mask.long())
    op = op + mask.long()
    op = _emit_length(out, op, mask & (lit >= 15), lit)
    count = torch.where(mask, lit, 0)
    width = int(count.max())
    if width:
        idx = (anchor[:, None] + torch.arange(width, device=src.device)).clamp(
            max=src.shape[1] - 1)
        put(out, op, src.gather(1, idx), count)
    op = op + count
    two = torch.where(match, 2, 0)
    put(out, op, torch.stack([dist & 255, dist >> 8], 1), two)
    return _emit_length(out, op + two, match & (ml - 4 >= 15), ml - 4)


def encode_plain(data: torch.Tensor, lengths: torch.Tensor, with_steps: bool = False):
    """Plain PyTorch encode with the kernel's results, for tests and checks.

    Steps all B chunks in lockstep with masks, as the Pallas kernel's loop
    does, one probe per chunk a step. A chunk whose probe hits runs its
    forward and backward extension and emits its sequence in that same
    step, over windows of its row.
    """
    data, lengths = check_encode_args(data, lengths)
    B, cap = data.shape
    dev = data.device
    i64 = torch.int64
    n = lengths.to(i64)
    col = torch.arange(cap, device=dev)[None, :]
    src = torch.zeros((B, cap + _PAD), dtype=i64, device=dev)
    src[:, :cap] = torch.where(col < n[:, None], data.to(i64), 0)
    last = src.shape[1] - 1
    out = torch.zeros((B, OUT_CAP + 1), dtype=torch.uint8, device=dev)
    rows_b = torch.arange(B, device=dev)
    zero = torch.zeros(B, dtype=i64, device=dev)
    find_limit = n - MATCH_FIND_LIMIT
    match_limit = n - LAST_LITERALS

    table = torch.full((B, 1 << HASH_LOG), -1, dtype=i64, device=dev)
    op = zero.clone()
    ip = zero.clone()
    anchor = zero.clone()
    skip = torch.full((B,), 64, dtype=i64, device=dev)
    steps = zero.clone()
    live = torch.ones(B, dtype=torch.bool, device=dev)
    back_k = torch.arange(1, BACK_CAP + 1, device=dev)[None, :]
    while True:
        scan = live & (ip < find_limit)
        tail = live & ~scan
        if tail.any():
            op = _emit_sequence(out, op, src, tail, anchor, n - anchor, zero, zero)
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
        ip = torch.where(miss, ip + (skip >> 6), ip)
        skip = torch.where(miss, skip + 1, skip)
        if not hit.any():
            continue

        # Forward extension up to len - 5, in growing windows.
        mlen = torch.where(hit, MIN_MATCH, 0)
        done = ~hit
        width = 64
        while not bool(done.all()):
            k = torch.arange(width, device=dev)[None, :]
            a = (ip + mlen)[:, None] + k
            b = (cand + mlen)[:, None] + k
            diff = (a >= match_limit[:, None]) | (src.gather(1, a.clamp(max=last))
                                                  != src.gather(1, b.clamp(0, last)))
            run = torch.where(diff.any(1), diff.to(torch.uint8).argmax(1), width)
            mlen = torch.where(done, mlen, mlen + run)
            done = done | (run < width)
            width = min(2 * width, 8192)
        mend = ip + mlen

        # Backward extension by at most min(ip - anchor, cand, 127) bytes.
        room = torch.minimum(ip - anchor, cand).clamp(0, BACK_CAP)
        a = (ip[:, None] - back_k).clamp(min=0)
        b = (cand[:, None] - back_k).clamp(min=0)
        diff = (back_k > room[:, None]) | (src.gather(1, a) != src.gather(1, b))
        back = torch.where(hit & diff.any(1), diff.to(torch.uint8).argmax(1),
                           torch.where(hit, BACK_CAP, 0))

        op = _emit_sequence(out, op, src, hit, anchor, ip - back - anchor,
                            mlen + back, ip - cand)
        seed = (mend - 2).clamp(min=0)
        h_seed = _hash(u32le(src, seed))
        table[rows_b[hit], h_seed[hit]] = seed[hit]
        ip = torch.where(hit, mend, ip)
        anchor = torch.where(hit, mend, anchor)
        skip = torch.where(hit, 64, skip)

    ok = op + 8 <= OUT_CAP
    result = (out[:, :OUT_CAP].contiguous(), op.clamp(max=OUT_CAP).to(torch.int32), ok)
    return result + (steps.to(torch.int32),) if with_steps else result
