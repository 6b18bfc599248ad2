"""A model of the deflate decode kernel's shared-memory staging, against the
plain version.

``csrc/deflate_decode.cu`` keeps, for each chunk, its current block's
tables in a slot of ``SLOT`` entries (filled at each Huffman block from the
lower root; a block whose roots do not both fit reads device memory, and so
does a subtable entry past the slot), its input in a ring that cp.async
fills a quarter at a time, two quarters ahead (restarted at each Huffman
block), and its recent output in a window from which near copies read and
which drains to device memory in 16-byte units. Those rules cannot run
here, so this file models them in numpy and plain Python, symbol by symbol
and in the kernel's order, and checks at every step what the kernel relies
on:

- a ring byte is read only after its quarter arrived and before a later
  quarter reuses its slot; bytes at or past the chunk's length read as 0;
- a root lookup from the slot lies inside it;
- a copy reads the window only for dist <= window - 258, and then only
  bytes the window still holds, never a slot the same copy writes;
- a farther copy reads device memory only where the byte was drained;
- a window slot is overwritten only after its byte was drained (or lies at
  or past out_cap);
- every byte below out_cap is stored exactly once, in ranges that start
  and end on 16-byte units of the row's address except at the row's ends.

The model's results (out, out_lens, ok, steps) must equal ``decode_plain``
exactly (integer codec: tolerance 0) on ``chip_smoke.deflate_window_cases``
(copies at each window's reach and one either side, a 64 KB all-literal
block, a stored block between Huffman blocks), the 65-block full-flush
chunk, ``chip_smoke.deflate_slot_cases`` (tables past the slot) and a 64 KB
text chunk at level 6, under both windows, at out_cap 65536 and 4093. A
model with a window reach one byte longer, or a drain that waits for a full
window, must break a rule. It also holds ``deflate_decode.distance_shares``
to the reach case.
"""

import numpy as np
import pytest
import torch

from aircompressor_tpu_torch.host.deflate import plan as deflate_plan
from aircompressor_tpu_torch.ops import deflate_decode
from aircompressor_tpu_torch.ops.batch import _pack, _selfcheck_payload, deflate_raw, to_device_batch
from aircompressor_tpu_torch.ops.deflate_decode import SLOT, WINDOWS, copy_reach
from chip_smoke import deflate_full_flush, deflate_slot_cases, deflate_window_cases

MAX_OUT = 65536
RINGS = {WINDOWS[0]: 512, WINDOWS[1]: 2048}  # the ring beside each window
OP_LIT, OP_LEN, OP_DIST, OP_EOB, OP_SUB = 1, 2, 3, 4, 5
M64 = (1 << 64) - 1


class Violation(AssertionError):
    """A rule of the kernel's staging was broken."""


def _check(cond, what):
    if not cond:
        raise Violation(what)


def flush_at(window: int) -> int:
    """The kernel's kFlush: bytes waiting that start a drain."""
    return window // 2 if window >= 4096 else window // 4


class ChunkModel:
    """One chunk through the kernel's rules; ``sr`` and ``so`` are the row's
    input and output addresses mod 16. ``reach`` and ``flush`` default to
    the kernel's window - 258 and kFlush."""

    def __init__(self, row, clen, blocks, tab, out_cap, window, sr, so,
                 reach=None, flush=None):
        self.row, self.clen, self.blocks, self.tab = row, clen, blocks, tab
        self.out_cap, self.window, self.sr, self.so = out_cap, window, sr, so
        self.reach = copy_reach(window) if reach is None else reach
        self.flush = flush_at(window) if flush is None else flush
        self.ring_size = RINGS[window]
        self.quarter = self.ring_size // 4
        self.in_end = sr + max(0, min(clen, row.size))
        self.ring_at = [-1] * self.ring_size  # ring coordinate each slot holds
        self.ring_val = [0] * self.ring_size
        self.issued = self.ready = 0
        self.win_at = [-1] * window  # output position each window slot holds
        self.win = [0] * window
        self.mem = [-1] * out_cap  # device memory; -1: not stored
        self.op = self.flushed = 0
        self.slot_lo, self.slot = None, None
        self.counts = dict(drains=0, far_copies=0, window_copies=0, slot_blocks=0,
                           device_blocks=0, sub_outside=0, stored=0, resets=0)

    # ---- input ring
    def _issue(self):
        q0 = self.issued * self.quarter
        for p in range(q0, q0 + self.quarter):
            s = p % self.ring_size
            self.ring_at[s] = -2  # in flight
            self.ring_val[s] = int(self.row[p - self.sr]) if self.sr <= p < self.in_end else 0
        self.issued += 1

    def _need(self, end):
        while self.ready * self.quarter < end:
            _check(self.issued == self.ready + 2, "two quarters in flight")
            q0 = self.ready * self.quarter
            for p in range(q0, q0 + self.quarter):
                self.ring_at[p % self.ring_size] = p
            self.ready += 1
            self._issue()

    def _reset(self, p0):
        self.ring_at = [-1] * self.ring_size  # cp.async.wait_all, then a new start
        self.issued = self.ready = p0 // self.quarter
        self._issue()
        self._issue()
        self.counts["resets"] += 1

    def _read64(self, p):
        r = self.ring_size
        # quarters fill whole: the two ends of the 8 bytes vouch for the middle
        _check(self.ring_at[p % r] == p and self.ring_at[(p + 7) % r] == p + 7,
               f"the ring holds bytes {p - self.sr}..{p - self.sr + 7}")
        return int.from_bytes(bytes(self.ring_val[(p + i) % r] for i in range(8)), "little")

    # ---- tables
    def _entry(self, i):
        return int(self.tab[i]) if 0 <= i < self.tab.size else 0

    # ---- output window and device memory
    def _write(self, pos, val):
        s = (pos + self.so) % self.window
        old = self.win_at[s]
        _check(not (0 <= old < self.out_cap and old >= self.flushed and old != pos),
               "a window slot is overwritten before its byte drained")
        self.win_at[s] = pos
        self.win[s] = val

    def _store(self, a, b, zeros=False):
        _check(a == 0 or (a + self.so) % 16 == 0, f"a store starts inside a unit at {a}")
        _check(b == self.out_cap or (b + self.so) % 16 == 0, f"a store ends inside a unit at {b}")
        for pos in range(a, b):
            _check(self.mem[pos] == -1, "a byte is stored twice")
            if zeros:
                self.mem[pos] = 0
            else:
                s = (pos + self.so) % self.window
                _check(self.win_at[s] == pos, "a drained byte is in the window")
                self.mem[pos] = self.win[s]

    def _drain(self):
        if self.flushed < self.out_cap and self.op - self.flushed >= self.flush:
            lim = (self.out_cap if self.op >= self.out_cap
                   else ((self.op + self.so) & ~15) - self.so)
            self._store(self.flushed, lim)
            self.flushed = lim
            self.counts["drains"] += 1

    def _copy(self, length, dist):
        while length > 0:
            piece = min(length, 258)
            op = self.op
            if dist <= self.reach:
                src = [op - dist + (k % dist if dist < piece else k) for k in range(piece)]
                dst_slots = {(op + k + self.so) % self.window for k in range(piece)}
                for s in src:
                    _check(self.win_at[(s + self.so) % self.window] == s or s >= self.out_cap,
                           "a copy's source is in the window")
                    _check((s + self.so) % self.window not in dst_slots,
                           "a copy reads a slot it writes")
                vals = [self.win[(s + self.so) % self.window] for s in src]
                for k in range(piece):
                    self._write(op + k, vals[k])
                self.counts["window_copies"] += 1
            else:
                for k in range(piece):
                    if op + k < self.out_cap:
                        _check(self.mem[op + k - dist] >= 0, "a far copy's source was drained")
                        self._write(op + k, self.mem[op + k - dist])
                self.counts["far_copies"] += 1
            self.op += piece
            length -= piece
            self._drain()

    # ---- one Huffman block
    def _huffman(self, d1, ll_root, d_root, last):
        lo = min(ll_root, d_root)
        in_slot = max(ll_root, d_root) + 512 <= lo + SLOT
        if in_slot:
            self.counts["slot_blocks"] += 1
            if lo != self.slot_lo:
                self.slot = [self._entry(lo + i) for i in range(SLOT)]
                self.slot_lo = lo
        else:
            self.counts["device_blocks"] += 1

        def root_entry(root, bits):
            if in_slot:
                i = root - lo + bits
                _check(0 <= i < SLOT, "a root lookup lies in the slot")
                return self.slot[i]
            return self._entry(root + bits)

        def resolve(e, bits):
            if e >> 28 == OP_SUB:
                sbits = min((e >> 22) & 63, 6)
                i = (e & 0x3FFFFF) + ((bits >> 9) & ((1 << sbits) - 1))
                if in_slot and 0 <= i - lo < SLOT:
                    e = self.slot[i - lo]
                else:
                    self.counts["sub_outside"] += in_slot
                    e = self._entry(i)
            nbits = (e >> 22) & 63
            return 0 if (e >> 28 == 0 or nbits == 0 or nbits > 15) else e

        bytepos = (d1 >> 3) + self.sr
        self._reset(bytepos)
        buf = nbuf = 0

        def refill():
            nonlocal buf, nbuf, bytepos
            self._need(bytepos + 8)
            buf = (buf | (self._read64(bytepos) << nbuf)) & M64
            bytepos += (63 - nbuf) >> 3
            nbuf |= 56

        refill()
        buf >>= d1 & 7
        nbuf -= d1 & 7
        avail = 8 * self.clen - d1
        err = done = False
        while True:
            self.count += 1
            e = resolve(root_entry(ll_root, buf & 511), buf)
            if nbuf < 32:  # beside the lookup, which needs 15 bits
                refill()
            op_sym, val, nb = e >> 28, e & 0x3FFFFF, (e >> 22) & 63
            buf >>= nb
            nbuf -= nb
            avail -= nb
            if op_sym == OP_LIT:
                err = avail < 0 or self.op + 1 > MAX_OUT
                if err:
                    break
                if self.op < self.out_cap:
                    self._write(self.op, val & 255)
                self.op += 1
                self._drain()
                continue
            if op_sym == OP_EOB:
                err, done = avail < 0, last
                break
            err = op_sym != OP_LEN
            if err:
                break
            lx = (val >> 9) & 15
            length = (val & 511) + (buf & ((1 << lx) - 1))
            buf >>= lx
            nbuf -= lx
            avail -= lx
            err = avail < 0
            if err:
                break
            refill()
            de = resolve(root_entry(d_root, buf & 511), buf)
            err = de >> 28 != OP_DIST
            if err:
                break
            dval, dnb = de & 0x3FFFFF, (de >> 22) & 63
            dx = (dval >> 16) & 15
            buf >>= dnb
            dist = (dval & 0xFFFF) + (buf & ((1 << dx) - 1))
            buf >>= dx
            nbuf -= dnb + dx
            avail -= dnb + dx
            err = avail < 0 or dist <= 0 or dist > self.op or self.op + length > MAX_OUT
            if err:
                break
            refill()
            self._copy(length, dist)
        return err, done

    # ---- the kernel's block loop
    def run(self):
        self.count = 0
        clen = self.clen
        err = clen <= 0 or clen > self.row.size
        done = False
        blk = 0
        while not err and not done:
            if blk >= len(self.blocks):
                err = True
                break
            d = self.blocks[blk]
            blk += 1
            last = d[6] != 0
            if d[0] == 0:
                frm, n = d[4], d[5]
                err = frm < 0 or n < 0 or frm > clen - n or self.op + n > MAX_OUT
                if err:
                    break
                piece = self.window - self.flush
                for at in range(0, n, piece):
                    k = min(n - at, piece)
                    for j in range(k):
                        if self.op + j < self.out_cap:
                            self._write(self.op + j, int(self.row[frm + at + j]))
                    self.op += k
                    self._drain()
                self.counts["stored"] += 1
                done = last
                continue
            if d[1] < 0:
                err = True
                break
            if d[1] >= 8 * clen:
                self.count += 1
                err = True
                break
            err, done = self._huffman(d[1], d[2], d[3], last)
        op = self.op
        if op < self.out_cap:
            unit_end = min(((op + self.so + 15) & ~15) - self.so, self.out_cap)
            for p in range(op, unit_end):
                self._write(p, 0)
            self._store(self.flushed, unit_end)
            self._store(unit_end, self.out_cap, zeros=True)
        elif self.flushed < self.out_cap:
            self._store(self.flushed, self.out_cap)
        _check(min(self.mem) >= 0, "every byte below out_cap is stored")
        return np.array(self.mem, np.uint8), op, not err and done, self.count


def model_decode(comp, comp_lens, plan, out_cap, window, **kw):
    """The model over a batch laid out as the kernel sees it, and its
    counters summed over the rows."""
    B, cap = comp.shape
    res, counts = [], {}
    for i in range(B):
        s0, nb, t0, nt = (int(v) for v in plan.index[i])
        m = ChunkModel(comp[i].numpy(), int(comp_lens[i]), plan.desc[s0:s0 + nb].tolist(),
                       plan.tabs[t0:t0 + nt].numpy(), out_cap, window,
                       (i * cap) % 16, (i * out_cap) % 16, **kw)
        res.append(m.run())
        for k, v in m.counts.items():
            counts[k] = counts.get(k, 0) + v
    out = torch.from_numpy(np.stack([r[0] for r in res]))
    lens = torch.tensor([r[1] for r in res], dtype=torch.int32)
    ok = torch.tensor([r[2] for r in res]) & (lens <= out_cap)
    return (out, lens, ok, torch.tensor([r[3] for r in res], dtype=torch.int32)), counts


CASES = (deflate_window_cases()
         + [("full-flush", deflate_full_flush(_selfcheck_payload(3)))]
         + deflate_slot_cases()
         + [("text", deflate_raw(_selfcheck_payload(5)))])


@pytest.fixture(scope="module")
def batch():
    blobs = [b for _, b in CASES]
    cap = max(map(len, blobs)) + 3  # an odd row length: every row's own alignment
    buf, lens = _pack(blobs, cap)
    plan = deflate_plan.plan(buf, lens)
    assert (plan.info[:, 3] == deflate_plan.ST_OK).all()
    comp, comp_lens = to_device_batch(buf, lens, "cpu")
    return comp, comp_lens, deflate_decode.upload(plan, "cpu")


@pytest.mark.parametrize("out_cap, window", [(65536, WINDOWS[0]), (4093, WINDOWS[1])])
def test_model_equals_decode_plain(batch, out_cap, window):
    comp, lens, plan = batch
    got, counts = model_decode(comp, lens, plan, out_cap, window)
    want = deflate_decode.decode_plain(comp, lens, plan, out_cap=out_cap, with_steps=True)
    for name, g, w in zip(("out", "out_lens", "ok", "steps"), got, want):
        assert torch.equal(g, w), name
    assert bool(want[2].all()) or out_cap < MAX_OUT
    assert counts["far_copies"] > 0 and counts["window_copies"] > 0 and counts["drains"] > 0
    assert counts["device_blocks"] == 1 and counts["sub_outside"] > 0
    assert counts["stored"] > 32 and counts["slot_blocks"] > 30  # full flushes add stored ones


def test_the_reach_case_takes_both_paths():
    """At each window the copies at reach - 1 and reach read the window and
    the one past it device memory, for lengths 258 and 3."""
    blob = dict(CASES)["reach"]
    buf, lens = _pack([blob], len(blob))
    plan = deflate_decode.upload(deflate_plan.plan(buf, lens), "cpu")
    comp, comp_lens = to_device_batch(buf, lens, "cpu")
    small, large = WINDOWS
    for window, near in ((small, 3 + 4), (large, 3 + 6 + 4)):
        _, counts = model_decode(comp, comp_lens, plan, MAX_OUT, window)
        # the overlapping copies (dists 1, 3, 7) and the copies up to the
        # reach in the window; the rest, 32768 included, from device memory
        assert counts["window_copies"] == near
        assert counts["far_copies"] == 16 - near


@pytest.mark.parametrize("reach, flush, what", [
    (copy_reach(WINDOWS[0]) + 1, None, "a copy reads a slot it writes"),
    (None, WINDOWS[0], "a window slot is overwritten before its byte drained")])
def test_a_broken_rule_is_caught(reach, flush, what):
    """The checks bite: a window read one byte farther, or a drain that
    waits for a full window, breaks a rule the model names."""
    blob = dict(CASES)["reach"]
    buf, lens = _pack([blob], len(blob))
    plan = deflate_plan.plan(buf, lens)
    s0, nb, t0, nt = plan.index[0]
    model = ChunkModel(buf[0], int(lens[0]), plan.desc[s0:s0 + nb].tolist(),
                       plan.tabs[t0:t0 + nt], MAX_OUT, WINDOWS[0], 0, 0, reach, flush)
    with pytest.raises(Violation, match=what):
        model.run()


def test_distance_shares_of_the_reach_case():
    blob = dict(CASES)["reach"]
    buf, lens = _pack([blob], len(blob))
    plan = deflate_decode.upload(deflate_plan.plan(buf, lens), "cpu")
    comp, comp_lens = to_device_batch(buf, lens, "cpu")
    got = deflate_decode.distance_shares(comp, comp_lens, plan)
    # 3 overlapping, 6 at each reach (258 and 3 bytes), 1 at 32768
    assert got["copies"] == 16 and got["copy_bytes"] == 616 + 6 * 261 + 258
    r0, r1 = map(copy_reach, WINDOWS)
    assert got["within"][r0]["copies"] == 7 / 16
    assert got["within"][r1]["copies"] == 13 / 16
