"""A model of the LZO decode kernel's shared-memory ring and window, against
the plain version.

``csrc/lzo_decode.cu`` keeps each chunk's input in a ring (2 KB, 4 KB
beside the 32 KB window) that cp.async fills a 512-byte slice at a time,
all but two slices of the ring ahead, and its
recent output in a window from which matches read and which drains to
device memory in 16-byte units. A step moves at most window / 16 bytes: a
match piece and, with its last piece, the 0-3 trailing literals. Those
rules cannot run here, so this file models them in numpy, byte for byte and
in the kernel's order, and checks at every step what the kernel relies on:

- a ring byte is read only after its slice arrived and before a later
  slice reuses its place (command bytes, zero runs, literals);
- a match reads the window only for dist <= the reach, then only bytes the
  window still holds and never a slot the same step writes;
- a farther match reads device memory only where the byte was drained;
- a window slot is overwritten only after its byte was drained (or lies at
  or past out_cap, where nothing is stored);
- every byte below out_cap is stored to device memory exactly once, in
  ranges that start and end on 16-byte units of the row's address except
  at the row's two ends.

The model's results (out, out_lens, ok, steps) must equal ``decode_plain``
exactly (integer codec: tolerance 0) on the LZO cases, 64 KB text chunks,
``LZO_EDGE_BLOCKS`` and the hand-built window cases, at out_cap 65536, 4096
and 4093, with each row at its own misalignment; the hand-built blocks also
equal ``aircompressor_tpu.lzo.block_ref``. A skipped drain and a reach one
byte too long must break a rule. It also holds
``lzo_decode.distance_shares`` to a hand-built block.
"""

import numpy as np
import pytest
import torch

from aircompressor_tpu.errors import MalformedInputException
from aircompressor_tpu.lzo import block_ref
from aircompressor_tpu_torch.host import lzo as host_lzo
from aircompressor_tpu_torch.ops import lzo_decode
from aircompressor_tpu_torch.ops.batch import _pack, _selfcheck_payload, to_device_batch
from aircompressor_tpu_torch.ops.lzo_decode import WINDOWS, copy_reach, step_bytes
from chip_smoke import LZO_EDGE_BLOCKS, LzoBlock, lzo_cases, lzo_window_cases

SLICE = 512


def ring_bytes(window: int) -> int:
    return 4096 if window >= 32768 else 2048
MAX_OUT = 65536
LONG_RUN = 258


class Violation(AssertionError):
    """A rule of the kernel's ring or window was broken."""


def _check(cond, what):
    if not cond:
        raise Violation(what)


class ChunkModel:
    """One chunk through the kernel's rules, with a window of ``window``
    bytes; ``sr`` and ``so`` are the row's input and output addresses mod
    16. ``reach`` defaults to the kernel's window - window / 16; with
    ``skip_drain`` = n the n-th drain moves its mark without storing."""

    def __init__(self, row: np.ndarray, clen: int, out_cap: int, window: int,
                 sr: int, so: int, reach: int | None = None, skip_drain: int | None = None):
        self.row, self.clen, self.out_cap, self.window = row, clen, out_cap, window
        self.step_max = step_bytes(window)
        self.reach = copy_reach(window) if reach is None else reach
        self.skip_drain = skip_drain
        self.sr, self.so = sr, so
        self.readable = max(0, min(clen, row.size))
        self.in_end = sr + self.readable
        self.ring = ring_bytes(window)
        self.ahead = self.ring // SLICE - 2
        self.n_slices = -(-self.in_end // SLICE) if self.readable > 0 else 0
        self.ring_at = np.full(self.ring, -1, np.int64)  # ring coordinate each slot holds
        self.issued = self.ready = 0
        self.win_at = np.full(window, -1, np.int64)  # output position each slot holds
        self.win = np.zeros(window, np.uint8)
        self.mem = np.full(out_cap, -1, np.int16)  # device memory; -1: not stored
        self.op = self.flushed = 0
        self.drain_at = window // 2
        self.drains = self.far = self.near = self.pieces = self.scans = 0

    # ---- input ring
    def _issue(self):
        if self.issued < self.n_slices:
            lo = self.issued * SLICE
            p = np.arange(max(lo, self.sr), min(lo + SLICE, self.in_end))
            self.ring_at[p % self.ring] = -2  # in flight: neither old nor new
        self.issued += 1

    def need(self, end: int):
        while self.ready < self.n_slices and self.ready * SLICE < end:
            _check(self.issued == self.ready + self.ahead, "all but two slices in flight")
            lo = self.ready * SLICE
            p = np.arange(max(lo, self.sr), min(lo + SLICE, self.in_end))
            self.ring_at[p % self.ring] = p
            self.ready += 1
            self._issue()

    def ready_end(self) -> int:
        return 1 << 31 if self.ready >= self.n_slices else self.ready * SLICE

    def ring_bytes(self, at: int, n: int) -> np.ndarray:
        """Chunk bytes at..at+n-1 from the ring; they must be there."""
        p = np.arange(at, at + n) + self.sr
        _check((self.ring_at[p % self.ring] == p).all(), f"ring holds input {at}..{at + n}")
        return self.row[at:at + n]

    def read8(self, at: int) -> list[int]:
        self.need(min(at + self.sr + 8, self.in_end))
        n = max(0, min(8, self.readable - at))
        return [int(b) for b in self.ring_bytes(at, n)] + [0] * (8 - n)

    def zero_run_end(self, p: int) -> int:
        while True:
            self.need(min(p + self.sr + 32, self.in_end))
            n = max(0, min(32, self.readable - p))
            b = list(self.ring_bytes(p, n)) + [-1] * (32 - n)
            self.scans += 1
            hit = [k for k in range(32) if b[k] != 0]
            if hit:
                return -1 if b[hit[0]] < 0 else p + hit[0]
            p += 32

    # ---- output window and device memory
    def slot(self, pos):
        return (np.asarray(pos) + self.so) % self.window

    def write_window(self, pos: np.ndarray, vals: np.ndarray):
        old = self.win_at[self.slot(pos)]
        lost = (old >= 0) & (old < self.out_cap) & (old >= self.flushed) & (old != pos)
        _check(not lost.any(), "a window slot is overwritten before its byte drained")
        self.win_at[self.slot(pos)] = pos
        self.win[self.slot(pos)] = vals

    def store(self, a: int, b: int, zeros: bool = False):
        _check(a == 0 or (a + self.so) % 16 == 0, f"a store starts inside a unit at {a}")
        _check(b == self.out_cap or (b + self.so) % 16 == 0, f"a store ends inside a unit at {b}")
        pos = np.arange(a, b)
        _check((self.mem[pos] == -1).all(), "a byte is stored twice")
        if zeros:
            self.mem[pos] = 0
        else:
            _check((self.win_at[self.slot(pos)] == pos).all(), "a drained byte is in the window")
            self.mem[pos] = self.win[self.slot(pos)]

    def drain(self):
        if self.op >= self.drain_at:
            lim = (self.out_cap if self.op >= self.out_cap
                   else ((self.op + self.so) & ~15) - self.so)
            self.drains += 1
            if self.drains != self.skip_drain:
                self.store(self.flushed, lim)
            self.flushed = lim
            self.drain_at = lim + self.window // 2 if lim < self.out_cap else 1 << 31

    def step(self, dist: int, mlen: int, total: int, lit_at: int):
        """Bytes k < mlen repeat the byte dist back, the rest are input bytes
        from lit_at; all reads before all writes, then a drain."""
        _check(total <= self.step_max, "a step moves at most window / 16 bytes")
        k = np.arange(total)
        dst = self.op + k
        vals = np.zeros(total, np.uint8)
        live = np.ones(total, bool)
        if mlen:
            km = k[:mlen]
            if dist <= self.reach:
                src = self.op - dist + (km if dist >= mlen else km % dist)
                held = (self.win_at[self.slot(src)] == src) | (src >= self.out_cap)
                _check(held.all(), "a match's source is in the window")
                _check(not np.isin(self.slot(src), self.slot(dst)).any(),
                       "a step reads a slot it writes")
                vals[:mlen] = self.win[self.slot(src)]
                self.near += 1
            else:
                live[:mlen] = dst[:mlen] < self.out_cap
                src = dst[:mlen][live[:mlen]] - dist
                _check((self.mem[src] >= 0).all(), "a far match's source was drained")
                vals[:mlen][live[:mlen]] = self.mem[src].astype(np.uint8)
                self.far += 1
        if total > mlen:
            vals[mlen:] = self.ring_bytes(lit_at, total - mlen)
        self.write_window(dst[live], vals[live])
        self.op += total
        self.drain()

    def literals(self, frm: int, n: int):
        while n > 0:
            p = frm + self.sr
            self.need(p + 1)
            piece = min(n, self.step_max, self.ready_end() - p)
            self.step(0, 0, piece, frm)
            self.pieces += 1
            frm, n = frm + piece, n - piece

    # ---- the kernel's loop
    def run(self):
        for _ in range(self.ahead):
            self._issue()
        clen, sr = self.clen, self.sr
        err = clen <= 0 or clen > self.row.size
        done = False
        ip = state = count = 0
        b = self.read8(0)
        if not err and b[0] > 17:
            n = b[0] - 17
            err = 1 + n > clen
            if not err:
                self.literals(1, n)
                ip, state = 1 + n, min(n, 4)
                b = self.read8(ip)
        while not err:
            count += 1
            if ip >= clen:
                err = True
                break
            t = b[0]
            if t < 16 and state == 0:
                length, frm = t + 3, ip + 1
                if t == 0:
                    z = self.zero_run_end(ip + 1)
                    if z < 0:
                        err = True
                        break
                    length = 255 * min(z - ip - 1, LONG_RUN) + int(self.ring_bytes(z, 1)[0]) + 18
                    frm = z + 1
                err = length > clen - frm or self.op + length > MAX_OUT
                if err:
                    break
                self.literals(frm, length)
                ip, state = frm + length, 4
                b = self.read8(ip)
                continue
            if t < 16 or t >= 64:
                end, trailing = ip + 2, t & 3
                if t >= 64:
                    length, dist = (t >> 5) + 1, ((t >> 2) & 7) + (b[1] << 3) + 1
                else:
                    length = 2 if state < 4 else 3
                    dist = (t >> 2) + (b[1] << 2) + (1 if state < 4 else 2049)
            else:
                m4 = t < 32
                low = t & 7 if m4 else t & 31
                word, wat, length = b[1] | (b[2] << 8), ip + 1, low + 2
                if low == 0:
                    z = self.zero_run_end(ip + 1)
                    if z < 0:
                        err = True
                        break
                    length = (255 * min(z - ip - 1, LONG_RUN) + int(self.ring_bytes(z, 1)[0])
                              + (9 if m4 else 33))
                    wat = z + 1
                    w = self.read8(wat)
                    word = w[0] | (w[1] << 8)
                end, trailing = wat + 2, word & 3
                dist = 16384 + ((t & 8) << 11) + (word >> 2) if m4 else (word >> 2) + 1
                if m4 and dist == 16384 and end <= clen:
                    done = True
                    break
            err = end > clen or dist > self.op or self.op + length > MAX_OUT
            if err:
                break
            tail_err = trailing and (end + trailing > clen or self.op + length + trailing > MAX_OUT)
            tail = 0 if tail_err else trailing
            ip = end + tail
            b = self.read8(ip)
            rem = length
            while True:
                piece = min(rem, self.step_max - tail)
                rem -= piece
                self.step(dist, piece, piece + (tail if rem == 0 else 0), end)
                if rem == 0:
                    break
            err = bool(tail_err)
            state = trailing
        op = self.op
        if op < self.out_cap:
            unit_end = min(((op + self.so + 15) & ~15) - self.so, self.out_cap)
            self.write_window(np.arange(op, unit_end), 0)
            self.store(self.flushed, unit_end)
            self.store(unit_end, self.out_cap, zeros=True)
        elif self.flushed < self.out_cap:
            self.store(self.flushed, self.out_cap)
        _check((self.mem >= 0).all(), "every byte below out_cap is stored")
        return self.mem.astype(np.uint8), op, not err and done, count


def model_decode(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int, window: int):
    """The model over a batch laid out as the kernel sees it (rows of a
    256-byte aligned tensor), and its counters summed over the rows."""
    B, cap = comp.shape
    rows = [ChunkModel(comp[i].numpy(), int(comp_lens[i]), out_cap, window,
                       (i * cap) % 16, (i * out_cap) % 16) for i in range(B)]
    res = [m.run() for m in rows]
    counts = {k: sum(getattr(m, k) for m in rows)
              for k in ("drains", "far", "near", "pieces", "scans")}
    lens = torch.tensor([r[1] for r in res], dtype=torch.int32)
    return (torch.from_numpy(np.stack([r[0] for r in res])), lens,
            torch.tensor([r[2] for r in res], dtype=torch.bool) & (lens <= out_cap),
            torch.tensor([r[3] for r in res], dtype=torch.int32)), counts


def _blobs() -> list[bytes]:
    """The kernel's checks: the LZO cases and 64 KB text chunks through the
    host encoder, the edge blocks, the hand-built window cases."""
    raws = lzo_cases() + [_selfcheck_payload(s) for s in (1, 2)]
    return ([host_lzo.compress(r) for r in raws] + [b for b, _, _ in LZO_EDGE_BLOCKS]
            + [b for _, b in lzo_window_cases()])


BLOBS = _blobs()


@pytest.fixture(scope="module")
def batch():
    cap = max(map(len, BLOBS)) + 3  # an odd row length: every row's own alignment
    return to_device_batch(*_pack(BLOBS, cap), "cpu")


@pytest.fixture(scope="module")
def plain(batch):
    comp, lens = batch
    return {out_cap: lzo_decode.decode_plain(comp, lens, out_cap=out_cap, with_steps=True)
            for out_cap in (65536, 4096, 4093)}


@pytest.mark.parametrize("out_cap, window", [
    (65536, WINDOWS[0]), (65536, WINDOWS[1]),
    (4096, WINDOWS[0]), (4093, WINDOWS[0]), (4093, WINDOWS[1])])
def test_model_equals_decode_plain(batch, plain, out_cap, window):
    comp, lens = batch
    got, counts = model_decode(comp, lens, out_cap, window)
    for name, g, w in zip(("out", "out_lens", "ok", "steps"), got, plain[out_cap]):
        assert torch.equal(g, w), name
    assert counts["far"] > 0 and counts["near"] > 0 and counts["scans"] > 0
    assert counts["drains"] > 0 and counts["pieces"] > 0


def test_the_hand_built_blocks_equal_block_ref(plain):
    """The window cases decode as the JAX package's reference decoder has
    them, and are rejected where it rejects them."""
    out, out_lens, ok, _ = plain[65536]
    first = len(BLOBS) - len(lzo_window_cases())
    for i, (name, blob) in enumerate(lzo_window_cases(), first):
        dst = np.zeros(65536, np.uint8)
        try:
            want = dst[:block_ref.decompress(np.frombuffer(blob, np.uint8), dst)].tobytes()
        except MalformedInputException:
            assert not ok[i], name
            continue
        assert ok[i] and out_lens[i] == len(want), name
        assert out[i, :len(want)].numpy().tobytes() == want, name


def test_the_window_cases_take_both_paths():
    """The reach cases put matches on each side of each window's reach, in
    pieces of up to window / 16 bytes; the 64 KB literal streams through the
    ring in pieces; the 300-byte zero runs take ten ballots each."""
    cases = dict(lzo_window_cases())
    for window in WINDOWS:
        blob = cases[f"reach-{window}"]
        comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
        (_, _, ok, _), counts = model_decode(comp, lens, 65536, window)
        step = step_bytes(window)
        # dists reach - 1 and reach read the window, reach + 1 device memory:
        # lengths 9, 2 * step + 17 and step, in 1, 3 and 1 or 2 pieces
        assert ok.all() and counts["near"] >= 2 * 5 and counts["far"] >= 5
    blob = cases["literal-64k"]
    comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
    _, counts = model_decode(comp, lens, 65536, WINDOWS[0])
    assert counts["pieces"] >= 65536 // step_bytes(WINDOWS[0])
    assert counts["drains"] >= 65536 // 2048 - 1
    blob = cases["stop-zero-run-300"]
    comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
    (_, _, ok, _), counts = model_decode(comp, lens, 65536, WINDOWS[1])
    assert ok.all() and counts["scans"] == 10


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("reach, skip_drain, what", [
    (1, None, "a step reads a slot it writes"),
    (0, 1, "a far match's source was drained")])
def test_a_broken_rule_is_caught(window, reach, skip_drain, what):
    """The checks bite: a reach one byte too long lets a full step at dist
    reach + 1 read a slot it writes, and a skipped drain leaves a far match's
    source (and the row) unstored."""
    blob = dict(lzo_window_cases())[f"reach-{window}"]
    comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
    model = ChunkModel(comp[0].numpy(), int(lens[0]), 65536, window, 0, 0,
                       copy_reach(window) + reach, skip_drain)
    with pytest.raises(Violation, match=what):
        model.run()


def test_distance_shares_of_a_hand_built_block():
    """Matches at dists 1, 100, and each reach and reach + 1, after a
    literal run long enough for all of them, then one from before the
    start: bad, not counted."""
    reach4, reach32 = map(copy_reach, WINDOWS)
    blk = LzoBlock(7).literals(40000)
    dists = [(1, 4), (100, 10), (reach4, 20), (reach4 + 1, 30), (reach32, 40), (reach32 + 1, 64)]
    for dist, length in dists:
        blk.match("M3" if dist <= 16384 else "M4", length, dist, 1)
    blob = blk.stop()[:-3] + b"\x1f\xfc\xff" + blk.stop()[-3:]  # M4 at dist 49151 > op
    comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
    got = lzo_decode.distance_shares(comp, lens, (reach4, reach32))
    assert got["matches"] == 6 and got["match_bytes"] == 168
    assert got["within"][reach4] == {"matches": 3 / 6, "bytes": 34 / 168}
    assert got["within"][reach32] == {"matches": 5 / 6, "bytes": 104 / 168}
