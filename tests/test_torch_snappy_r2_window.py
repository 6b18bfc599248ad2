"""A model of the r2 Snappy decode kernel's shared-memory ring and window,
against the plain version.

``csrc/snappy_decode_r2.cu`` keeps the r2 loop (one window of at most 128
bytes an iteration, a copy taking at most ``dist`` bytes, ``dist`` doubling
after a window of exactly ``dist``) and lays it over
``csrc/decode_window.cuh``: each chunk's input in a ring (2 KB, 4 KB beside
the 32 KB window) that cp.async fills a 512-byte slice at a time, all but two
slices of the ring ahead of the one being read, and its recent output in a
window from which copies read and which drains to device memory in 16-byte
units. Those rules cannot run here, so this file models them in numpy, byte
for byte and in the kernel's order, and checks at every window what the
kernel relies on:

- a ring byte (a token's header or a literal's bytes) is read only after its
  slice arrived and before a later slice reuses its place;
- a copy reads the window only for dist <= the reach (window - window / 16,
  the header's rule: no step of up to window / 16 bytes from op writes its
  source's slot), and only bytes the window still holds;
- a farther copy reads device memory only where the byte was drained;
- a window slot is overwritten only after its byte was drained (or lies at
  or past out_cap, where nothing is stored);
- every byte below out_cap is stored exactly once, in ranges that start and
  end on 16-byte units of the row's address except at the row's two ends.

The model's (out, out_lens, ok, steps) must equal ``decode_plain(...,
with_steps=True)`` exactly (integer codec: tolerance 0) on the synthetic,
malformed, F10 and hand-built window cases and 64 KB text chunks, at both
windows and out_cap 65536, 4096 and 4093, with each row at its own
misalignment; the hand-built blocks also equal the host decoder and the
JAX package's ``SnappyRefDecompressor`` and ``snappy_jax.decode``. A skipped
drain, a reach one byte too long and a ring slice reused too early must
break a rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aircompressor_tpu.errors import MalformedInputException as JaxMalformed
from aircompressor_tpu.ops import snappy_jax
from aircompressor_tpu.snappy import SnappyRefDecompressor
from aircompressor_tpu_torch.errors import MalformedInputException
from aircompressor_tpu_torch.host import snappy as host_snappy
from aircompressor_tpu_torch.ops import snappy_decode_r2
from aircompressor_tpu_torch.ops.batch import _pack, _selfcheck_payload, to_device_batch
from aircompressor_tpu_torch.ops.snappy_decode_r2 import WINDOWS, copy_reach
from chip_smoke import R2_MALFORMED, malformed_cases, r2_window_cases, synthetic_cases

SLICE = 512
MAX_OUT = 65536
BLOCK = 128


def ring_size(window: int) -> int:
    return 4096 if window >= 32768 else 2048


class Violation(AssertionError):
    """A rule of the kernel's ring or window was broken."""


def _check(cond, what):
    if not cond:
        raise Violation(what)


def _i32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


class ChunkModel:
    """One chunk through the kernel's rules, with a window of ``window``
    bytes; ``sr`` and ``so`` are the row's input and output addresses mod
    16. ``reach`` defaults to the kernel's window - window / 16; with
    ``skip_drain`` = n the n-th drain moves its mark without storing; with
    ``early`` one slice more is in flight than the ring's places allow."""

    def __init__(self, row: np.ndarray, clen: int, out_cap: int, window: int,
                 sr: int, so: int, reach: int | None = None, skip_drain: int | None = None,
                 early: bool = False):
        self.row, self.clen, self.out_cap, self.window = row, clen, out_cap, window
        self.reach = copy_reach(window) if reach is None else reach
        self.skip_drain, self.early = skip_drain, early
        self.sr, self.so = sr, so
        self.readable = max(0, min(clen, row.size))
        self.in_end = sr + self.readable
        self.ring = ring_size(window)
        self.ahead = self.ring // SLICE - 2
        self.n_slices = -(-self.in_end // SLICE) if self.readable > 0 else 0
        self.ring_at = np.full(self.ring, -1, np.int64)  # ring coordinate each slot holds
        self.issued = self.ready = sr // SLICE if self.readable > 0 else 0
        self.win_at = np.full(window, -1, np.int64)  # output position each slot holds
        self.win = np.zeros(window, np.uint8)
        self.mem = np.full(out_cap, -1, np.int16)  # device memory; -1: not stored
        self.op = self.flushed = 0
        self.drain_at = window // 2
        self.counts = dict(drains=0, far=0, near=0, literal=0, headers=0, waits=0)

    # ---- input ring
    def _issue(self):
        if self.issued < self.n_slices:
            lo = self.issued * SLICE
            p = np.arange(max(lo, self.sr), min(lo + SLICE, self.in_end))
            self.ring_at[p % self.ring] = -2  # in flight: neither old nor new
        self.issued += 1

    def need(self, end: int):
        while self.ready < self.n_slices and self.ready * SLICE < end:
            lo = self.ready * SLICE
            p = np.arange(max(lo, self.sr), min(lo + SLICE, self.in_end))
            self.ring_at[p % self.ring] = p
            self.ready += 1
            self.counts["waits"] += 1
            self._issue()

    def ring_read(self, at: np.ndarray) -> np.ndarray:
        """Chunk bytes at the positions ``at``, from the ring; they must be
        there."""
        p = np.asarray(at) + self.sr
        _check((self.ring_at[p % self.ring] == p).all(), "the ring holds the input read")
        return self.row[np.asarray(at)]

    def read8(self, at: int) -> int:
        self.need(min(at + self.sr + 8, self.in_end))
        n = max(0, min(8, self.readable - at))
        return int.from_bytes(self.ring_read(np.arange(at, at + n)).tobytes(), "little")

    # ---- output window and device memory
    def slot(self, pos):
        return (np.asarray(pos) + self.so) % self.window

    def write_window(self, pos: np.ndarray, vals):
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
            self.counts["drains"] += 1
            if self.counts["drains"] != self.skip_drain:
                self.store(self.flushed, lim)
            self.flushed = lim
            self.drain_at = lim + self.window // 2 if lim < self.out_cap else 1 << 31

    def emit(self, take: int, literal: bool, frm: int, dist: int):
        """One window: take bytes from op, a literal's from the ring at frm,
        a copy's from dist back; all reads before all writes, then a drain."""
        op = self.op
        dst = op + np.arange(take)
        live = np.ones(take, bool)
        if literal:
            self.need(frm + take + self.sr)
            vals = self.ring_read(np.arange(frm, frm + take))
            self.counts["literal"] += 1
        elif dist <= self.reach:
            src = dst - dist
            _check(src.min() >= op + self.window // 16 - self.window,
                   "a window copy's source lies where no step of window / 16 bytes writes")
            held = (self.win_at[self.slot(src)] == src) | (src >= self.out_cap)
            _check(held.all(), "a copy's source is in the window")
            vals = self.win[self.slot(src)]
            self.counts["near"] += 1
        else:
            live = dst < self.out_cap
            src = dst[live] - dist
            _check((self.mem[src] >= 0).all(), "a far copy's source was drained")
            vals = np.zeros(take, np.uint8)
            vals[live] = self.mem[src].astype(np.uint8)
            self.counts["far"] += 1
        self.write_window(dst[live], vals[live])
        self.op += take
        self.drain()

    # ---- the kernel's loop
    def run(self):
        for _ in range(self.ahead + self.early):
            self._issue()
        clen = self.clen
        head = self.read8(0)
        varint, vlen, more = head & 0x7F, 1, True
        for k in range(1, 5):
            b = (head >> (8 * k)) & 0xFF
            more = more and ((head >> (8 * (k - 1))) & 0xFF) >= 128
            if more:
                varint |= (b & 0x7F) << (7 * k)
                vlen += 1
        declared = _i32(varint)
        err = declared > MAX_OUT or vlen > clen or clen > self.row.size
        ip, rem, frm, dist, literal, count = vlen, 0, 0, 0, False, 0
        while not err and (rem > 0 or ip < clen):
            count += 1
            if rem == 0:
                h = self.read8(ip)
                self.counts["headers"] += 1
                tag, word = h & 0xFF, (h >> 8) & 0xFFFFFFFF
                kind, n = tag & 3, tag >> 2
                literal = kind == 0
                if literal:
                    extra = min(max(n - 59, 0), 4)
                    length = (word & ((1 << (8 * extra)) - 1) if extra else n) + 1
                    tok = 1 + extra
                    err = (length > MAX_OUT or ip + tok + length > clen
                           or self.op + length > declared)
                    frm = ip + tok
                else:
                    tok = (2, 3, 5)[kind - 1]
                    length = 4 + (n & 7) if kind == 1 else n + 1
                    d = (((tag >> 5) << 8) | (word & 0xFF) if kind == 1
                         else word & 0xFFFF if kind == 2 else word)
                    err = ip + tok > clen or self.op + length > declared or not 0 < d <= self.op
                    dist = d
                if err:
                    break
                rem = length
                ip += tok + (rem if literal else 0)
            o = self.op & (BLOCK - 1)
            take = min(rem, BLOCK - o, BLOCK if literal else dist)
            self.emit(take, literal, frm, dist)
            if literal:
                frm += take
            elif take == dist:
                dist = min(2 * dist, MAX_OUT)
            rem -= take
        op = self.op
        if op < self.out_cap:
            unit_end = min(((op + self.so + 15) & ~15) - self.so, self.out_cap)
            self.write_window(np.arange(op, unit_end), 0)
            self.store(self.flushed, unit_end)
            self.store(unit_end, self.out_cap, zeros=True)
        elif self.flushed < self.out_cap:
            self.store(self.flushed, self.out_cap)
        _check((self.mem >= 0).all(), "every byte below out_cap is stored")
        return self.mem.astype(np.uint8), op, not err and op == declared, count


def model_decode(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int, window: int,
                 **kw):
    """The model over a batch laid out as the kernel sees it (rows of a
    256-byte aligned tensor), with the group maxima of its counts, and its
    counters summed over the rows."""
    B, cap = comp.shape
    rows = [ChunkModel(comp[i].numpy(), int(comp_lens[i]), out_cap, window,
                       (i * cap) % 16, (i * out_cap) % 16, **kw) for i in range(B)]
    res = [m.run() for m in rows]
    counts = {k: sum(m.counts[k] for m in rows) for k in rows[0].counts}
    lens = torch.tensor([r[1] for r in res], dtype=torch.int32)
    steps = snappy_decode_r2.group_max(torch.tensor([r[3] for r in res], dtype=torch.int32))
    return (torch.from_numpy(np.stack([r[0] for r in res])), lens,
            torch.tensor([r[2] for r in res], dtype=torch.bool) & (lens <= out_cap),
            steps), counts


def _blobs() -> list[bytes]:
    """The synthetic cases and two 64 KB text chunks through the host
    encoder, the malformed blocks and the r2 malformed rows (F10 last), then
    the hand-built window cases."""
    raws = [c[:MAX_OUT] for _, c in synthetic_cases()] + [_selfcheck_payload(s) for s in (1, 2)]
    return ([host_snappy.compress(r) for r in raws] + malformed_cases(host_snappy.compress)
            + R2_MALFORMED + [b for _, b in r2_window_cases()])


BLOBS = _blobs()


@pytest.fixture(scope="module")
def batch():
    cap = max(map(len, BLOBS)) + 3  # an odd row length: every row's own alignment
    return to_device_batch(*_pack(BLOBS, cap), "cpu")


@pytest.fixture(scope="module")
def plain(batch):
    comp, lens = batch
    return {out_cap: snappy_decode_r2.decode_plain(comp, lens, out_cap=out_cap, with_steps=True)
            for out_cap in (65536, 4096, 4093)}


@pytest.mark.parametrize("out_cap", [65536, 4096, 4093])
@pytest.mark.parametrize("window", WINDOWS)
def test_model_equals_decode_plain(batch, plain, out_cap, window):
    comp, lens = batch
    got, counts = model_decode(comp, lens, out_cap, window)
    for name, g, w in zip(("out", "out_lens", "ok", "steps"), got, plain[out_cap]):
        assert torch.equal(g, w), name
    for k in ("far", "near", "literal", "drains", "waits"):
        assert counts[k] > 0, k


def test_the_hand_built_blocks_equal_the_host(plain):
    """The window cases decode as the host decoder has them."""
    cases = r2_window_cases()
    first = len(BLOBS) - len(cases)
    out, out_lens, ok, _ = plain[65536]
    for i, (name, blob) in enumerate(cases):
        want = host_snappy.decompress(blob, 65536)
        assert bool(ok[first + i]) and int(out_lens[first + i]) == len(want), name
        assert out[first + i, :len(want)].numpy().tobytes() == want, name
    for blob in R2_MALFORMED:
        with pytest.raises(MalformedInputException):
            host_snappy.decompress(blob, 65536)


def test_the_hand_built_blocks_equal_the_jax_package(plain):
    """The window cases decode as the JAX package's reference decoder and
    its XLA tier have them (bytes, zero tails, lengths, ok), and its
    reference decoder rejects the malformed rows."""
    cases = r2_window_cases()
    first = len(BLOBS) - len(cases)
    out, out_lens, ok, _ = (t[first:].numpy() for t in plain[65536])
    blobs = [b for _, b in cases]
    buf, lens = _pack(blobs, max(map(len, blobs)))
    j_out, j_lens, j_ok = (np.asarray(a) for a in snappy_jax.decode(jnp.asarray(buf),
                                                                    jnp.asarray(lens)))
    np.testing.assert_array_equal(ok, j_ok)
    np.testing.assert_array_equal(out_lens, j_lens)
    np.testing.assert_array_equal(out, j_out)
    ref = SnappyRefDecompressor()
    for i, (name, blob) in enumerate(cases):
        want = bytes(ref.decompress(blob, 65536))
        assert out[i, :out_lens[i]].tobytes() == want and out_lens[i] == len(want), name
    for blob in R2_MALFORMED:
        with pytest.raises(JaxMalformed):
            ref.decompress(blob, 65536)


def test_the_window_cases_take_each_path():
    """The reach cases put copies on each side of each window's reach; the
    dist-1 and dist-3 runs double in the window; the literals stream through
    the ring across its slices."""
    cases = dict(r2_window_cases())

    def run(name, window, **kw):
        blob = cases[name]
        comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
        return model_decode(comp, lens, 65536, window, **kw)

    for window in WINDOWS:
        (_, _, ok, _), counts = run(f"reach-{window}", window)
        # dists reach - 1 and reach read the window, reach + 1 device memory
        assert ok.all() and counts["near"] >= 4 and counts["far"] >= 2
    (_, _, ok, steps), counts = run("dist1-dist3-runs", WINDOWS[0])
    # dist 1: windows of 1, 2, 4, ..., 32 and 1 byte; dist 3: 3, 6, 12, 24
    # and 19, some cut in two at a 128-byte block's end
    assert ok.all() and 1 + 40 * 7 + 1 + 40 * 5 < int(steps[0]) < 1 + 40 * 7 + 1 + 40 * 6
    (_, _, ok, _), counts = run("literal-slices", WINDOWS[0])
    assert ok.all() and counts["waits"] >= 65536 // SLICE - 4 and counts["far"] == 0
    (_, _, ok, _), counts = run("dist-65535", WINDOWS[1])
    assert ok.all() and counts["far"] == 1


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("name, kw, what", [
    ("reach", dict(reach=1), "no step of window / 16 bytes writes"),
    ("reach", dict(skip_drain=1), "a far copy's source was drained"),
    ("literal-slices", dict(early=True), "the ring holds the input read")])
def test_a_broken_rule_is_caught(window, name, kw, what):
    """The checks bite: a reach one byte too long reads the window at
    reach + 1, a skipped drain leaves a far copy's source (and the row)
    unstored, and a slice issued one place early overwrites ring bytes not
    yet read."""
    blob = dict(r2_window_cases())[f"reach-{window}" if name == "reach" else name]
    comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
    if "reach" in kw:
        kw = dict(reach=copy_reach(window) + kw["reach"])
    model = ChunkModel(comp[0].numpy(), int(lens[0]), 65536, window, 0, 0, **kw)
    with pytest.raises(Violation, match=what):
        model.run()
