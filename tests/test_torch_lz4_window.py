"""A model of the LZ4 decode kernel's shared-memory ring and window, against
the plain version.

``csrc/lz4_decode.cu`` keeps each chunk's input in a ring (2 KB, 4 KB
beside the 32 KB window) that cp.async fills a 512-byte slice at a time,
all but two slices of the ring ahead, and its recent output in a window
from which matches read and which drains to device memory in 16-byte units.
A step moves at most window / 16 bytes: a sequence's literals, then a piece
of its match. Those rules cannot run here, so this file models them in
numpy, byte for byte and in the kernel's order, and checks at every step
what the kernel relies on:

- a ring byte is read only after its slice arrived and before a later
  slice reuses its place (headers, extension ballots, literals; literals
  that a later read would drop move first);
- a match reads the window only for dist <= the reach, then only bytes the
  window still holds and never a slot the same step writes: a source byte
  among the step's own literals comes from the ring;
- a farther match reads device memory only where the byte was drained;
- a window slot is overwritten only after its byte was drained (or lies at
  or past out_cap, where nothing is stored);
- every byte below out_cap is stored to device memory exactly once, in
  ranges that start and end on 16-byte units of the row's address except
  at the row's two ends.

The model's results (out, out_lens, ok, steps) must equal ``decode_plain``
exactly (integer codec: tolerance 0) on the LZ4 cases, 64 KB text chunks,
the malformed and F6 blocks and the hand-built window cases, at out_cap
65536, 4096 and 4093 and both windows, with each row at its own
misalignment. The hand-built blocks also equal the host decoder and
``aircompressor_tpu.ops.lz4_jax.decode``. A skipped drain, a reach one byte
too long and a match that reads its own literals from the window must
break a rule. It also holds ``lz4_decode.distance_shares`` to a hand-built
block.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aircompressor_tpu.ops import lz4_jax  # noqa: E402
from aircompressor_tpu_torch.errors import MalformedInputException  # noqa: E402
from aircompressor_tpu_torch.host import lz4 as host_lz4  # noqa: E402
from aircompressor_tpu_torch.ops import lz4_decode  # noqa: E402
from aircompressor_tpu_torch.ops.batch import (  # noqa: E402
    _pack, _selfcheck_payload, to_device_batch)
from aircompressor_tpu_torch.ops.lz4_decode import WINDOWS, copy_reach, step_bytes  # noqa: E402
from chip_smoke import (  # noqa: E402
    LZ4_EDGE_BLOCKS, Lz4Block, lz4_length_edges_case, lz4_malformed_cases, lz4_window_cases,
    synthetic_cases)

SLICE = 512
MAX_OUT = 65536


def ring_size(window: int) -> int:
    return 4096 if window >= 32768 else 2048


class Violation(AssertionError):
    """A rule of the kernel's ring or window was broken."""


def _check(cond, what):
    if not cond:
        raise Violation(what)


class ChunkModel:
    """One chunk through the kernel's rules, with a window of ``window``
    bytes; ``sr`` and ``so`` are the row's input and output addresses mod
    16. ``reach`` defaults to the kernel's window - window / 16; with
    ``skip_drain`` = n the n-th drain moves its mark without storing; with
    ``own_from_window`` a match reads its own step's literals from the
    window instead of the ring."""

    def __init__(self, row: np.ndarray, clen: int, out_cap: int, window: int,
                 sr: int, so: int, reach: int | None = None, skip_drain: int | None = None,
                 own_from_window: bool = False):
        self.row, self.clen, self.out_cap, self.window = row, clen, out_cap, window
        self.step_max = step_bytes(window)
        self.reach = copy_reach(window) if reach is None else reach
        self.skip_drain, self.own_from_window = skip_drain, own_from_window
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
        self.pend_at = self.pend_n = 0
        self.counts = dict(drains=0, far=0, near=0, own=0, pieces=0, scans=0, crossing=0,
                           early=0, in_word=0)

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

    def kept_from(self, end: int) -> int:
        r = max(self.ready, min(self.n_slices, -(-end // SLICE)))
        return (r - 2) * SLICE

    def fetch(self, end: int):
        """need(end), first moving the pending literals where the ring
        would drop them."""
        if self.pend_n > 0 and self.pend_at + self.sr < self.kept_from(end):
            self.counts["early"] += 1
            self.literals(self.pend_at, self.pend_n)
            self.pend_n = 0
        self.need(end)

    def ring_read(self, at: np.ndarray) -> np.ndarray:
        """Chunk bytes at the positions ``at``, from the ring; they must be
        there."""
        p = np.asarray(at) + self.sr
        _check((self.ring_at[p % self.ring] == p).all(), "the ring holds the input read")
        return self.row[np.asarray(at)]

    def read8(self, at: int) -> list[int]:
        self.fetch(min(at + self.sr + 8, self.in_end))
        n = max(0, min(8, self.readable - at))
        return [int(b) for b in self.ring_read(np.arange(at, at + n))] + [0] * (8 - n)

    def read_ext(self, p: int) -> tuple[int, int]:
        """The extension's sum and the position after it, a ballot over 32
        ring bytes a round; -1 where it runs past the chunk or passes 64 KB."""
        total = 0
        while True:
            self.fetch(min(p + self.sr + 32, self.in_end))
            n = max(0, min(32, self.readable - p))
            b = list(self.ring_read(np.arange(p, p + n))) + [-1] * (32 - n)
            self.counts["scans"] += 1
            self.counts["crossing"] += (p + self.sr) // SLICE != (p + self.sr + n - 1) // SLICE
            ends = [k for k in range(32) if b[k] != 255]
            if not ends:
                total += 255 * 32
                p += 32
                if total > MAX_OUT:
                    return -1, p
                continue
            k = ends[0]
            return (-1, p) if b[k] < 0 else (total + 255 * k + int(b[k]), p + k + 1)

    def ext_at(self, word: list[int], valid: int, p: int) -> tuple[int, int]:
        """The extension at p from ``word``, the next ``valid`` chunk bytes
        from p already read, where it ends among them (beside the 32 KB
        window only); else read_ext."""
        ends = [k for k in range(max(valid, 0)) if word[k] != 255] if self.window >= 32768 else []
        if not ends:
            return self.read_ext(p)
        self.counts["in_word"] += 1
        k = ends[0]
        return 255 * k + word[k], p + k + 1

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

    def step(self, n_lit: int, lit_at: int, dist: int, mlen: int):
        """n_lit input bytes from lit_at, then mlen bytes that repeat the
        byte dist back; all reads before all writes, then a drain."""
        total = n_lit + mlen
        _check(total <= self.step_max, "a step moves at most window / 16 bytes")
        op = self.op
        dst = op + np.arange(total)
        vals = np.zeros(total, np.uint8)
        live = np.ones(total, bool)
        if n_lit:
            vals[:n_lit] = self.ring_read(np.arange(lit_at, lit_at + n_lit))
        if mlen:
            at = op + n_lit
            km = np.arange(mlen)
            if dist <= self.reach:
                src = at - dist + (km if dist >= mlen else km % dist)
                own = (src >= op) & (not self.own_from_window)
                win_src = src[~own]
                _check(not np.isin(self.slot(win_src), self.slot(dst)).any(),
                       "a step reads a slot it writes")
                held = (self.win_at[self.slot(win_src)] == win_src) | (win_src >= self.out_cap)
                _check(held.all(), "a match's source is in the window")
                got = np.zeros(mlen, np.uint8)
                got[~own] = self.win[self.slot(win_src)]
                got[own] = self.ring_read(lit_at + src[own] - op)
                vals[n_lit:] = got
                self.counts["near"] += 1
                self.counts["own"] += bool(own.any())
            else:
                live[n_lit:] = dst[n_lit:] < self.out_cap
                src = dst[n_lit:][live[n_lit:]] - dist
                _check((self.mem[src] >= 0).all(), "a far match's source was drained")
                vals[n_lit:][live[n_lit:]] = self.mem[src].astype(np.uint8)
                self.counts["far"] += 1
        self.write_window(dst[live], vals[live])
        self.op += total
        self.drain()

    def literals(self, frm: int, n: int):
        while n > 0:
            p = frm + self.sr
            self.need(p + 1)
            piece = min(n, self.step_max, self.ready_end() - p)
            self.step(piece, frm, 0, 0)
            self.counts["pieces"] += 1
            frm, n = frm + piece, n - piece

    # ---- the kernel's loop
    def run(self):
        for _ in range(self.ahead):
            self._issue()
        clen = self.clen
        err = clen <= 0 or clen > self.row.size
        ended = False
        ip = count = 0
        b = self.read8(0)
        while not err and ip < clen:
            count += 1
            token = b[0]
            lit, lit_at = token >> 4, ip + 1
            if lit == 15:
                more, lit_at = self.ext_at(b[1:], min(self.readable - lit_at, 7), lit_at)
                if more < 0:
                    err = True
                    break
                lit += more
            err = lit > clen - lit_at or self.op + lit > MAX_OUT
            if err:
                break
            lit_end = lit_at + lit
            if lit_end == clen:
                self.literals(lit_at, lit)
                ended = True
                break
            self.pend_at, self.pend_n = lit_at, lit
            lop = self.op + lit
            mat = lit_end + 2
            err = mat > clen
            dist = 0
            w8 = []  # the bytes from lit_end that were read
            if not err:
                w8 = b[lit_end - ip:] if mat <= ip + 8 else self.read8(lit_end)
                dist = w8[0] | (w8[1] << 8)
                err = dist == 0 or dist > lop
            ml = token & 15
            if not err and ml == 15:
                more, mat = self.ext_at(w8[2:], min(self.readable - mat, len(w8) - 2), mat)
                err = more < 0
                ml += more
            ml += 4
            err = err or ml > MAX_OUT - lop
            if err:
                self.literals(self.pend_at, self.pend_n)
                self.pend_n = 0
                break
            ip = mat
            b = self.read8(ip)
            if self.pend_n > self.step_max // 2:
                self.literals(self.pend_at, self.pend_n)
                self.pend_n = 0
            rem = ml
            while rem > 0:
                piece = min(rem, self.step_max - self.pend_n)
                self.step(self.pend_n, self.pend_at, dist, piece)
                self.pend_n = 0
                rem -= piece
        op = self.op
        if op < self.out_cap:
            unit_end = min(((op + self.so + 15) & ~15) - self.so, self.out_cap)
            self.write_window(np.arange(op, unit_end), 0)
            self.store(self.flushed, unit_end)
            self.store(unit_end, self.out_cap, zeros=True)
        elif self.flushed < self.out_cap:
            self.store(self.flushed, self.out_cap)
        _check((self.mem >= 0).all(), "every byte below out_cap is stored")
        return self.mem.astype(np.uint8), op, not err and ended, count


def model_decode(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int, window: int,
                 **kw):
    """The model over a batch laid out as the kernel sees it (rows of a
    256-byte aligned tensor), and its counters summed over the rows."""
    B, cap = comp.shape
    rows = [ChunkModel(comp[i].numpy(), int(comp_lens[i]), out_cap, window,
                       (i * cap) % 16, (i * out_cap) % 16, **kw) for i in range(B)]
    res = [m.run() for m in rows]
    counts = {k: sum(m.counts[k] for m in rows) for k in rows[0].counts}
    lens = torch.tensor([r[1] for r in res], dtype=torch.int32)
    return (torch.from_numpy(np.stack([r[0] for r in res])), lens,
            torch.tensor([r[2] for r in res], dtype=torch.bool) & (lens <= out_cap),
            torch.tensor([r[3] for r in res], dtype=torch.int32)), counts


def _blobs() -> list[bytes]:
    """The kernel's checks: the LZ4 cases and 64 KB text chunks through the
    host encoder, the malformed and F6 blocks, the hand-built window cases."""
    raws = ([c[:65536] for _, c in synthetic_cases()] + [lz4_length_edges_case()]
            + [_selfcheck_payload(s) for s in (1, 2)])
    return ([host_lz4.compress(r) for r in raws] + lz4_malformed_cases(host_lz4.compress)
            + [b for b, _, _ in LZ4_EDGE_BLOCKS] + [b for _, b in lz4_window_cases()])


BLOBS = _blobs()


@pytest.fixture(scope="module")
def batch():
    cap = max(map(len, BLOBS)) + 3  # an odd row length: every row's own alignment
    return to_device_batch(*_pack(BLOBS, cap), "cpu")


@pytest.fixture(scope="module")
def plain(batch):
    comp, lens = batch
    return {out_cap: lz4_decode.decode_plain(comp, lens, out_cap=out_cap, with_steps=True)
            for out_cap in (65536, 4096, 4093)}


@pytest.mark.parametrize("out_cap", [65536, 4096, 4093])
@pytest.mark.parametrize("window", WINDOWS)
def test_model_equals_decode_plain(batch, plain, out_cap, window):
    comp, lens = batch
    got, counts = model_decode(comp, lens, out_cap, window)
    for name, g, w in zip(("out", "out_lens", "ok", "steps"), got, plain[out_cap]):
        assert torch.equal(g, w), name
    for k in ("far", "near", "own", "scans", "crossing", "drains", "pieces", "early"):
        assert counts[k] > 0, k
    assert (counts["in_word"] > 0) == (window >= 32768)


def test_the_hand_built_blocks_equal_the_host_and_lz4_jax(plain):
    """The window cases decode as the host decoder and the JAX package's
    XLA decoder have them, and are rejected where those reject them."""
    cases = lz4_window_cases()
    first = len(BLOBS) - len(cases)
    out, out_lens, ok, _ = plain[65536]
    blobs = [b for _, b in cases]
    buf, blens = _pack(blobs, max(map(len, blobs)))
    j_out, j_lens, j_ok = (np.asarray(a) for a in lz4_jax.decode(jnp.asarray(buf),
                                                                  jnp.asarray(blens)))
    for i, (name, blob) in enumerate(cases):
        try:
            want = host_lz4.decompress(blob, 65536)
        except MalformedInputException:
            want = None
        assert bool(ok[first + i]) == (want is not None) == bool(j_ok[i]), name
        if want is not None:
            assert int(out_lens[first + i]) == len(want) == int(j_lens[i]), name
            assert out[first + i, :len(want)].numpy().tobytes() == want, name
            assert j_out[i, :len(want)].tobytes() == want, name
    assert sum(bool(v) for v in j_ok) == len(cases) - 2  # offset-65535, match-past-64k


def test_the_window_cases_take_each_path():
    """The reach cases put matches on each side of each window's reach, in
    pieces of up to window / 16 bytes; own-literals reads a step's own
    literals from the ring, with the literals in the match's step and alone
    before it; the 64 KB literal streams through the ring in pieces; the
    extensions of ext-slices cross ring slices."""
    cases = dict(lz4_window_cases())

    def run(name, window, **kw):
        blob = cases[name]
        comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
        return model_decode(comp, lens, 65536, window, **kw)

    for window in WINDOWS:
        (_, _, ok, _), counts = run(f"reach-{window}", window)
        # dists reach - 1 and reach read the window, reach + 1 device memory:
        # lengths 9, 2 * step + 17 and step, in 1, 3 and 1 or 2 pieces
        assert ok.all() and counts["near"] >= 2 * 5 and counts["far"] >= 5
        (_, _, ok, _), counts = run("own-literals", window)
        assert ok.all() and counts["own"] >= 5 and counts["pieces"] >= 1
    (_, _, ok, _), counts = run("literal-64k", WINDOWS[0])
    assert ok.all() and counts["pieces"] >= 65536 // step_bytes(WINDOWS[0])
    assert counts["drains"] >= 65536 // 2048 - 1
    (_, _, ok, _), counts = run("ext-slices", WINDOWS[0])
    assert ok.all() and counts["crossing"] >= 2 and counts["early"] >= 1


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("name, kw, what", [
    ("reach", dict(reach=1), "a step reads a slot it writes"),
    ("reach", dict(skip_drain=1), "a far match's source was drained"),
    ("own-literals", dict(own_from_window=True), "a step reads a slot it writes")])
def test_a_broken_rule_is_caught(window, name, kw, what):
    """The checks bite: a reach one byte too long lets a full step at dist
    reach + 1 read a slot it writes, a skipped drain leaves a far match's
    source (and the row) unstored, and a match that reads its own literals
    from the window reads the slots its step writes."""
    blob = dict(lz4_window_cases())[f"reach-{window}" if name == "reach" else name]
    comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
    if "reach" in kw:
        kw = dict(reach=copy_reach(window) + kw["reach"])
    model = ChunkModel(comp[0].numpy(), int(lens[0]), 65536, window, 0, 0, **kw)
    with pytest.raises(Violation, match=what):
        model.run()


def test_distance_shares_of_a_hand_built_block():
    """Matches at dists 1, 100, and each reach and reach + 1 after a literal
    run long enough for all of them, then one from before the start: bad,
    not counted."""
    reach4, reach32 = map(copy_reach, WINDOWS)
    blk = Lz4Block(7).seq(40000, 1, 4)
    for dist, length in [(1, 4), (100, 10), (reach4, 20), (reach4 + 1, 30), (reach32, 40),
                         (reach32 + 1, 64)]:
        blk.seq(0, dist, length)
    blob = blk.seq(3, 60000, 4).end()
    comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
    got = lz4_decode.distance_shares(comp, lens, (reach4, reach32))
    assert got["matches"] == 7 and got["match_bytes"] == 172
    assert got["within"][reach4] == {"matches": 4 / 7, "bytes": 38 / 172}
    assert got["within"][reach32] == {"matches": 6 / 7, "bytes": 108 / 172}
