"""A model of the Snappy decode kernel's shared-memory rings, against the
plain version.

``csrc/snappy_decode.cu`` keeps each chunk's input in a 2 KB ring that
cp.async fills a 512-byte quarter at a time, two quarters ahead, and its
recent output in a window from which copies read and which drains to
device memory in 16-byte units. Those rules cannot run here, so this file
models them in numpy, byte for byte and in the kernel's order, and checks
at every step what the kernel relies on:

- a ring byte is read only after its quarter arrived and before a later
  quarter reuses its slot;
- a copy reads the window only for dist <= window - 64, and then only bytes
  the window still holds (or, at or past out_cap, bytes never stored: a far
  copy skips those), never a slot the same copy writes;
- a farther copy reads device memory only where the byte was drained;
- a window slot is overwritten only after its byte was drained (or lies at
  or past out_cap, where nothing is stored);
- every byte below out_cap is stored to device memory exactly once, in
  ranges that start and end on 16-byte units of the row's address except
  at the row's two ends.

The model's results (out, out_lens, ok, steps) must equal ``decode_plain``
exactly (integer codec: tolerance 0) on the synthetic cases, 64 KB text
chunks, the malformed blobs of ``tests/test_torch_cuda.py::_blobs``,
``chip_smoke.R2_MALFORMED`` and the hand-built window cases, at out_cap
65536, 4096 and 4093, with each row at its own misalignment. It also holds
``snappy_decode.distance_shares`` to a hand-built block.
"""

import numpy as np
import pytest
import torch

from aircompressor_tpu_torch.host import snappy as host_snappy
from aircompressor_tpu_torch.ops import snappy_decode
from aircompressor_tpu_torch.ops.batch import _pack, _selfcheck_payload, to_device_batch
from aircompressor_tpu_torch.ops.snappy_decode import WINDOWS, copy_reach
from chip_smoke import (
    R2_MALFORMED, snappy_copy, snappy_literal, snappy_window_cases, synthetic_cases)

RING = 2048
QUARTER = RING // 4
RUN = 1024  # output bytes a run of identical copies may add
MAX_OUT = 65536


class Violation(AssertionError):
    """A rule of the kernel's rings was broken."""


def _check(cond, what):
    if not cond:
        raise Violation(what)


class ChunkModel:
    """One chunk through the kernel's rules, with a window of ``window``
    bytes; ``sr`` and ``so`` are the row's input and output addresses mod
    16. ``reach`` and ``drain_at`` default to the kernel's window - 64 and
    window / 2."""

    def __init__(self, row: np.ndarray, clen: int, out_cap: int, window: int,
                 sr: int, so: int, reach: int | None = None, drain_at: int | None = None):
        self.row, self.clen, self.out_cap, self.window = row, clen, out_cap, window
        self.reach = snappy_decode.copy_reach(window) if reach is None else reach
        self.drain_at = window // 2 if drain_at is None else drain_at
        self.sr, self.so = sr, so
        self.readable = max(0, min(clen, row.size))
        self.in_end = sr + self.readable
        self.n_quarters = -(-self.in_end // QUARTER) if self.readable > 0 else 0
        self.ring_at = np.full(RING, -1, np.int64)  # ring coordinate each slot holds
        self.issued = self.ready = 0
        self.win_at = np.full(window, -1, np.int64)  # output position each slot holds
        self.win = np.zeros(window, np.uint8)
        self.mem = np.full(out_cap, -1, np.int16)  # device memory; -1: not stored
        self.op = self.flushed = 0
        self.drains = self.far_copies = self.window_copies = self.pieces = self.runs = 0

    # ---- input ring
    def _issue(self):
        if self.issued < self.n_quarters:
            lo = self.issued * QUARTER
            p = np.arange(max(lo, self.sr), min(lo + QUARTER, self.in_end))
            self.ring_at[p % RING] = -2  # in flight: neither old nor new
        self.issued += 1

    def need(self, end: int):
        while self.ready * QUARTER < end:
            _check(self.issued == self.ready + 2, "two quarters in flight")
            if self.ready < self.n_quarters:
                lo = self.ready * QUARTER
                p = np.arange(max(lo, self.sr), min(lo + QUARTER, self.in_end))
                self.ring_at[p % RING] = p
            self.ready += 1
            self._issue()

    def ring_bytes(self, at: int, n: int) -> np.ndarray:
        """Chunk bytes at..at+n-1 from the ring; they must be there."""
        p = np.arange(at, at + n) + self.sr
        _check((self.ring_at[p % RING] == p).all(), f"ring holds input {at}..{at + n}")
        return self.row[at:at + n]

    def ring_list(self, at: int, n: int) -> list[int]:
        return [int(b) for b in self.ring_bytes(at, n)]

    def peek(self, at: int, n: int) -> list[int]:
        """Bytes at..at+n-1 of what the kernel's 8-byte read at the token
        holds: ring bytes below readable, 0 past it (no readiness check: the
        kernel only compares them)."""
        return [int(self.row[p]) if p < self.readable else 0 for p in range(at, at + n)]

    def read5(self, at: int) -> list[int]:
        self.need(min(at + self.sr + 6, self.in_end))
        n = max(0, min(5, self.readable - at))
        return [int(b) for b in self.ring_bytes(at, n)] + [0] * (5 - n)

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
        if self.op - self.flushed >= self.drain_at and self.flushed < self.out_cap:
            lim = (self.out_cap if self.op >= self.out_cap
                   else ((self.op + self.so) & ~15) - self.so)
            self.store(self.flushed, lim)
            self.flushed = lim
            self.drains += 1

    # ---- the kernel's loop
    def run(self):
        self._issue()
        self._issue()
        head = self.read5(0)
        declared, vlen, more = head[0] & 0x7F, 1, head[0] >= 128
        for k in range(1, 5):
            if more:
                declared |= (head[k] & 0x7F) << (7 * k)
                vlen += 1
            more = more and head[k] >= 128
        declared &= 0xFFFFFFFF
        clen = self.clen
        err = declared > MAX_OUT or vlen > clen or clen > self.row.size
        ip, count = vlen, 0
        while not err and ip < clen:
            tag, *ops = self.read5(ip)
            word = ops[0] | (ops[1] << 8) | (ops[2] << 16) | (ops[3] << 24)
            if tag & 3 == 0:  # a literal, streamed from the ring
                count += 1
                n = tag >> 2
                extra = min(max(n - 59, 0), 4)
                length = (n if extra == 0 else word & ((1 << (8 * extra)) - 1)) + 1
                tok = 1 + extra
                err = length > MAX_OUT or ip + tok + length > clen or self.op + length > declared
                if err:
                    break
                at, rem = ip + tok, length
                while rem > 0:
                    p = at + self.sr
                    self.need(p + 1)
                    piece = min(rem, self.ready * QUARTER - p)
                    self.write_window(self.op + np.arange(piece), self.ring_bytes(at, piece))
                    at, rem, self.op = at + piece, rem - piece, self.op + piece
                    self.pieces += 1
                    self.drain()
                ip = at
                continue
            count += 1
            kind, n = tag & 3, tag >> 2
            tok = (2, 3, 5)[kind - 1]
            length = 4 + (n & 7) if kind == 1 else n + 1
            dist = ((tag >> 5) << 8 | ops[0]) if kind == 1 else (
                word & 0xFFFF if kind == 2 else word)
            err = ip + tok > clen or self.op + length > declared or dist == 0 or dist > self.op
            if err:
                break
            run = 1
            if kind == 2 and self.peek(ip + 3, 3) == [tag, ops[0], ops[1]]:
                _check(ip + 6 > self.readable or
                       (self.ring_at[(ip + 3 + self.sr + np.arange(3)) % RING]
                        == ip + 3 + self.sr + np.arange(3)).all(), "the ring holds the next token")
                room = min(RUN, self.window - dist) if dist <= self.reach else RUN
                most = min(32, room // length, (declared - self.op) // length)
                self.need(min(ip + self.sr + 96, self.in_end))
                while (run < most and ip + 3 * run + 3 <= clen
                       and self.ring_list(ip + 3 * run, 3) == [tag, ops[0], ops[1]]):
                    run += 1
                count += run - 1
                self.runs += run > 1
            ip += tok * run
            length *= run
            self.need(min(ip + self.sr + 6, self.in_end))  # the next token's bytes, first
            k = np.arange(length)
            dst = self.op + k
            if dist <= self.reach:
                src = self.op - dist + (k if dist >= length else k % dist)
                held = (self.win_at[self.slot(src)] == src) | (src >= self.out_cap)
                _check(held.all(), "a copy's source is in the window")
                _check(not np.isin(self.slot(src), self.slot(dst)).any(),
                       "a copy reads a slot it writes")
                self.write_window(dst, self.win[self.slot(src)])
                self.window_copies += 1
            else:
                live = dst < self.out_cap
                src = dst[live] - dist
                _check((self.mem[src] >= 0).all(), "a far copy's source was drained")
                self.write_window(dst[live], self.mem[src].astype(np.uint8))
                self.far_copies += 1
            self.op += length
            self.drain()
        if self.op < self.out_cap:
            unit_end = min(((self.op + self.so + 15) & ~15) - self.so, self.out_cap)
            self.write_window(np.arange(self.op, unit_end), 0)
            self.store(self.flushed, unit_end)
            self.store(unit_end, self.out_cap, zeros=True)
        elif self.flushed < self.out_cap:
            self.store(self.flushed, self.out_cap)
        _check((self.mem >= 0).all(), "every byte below out_cap is stored")
        ok = not err and self.op == declared
        return self.mem.astype(np.uint8), self.op, ok, count


def model_decode(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int, window: int):
    """The model over a batch laid out as the kernel sees it (rows of a
    256-byte aligned tensor), and its counters summed over the rows."""
    B, cap = comp.shape
    rows = [ChunkModel(comp[i].numpy(), int(comp_lens[i]), out_cap, window,
                       (i * cap) % 16, (i * out_cap) % 16) for i in range(B)]
    res = [m.run() for m in rows]
    out = torch.from_numpy(np.stack([r[0] for r in res])) if B else torch.zeros((0, out_cap), dtype=torch.uint8)
    counts = {k: sum(getattr(m, k) for m in rows)
              for k in ("drains", "far_copies", "window_copies", "pieces", "runs")}
    return (out, torch.tensor([r[1] for r in res], dtype=torch.int32),
            torch.tensor([r[2] for r in res], dtype=torch.bool) & (torch.tensor([r[1] for r in res]) <= out_cap),
            torch.tensor([r[3] for r in res], dtype=torch.int32)), counts


def _blobs() -> list[bytes]:
    """The kernel's checks: synthetic cases, 64 KB text, the malformed blobs
    of the card tests, the r2 malformed blobs, the hand-built window cases."""
    raws = [c[:65536] for _, c in synthetic_cases()] + [_selfcheck_payload(s) for s in (1, 2)]
    blobs = [host_snappy.compress(r) for r in raws]
    blobs += [blobs[-1][: len(blobs[-1]) // 2], b"\x08\x0cabcd\x0f\x04\x00\x00\x01"]
    return blobs + R2_MALFORMED + [b for _, b in snappy_window_cases()]


BLOBS = _blobs()


@pytest.fixture(scope="module")
def batch():
    cap = max(map(len, BLOBS)) + 3  # an odd row length: every row's own alignment
    return to_device_batch(*_pack(BLOBS, cap), "cpu")


@pytest.mark.parametrize("out_cap, window", [
    (65536, WINDOWS[0]), (65536, WINDOWS[1]),
    (4096, WINDOWS[0]), (4093, WINDOWS[0]), (4093, WINDOWS[1])])
def test_model_equals_decode_plain(batch, out_cap, window):
    comp, lens = batch
    got, counts = model_decode(comp, lens, out_cap, window)
    want = snappy_decode.decode_plain(comp, lens, out_cap=out_cap, with_steps=True)
    for name, g, w in zip(("out", "out_lens", "ok", "steps"), got, want):
        assert torch.equal(g, w), name
    assert counts["far_copies"] > 0 and counts["window_copies"] > 0
    assert counts["drains"] > 0 and counts["pieces"] > 0 and counts["runs"] > 0


def test_the_window_cases_take_both_paths():
    """The straddle cases put copies on each side of each window's reach,
    and the 64 KB literal streams through the ring in quarter-sized pieces."""
    cases = dict(snappy_window_cases())
    for window in WINDOWS:
        blob = cases[f"straddle-{window}"]
        comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
        _, counts = model_decode(comp, lens, 65536, window)
        # 64-byte copies at reach - 1 and reach read the window, the six
        # farther ones and every 37-byte copy (dist + 5) device memory
        assert counts["far_copies"] == 6 + 8
        assert counts["window_copies"] == 2 + 8  # and the 9-byte copies at dist 3
    blob = cases["literal-64k"]
    comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
    _, counts = model_decode(comp, lens, 65536, WINDOWS[0])
    assert counts["pieces"] >= 65536 // QUARTER and counts["drains"] >= 65536 // 2048 - 1


@pytest.mark.parametrize("reach, drain_at, what", [
    (4096, None, "a copy reads a slot it writes"),
    (None, 4096, "a window slot is overwritten before its byte drained")])
def test_a_broken_rule_is_caught(reach, drain_at, what):
    """The checks bite: a window read up to the window's full size, or a
    drain that waits for a full window, breaks a rule the model names."""
    blob = dict(snappy_window_cases())["straddle-4096"]
    comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
    model = ChunkModel(comp[0].numpy(), int(lens[0]), 65536, 4096, 0, 0, reach, drain_at)
    with pytest.raises(Violation, match=what):
        model.run()


def test_distance_shares_of_a_hand_built_block():
    """Copies at dists 1, 100, reach and reach + 1 of each window, after a
    literal long enough for all of them."""
    reach4, reach32 = map(copy_reach, WINDOWS)
    dists = [(1, 4), (100, 10), (reach4, 20), (reach4 + 1, 30),
             (reach32, 40), (reach32 + 1, 64)]
    lit = bytes(range(256)) * 160  # 40,960 bytes
    total = len(lit) + sum(n for _, n in dists)
    blob = b"".join([_uvarint(total), snappy_literal(lit)]
                    + [snappy_copy(n, d) for d, n in dists]
                    + [b"\x01\x00"])  # then a copy at dist 0: bad, not counted
    comp, lens = to_device_batch(*_pack([blob], len(blob)), "cpu")
    got = snappy_decode.distance_shares(comp, lens, (reach4, reach32))
    assert got["copies"] == 6 and got["copy_bytes"] == 168
    assert got["within"][reach4] == {"copies": 3 / 6, "bytes": 34 / 168}
    assert got["within"][reach32] == {"copies": 5 / 6, "bytes": 104 / 168}


def _uvarint(n: int) -> bytes:
    out = bytearray()
    while n >= 128:
        out.append((n & 127) | 128)
        n >>= 7
    return bytes(out + bytes([n]))
