"""A model of the zstd execute kernel's rounds, literal ring and window,
against the plain version.

``csrc/zstd_execute.cu`` takes a block's sequences in rounds: lane k holds
triple k, warp prefix sums of the clamped ll and ml give every sequence's
literal position and output offset, one ballot checks every rule that
makes the frame not ok, and a round takes the leading sequences whose
output fits its budget (a longer sequence moves alone, in pieces). The
round's literals go first, in one pass over their concatenated bytes read
from a ring that streams the current piece's source; then its matches, in
order, from a window of the frame's recent output (or from device memory
past the reach), which drains in 16-byte units. Those rules cannot run
here, so this file models them in numpy, in the kernel's order, and checks
at every step what the kernel relies on:

- a ring byte is read only after its slice arrived and before a later
  slice reuses its place;
- a match reads the window only for offsets within the reach, then only
  bytes the window holds and never a slot the same match writes;
- a farther match reads device memory only where the byte was drained;
- a window slot is overwritten only after its byte was drained;
- every byte of an ok frame's row is stored exactly once, in ranges that
  start and end on 16-byte units of the row's address except at its ends.

Its ``(out, out_len, ok)`` must equal ``zstd_decode.execute_plain`` exactly
(integer codec: tolerance 0) on the planned batch of
``tests/test_torch_zstd.py`` (host-encoder and libzstd frames, the
multi-block ones with repeat offsets carried across blocks, F7) with two
8 KB text frames, and on ``chip_smoke.execute_round_cases``, at both
windows and out_cap 65536 and 4093. Placing a round's literals after its
matches must fail. It also holds ``zstd_decode.offset_shares`` to a
hand-built batch.
"""

import numpy as np
import pytest
import torch

from aircompressor_tpu_torch.data import libzstd_frames
from aircompressor_tpu_torch.host.zstd import device_prep, frame_enc
from aircompressor_tpu_torch.ops import zstd_decode
from aircompressor_tpu_torch.ops.batch import _selfcheck_payload
from aircompressor_tpu_torch.ops.zstd_decode import (
    EXECUTE_WINDOWS, execute_round, offset_reach)
from chip_smoke import ExecBatch, execute_round_cases, zstd_cases

SLICE = 512
CLAMP = 65537
HUFF, RAW = 0, 1


class Violation(AssertionError):
    """A rule of the kernel's rounds, ring or window was broken."""


def _check(cond, what):
    if not cond:
        raise Violation(what)


class Ring:
    """The literal ring of ``size`` bytes over buf[frm, to) of a 16-byte
    aligned buffer whose readable indices are [0, len)."""

    def __init__(self, buf: np.ndarray, frm: int, to: int, size: int):
        self.buf, self.size, self.ahead = buf, size, size // SLICE - 2
        self.origin = frm - (frm & 15)
        alo, ahi = max(-self.origin, 0), max(buf.size - self.origin, 0)
        self.lo = max(alo, frm - self.origin)
        self.hi = min(ahi, max(to - self.origin, 0))
        self.n_slices = -(-self.hi // SLICE) if self.hi > self.lo else 0
        self.ready = self.issued = self.lo // SLICE if self.hi > self.lo else 0
        self.at = np.full(size, -1, np.int64)  # ring coordinate each slot holds
        for _ in range(self.ahead):
            self._issue()

    def _issue(self):
        if self.issued < self.n_slices:
            q = np.arange(max(self.issued * SLICE, self.lo),
                          min((self.issued + 1) * SLICE, self.hi))
            self.at[q % self.size] = -2  # in flight
        self.issued += 1

    def need(self, end: int):
        while self.ready < self.n_slices and self.ready * SLICE < end:
            _check(self.issued == self.ready + self.ahead, "all but two slices in flight")
            q = np.arange(max(self.ready * SLICE, self.lo),
                          min((self.ready + 1) * SLICE, self.hi))
            self.at[q % self.size] = q
            self.ready += 1
            self._issue()

    def ready_end(self) -> int:
        return 1 << 31 if self.ready >= self.n_slices else self.ready * SLICE

    def bytes(self, p: np.ndarray) -> np.ndarray:
        inside = (p >= self.lo) & (p < self.hi)
        _check((self.at[p[inside] % self.size] == p[inside]).all(), "the ring holds the literal")
        out = np.zeros(p.size, np.uint8)
        out[inside] = self.buf[p[inside] + self.origin]
        return out


class FrameModel:
    """One frame through the kernel's rules with a window of ``window``
    bytes; ``so`` is its row's address mod 16. With ``literals_last`` a
    round's matches run before its literals."""

    def __init__(self, src, lit, seq3, blocks, first, n_blocks, out_cap, window, so,
                 literals_last=False):
        self.src, self.lit, self.seq3, self.blocks = src, lit, seq3, blocks
        self.first, self.n_blocks = first, n_blocks
        self.out_cap, self.window, self.so = out_cap, window, so
        self.rnd, self.reach = execute_round(window), offset_reach(window)
        self.literals_last = literals_last
        self.win_at = np.full(window, -1, np.int64)
        self.win = np.zeros(window, np.uint8)
        self.mem = np.full(out_cap, -1, np.int16)
        self.op = self.flushed = 0
        self.drain_at = window // 2
        self.counts = dict(rounds=0, long=0, near=0, far=0, drains=0, rings=0, full=0)

    # ---- output window and device memory
    def slot(self, pos):
        return (np.asarray(pos) + self.so) % self.window

    def write(self, pos, vals):
        old = self.win_at[self.slot(pos)]
        lost = (old >= 0) & (old < self.out_cap) & (old >= self.flushed) & (old != pos)
        _check(not lost.any(), "a window slot is overwritten before its byte drained")
        self.win_at[self.slot(pos)] = pos
        self.win[self.slot(pos)] = vals

    def store(self, a, b, zeros=False):
        _check(a == 0 or (a + self.so) % 16 == 0, f"a store starts inside a unit at {a}")
        _check(b == self.out_cap or (b + self.so) % 16 == 0, f"a store ends inside a unit at {b}")
        pos = np.arange(a, b)
        if zeros:
            self.mem[pos] = 0
            return
        _check((self.mem[pos] == -1).all(), "a byte is stored twice")
        _check((self.win_at[self.slot(pos)] == pos).all(), "a drained byte is in the window")
        self.mem[pos] = self.win[self.slot(pos)]

    def drain(self):
        if self.op >= self.drain_at:
            lim = self.out_cap if self.op >= self.out_cap else ((self.op + self.so) & ~15) - self.so
            self.store(self.flushed, lim)
            self.flushed = lim
            self.drain_at = lim + self.window // 2 if lim < self.out_cap else 1 << 31
            self.counts["drains"] += 1

    def match(self, p, d, n):
        _check(n <= self.rnd, "a match moves at most a round")
        k = np.arange(n)
        src = p - d + (k if d >= n else k % d)
        dst = p + k
        if d <= self.reach:
            _check((self.win_at[self.slot(src)] == src).all(), "a match's source is in the window")
            _check(not np.isin(self.slot(src), self.slot(dst)).any(),
                   "a match reads a slot it writes")
            self.write(dst, self.win[self.slot(src)])
            self.counts["near"] += 1
        else:
            _check((self.mem[p - d + k] >= 0).all(), "a far match's source was drained")
            self.write(dst, self.mem[p - d + k].astype(np.uint8))
            self.counts["far"] += 1

    # ---- literals
    def enter_piece(self, pos):
        pend, kind, psrc = self.pend, self.kind, self.psrc
        q = next((i for i in range(3) if pos < pend[i]), 3)
        prev = 0 if q == 0 else pend[q - 1]
        self.piece_end = pend[q] if q < 3 else 1 << 31
        self.piece_kind = kind[q] if kind[q] in (HUFF, RAW) else 2
        self.rle = psrc[q] & 0xFF
        self.base = psrc[q] - prev
        if self.piece_kind != 2:
            buf = self.lit if self.piece_kind == HUFF else self.src
            self.ring = Ring(buf, self.base + pos, self.base + min(self.piece_end, self.cover),
                             4096 if self.window >= 32768 else 2048)
            self.counts["rings"] += 1

    def literal_pass(self, lt, lincl, mexcl, single):
        """lt literal bytes from litpos: byte j to op + j + the match bytes
        before its sequence (a binary search of the inclusive literal sums)."""
        j = 0
        while j < lt:
            pos = self.litpos + j
            if pos >= self.piece_end:
                self.enter_piece(pos)
            n = min(lt - j, self.piece_end - pos)
            if self.piece_kind != 2:
                p0 = self.base + pos - self.ring.origin
                self.ring.need(p0 + 1)
                n = min(n, self.ring.ready_end() - p0)
                vals = self.ring.bytes(p0 + np.arange(n))
            else:
                vals = np.full(n, self.rle, np.uint8)
            jj = j + np.arange(n)
            s = 0 if single else np.searchsorted(lincl, jj, side="right")
            self.write(self.op + jj + (0 if single else mexcl[s]), vals)
            j += n

    def literal_run(self, n):
        while n > 0:
            piece = min(n, self.rnd)
            self.literal_pass(piece, None, None, True)
            self.litpos += piece
            self.op += piece
            n -= piece
            self.drain()

    # ---- the kernel's loop
    def run(self):
        err = False
        for b in range(self.first, self.first + max(self.n_blocks, 0)):
            if err:
                break
            d = [int(x) for x in self.blocks[b]]
            n_seq, seq_base, lit_total = max(d[0], 0), d[1], d[2]
            self.kind, self.psrc, self.pend = d[4:8], d[8:12], d[12:16]
            self.cover = max(self.pend)
            self.litpos, self.piece_end = 0, -(1 << 31)
            i = 0
            while i < n_seq:
                t = self.seq3[seq_base + i:seq_base + min(i + 32, n_seq)].astype(np.int64)
                ll, ml, of = t[:, 0], t[:, 1], t[:, 2]
                llc, mlc = np.clip(ll, 0, CLAMP), np.clip(ml, 0, CLAMP)
                lincl, oincl = np.cumsum(llc), np.cumsum(llc + mlc)
                _check(oincl[-1] < 1 << 31 and lincl[-1] < 1 << 31, "the sums fit an int")
                lexcl, oexcl = lincl - llc, oincl - llc - mlc
                fits = oincl <= self.rnd
                n = max(int(np.argmin(fits)) if not fits.all() else len(t), 1)
                lpos = self.litpos + lexcl
                dl = self.op + oexcl
                dm = dl + llc
                bad = ((ml < 0) | (ll < 0) | (lpos + ll > lit_total)
                       | ((ll > 0) & ((lpos + ll > self.cover) | (dl + ll > self.out_cap)))
                       | ((ml > 0) & ((of <= 0) | (of > dm) | (dm + ml > self.out_cap))))
                if bad[:n].any():
                    err = True
                    break
                if n == 1 and oincl[0] > self.rnd:  # a long sequence, alone
                    self.counts["long"] += 1
                    self.literal_run(int(llc[0]))
                    rem = int(mlc[0])
                    while rem > 0:
                        piece = min(rem, self.rnd)
                        self.match(self.op, int(of[0]), piece)
                        self.op += piece
                        rem -= piece
                        self.drain()
                else:
                    self.counts["rounds"] += 1
                    self.counts["full"] += n == 32
                    lt = int(lincl[n - 1])

                    def literals():
                        self.literal_pass(lt, lincl[:n], (oexcl - lexcl)[:n], False)

                    if not self.literals_last:
                        literals()
                    for s in range(n):
                        if mlc[s] > 0:
                            self.match(int(dm[s]), int(of[s]), int(mlc[s]))
                    if self.literals_last:
                        literals()
                    self.litpos += lt
                    self.op += int(oincl[n - 1])
                    self.drain()
                i += n
            if not err:
                rest = lit_total - self.litpos
                if rest > 0:
                    err = self.litpos + rest > self.cover or self.op + rest > self.out_cap
                    if not err:
                        self.literal_run(rest)
        if err:
            self.store(0, self.out_cap, zeros=True)
        else:
            op = self.op
            if op < self.out_cap:
                unit_end = min(((op + self.so + 15) & ~15) - self.so, self.out_cap)
                self.write(np.arange(op, unit_end), 0)
                self.store(self.flushed, unit_end)
                self.store(unit_end, self.out_cap, zeros=True)
            elif self.flushed < self.out_cap:
                self.store(self.flushed, self.out_cap)
        _check((self.mem >= 0).all(), "every byte of the row is stored")
        return self.mem.astype(np.uint8), -1 if err else self.op, not err


def model_execute(args, out_cap, window, literals_last=False):
    """The model over a batch as the kernel sees it (rows of a 256-byte
    aligned tensor), and its counters summed over the frames."""
    src, lit, seq3, frames, blocks = (a.numpy() for a in args)
    models = [FrameModel(src, lit, seq3, blocks, int(f), int(n), out_cap, window,
                         (i * out_cap) % 16, literals_last)
              for i, (f, n) in enumerate(frames)]
    res = [m.run() for m in models]
    counts = {k: sum(m.counts[k] for m in models) for k in models[0].counts}
    return (torch.from_numpy(np.stack([r[0] for r in res])),
            torch.tensor([r[1] for r in res], dtype=torch.int32),
            torch.tensor([r[2] for r in res], dtype=torch.bool)), counts


@pytest.fixture(scope="module")
def planned():
    """The planned batch of tests/test_torch_zstd.py with two 8 KB text
    frames, through the plain Huffman and FSE versions."""
    fixture = [f for f in libzstd_frames() if f["cut"] <= 8192]
    frames = ([frame_enc.compress_bytes(r) for r in zstd_cases()]
              + [frame_enc.compress_bytes(_selfcheck_payload(s)[:8192]) for s in (2, 9)]
              + [f["frame"] for f in fixture])
    pk = zstd_decode.pack(device_prep.plan_batch(frames, 65536), "cpu")
    lit, _ = zstd_decode.huffman_decode_plain(pk.src, pk.h_params, pk.h_perm, pk.lit_size)
    seq3, _, _ = zstd_decode.fse_sequences_plain(pk.src, pk.s_params, pk.s_tabs, pk.s_frames,
                                                pk.seq_slots)
    return pk.src, lit, seq3, pk.b_frames, pk.blocks


@pytest.fixture(scope="module")
def hand_built():
    names, arrays = execute_round_cases()
    return names, tuple(torch.from_numpy(arrays[k])
                        for k in ("src", "lit", "seq3", "frames", "blocks"))


@pytest.mark.parametrize("out_cap", [65536, 4093])
@pytest.mark.parametrize("window", EXECUTE_WINDOWS)
@pytest.mark.parametrize("which", ["planned", "hand_built"])
def test_model_equals_execute_plain(request, which, window, out_cap):
    args = request.getfixturevalue(which)
    args = args[1] if which == "hand_built" else args
    got, counts = model_execute(args, out_cap, window)
    want = zstd_decode.execute_plain(*args, out_cap=out_cap)
    for name, g, w in zip(("out", "out_len", "ok"), got, want):
        assert torch.equal(g, w), name
    assert counts["rounds"] > 0 and counts["rings"] > 0
    if which == "hand_built" and out_cap == 65536:
        assert counts["long"] > 0 and counts["near"] > 0 and counts["far"] > 0
        assert counts["drains"] > 0 and counts["full"] > 0


def test_the_hand_built_frames(hand_built):
    """Each case decodes ok or not as its name says; the round cases take
    full rounds of 32 and the reach cases both reads."""
    names, args = hand_built
    _, out_len, ok = zstd_decode.execute_plain(*args)
    for name, n, k in zip(names, out_len.tolist(), ok.tolist()):
        assert k == (not name.startswith(("bad", "ll-", "ml-", "past"))), name
        assert k or n == -1
    assert dict(zip(names, out_len.tolist()))["out-4093"] == 4093
    _, _, ok = zstd_decode.execute_plain(*args, out_cap=4093)
    assert dict(zip(names, ok.tolist())) == {**dict.fromkeys(names, False), **{
        n: True for n in names if n.startswith(("rounds", "two-blocks", "out-4093"))}}


@pytest.mark.parametrize("window", EXECUTE_WINDOWS)
def test_literals_after_matches_are_caught(hand_built, window):
    """Literals placed after the round's matches: a match whose source is an
    earlier literal of its round reads a stale window byte."""
    names, args = hand_built
    with pytest.raises(Violation, match="a match's source is in the window"):
        model_execute(args, 65536, window, literals_last=True)


def test_offset_shares_of_a_hand_built_batch():
    """Matches at offsets 1, 100, and each reach and reach + 1, and a
    sequence with no match (not counted), in two frames."""
    reach4, reach32 = map(offset_reach, EXECUTE_WINDOWS)
    b = ExecBatch(3)
    seqs = [(40000, 4, 1), (0, 10, 100), (0, 20, reach4), (0, 30, reach4 + 1)]
    b.frame("a", [b.block(seqs, 40000, [(0, 0, 40000)])])
    seqs = [(30000, 40, reach32), (0, 64, reach32 + 1), (5, 0, 7)]
    b.frame("b", [b.block(seqs, 30005, [(0, 0, 30005)])])
    a = {k: torch.from_numpy(v) for k, v in b.arrays().items()}
    got = zstd_decode.offset_shares(a["seq3"], a["frames"], a["blocks"], (reach4, reach32))
    assert got["matches"] == 6 and got["match_bytes"] == 168
    assert got["within"][reach4] == {"matches": 3 / 6, "bytes": 34 / 168}
    assert got["within"][reach32] == {"matches": 5 / 6, "bytes": 104 / 168}
