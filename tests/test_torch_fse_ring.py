"""A model of the zstd FSE sequences kernel's walk, against the plain version.

``csrc/zstd_fse.cu`` walks each frame's sequences sections with a group of
8 lanes (four frames a warp). Per section it stages the 2^log entries of its LL,
OF and ML tables into shared memory and streams the section's bytes through
a backward ring (1 KB: slices of 256 B issued from the top of the section
down, all but two slices of the ring ahead of the one being read). Per
sequence it loads a 64-bit window of bits ending at its bit position from
the ring, and reloads it where a read falls below. Those rules cannot run
here, so this file models them in numpy, in the kernel's order, and checks
what the kernel relies on:

- a state lies within its staged table (the first 2^log entries), so the
  kernel's state mod 2^log and the plain version's mod 512 and 256 (the
  Pallas kernel's masks) pick the same entry;
- a bit is read only from the register window, and only after the ring
  slice that holds it arrived and before a later slice reused its place
  (bits below the section's start or past the input read as 0);
- all but two slices of the ring are in flight.

The model's (seq3, rem, err) must equal ``fse_sequences_plain`` exactly
(integer codec: tolerance 0) on the libzstd fixture's frames (multi-block
frames whose repeat offsets carry across blocks), frames from the host
encoder (one of short matches whose bitstream spans many ring slices) and
the hand-built sections of ``chip_smoke.fse_section_cases``. A skipped
window refill, a table log one too small and a slice issued one place too
early must break a rule. ``pack`` writes the three logs into word 7, and
the model's triples decode through ``execute_plain`` to what the JAX
package's host decoder gives. The JAX package's ``zstd_pallas`` is not run:
one interpret-mode call on two 16 KB frames takes minutes.
"""

import numpy as np
import pytest
import torch

from aircompressor_tpu.zstd import frame_dec as jax_dec
from aircompressor_tpu_torch.data import libzstd_frames
from aircompressor_tpu_torch.host.zstd import constants as C
from aircompressor_tpu_torch.host.zstd import device_prep, frame_enc
from aircompressor_tpu_torch.ops import zstd_decode
from chip_smoke import fse_section_cases, fse_short_match_chunk, zstd_cases

SLICE = 256
RING = 1024
AHEAD = RING // SLICE - 2
MAX_LOGS = (9, 8, 9)
SHORT_MATCH = 16384  # the short-match chunk's cut here (64 KB on the card)
LL_CODES = [(int(b), int(n)) for b, n in zip(C.LL_BASE, C.LL_BITS)]
ML_CODES = [(int(b), int(n)) for b, n in zip(C.ML_BASE, C.ML_BITS)]


class Violation(AssertionError):
    """A rule of the kernel's tables, ring or window was broken."""


def _check(cond, what):
    if not cond:
        raise Violation(what)


class BatchModel:
    """The kernel's walk over every frame of a batch. ``skip_refill``: the
    first sequence whose reads the window it holds does not cover keeps it
    (no load, no reload); ``small_log`` = k: table k's log reads one too
    small; ``early``: one slice more in flight than the ring's places
    allow."""

    def __init__(self, src, params, tabs, *, skip_refill=False, small_log=None, early=False):
        self.data = bytes(np.asarray(src, np.uint8))
        self.params = np.asarray(params).tolist()
        self.tabs = np.asarray(tabs)
        self.skip_refill, self.small_log, self.early = skip_refill, small_log, early
        self.counts = dict(sequences=0, sections=0, waits=0, reloads=0, below=0, past=0,
                           crossing=0)

    # ---- backward ring
    def _issue(self):
        q = self.next
        if q >= 0:
            for c in range(max(q * SLICE, self.lo), min((q + 1) * SLICE, self.hi)):
                self.ring_at[c % RING] = -2  # in flight: neither old nor new
        self.next -= 1

    def _need(self, c):
        while self.ready > 0 and self.ready * SLICE > c:
            q = self.ready - 1
            for p in range(max(q * SLICE, self.lo), min((q + 1) * SLICE, self.hi)):
                self.ring_at[p % RING] = p
            self.ready -= 1
            self.counts["waits"] += 1
            self._issue()

    # ---- the register window
    def _load(self, b):
        self._need(max(b, 0) + self.lo)
        self.win, self.held, self.wb = 0, [], 8 * b
        for k in range(8):
            i = b + k
            if 0 <= i < self.valid:
                c = i + self.lo
                self.held.append(self.ring_at[c % RING] == c)
                self.win |= self.data[self.byte_lo + i] << (8 * k)
            else:
                self.held.append(True)  # read as 0
                if i < 0:
                    self.counts["below"] += 1
                elif i < self.top:
                    self.counts["past"] += 1
        self.counts["crossing"] += (max(b, 0) + self.lo) // SLICE != (b + 7 + self.lo) // SLICE

    def _bits(self, at, n):
        if n == 0:
            return 0
        if at < self.wb and not self.frozen:
            self.counts["reloads"] += 1
            self._load(((at + n + 7) >> 3) - 8)
        _check(self.wb <= at and at + n <= self.wb + 64, "a read lies within the register window")
        for k in range((at - self.wb) >> 3, ((at + n - 1 - self.wb) >> 3) + 1):
            _check(self.held[k], "a bit is read after its slice arrived and before its place "
                                 "was reused")
        return (self.win >> (at - self.wb)) & ((1 << n) - 1)

    def _entry(self, k, state):
        _check(0 <= state < self.sizes[k], "a state lies within its staged table")
        return int(self.tabs[self.s, (0, 512, 768)[k] + state])

    # ---- the walk
    def run(self, frames, seq_slots):
        seq3 = np.zeros((seq_slots, 3), np.int64)
        rem_out = np.zeros(len(self.params), np.int64)
        err_out = np.zeros(len(self.params), np.int64)
        for first, count in np.asarray(frames).tolist():
            rep = [1, 4, 8]
            for s in range(first, first + count):
                self._section(s, rep, seq3, rem_out, err_out)
        return (torch.from_numpy(seq3).to(torch.int32), torch.from_numpy(rem_out).to(torch.int32),
                torch.from_numpy(err_out).to(torch.int32))

    def _section(self, s, rep, seq3, rem_out, err_out):
        self.s = s
        byte_lo, rem, nseq, out_base, lls, ofs, mls, logs = self.params[s]
        logs = [min((logs >> (8 * k)) & 255, m) for k, m in enumerate(MAX_LOGS)]
        if self.small_log is not None:
            logs[self.small_log] = max(logs[self.small_log] - 1, 0)
        self.sizes = [1 << log for log in logs]
        self.counts["sections"] += 1
        # the ring, from the top of the section's bytes down (the input's
        # address is 16-byte aligned, as a fresh tensor's is)
        self.byte_lo, self.lo = byte_lo, byte_lo % 16
        self.top = max((rem + 7) >> 3, 0)
        self.valid = max(min(byte_lo + self.top, len(self.data)) - byte_lo, 0)
        self.hi = self.lo + self.valid
        self.ring_at = [-1] * RING  # the previous section's bytes are stale
        self.next = (self.hi - 1) // SLICE if self.hi > self.lo else -1
        self.ready = self.next + 1
        for _ in range(AHEAD + self.early):
            self._issue()
        self.wb, self.win, self.held, self.frozen = 1 << 40, 0, [], False
        err = 0
        for i in range(nseq):
            self.counts["sequences"] += 1
            le, oe, me = self._entry(0, lls), self._entry(1, ofs), self._entry(2, mls)
            llc, mlc = le & 63, me & 63
            ofc = oe & 63
            if ofc > 23:
                err, ofc = 1, 23
            ll_base, ll_bits = LL_CODES[llc] if llc < len(LL_CODES) else (0, 0)
            ml_base, ml_bits = ML_CODES[mlc] if mlc < len(ML_CODES) else (0, 0)
            last = i == nseq - 1
            nbs = (0, 0, 0) if last else ((le >> 6) & 15, (me >> 6) & 15, (oe >> 6) & 15)
            reads, at = [], rem  # (position, width) of each read, in order
            for n in (ofc, ml_bits, ll_bits, *nbs):
                at -= n
                reads.append((at, n))
            low = min((p for p, n in reads if n > 0), default=rem)
            if self.skip_refill and i > 0 and low < self.wb:
                self.skip_refill, self.frozen = False, True
            else:
                self._load(((rem + 7) >> 3) - 8)
            pos = rem - ofc
            of_value = (1 << ofc) + self._bits(pos, ofc)
            pos -= ml_bits
            ml = ml_base + self._bits(pos, ml_bits)
            pos -= ll_bits
            ll = ll_base + self._bits(pos, ll_bits)
            if of_value > 3:
                offset = of_value - 3
                rep[:] = [offset, rep[0], rep[1]]
            else:
                idx = of_value - 1 + (ll == 0)
                if idx == 0:
                    offset = rep[0]
                else:
                    offset = (rep[1], rep[2], rep[0] - 1)[idx - 1]
                    err |= offset <= 0
                    rep[:] = [offset, rep[0], rep[2] if idx == 1 else rep[1]]
            if not last:
                pos -= nbs[0]
                lls = ((le >> 10) & 1023) + self._bits(pos, nbs[0])
                pos -= nbs[1]
                mls = ((me >> 10) & 1023) + self._bits(pos, nbs[1])
                pos -= nbs[2]
                ofs = ((oe >> 10) & 1023) + self._bits(pos, nbs[2])
            err |= pos < 0
            rem = pos
            self.frozen = False
            seq3[out_base + i] = (ll, ml, offset)
        rem_out[s], err_out[s] = rem, err


def _frames_batch():
    fixture = libzstd_frames()
    raws = zstd_cases() + [fse_short_match_chunk(SHORT_MATCH)]
    frames = [f["frame"] for f in fixture] + [frame_enc.compress_bytes(r, 3) for r in raws]
    return frames, [f["original"] for f in fixture] + raws


@pytest.fixture(scope="module")
def frames_batch():
    frames, originals = _frames_batch()
    plan = device_prep.plan_batch(frames, 65536)
    pk = zstd_decode.pack(plan, "cpu")
    args = (pk.src, pk.s_params, pk.s_tabs, pk.s_frames, pk.seq_slots)
    return dict(frames=frames, originals=originals, plan=plan, pk=pk, args=args,
                plain=zstd_decode.fse_sequences_plain(*args))


@pytest.fixture(scope="module")
def hand_batch():
    names, a = fse_section_cases()
    args = (torch.from_numpy(a["src"]), torch.from_numpy(a["params"]),
            torch.from_numpy(a["tabs"]), torch.from_numpy(a["frames"]), a["seq_slots"])
    return dict(names=names, args=args, plain=zstd_decode.fse_sequences_plain(*args))


def _model(batch, **kw):
    src, params, tabs, frames, slots = batch["args"]
    model = BatchModel(src.numpy(), params.numpy(), tabs.numpy(), **kw)
    return model.run(frames.numpy(), slots), model.counts


@pytest.mark.parametrize("which", ["frames_batch", "hand_batch"])
def test_model_equals_fse_sequences_plain(request, which):
    batch = request.getfixturevalue(which)
    got, counts = _model(batch)
    for name, g, w in zip(("seq3", "rem", "err"), got, batch["plain"]):
        assert torch.equal(g, w), name
    assert counts["waits"] > counts["sections"] and counts["crossing"] > 0


def test_the_cases_take_each_path(frames_batch, hand_batch):
    """The short-match frame's section spans many ring slices; hand-built
    sections reload the window within a sequence, read below their start
    and past the input; their err flags are the cases'."""
    plan = frames_batch["plan"]
    big = max(plan.seq_streams, key=lambda s: s.nseq)
    assert big.nseq >= 1500 and big.rem_init // 8 >= 12 * SLICE
    _, counts = _model(hand_batch)
    assert counts["reloads"] > 0 and counts["below"] > 0 and counts["past"] > 0
    names = hand_batch["names"]
    frames = hand_batch["args"][3].tolist()
    err, rem = hand_batch["plain"][2].tolist(), hand_batch["plain"][1].tolist()
    flags = {n: [err[s] for s in range(f, f + c)] for n, (f, c) in zip(names, frames)}
    assert flags["of-code-26"] == flags["repeat-offset-0"] == flags["below-start"] == [1]
    assert flags["no-sequences"] == []
    assert rem[frames[names.index("below-start")][0]] < 0
    assert hand_batch["args"][1][frames[names.index("one-sequence")][0], 2] == 1


@pytest.mark.parametrize("kw, which, what", [
    (dict(skip_refill=True), "frames_batch", "a read lies within the register window"),
    (dict(small_log=0), "hand_batch", "a state lies within its staged table"),
    (dict(early=True), "frames_batch", "a bit is read after its slice arrived")])
def test_a_broken_rule_is_caught(request, kw, which, what):
    """The checks bite: a sequence that keeps a window not covering its
    reads, an LL table staged at half its size, and a slice issued over the
    place of one still read."""
    with pytest.raises(Violation, match=what):
        _model(request.getfixturevalue(which), **kw)


def test_pack_writes_the_logs(frames_batch):
    plan, pk = frames_batch["plan"], frames_batch["pk"]
    want = [s.ll_log | s.of_log << 8 | s.ml_log << 16 for s in plan.seq_streams]
    assert pk.s_params[:, zstd_decode.S_LOGS].tolist() == want


@pytest.mark.parametrize("word, by", [(4, 512), (5, 256), (6, 512)])
def test_plain_indexes_a_state_mod_512_and_256(hand_batch, word, by):
    """The plain version masks the LL and ML states by 511 and the OF state
    by 255, as the Pallas kernel does: the 9/8/9 section with one initial
    state raised by its table's size decodes the same."""
    src, params, tabs, frames, slots = hand_batch["args"]
    s = frames[hand_batch["names"].index("max-logs"), 0]
    assert params[s, zstd_decode.S_LOGS] == 9 | 8 << 8 | 9 << 16
    raised = params.clone()
    raised[s, word] += by
    got = zstd_decode.fse_sequences_plain(src, raised, tabs, frames, slots)
    for g, w in zip(got, hand_batch["plain"]):
        assert torch.equal(g, w)


def test_model_triples_decode_as_the_jax_host_decoder(frames_batch):
    """The model's triples, through ``execute_plain`` with the plain
    literals, give every frame's original, as the JAX package's host
    decoder does."""
    pk = frames_batch["pk"]
    (seq3, rem, err), _ = _model(frames_batch)
    assert not rem.any() and not err.any()
    lit, _ = zstd_decode.huffman_decode_plain(pk.src, pk.h_params, pk.h_perm, pk.lit_size)
    out, out_len, ok = zstd_decode.execute_plain(pk.src, lit, seq3, pk.b_frames, pk.blocks)
    assert ok.all()
    for i, (frame, raw) in enumerate(zip(frames_batch["frames"], frames_batch["originals"])):
        dst = np.zeros(65536, np.uint8)
        n = jax_dec.decompress(np.frombuffer(frame, np.uint8), dst)
        assert dst[:n].tobytes() == raw
        assert int(out_len[i]) == n and out[i, :n].numpy().tobytes() == raw
