"""A model of the DFAST kernel's rounds of 32 probes, against the plain
version.

``csrc/zstd_dfast.cu`` probes 32 positions at once: between two matches
the positions depend only on the anchor, lane k takes the k-th, its
candidate in each table is the position of the highest lane below it with
the same hash (else the entry as the round found it), the first lane m
that matches ends the round, and for each hash only the highest lane <= m
that has it writes the table. A lane runs only while its position is below
the limit and the steps before it are below the cap. Extension compares 4
bytes a lane, 128 a step. Those rules cannot run here, so this file models
them in numpy, round by round, and holds the model to
``find_sequences_plain`` (the serial scan) on every output and on the step
counts, exactly (an integer matcher: tolerance 0): on the DFAST edge cases
of ``chip_smoke.dfast_cases``, on two hand-built chunks (two probes of one
round with both hashes equal and unequal bytes; a lane that matches through
an earlier lane of its round) and with a small step cap. Two broken models
(every probe of the round commits its writes; a lane takes the table's
entry even where an earlier lane of its round has its hash) must fail.
"""

import numpy as np
import pytest
import torch

from aircompressor_tpu_torch.ops import zstd_dfast
from chip_smoke import dfast_cases, dfast_collision_case, dfast_in_round_case

HASH_LOG = 14
SEQ_CAP = 16384
M32 = 0xFFFFFFFF
EMPTY = 0xFFFF


def hashes(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The long and short hashes of 8-byte little-endian words."""
    w = w.astype(np.uint64)
    lo, b4, hi3 = w & M32, (w >> 32) & 0xFF, w >> 40
    h_l = (((lo * 0x1E35A7BD) ^ (hi3 * 0x9E3779B9) ^ (b4 * 0x85EBCA77)) & M32) >> 18
    h_s = (((lo * 0x9E3779B9) ^ (b4 * 0x1E35A7BD)) & M32) >> 18
    return h_l.astype(np.int64), h_s.astype(np.int64)


def probe_positions(ip: int, anchor: int) -> np.ndarray:
    """The 32 positions of a round, as the kernel computes them: by bands of
    256 from the anchor, where the step is the band's index + 1."""
    out, d = [], ip - anchor
    for _ in range(32):
        out.append(anchor + d)
        d += 1 + (d >> 8)
    return np.array(out, np.int64)


def word_at(row: np.ndarray, pos: int, n: int, width: int = 4) -> int:
    """Bytes pos..pos+width-1, those outside [0, n) as 0 (the kernel's
    guarded loads)."""
    v = 0
    for i in range(width):
        if 0 <= pos + i < n:
            v |= int(row[pos + i]) << (8 * i)
    return v


class RoundModel:
    """One chunk through the kernel's rounds. ``commit_all`` and ``stale``
    break one rule each (see the module doc)."""

    def __init__(self, row: np.ndarray, n: int, cap: int = 4 * 65536,
                 commit_all: bool = False, stale: bool = False):
        self.row, self.n, self.cap = row, n, cap
        self.commit_all, self.stale = commit_all, stale
        self.rounds = self.in_round_candidates = 0

    def forward(self, mstart: int, cand: int) -> int:
        mlen, n, row = 4, self.n, self.row
        while True:
            for lane in range(32):  # one ballot: the first lane whose word differs
                a = mstart + mlen + 4 * lane
                valid = min(max(n - a, 0), 4)
                diff = (word_at(row, a, n) ^ word_at(row, cand + mlen + 4 * lane, n)
                        if valid else 0)
                if valid < 4:
                    diff |= (M32 << (8 * valid)) & M32
                if diff:
                    return mlen + 4 * lane + ((diff & -diff).bit_length() - 1) // 8
            mlen += 128

    def backward(self, mstart: int, cand: int, room: int) -> int:
        n, row = self.n, self.row
        for lane in range(32):  # room <= 127: one ballot always ends it
            q = 4 * lane
            diff = (word_at(row, mstart - 4 - q, n) ^ word_at(row, cand - 4 - q, n)
                    if q < room else 0)
            if q + 4 > room:
                diff |= M32 if q >= room else M32 >> (8 * (room - q))
            if diff:
                return q + 3 - (diff.bit_length() - 1) // 8
        raise AssertionError("a backward step always ends")

    def run(self):
        row, n, cap = self.row, self.n, self.cap
        tab_l = np.full(1 << HASH_LOG, EMPTY, np.int64)
        tab_s = np.full(1 << HASH_LOG, EMPTY, np.int64)
        seqs = []
        limit = n - 12
        ip = anchor = steps = 0
        rep0, err = 1, False
        lanes = np.arange(32)
        padded = np.zeros(n + 40, np.uint8)
        padded[:n] = row[:n]
        if n >= 24:
            while ip < limit:
                self.rounds += 1
                p = probe_positions(ip, anchor)
                active = (p < limit) & (steps + lanes < cap)
                n_active = int(active.sum())
                words = np.zeros(32, np.uint64)
                for k in range(n_active):
                    words[k] = int.from_bytes(padded[p[k]:p[k] + 8].tobytes(), "little")
                h_l, h_s = hashes(words)
                cands, kinds = [], []
                for k in range(32):
                    if not active[k]:
                        cands.append(None)
                        kinds.append(None)
                        continue
                    lo = int(words[k]) & M32
                    pk = int(p[k])
                    c = []
                    for h, tab in ((h_l, tab_l), (h_s, tab_s)):
                        earlier = [j for j in range(k) if h[j] == h[k]]
                        if earlier and not self.stale:
                            self.in_round_candidates += 1
                            c.append(int(p[earlier[-1]]))
                        else:
                            c.append(int(tab[h[k]]))
                    rep_pos = pk + 1 - rep0
                    if rep_pos >= 0 and word_at(row, rep_pos, n) == (int(words[k]) >> 8) & M32:
                        kinds.append(("rep", pk + 1, rep_pos))
                    elif c[0] < pk and word_at(row, c[0], n) == lo:
                        kinds.append(("long", pk, c[0]))
                    elif c[1] < pk and word_at(row, c[1], n) == lo:
                        kinds.append(("short", pk, c[1]))
                    else:
                        kinds.append(None)
                    cands.append(c)
                hits = [k for k in range(n_active) if kinds[k] is not None]
                last = hits[0] if hits else n_active - 1
                commit = n_active - 1 if self.commit_all else last
                for j in range(commit + 1):  # in lane order: the highest writes last
                    tab_l[h_l[j]] = p[j]
                    tab_s[h_s[j]] = p[j]
                if not hits:
                    steps += n_active
                    if n_active == 32:
                        ip = int(p[31] + 1 + ((p[31] - anchor) >> 8))
                        continue
                    ip = int(p[n_active])
                    err = ip < limit
                    break
                steps += last + 1
                _, mstart, cand = kinds[last]
                mlen = self.forward(mstart, cand)
                room = min(mstart - anchor, cand, 127)
                back = self.backward(mstart, cand, room) if room > 0 else 0
                steps += 1
                f_start, f_len = mstart - back, mlen + back
                f_ll, moff = f_start - anchor, mstart - cand
                seqs.append((f_ll, f_len, moff))
                rep0 = moff
                ip = anchor = f_start + f_len
                if len(seqs) > SEQ_CAP or f_ll < 0 or moff <= 0 or moff > f_start:
                    err = True
                    break
        return seqs, n - anchor, not err, steps


def model_batch(data: torch.Tensor, lengths: torch.Tensor, **kw):
    """The model over a batch, shaped as ``find_sequences_plain(...,
    with_steps=True)``, and the rounds and in-round candidates it took."""
    B = data.shape[0]
    out = [np.zeros((B, SEQ_CAP), np.int32) for _ in range(3)]
    nseq, last_lit, ok, steps = (np.zeros(B, np.int32) for _ in range(4))
    rounds = in_round = 0
    for i in range(B):
        m = RoundModel(data[i].numpy(), int(lengths[i]), **kw)
        seqs, last_lit[i], ok[i], steps[i] = m.run()
        nseq[i] = len(seqs)
        for j, s in enumerate(seqs[:SEQ_CAP]):
            for k in range(3):
                out[k][i, j] = s[k]
        rounds += m.rounds
        in_round += m.in_round_candidates
    got = tuple(torch.from_numpy(a) for a in out) + (
        torch.from_numpy(nseq), torch.from_numpy(last_lit),
        torch.from_numpy(ok.astype(bool)), torch.from_numpy(steps))
    return got, rounds, in_round


def _batch(chunks):
    width = max(map(len, chunks)) | 1  # an odd width
    buf = np.zeros((len(chunks), width), np.uint8)
    for i, c in enumerate(chunks):
        buf[i, :len(c)] = np.frombuffer(c, np.uint8)
    return (torch.from_numpy(buf),
            torch.tensor([len(c) for c in chunks], dtype=torch.int32))


NAMES = ("ll", "ml", "of", "nseq", "last_lit", "ok", "steps")
COLLISION, COLLISION_AT = dfast_collision_case()
IN_ROUND, IN_ROUND_AT = dfast_in_round_case()
CHUNKS = dfast_cases() + [COLLISION, IN_ROUND]


@pytest.fixture(scope="module")
def batch():
    data, lengths = _batch(CHUNKS)
    return data, lengths, zstd_dfast.find_sequences_plain(data, lengths, with_steps=True)


def _differs(got, want) -> list[str]:
    return [name for name, g, w in zip(NAMES, got, want) if not torch.equal(g, w)]


def test_model_equals_find_sequences_plain(batch):
    data, lengths, want = batch
    got, rounds, in_round = model_batch(data, lengths)
    assert _differs(got, want) == []
    assert bool(want[5].all()) and rounds > 0 and in_round > 0
    # every round but those a match ends runs 32 probes: far fewer rounds than probes
    assert rounds < int(want[6].sum()) // 8


def test_the_hand_built_chunks(batch):
    """The collision chunk: its second probe of the pair is the k-th of a
    round whose earlier lane has both of its hashes and other bytes, while
    the table holds an older position with its bytes. The in-round chunk:
    a lane matches the word an earlier lane of its round probed."""
    data, lengths, want = batch
    i = len(CHUNKS) - 2
    older, earlier, later = COLLISION_AT
    assert older < earlier < later
    assert int(want[3][i]) == 0  # the true candidate has other bytes: no match
    j = i + 1
    a, b = IN_ROUND_AT
    assert int(want[3][j]) == 1 and (int(want[0][j, 0]), int(want[2][j, 0])) == (b, b - a)


@pytest.mark.parametrize("broken", ["commit_all", "stale"])
def test_a_broken_rule_fails(batch, broken):
    data, lengths, want = batch
    got, _, _ = model_batch(data, lengths, **{broken: True})
    assert _differs(got, want) != []
    if broken == "stale":  # the collision chunk alone shows it
        i = len(CHUNKS) - 2
        one, _, _ = model_batch(data[i:i + 1], lengths[i:i + 1], stale=True)
        assert _differs(one, [w[i:i + 1] for w in want]) != []


@pytest.mark.parametrize("cap", [1, 31, 32, 33, 100])
def test_the_step_cap_fires_where_the_serial_scan_fires_it(batch, cap, monkeypatch):
    data, lengths, _ = batch
    rows = slice(4, 7)  # the text heads: probes and matches before the cap
    monkeypatch.setattr(zstd_dfast, "STEP_CAP", cap)
    want = zstd_dfast.find_sequences_plain(data[rows], lengths[rows], with_steps=True)
    got, _, _ = model_batch(data[rows], lengths[rows], cap=cap)
    assert _differs(got, want) == []
    assert not bool(want[5].any()) and all(s in (cap, cap + 1) for s in want[6].tolist())


def kernel_probe_position(ip: int, anchor: int, lane: int) -> int:
    """csrc/zstd_dfast.cu's probe_position, line for line."""
    d = ip - anchor
    step = (d >> 8) + 1
    if d + 31 * step < ((d >> 8) + 1) << 8:
        return ip + lane * step
    k = lane
    while True:
        s = (d >> 8) + 1
        left = ((s << 8) - d + s - 1) // s
        if k < left:
            return anchor + d + k * s
        d += left * s
        k -= left


def test_band_positions_equal_the_serial_steps():
    rng = np.random.default_rng(3)
    for d in list(range(0, 1200)) + rng.integers(0, 65536, 400).tolist():
        anchor = int(rng.integers(0, 100))
        want = probe_positions(anchor + d, anchor).tolist()
        assert [kernel_probe_position(anchor + d, anchor, k) for k in range(32)] == want


def serial_walk(row: np.ndarray, n: int):
    """The serial scan written out probe by probe, byte by byte: (sequences,
    last_lit, ok, steps), one step for each probe and each match."""
    tab_l, tab_s = {}, {}
    limit, ip, anchor, rep0, steps, seqs = n - 12, 0, 0, 1, 0, []

    def u32(p):
        return int.from_bytes(row[p:p + 4].tobytes(), "little")

    while n >= 24 and ip < limit:
        steps += 1
        h_l, h_s = (int(h[0]) for h in hashes(np.array(
            [int.from_bytes(row[ip:ip + 8].tobytes(), "little")], np.uint64)))
        cand_l, cand_s = tab_l.get(h_l, EMPTY), tab_s.get(h_s, EMPTY)
        tab_l[h_l] = tab_s[h_s] = ip
        if ip + 1 - rep0 >= 0 and u32(ip + 1 - rep0) == u32(ip + 1):
            mstart, cand = ip + 1, ip + 1 - rep0
        elif cand_l < ip and u32(cand_l) == u32(ip):
            mstart, cand = ip, cand_l
        elif cand_s < ip and u32(cand_s) == u32(ip):
            mstart, cand = ip, cand_s
        else:
            ip += 1 + ((ip - anchor) >> 8)
            continue
        mlen = 4
        while mstart + mlen < n and row[mstart + mlen] == row[cand + mlen]:
            mlen += 1
        back, room = 0, min(mstart - anchor, cand, 127)
        while back < room and row[mstart - 1 - back] == row[cand - 1 - back]:
            back += 1
        steps += 1
        seqs.append((mstart - back - anchor, mlen + back, mstart - cand))
        rep0 = mstart - cand
        ip = anchor = mstart + mlen
    return seqs, n - anchor, True, steps


def test_with_steps_counts_the_probes_and_matches(batch):
    """find_sequences_plain's step counts (and sequences) equal the serial
    walk's on every chunk; without with_steps the six outputs are the same."""
    data, lengths, want = batch
    for i in range(len(CHUNKS)):
        seqs, last_lit, ok, steps = serial_walk(data[i].numpy(), int(lengths[i]))
        nseq = len(seqs)
        assert (int(want[3][i]), int(want[4][i]), bool(want[5][i]), int(want[6][i])) == (
            nseq, last_lit, ok, steps), i
        assert [tuple(int(want[k][i, j]) for k in range(3)) for j in range(nseq)] == seqs, i
    plain = zstd_dfast.find_sequences_plain(data, lengths)
    assert len(plain) == 6 and _differs(plain, want[:6]) == []
