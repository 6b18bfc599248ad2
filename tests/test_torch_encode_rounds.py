"""A model of the LZ4 and Snappy encode kernels' rounds of 32 probes, against
the plain versions.

``csrc/lz4_encode.cu`` and ``csrc/snappy_encode.cu`` probe 32 positions at
once: between two matches the scan's positions depend only on the round's
``ip`` and ``skip`` (``p(k + 1) = p(k) + ((skip + k) >> shift)``, shift 6
for LZ4 and 5 for Snappy; ``skip`` is a multiple of 32 at every round's
start, so the step is the same for all 32 lanes), and only lanes below the
find limit run. Lane k's candidate is the position of the highest lane
below it with the same hash, else the table's entry as the round found it;
the first lane m that hits ends the round, and for each hash only the
highest lane <= m that has it writes the table. Extension compares 4 bytes
a lane, 128 a ballot. Those rules cannot run here, so this file models
them in numpy, round by round, with the two encoders' emitters written out
byte by byte, and holds the model to ``encode_plain`` (the serial scan) on
``comp``, ``comp_lens``, ``ok`` and the step counts, exactly (integer
encoders: tolerance 0): on ``chip_smoke.encode_cases`` and on the
hand-built round chunks of ``chip_smoke.encode_round_cases``. Two broken
models (every running lane of the round commits its write; a lane takes the
table's entry although an earlier lane of its round has its hash) must
fail.
"""

import numpy as np
import pytest
import torch

from aircompressor_tpu_torch.ops import lz4_encode, snappy_encode
from aircompressor_tpu_torch.ops.batch import _pack
from chip_smoke import (ENC_CUT, enc_hash, enc_margin, enc_probes, encode_cases,
                        encode_round_cases)

EMPTY = 0xFFFF
CODECS = {"lz4": lz4_encode, "snappy": snappy_encode}


def u32(row: np.ndarray, pos: int) -> int:
    return int.from_bytes(row[pos:pos + 4].tobytes(), "little")


def lz4_length(out: bytearray, n: int) -> None:
    rest = n - 15
    out += b"\xff" * (rest // 255) + bytes([rest % 255])


def lz4_sequence(out: bytearray, row, start: int, lit: int, ml: int, dist: int) -> None:
    out.append((min(lit, 15) << 4) | (min(ml - 4, 15) if ml else 0))
    if lit >= 15:
        lz4_length(out, lit)
    out += row[start:start + lit].tobytes()
    if ml:
        out += bytes([dist & 255, dist >> 8])
        if ml - 4 >= 15:
            lz4_length(out, ml - 4)


def snappy_literal(out: bytearray, row, start: int, n: int) -> None:
    n1 = n - 1
    if n1 < 60:
        out.append(n1 << 2)
    elif n1 < 256:
        out += bytes([60 << 2, n1])
    else:
        out += bytes([61 << 2, n1 & 255, n1 >> 8])
    out += row[start:start + n].tobytes()


def snappy_copy(out: bytearray, n: int, dist: int) -> None:
    d = bytes([dist & 255, dist >> 8])
    n64 = (n - 68) // 64 + 1 if n >= 68 else 0
    out += (bytes([2 | (63 << 2)]) + d) * n64
    rest = n - 64 * n64
    if rest > 64:
        out += bytes([2 | (59 << 2)]) + d
        rest -= 60
    if rest <= 11 and dist < 2048:
        out += bytes([1 | ((rest - 4) << 2) | ((dist >> 8) << 5), dist & 255])
    else:
        out += bytes([2 | ((rest - 1) << 2)]) + d


class RoundModel:
    """One chunk through the kernel's rounds. ``commit_all`` and ``stale``
    break one rule each (see the module doc). ``events`` counts what the
    rounds met: in-round candidates and hits, rounds cut by the limit,
    forward extensions that stopped inside a lane's window at the limit."""

    def __init__(self, codec: str, row: np.ndarray, n: int,
                 commit_all: bool = False, stale: bool = False):
        self.codec, self.row, self.n = codec, row, n
        self.commit_all, self.stale = commit_all, stale
        self.shift = 6 if codec == "lz4" else 5
        self.events = dict(rounds=0, in_round_cands=0, in_round_hits=0, cut_hits=0,
                           limit_in_lane=0, step_changes=0, hits=0)
        self.hits = []  # (round since the anchor, step, lane) of each hit
        self.positions = []  # every probe that ran, in order

    def forward(self, ip: int, cand: int, limit: int) -> int:
        """4 bytes a lane, 128 a ballot; bytes at or past ``limit`` differ
        and are not read."""
        mlen, row = 4, self.row
        while True:
            for lane in range(32):
                a = ip + mlen + 4 * lane
                valid = min(max(limit - a, 0), 4)
                diff = [row[a + i] != row[cand + mlen + 4 * lane + i] for i in range(valid)]
                if any(diff):
                    return mlen + 4 * lane + diff.index(True)
                if valid < 4:
                    self.events["limit_in_lane"] += valid > 0
                    return mlen + 4 * lane + valid
            mlen += 128

    def backward(self, ip: int, cand: int, room: int) -> int:
        """One ballot (room <= 127): lane k takes the bytes ip-1-q against
        cand-1-q for q = 4k..4k+3; those with q >= room differ and are not
        read."""
        row = self.row
        for lane in range(32):
            for q in range(4 * lane, 4 * lane + 4):
                if q >= room or row[ip - 1 - q] != row[cand - 1 - q]:
                    return q
        raise AssertionError("a backward ballot always ends")

    def run(self):
        row, n, codec, shift = self.row, self.n, self.codec, self.shift
        out = bytearray()
        if codec == "snappy":
            m = n
            while m >= 128:
                out.append((m & 127) | 128)
                m >>= 7
            out.append(m)
        table = np.full(1 << 14, EMPTY, np.int64)
        find_limit = n - enc_margin(codec)
        match_limit = n - 5 if codec == "lz4" else n
        ip = anchor = steps = 0
        skip = 1 << shift
        step_before, since = None, 0
        while ip < find_limit:
            assert skip % 32 == 0  # so the step is the same for the whole round
            self.events["rounds"] += 1
            step = skip >> shift
            self.events["step_changes"] += step_before is not None and step != step_before
            step_before = step
            p = [ip + k * step for k in range(32)]
            running = sum(q < find_limit for q in p)
            words = [u32(row, q) for q in p[:running]]
            h = enc_hash(codec, np.array(words, np.uint64)).astype(np.int64)
            hit_at = cand_at = None
            for k in range(running):
                earlier = [j for j in range(k) if h[j] == h[k]]
                if earlier and not self.stale:
                    self.events["in_round_cands"] += 1
                    j = earlier[-1]
                    hit = words[j] == words[k]  # the earlier lane's word, by shuffle
                    cand = p[j]
                else:
                    cand = int(table[h[k]])
                    hit = cand < p[k] and u32(row, cand) == words[k]
                if hit:
                    hit_at, cand_at = k, cand
                    self.events["in_round_hits"] += bool(earlier) and not self.stale
                    break
            last = running - 1 if hit_at is None else hit_at
            for j in range(running if self.commit_all else last + 1):
                table[h[j]] = p[j]  # in lane order: the highest lane writes last
            self.positions += p[:last + 1]
            steps += last + 1
            if hit_at is None:
                skip += running
                ip = p[31] + step
                since += 1
                continue
            self.events["hits"] += 1
            self.hits.append((since, step, hit_at))
            self.events["cut_hits"] += running < 32
            ip, cand = p[hit_at], cand_at
            mlen = self.forward(ip, cand, match_limit)
            back = self.backward(ip, cand, min(ip - anchor, cand, 127))
            mend = ip + mlen
            if codec == "lz4":
                lz4_sequence(out, row, anchor, ip - back - anchor, mlen + back, ip - cand)
                seed = mend - 2
                table[int(enc_hash(codec, np.array([u32(row, seed)], np.uint64))[0])] = seed
            else:
                if ip - back > anchor:
                    snappy_literal(out, row, anchor, ip - back - anchor)
                snappy_copy(out, mlen + back, ip - cand)
                if mend < find_limit:
                    seed = mend - 1
                    table[int(enc_hash(codec, np.array([u32(row, seed)], np.uint64))[0])] = seed
            ip = anchor = mend
            skip = 1 << shift
            step_before, since = None, 0
        if codec == "lz4":
            lz4_sequence(out, row, anchor, n - anchor, 0, 0)
        elif n > anchor:
            snappy_literal(out, row, anchor, n - anchor)
        return bytes(out), steps


def model_batch(codec: str, data: torch.Tensor, lengths: torch.Tensor, **kw):
    """The model over a batch, shaped as ``encode_plain(..., with_steps=True)``,
    and the events of its rounds summed."""
    mod = CODECS[codec]
    B = data.shape[0]
    comp = np.zeros((B, mod.OUT_CAP), np.uint8)
    clens, ok, steps = np.zeros(B, np.int32), np.zeros(B, bool), np.zeros(B, np.int32)
    events = {}
    for i in range(B):
        m = RoundModel(codec, data[i].numpy(), int(lengths[i]), **kw)
        blob, steps[i] = m.run()
        comp[i, :len(blob)] = np.frombuffer(blob, np.uint8)
        clens[i], ok[i] = len(blob), len(blob) + 8 <= mod.OUT_CAP
        for key, v in m.events.items():
            events[key] = events.get(key, 0) + v
    got = (torch.from_numpy(comp), torch.from_numpy(clens), torch.from_numpy(ok),
           torch.from_numpy(steps))
    return got, events


NAMES = ("comp", "comp_lens", "ok", "steps")


def _differs(got, want) -> list[str]:
    return [name for name, g, w in zip(NAMES, got, want) if not torch.equal(g, w)]


def _batch(chunks):
    buf, lens = _pack(chunks, ENC_CUT | 1)  # an odd width
    return torch.from_numpy(buf), torch.from_numpy(lens)


@pytest.fixture(scope="module", params=list(CODECS))
def case(request):
    codec = request.param
    rounds = encode_round_cases(codec)
    chunks = encode_cases() + [c for _, c in rounds]
    data, lengths = _batch(chunks)
    want = CODECS[codec].encode_plain(data, lengths, with_steps=True)
    return codec, [name for name, _ in rounds], data, lengths, want


def test_model_equals_encode_plain(case):
    codec, _, data, lengths, want = case
    got, events = model_batch(codec, data, lengths)
    assert _differs(got, want) == []
    assert bool(want[2].all())
    # a round runs up to 32 probes: far fewer rounds than probes
    assert 0 < events["rounds"] < int(want[3].sum()) // 8
    assert events["in_round_cands"] > 0 and events["in_round_hits"] > 0


def test_the_round_chunks(case):
    """Each hand-built chunk meets the rule it was built for, in the model
    that equals the plain version."""
    codec, names, data, lengths, want = case
    first = data.shape[0] - len(names)

    def model(name, **kw):
        i = first + names.index(name)
        m = RoundModel(codec, data[i].numpy(), int(lengths[i]), **kw)
        m.run()
        return m

    def events(name, **kw):
        return model(name, **kw).events

    assert events("in_round")["in_round_hits"] == 1
    commit = model("commit").hits
    assert commit[0] == (0, 1, 20) and len(commit) == 2
    assert events("collision")["in_round_cands"] >= 1
    assert events("collision")["hits"] == 0 and events("collision", stale=True)["hits"] > 0
    # the first round of step 2: round 2 from the anchor in LZ4, round 1 in Snappy
    assert model("step_grows").hits[0] == ((2 if codec == "lz4" else 1), 2, 5)
    assert events("find_limit")["cut_hits"] == 1
    assert sum(events(f"match_limit_{k}")["limit_in_lane"] for k in range(4)) == 3


@pytest.mark.parametrize("broken", ["commit_all", "stale"])
def test_a_broken_rule_fails(case, broken):
    codec, names, data, lengths, want = case
    got, _ = model_batch(codec, data, lengths, **{broken: True})
    assert _differs(got, want) != []
    # the collision chunk alone shows a stale read, the commit chunk a write
    # of a lane past the hit
    i = data.shape[0] - len(names) + names.index("collision" if broken == "stale" else "commit")
    one, _ = model_batch(codec, data[i:i + 1], lengths[i:i + 1], **{broken: True})
    assert _differs(one, [w[i:i + 1] for w in want]) != []


@pytest.mark.parametrize("codec", list(CODECS))
def test_round_positions_equal_the_serial_scan(codec):
    """On a chunk with no match the rounds probe exactly the serial scan's
    positions, the steps growing at round starts, up to the find limit."""
    n = ENC_CUT
    row = np.random.default_rng(7).integers(0, 256, n, dtype=np.uint8)
    m = RoundModel(codec, row, n)
    blob, steps = m.run()
    serial = [p for p in enc_probes(codec, 4096) if p < n - enc_margin(codec)]
    assert m.positions == serial and steps == len(serial)
    assert m.events["step_changes"] > 3
