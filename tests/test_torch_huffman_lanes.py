"""Models of the zstd Huffman decode kernel's lanes and of the emission
kernel's rounds, against the plain versions.

``csrc/zstd_huffman.cu`` decodes a stream with one warp: the stream's bits
are cut into sub-ranges of up to SUB_BITS from the top, lane k decodes from
the top of its sub-range as if a code began there and marks the code starts
it finds, and rounds of synchronisation restart a lane from its
predecessor's exit until it meets a start it marked (or leaves its
sub-range again) and no exit changes. A scan of the counts places each
lane's symbols; past position 0 every peek is 0, so the symbols the stream
lacks are table[0]'s and the final bit count falls by its length for each.
Streams longer than 32 sub-ranges go by segments; a table of log 12, or
one whose walk gives a code of no bits, is walked by one lane.

``csrc/zstd_emit.cu`` packs each Huffman stream by rounds of 256 symbols,
8 a lane, at bit offsets from a warp scan of the code lengths, into words
flushed whole; the sequences stream walks its three FSE states over
windows of WINDOW groups (the head, one sequence each, the flush) and packs
each window by rounds of 32 groups of at most six fields.

Those rules cannot run here, so this file models them in numpy and holds
each model to ``huffman_decode_plain`` or ``emit_plain`` exactly (integer
codecs: tolerance 0). Three broken models (no synchronisation round, no
tail; a walk restarted each window) must fail.
"""

import numpy as np
import pytest
import torch

from aircompressor_tpu_torch.data import libzstd_frames
from aircompressor_tpu_torch.host.zstd import device_enc, device_prep
from aircompressor_tpu_torch.host.zstd import frame_enc
from aircompressor_tpu_torch.ops import zstd_decode, zstd_encode
from aircompressor_tpu_torch.ops.batch import _selfcheck_payload
from chip_smoke import (
    emit_edge_rows, huffman_lane_batch, huffman_lane_cases, one_sequence_case, zstd_cases)

LANES = 32
SUB_BITS = 1536  # the most bits of a lane's sub-range (kSubBits)
MAX_LOG = 11  # the shared decode table's 2^11 entries
MAP_BITS = 1024  # the top of a sub-range each lane's bitmap covers (kMapBits)


# ------------------------------------------------------------ Huffman decode
def sub_range(seg_hi: int, sub_bits: int) -> int:
    """A segment's sub-range: its bits over 32 lanes, rounded up to a
    multiple of 32, at most ``sub_bits``."""
    return min(sub_bits, -(-seg_hi // (32 * LANES)) * 32)


class StreamModel:
    """One Huffman stream through the kernel's rules. ``sync`` and ``tail``
    switch one rule off each."""

    def __init__(self, src: np.ndarray, row: np.ndarray, perm: np.ndarray,
                 lit: np.ndarray, sub_bits: int = SUB_BITS, map_bits: int = MAP_BITS,
                 sync: bool = True, tail: bool = True):
        self.src, self.perm, self.lit = src, perm, lit
        self.byte_lo, self.rem, self.nsym, self.out_base, self.log = (int(v) for v in row[:5])
        self.rs = [int(v) for v in row[zstd_decode.H_RANK_START:zstd_decode.H_RANK_START + 12]]
        self.cum = [int(v) for v in row[zstd_decode.H_CUM_SYMS:zstd_decode.H_CUM_SYMS + 12]]
        self.sub_bits, self.map_bits, self.sync, self.tail = sub_bits, map_bits, sync, tail
        self.rounds = 0

    def walk(self, st: int) -> tuple[int, int]:
        """The canonical walk: (byte, code length) of a peek."""
        rank = nb = 0
        for w in range(12):
            if st >= self.rs[w]:
                rank, nb = self.cum[w] + ((st - self.rs[w]) >> w), self.log - w
        return int(self.perm[rank & 255]), nb

    def peek(self, p: int) -> int:
        """The top ``log`` bits below position p, zero below the stream."""
        take = min(max(p, 0), self.log)
        lo = p - take
        word = 0
        for k in range(3):
            idx = self.byte_lo + (lo >> 3) + k
            if 0 <= idx < self.src.size:
                word |= int(self.src[idx]) << (8 * k)
        return ((word >> (lo & 7)) & ((1 << take) - 1)) << (self.log - take)

    def run(self) -> int:
        """Write the stream's bytes into ``lit``; return its final rem."""
        if self.nsym <= 0:
            return self.rem
        if not 1 <= self.log <= MAX_LOG:
            return self.serial()
        self.table = [self.walk(st) for st in range(1 << self.log)]
        if min(nb for _, nb in self.table) < 1:
            return self.serial()
        return self.lanes()

    def serial(self) -> int:
        """One lane, symbol by symbol, as the plain version."""
        p = self.rem
        for i in range(self.nsym):
            sym, nb = self.walk(self.peek(p))
            self.lit[self.out_base + i] = sym
            p -= nb
        return p

    def step(self, p: int) -> tuple[int, int]:
        return self.table[self.peek(p)]

    def lanes(self) -> int:
        seg_hi, base, rem = self.rem, 0, None
        while seg_hi > 0 and base < self.nsym:
            S = sub_range(seg_hi, self.sub_bits)
            his = [seg_hi - k * S for k in range(LANES)]
            los = [max(h - S, 0) for h in his]
            active = [h > 0 for h in his]
            marks = [set() for _ in range(LANES)]  # code starts in the bitmap's reach
            below = [0] * LANES  # and the count of those below it
            exits, starts = list(his), list(his)
            for k in range(LANES):  # the speculative pass
                p = his[k]
                while active[k] and p > los[k]:
                    if his[k] - p < self.map_bits:
                        marks[k].add(p)
                    else:
                        below[k] += 1
                    p -= self.step(p)[1]
                exits[k] = p
            while self.sync:  # rounds: every lane reads its predecessor's exit
                preds = [seg_hi] + exits[:-1]
                need = [active[k] and k > 0 and preds[k] != starts[k] for k in range(LANES)]
                if not any(need):
                    break
                self.rounds += 1
                for k in (k for k in range(LANES) if need[k]):
                    s = starts[k] = preds[k]
                    marks[k] = {q for q in marks[k] if q <= s}
                    p, fresh = s, 0
                    while p not in marks[k]:
                        q = p - self.step(p)[1]
                        if his[k] - p < self.map_bits:
                            marks[k].add(p)
                            marks[k].difference_update(range(q + 1, p))
                        else:
                            fresh += 1
                        if q <= los[k]:
                            exits[k], below[k] = q, fresh
                            break
                        p = q
            counts = [len(m) + b if a else 0 for m, b, a in zip(marks, below, active)]
            offs = np.concatenate([[0], np.cumsum(counts)[:-1]]).tolist()
            for k in range(LANES):  # the write pass
                p, o = starts[k], base + offs[k]
                while active[k] and p > los[k] and o < self.nsym:
                    sym, nb = self.step(p)
                    self.lit[self.out_base + o] = sym
                    o, p = o + 1, p - nb
                    if o == self.nsym:
                        rem = p
            base += sum(counts)
            seg_hi = exits[max(k for k in range(LANES) if active[k])]
        if rem is not None:
            return rem
        if not self.tail:
            return seg_hi
        sym, nb = self.table[0]  # past position 0 every peek is 0
        self.lit[self.out_base + base:self.out_base + self.nsym] = sym
        return seg_hi - (self.nsym - base) * nb


def model_decode(src, params, perm, lit_size, **kw):
    src, params, perm = src.numpy(), params.numpy(), perm.numpy()
    lit = np.zeros(lit_size, np.uint8)
    models = [StreamModel(src, params[h], perm[h], lit, **kw) for h in range(len(params))]
    rem = np.array([m.run() for m in models], np.int32)
    return torch.from_numpy(lit), torch.from_numpy(rem), sum(m.rounds for m in models)


def _zstd_args():
    """test_torch_zstd.py's batch (the zstd cases through the host encoder
    and the libzstd fixture up to 8 KB) and one 64 KB text chunk."""
    frames = [frame_enc.compress_bytes(r) for r in zstd_cases()]
    frames += [f["frame"] for f in libzstd_frames() if f["cut"] <= 8192]
    frames.append(frame_enc.compress_bytes(_selfcheck_payload(3), 3))  # one 64 KB text chunk
    pk = zstd_decode.pack(device_prep.plan_batch(frames, 65536), "cpu")
    return pk.src, pk.h_params, pk.h_perm, pk.lit_size


@pytest.fixture(scope="module")
def zstd_streams():
    args = _zstd_args()
    return args, zstd_decode.huffman_decode_plain(*args)


@pytest.fixture(scope="module")
def lane_streams():
    cases = huffman_lane_cases()
    args = huffman_lane_batch(cases, "cpu")
    return cases, args, zstd_decode.huffman_decode_plain(*args)


def _same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("sub_bits,map_bits", [(SUB_BITS, MAP_BITS), (64, MAP_BITS),
                                               (SUB_BITS, 32)])
def test_model_equals_plain_on_the_zstd_streams(zstd_streams, sub_bits, map_bits):
    args, want = zstd_streams
    assert args[1].shape[0] >= 40 and int(args[1][:, 1].max()) > 30000
    lit, rem, _ = model_decode(*args, sub_bits=sub_bits, map_bits=map_bits)
    assert _same((lit, rem), want)


@pytest.mark.parametrize("sub_bits,map_bits", [(SUB_BITS, MAP_BITS), (32, MAP_BITS),
                                               (96, MAP_BITS), (SUB_BITS, 32)])
def test_model_equals_plain_on_the_lane_cases(lane_streams, sub_bits, map_bits):
    cases, args, want = lane_streams
    lit, rem, rounds = model_decode(*args, sub_bits=sub_bits, map_bits=map_bits)
    assert _same((lit, rem), want)
    assert rounds > 0
    rem = want[1].tolist()
    by_name = {name: (c, r) for (name, c), r in zip(cases, rem)}
    assert by_name["bits left"][1] > 0 and by_name["read past start"][1] < 0
    assert by_name["short"][0]["rem"] < LANES * by_name["short"][0]["table_log"]
    c = by_name["one length"][0]
    S = sub_range(c["rem"], SUB_BITS)
    assert c["table_log"] == 7 and S <= SUB_BITS and S % 7 != 0
    assert by_name["log 11"][0]["table_log"] == 11 and by_name["log 12"][0]["table_log"] == 12
    for name, segments in (("one length, two segments", 2), ("log 11, three segments", 3)):
        assert by_name[name][0]["rem"] > (segments - 1) * LANES * SUB_BITS
        assert by_name[name][1] == 0


@pytest.mark.parametrize("broken", ["sync", "tail"])
def test_a_broken_rule_fails(lane_streams, broken):
    _, args, want = lane_streams
    lit, rem, _ = model_decode(*args, **{broken: False})
    assert not _same((lit, rem), want)


# ------------------------------------------------------------------ emission
WINDOW = 128  # groups a window of the sequences stream (zstd_emit.cu kWindow)
PER_LANE = 8  # Huffman symbols a lane a round (kPerLane)


class PackModel:
    """A stream packed as the kernel packs it: rounds of (value, width) ops
    by lane, each lane's bit offset from a scan of its widths, ORed into
    words; after each round the whole words go out, those at or past the
    capacity dropped; then the end mark and the last word."""

    def __init__(self, cap: int):
        self.cap_words, self.words, self.pos, self.flushed = cap // 4, {}, 0, 0
        self.out = np.zeros(cap // 4, np.uint32)

    def round(self, lanes: list) -> None:
        for ops in lanes:  # lane order: the scan's order
            for v, nb in ops:
                nb = min(max(int(nb), 0), 31)
                x = (int(v) & ((1 << nb) - 1)) << (self.pos & 31)
                w = self.pos >> 5
                self.words[w] = self.words.get(w, 0) | (x & 0xFFFFFFFF)
                self.words[w + 1] = self.words.get(w + 1, 0) | (x >> 32)
                self.pos += nb
        self.flush(self.pos >> 5)

    def flush(self, upto: int) -> None:
        for w in range(self.flushed, upto):
            v = self.words.pop(w, 0)
            if w < self.cap_words:
                self.out[w] = v
        self.flushed = max(self.flushed, upto)

    def finish(self, tail: bool = True):
        if tail:
            w = self.pos >> 5
            self.words[w] = self.words.get(w, 0) | 1 << (self.pos & 31)
            self.flush(w + 1)
        return self.out.view(np.uint8), self.pos


def model_emit(pk: dict, restart: bool = False, tail: bool = True):
    """``emit``'s four outputs for a batch of ``pack_plans`` arrays, by the
    kernel's rounds and windows. ``restart`` starts each window's walk from
    the last sequence's states again; ``tail`` off drops the end mark and
    the last word."""
    clamp = lambda v, lo, hi: min(max(int(v), lo), hi)  # noqa: E731
    B = pk["nseq"].shape[0]
    lit_bytes = np.zeros((B, 4, zstd_encode.LSTREAM_CAP), np.uint8)
    lit_tot = np.zeros((B, 4), np.int32)
    seq_bytes = np.zeros((B, zstd_encode.SSTREAM_CAP), np.uint8)
    seq_tot = np.zeros(B, np.int32)
    for r in range(B):
        huff = pk["huff"][r]
        for s in range(4):
            start, cnt = (int(v) for v in pk["lit_seg"][r, s])
            steps = clamp(cnt, 0, zstd_encode.SEG_CAP)
            pm = PackModel(zstd_encode.LSTREAM_CAP)
            for r0 in range(0, steps, 32 * PER_LANE):
                lanes = []
                for lane in range(32):
                    j0 = r0 + PER_LANE * lane
                    syms = [int(pk["lit"][r, clamp(start + cnt - 1 - j, 0, 65535)])
                            for j in range(j0, min(j0 + PER_LANE, steps))]
                    lanes.append([(huff[0, y], huff[1, y]) for y in syms])
                pm.round(lanes)
            out, lit_tot[r, s] = pm.finish(tail)
            lit_bytes[r, s, :out.size] = out

        fields, sym, ns = pk["seq"][r], pk["fse_sym"][r], pk["fse_ns"][r]
        nseq = clamp(pk["nseq"][r], 0, zstd_encode.S_CAP)
        last = max(nseq - 1, 0)

        def first_state(f):
            c = clamp(fields[f, last], 0, 63)
            d, fs = int(sym[f, 0, c]), int(sym[f, 1, c])
            nb = clamp((d + (1 << 15)) >> 16, 0, 31)
            return int(ns[f, clamp((((nb << 16) - d) >> nb) + fs, 0, 511)])

        st = [first_state(f) for f in range(3)]
        groups = last + 2 if nseq > 0 else 0
        pm = PackModel(zstd_encode.SSTREAM_CAP)
        for w0 in range(0, groups, WINDOW):
            if restart and w0:
                st = [first_state(f) for f in range(3)]
            window = {}  # group -> its ops
            for g in range(w0, min(w0 + WINDOW, groups)):
                if g == 0:
                    window[g] = [(fields[3 + f, last], fields[6 + f, last]) for f in range(3)]
                elif g <= last:
                    i, states = last - g, []
                    for f in range(3):  # the three chains, one step each
                        c = clamp(fields[f, i], 0, 63)
                        nb = clamp((st[f] + int(sym[f, 0, c])) >> 16, 0, 31)
                        states.append((st[f], nb))
                        st[f] = int(ns[f, clamp((st[f] >> nb) + int(sym[f, 1, c]), 0, 511)])
                    window[g] = states[::-1] + [(fields[3 + f, i], fields[6 + f, i])
                                                for f in range(3)]
                else:
                    fb = pk["flush_bits"][r]
                    window[g] = [(st[1], fb[0]), (st[2], fb[1]), (st[0], fb[2])]
            for k0 in range(w0, min(w0 + WINDOW, groups), 32):
                pm.round([window.get(g, []) for g in range(k0, k0 + 32)])
        out, seq_tot[r] = pm.finish(tail)
        seq_bytes[r, :out.size] = out
    return tuple(torch.from_numpy(a) for a in (lit_bytes, lit_tot, seq_bytes, seq_tot))


def _emit_args(pk: dict) -> list:
    return [torch.from_numpy(pk[name]) for name, _, _ in zstd_encode.EMIT_INPUTS]


@pytest.fixture(scope="module")
def emit_rows():
    """The plans of test_torch_zstd_encode.py (five 8 KB heads and one
    sequence), one 64 KB text chunk (more than one window), and the edge
    rows: nseq 0 and random fields inside the clamps; apart, the
    overflowing row."""
    chunks = [_selfcheck_payload(s)[:8192] for s in range(5)]
    chunks += [one_sequence_case(), _selfcheck_payload(7)]
    packed = device_enc.pack_plans([device_enc._plan_chunk(c, 3) for c in chunks])
    edge, over = emit_edge_rows(packed)
    rows = {k: np.concatenate([v, edge[k]]) for k, v in packed.items()}
    return rows, over


def test_emit_model_equals_plain(emit_rows):
    rows, _ = emit_rows
    nseq = rows["nseq"].tolist()
    assert 1 in nseq and 0 in nseq and max(nseq) > WINDOW + 1
    assert _same(model_emit(rows), zstd_encode.emit_plain(*_emit_args(rows)))


def test_emit_model_equals_plain_on_an_overflowing_row(emit_rows, monkeypatch):
    _, over = emit_rows
    with pytest.raises(RuntimeError, match="overflowed a stream of row 0"):
        zstd_encode.emit_plain(*_emit_args(over))
    monkeypatch.setattr(zstd_encode, "_check_totals", lambda *a: None)
    want = zstd_encode.emit_plain(*_emit_args(over))
    assert int(want[1][0, 0]) > 8 * zstd_encode.LSTREAM_CAP
    assert int(want[3][0]) > 8 * zstd_encode.SSTREAM_CAP
    assert _same(model_emit(over), want)


@pytest.mark.parametrize("broken", ["restart", "tail"])
def test_a_broken_emission_rule_fails(emit_rows, broken):
    rows, _ = emit_rows
    got = model_emit(rows, **{broken: broken == "restart", "tail": broken != "tail"})
    assert not _same(got, zstd_encode.emit_plain(*_emit_args(rows)))
