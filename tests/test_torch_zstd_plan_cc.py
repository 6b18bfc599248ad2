"""The C++ zstd planners against the Python planners they port, exactly.

``zstd_decode.plan`` (``host/zstd/decode_plan.cc``) must give the tensors
of ``zstd_decode.pack(device_prep.plan_batch(...))``, and the JAX package's
planner through the same ``pack``, and reject the same items for the same
reasons. ``zstd_encode.Plans`` (``host/zstd/encode_plan.cc``) must give
``device_enc._plan_chunk``'s device flag and reason, Huffman table and
field modes and descriptions, ``pack_plans``' rows and ``_assemble``'s
frames. These are integer plans and byte strings: every comparison is
exact, with no tolerance.
"""

import numpy as np
import pytest
import torch

from aircompressor_tpu.zstd import device_prep as jax_prep
from aircompressor_tpu_torch import _build
from aircompressor_tpu_torch.data import libzstd_frames
from aircompressor_tpu_torch.errors import MalformedInputException
from aircompressor_tpu_torch.host.xxhash import xxh64
from aircompressor_tpu_torch.host.zstd import block_enc
from aircompressor_tpu_torch.host.zstd import constants as C
from aircompressor_tpu_torch.host.zstd import (device_enc, device_prep, frame_enc, fse_enc,
                                              huff_enc, seq_enc)
from aircompressor_tpu_torch.host.zstd.params import compute as params
from aircompressor_tpu_torch.ops import zstd_decode, zstd_encode
from aircompressor_tpu_torch.ops.batch import _selfcheck_payload
from chip_smoke import packed_equal, zstd_malformed_cases

CAP = 1 << 20  # plans of frames of more than one block (the batch API caps at 64 KB)


def _assert_packed_equal(got, want):
    assert packed_equal(got, want)


def _python_packed(items, out_cap=CAP):
    return zstd_decode.pack(device_prep.plan_batch(items, out_cap, item_errors=True), "cpu")


def _python_error(items, out_cap=CAP):
    try:
        device_prep.plan_batch(items, out_cap, item_errors=True)
    except MalformedInputException as exc:
        return exc.offset, exc.reason
    return None


def _cc_error(items, out_cap=CAP):
    try:
        zstd_decode.plan(items, out_cap, "cpu")
    except MalformedInputException as exc:
        return exc.offset, exc.reason
    return None


# ----------------------------------------------------------- decode batches
def _header(size: int) -> bytes:
    out = bytearray(frame_enc.MAGIC.to_bytes(4, "little"))
    frame_enc._write_frame_header(out, size)
    return bytes(out)


def _crafted_frame() -> bytes:
    """Two blocks of RLE literals and one sequence each: the first block's
    tables are RLE, the second's repeat them; then an RLE block and a raw
    block."""
    seq1, fields = seq_enc.compress_sequences(np.array([4]), np.array([7]), np.array([4]))
    seq2, _ = seq_enc.compress_sequences(np.array([4]), np.array([7]), np.array([4]), fields)
    assert seq1[1] == 0b01010100 and seq2[1] == 0b11111100  # RLE, then repeat modes
    b1 = bytes([1 | (4 << 3)]) + b"a" + seq1
    b2 = bytes([1 | (4 << 3)]) + b"b" + seq2
    content = b"a" * 8 + b"b" * 8 + b"c" * 5 + b"raw!"
    return (_header(len(content)) + frame_enc._block_header(0, C.COMPRESSED_BLOCK, len(b1)) + b1
            + frame_enc._block_header(0, C.COMPRESSED_BLOCK, len(b2)) + b2
            + frame_enc._block_header(0, C.RLE_BLOCK, 5) + b"c"
            + frame_enc._block_header(1, C.RAW_BLOCK, 4) + b"raw!"
            + (xxh64(content) & 0xFFFFFFFF).to_bytes(4, "little")), content


def _fcs8(frame: bytes, size: int) -> bytes:
    """A host-encoder frame of 256 B or more with its content size in 8 bytes."""
    assert frame[4] == 0x64
    return frame[:4] + bytes([0xE4]) + size.to_bytes(8, "little") + frame[7:]


def _literals(src: np.ndarray, lo: int) -> tuple[int, int, int]:
    """The type, stream count and end of the literals section at ``lo``."""
    b = [int(v) for v in src[lo:lo + 5]]
    kind, size_format = b[0] & 3, (b[0] >> 2) & 3
    if kind in (C.RAW_LITERALS, C.RLE_LITERALS):
        header, regen = ((1, b[0] >> 3) if size_format in (0, 2) else
                         (2, (b[0] >> 4) | (b[1] << 4)) if size_format == 1 else
                         (3, (b[0] >> 4) | (b[1] << 4) | (b[2] << 12)))
        return kind, 1, lo + header + (regen if kind == C.RAW_LITERALS else 1)
    header, comp = ((3, (b[1] >> 6) | (b[2] << 2)) if size_format < 2 else
                    (4, (b[2] >> 2) | (b[3] << 6)) if size_format == 2 else
                    (5, (b[2] >> 6) | (b[3] << 2) | (b[4] << 10)))
    return kind, 1 if size_format == 0 else 4, lo + header + comp


def _features(frame: bytes) -> set:
    """The kinds of block, literals section and sequence table in a frame."""
    src = np.frombuffer(frame, np.uint8)
    ip = 4 + device_prep.read_frame_header(src, 4).header_size
    out = set()
    while True:
        bh = device_prep._u24le(src, ip)
        last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
        out.add(("block", btype))
        if btype == C.COMPRESSED_BLOCK:
            kind, streams, seq_lo = _literals(src, ip + 3)
            out.add(("literals", kind, streams))
            b0 = int(src[seq_lo])
            if b0:
                modes = int(src[seq_lo + (1 if b0 < 128 else 2 if b0 < 255 else 3)])
                out.update(("table", (modes >> s) & 3) for s in (6, 4, 2))
        ip += 3 + (1 if btype == C.RLE_BLOCK else size)
        if last:
            return out


def _decode_batches() -> dict:
    fixture = [f["frame"] for f in libzstd_frames()]
    long = _selfcheck_payload(3) * 3  # two blocks of 128 KB
    host = [frame_enc.compress_bytes(_selfcheck_payload(i)[:n], level)
            for i, n in ((1, 9000), (2, 30000), (5, 40000)) for level in (1, 3, 9)]
    host += [frame_enc.compress_bytes(long[:140000], 3)]
    crafted, _ = _crafted_frame()
    edges = [frame_enc.compress_bytes(bytes(2000)),  # one RLE block
             frame_enc.compress_bytes(np.random.default_rng(3).integers(
                 0, 256, 3000, dtype=np.uint8).tobytes()),  # one raw block
             crafted, _fcs8(frame_enc.compress_bytes(_selfcheck_payload(6)[:700]), 700)]
    return {"libzstd": fixture, "host levels": host, "blocks and tables": edges}


BATCHES = _decode_batches()


@pytest.mark.parametrize("name", BATCHES)
def test_decode_plan_equals_the_python_planner(name):
    items = BATCHES[name]
    _assert_packed_equal(zstd_decode.plan(items, CAP, "cpu"), _python_packed(items))


def test_decode_batches_reach_every_kind():
    """The batches hold raw, RLE and compressed blocks; raw, RLE, compressed
    and treeless literals, in one stream and in four; and predefined, RLE,
    FSE and repeat sequence tables."""
    seen = set().union(*(_features(f) for items in BATCHES.values() for f in items))
    assert {("block", 0), ("block", 1), ("block", 2)} <= seen
    assert {("literals", 0, 1), ("literals", 1, 1), ("literals", 2, 1), ("literals", 2, 4),
            ("literals", 3, 1), ("literals", 3, 4)} <= seen
    assert {("table", m) for m in range(4)} <= seen


def test_crafted_frame_decodes():
    frame, content = _crafted_frame()
    assert zstd_decode.decode_batch([frame], device="cpu") == [content]


def test_decode_plan_equals_the_jax_planner():
    """The JAX package's planner, through the same ``pack``."""
    items = BATCHES["libzstd"] + BATCHES["host levels"][:6]
    want = zstd_decode.pack(jax_prep.plan_batch(items, 65536), "cpu")
    _assert_packed_equal(zstd_decode.plan(items, 65536, "cpu"), want)


def test_decode_plan_of_an_empty_batch():
    _assert_packed_equal(zstd_decode.plan([], 4096, "cpu"), _python_packed([], 4096))


# ---------------------------------------------------------- malformed input
def _malformed_frames() -> list[bytes]:
    """test_torch_zstd.py's rejection cases (the smoke's malformed frames;
    cuts, a bad magic, a reserved block type and flipped bits of a valid
    frame), and header edges: a dictionary id, 8-byte content sizes past
    out_cap and past 2^63, and a frame cut inside its header."""
    good = frame_enc.compress_bytes(_selfcheck_payload(12)[:3000])
    flips = [good[:p] + bytes([good[p] ^ 0x10]) + good[p + 1:]
             for p in (4, 9, 30, len(good) // 2, len(good) - 12)]
    reserved = good[:7] + bytes([good[7] | 6]) + good[8:]
    dictionary = good[:4] + bytes([good[4] | 1, 7]) + good[5:]
    return [b for _, b, _ in zstd_malformed_cases()] + flips + [
        good[:3], good[:len(good) // 2], good[:-1], b"\0" + good[1:], reserved, dictionary,
        _fcs8(good, CAP + 1), _fcs8(good, 2**63 + 5), _fcs8(good, 3000)[:9]]


MALFORMED = _malformed_frames()


@pytest.mark.parametrize("case", range(len(MALFORMED)))
def test_malformed_item_as_the_python_planner(case):
    """Alone and between two valid frames: the same item index and reason,
    or the same plan."""
    good = BATCHES["host levels"][0]
    for items in ([MALFORMED[case]], [good, MALFORMED[case], good]):
        want = _python_error(items)
        assert _cc_error(items) == want
        if want is None:
            _assert_packed_equal(zstd_decode.plan(items, CAP, "cpu"), _python_packed(items))


def test_malformed_cases_reach_planning_failures():
    reasons = {_python_error([f])[1] for f in MALFORMED if _python_error([f])}
    assert {"invalid magic", "truncated block header", "reserved block type",
            "dictionaries are not supported", "frame exceeds batch out_cap"} <= reasons


@pytest.mark.parametrize("seed", range(4))
def test_cut_and_flipped_frames_as_the_python_planner(seed):
    """Seeded truncations and byte flips of valid frames: both planners
    raise, with the same index and reason, or neither does, with the same
    plan."""
    rng = np.random.default_rng(seed)
    frames = BATCHES["libzstd"] + BATCHES["host levels"][:6] + BATCHES["blocks and tables"]
    for _ in range(60):
        f = bytearray(frames[rng.integers(len(frames))])
        if rng.random() < 0.3:
            f = f[:rng.integers(len(f) + 1)]
        for _ in range(rng.integers(1, 4)):
            if f:
                f[rng.integers(len(f))] ^= 1 << int(rng.integers(8))
        items = [frames[0], bytes(f)]
        want = _python_error(items)
        assert _cc_error(items) == want
        if want is None:
            _assert_packed_equal(zstd_decode.plan(items, CAP, "cpu"), _python_packed(items))


def test_decode_batch_reports_the_item():
    good = BATCHES["host levels"][0]
    with pytest.raises(MalformedInputException) as exc:
        zstd_decode.decode_batch([good, good, b"\0" + good[1:]], device="cpu")
    assert (exc.value.offset, exc.value.reason) == (2, "invalid magic")


# ------------------------------------------------------------ compress plans
def _chunk(literals: np.ndarray, ll, ml, of, last: int):
    """A chunk of these sequences over these literals (match bytes 0: the
    planner reads only the literals) and its proposals."""
    ll, ml, of = (np.asarray(a, np.int64) for a in (ll, ml, of))
    parts, p = [], 0
    for i in range(ll.size):
        parts += [literals[p:p + ll[i]].tobytes(), bytes(int(ml[i]))]
        p += int(ll[i])
    parts.append(literals[p:p + last].tobytes())
    return b"".join(parts), (ll, of, ml)


def _text(n: int, seed: int, alphabet: int = 40) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = np.sort(rng.dirichlet(np.ones(alphabet)))
    return (rng.choice(alphabet, n, p=p) + 32).astype(np.uint8)


def _one_field(ml_codes, n_lit: int = 600):
    """A chunk whose literals all trail and whose sequences have these ML
    codes (LL 0, one offset code)."""
    ml = C.ML_BASE[np.asarray(ml_codes)]
    m = ml.size
    return _chunk(_text(n_lit, 1), np.zeros(m), ml, 1500 + np.arange(m), n_lit)


def _compress_cases() -> dict:
    cases = {}
    for level in (1, 3):
        for i, n in ((0, 65536), (1, 20000), (2, 9000), (4, 4000)):
            c = _selfcheck_payload(i + level)[:n]
            cases[f"level {level} chunk {i}"] = (c, block_enc.find_sequences(
                np.frombuffer(c, np.uint8), params(level, len(c)))[:3])
    text = _text(4000, 2)
    empty = (np.zeros(0, np.int64),) * 3
    cases["size: empty"] = (b"", empty)
    cases["size: 64 KB + 1"] = (bytes(65537), empty)
    cases["nseq: none"] = (text[:1000].tobytes(), empty)
    cases["nseq: 8193"] = _chunk(text, np.zeros(8193), np.full(8193, 4), np.full(8193, 9), 300)
    cases["small-literals"] = _chunk(text, [100, 100], [50, 60], [20, 30], 55)
    cases["literal-shape"] = _chunk(np.full(2000, 97, np.uint8), [300, 200], [9, 9], [5, 6], 100)
    noise = np.random.default_rng(4).integers(0, 256, 5000, dtype=np.uint8)
    cases["incompressible-literals"] = _chunk(noise, [1000, 2000], [40, 8], [99, 700], 1500)
    # package-merge ties: leaves whose counts equal packages' weights, and a
    # histogram deep enough that the depth limit of 11 binds
    counts = [1, 1] + [2 ** k for k in range(1, 9)]
    fib = [1, 1]
    while len(fib) < 16:
        fib.append(fib[-1] + fib[-2])
    for name, hist in (("package-merge ties", counts), ("depth limit", fib)):
        lits = np.repeat(np.arange(len(hist), dtype=np.uint8) * 7 + 1, hist)
        lits = np.random.default_rng(5).permutation(lits)
        cases[name] = _chunk(lits, [5, 9], [20, 30], [3, 10], lits.size - 14)
    # field costs: an exact tie (the predefined table is kept) and a near one
    cases["field cost tie"] = _one_field([19] * 4 + [20] * 4)
    cases["field cost near tie"] = _one_field([1] * 4 + [8] * 5)
    # normalize_counts: 5 * 32 / 64 rounds to even (2); and equal counts at
    # the symbol its correction stops on (ML codes 39 and 44), where numpy's
    # sort order decides
    cases["normalize half to even"] = _one_field([3] * 5 + [20] * 59)
    cases["normalize order"] = _one_field(np.repeat([10, 32, 39, 44, 49], [6, 7, 11, 11, 5]))
    for seed in range(24):  # random fields and histograms, equal counts among them
        rng = np.random.default_rng(100 + seed)
        m, n_lit = int(rng.integers(2, 80)), int(rng.integers(256, 3000))
        cut = np.sort(rng.integers(0, n_lit + 1, m))
        ll = np.diff(np.concatenate([[0], cut]))
        ml = rng.choice(rng.integers(4, 40, 4), m) if seed % 2 else rng.integers(4, 300, m)
        of = rng.choice(rng.integers(1, 300, 3), m) if seed % 3 else rng.integers(1, 9000, m)
        cases[f"random {seed}"] = _chunk(_text(n_lit, seed, int(rng.integers(2, 60))),
                                         ll, ml, of, n_lit - int(cut[-1]))
    return cases


COMPRESS = _compress_cases()


def _python_plans(chunks, proposals):
    plans = []
    for c, (ll, of, ml) in zip(chunks, proposals):
        data = np.frombuffer(c, np.uint8)
        lits = device_enc._extract_literals(data, ll, ml, data.size - int(ll.sum() + ml.sum()))
        plans.append(device_enc._plan_chunk(c, 3, (ll, of, ml, lits)))
    return plans


@pytest.fixture(scope="module")
def planned():
    chunks, proposals = zip(*COMPRESS.values())
    return list(chunks), _python_plans(chunks, proposals), zstd_encode.Plans(chunks, proposals)


def test_compress_plans_equal_the_python_planner(planned):
    _, py, cc = planned
    assert cc.reason == [p.reason for p in py]
    assert cc.device.tolist() == [p.device for p in py]
    assert set(cc.reason) == {"", "size", "nseq", "small-literals", "literal-shape",
                              "incompressible-literals"}
    for i in cc.rows:
        table, modes, descs = cc.detail(i)
        assert table == huff_enc.write_table(py[i].ct), i
        assert modes == tuple(f.mode for f in py[i].fields), i
        assert descs == tuple(f.desc for f in py[i].fields), i


def test_compress_rows_equal_pack_plans(planned):
    _, py, cc = planned
    want = device_enc.pack_plans([p for p in py if p.device])
    got = cc.pack()
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name]), name


def test_compress_frames_equal_assemble(planned):
    """Given the same ``emit_plain`` outputs and checksums."""
    chunks, py, cc = planned
    packed = cc.pack()
    out = [t.numpy() for t in zstd_encode.emit_plain(
        *(torch.from_numpy(packed[name]) for name, _, _ in zstd_encode.EMIT_INPUTS))]
    digest = np.random.default_rng(7).integers(-2**63, 2**63 - 1, len(cc.rows), dtype=np.int64)
    want = [device_enc._assemble(py[i], out[0][r], out[1][r], out[2][r], int(out[3][r]),
                                 int(digest[r])) for r, i in enumerate(cc.rows)]
    assert cc.assemble(*out, digest) == want
    assert sum(f == b"" for f in want) < len(want)


def test_field_cost_cases_pick_their_modes(planned):
    """The exact tie keeps the predefined ML table; the near tie (0.079
    bits) takes the FSE table; equal counts reach normalize_counts'
    correction in numpy's order."""
    names = list(COMPRESS)
    _, py, cc = planned
    tie, near = names.index("field cost tie"), names.index("field cost near tie")
    assert cc.detail(tie)[1][2] == C.SEQ_PREDEFINED
    assert cc.detail(near)[1][2] == C.SEQ_FSE
    counts = np.bincount([19] * 4 + [20] * 4, minlength=53)
    pre = seq_enc._field_cost_bits(counts, C.ML_DEFAULT_NORM, 6)
    norm = fse_enc.normalize_counts(counts[:21], 5, 8)
    assert pre == seq_enc._field_cost_bits(counts, norm, 5) + 8 * len(
        fse_enc.write_normalized_counts(norm, 5))


def test_field_cost_bits_are_numpys():
    """seq_enc._field_cost_bits, double for double, on random counts and
    tables of 1 to 60 symbols (numpy's pairwise sum by blocks of 8)."""
    lib = _build.load_host()
    rng = np.random.default_rng(11)
    for _ in range(300):
        n = int(rng.integers(1, 61))
        log = int(rng.integers(5, 10))
        counts = np.where(rng.random(n) < 0.7, rng.integers(0, 5000, n), 0).astype(np.int64)
        norm = rng.integers(-1, 1 << (log - 1), n).astype(np.int64)
        want = seq_enc._field_cost_bits(counts, norm, log)
        got = lib.acx_zstd_field_cost(counts.ctypes.data, n, norm.ctypes.data, n, log,
                                      zstd_encode._LOG2.ctypes.data)
        assert got == want or (np.isnan(want) and np.isnan(got))


def test_normalize_ties_take_numpys_order(monkeypatch):
    """Where the correction of normalize_counts stops among equal counts,
    numpy's sort order decides: the C++ planner asks for it, and the plans
    of such fields equal Python's (the random cases hold several)."""
    calls = []
    real = zstd_encode._numpy_order

    def counting(keys, n, out):
        calls.append(n)
        return real(keys, n, out)

    monkeypatch.setattr(zstd_encode, "_ORDER", _build.ORDER_FN(counting))
    chunks, proposals = zip(*[v for k, v in COMPRESS.items() if k.startswith("random")])
    cc = zstd_encode.Plans(chunks, proposals)
    assert calls
    py = _python_plans(chunks, proposals)
    want = device_enc.pack_plans([p for p in py if p.device])
    got = cc.pack()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_verify_equals_verify_proposals():
    """``zstd_encode.verify`` flags the first chunk whose proposals
    ``_verify_proposals`` rejects."""
    chunks, props = [], []
    for i in range(3):
        c = _selfcheck_payload(20 + i)[:6000]
        ll, of, ml = block_enc.find_sequences(np.frombuffer(c, np.uint8), params(3, 6000))[:3]
        chunks.append(c)
        props.append((ll, ml, of))
    bad = [("short match", 1, lambda ll, ml, of: (ll, np.r_[3, ml[1:]], of)),
           ("offset past start", 0, lambda ll, ml, of: (ll, ml, np.r_[ll[0] + 1, of[1:]])),
           ("wrong offset", 2, lambda ll, ml, of: (ll, ml, np.r_[of[:-1], of[-1] + 1])),
           ("coverage", 1, lambda ll, ml, of: (np.r_[ll[:-1], ll[-1] + 1], ml, of))]
    for name, at, edit in [("sound", -1, None)] + bad:
        rows = [edit(*p) if i == at else p for i, p in enumerate(props)]
        width = max(r[0].size for r in rows)
        arrays = [np.zeros((3, width), np.int64) for _ in range(3)]
        for i, r in enumerate(rows):
            for a, v in zip(arrays, r):
                a[i, :v.size] = v
        nseq = np.array([r[0].size for r in rows])
        last = np.array([len(c) - int(p[0].sum() + p[1].sum()) for c, p in zip(chunks, props)])
        py = [device_enc._verify_proposals(np.frombuffer(c, np.uint8), *r, int(e), 4)
              for c, r, e in zip(chunks, rows, last)]
        want = py.index(False) if False in py else -1
        assert want == at, name
        assert zstd_encode.verify(chunks, *arrays, nseq, last) == want, name


def test_compress_batch_equals_the_host_encoder_without_the_matcher():
    """With the matcher off, every frame is frame_enc.compress_bytes'."""
    chunks = [_selfcheck_payload(i)[:n] for i, n in ((30, 6000), (31, 300), (32, 9000))]
    chunks += [b"", bytes(700)]
    got = zstd_encode.compress_batch(chunks, 3, device_matcher=False, device="cpu")
    assert got == [frame_enc.compress_bytes(c, 3) for c in chunks]
