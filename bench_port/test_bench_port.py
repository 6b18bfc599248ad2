"""The benchmark's parts on the CPU: the generator, the references, the byte
counts, the manifest and its discovery by name, the imports, the trace
reader, and the harness at a small size with the port's plain versions,
with its control and with faults planted in the port's ops.

    python -m pytest bench_port -q
"""

from __future__ import annotations

import ast
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_port import check, control, manifest, native, roofline
from bench_port import run as harness
from bench_port.data import lineitem
from bench_port.reference import blocks, hashes
from bench_port.trace import Trace

BENCH = Path(__file__).resolve().parent
CELLS = [w["name"] for w in manifest.load()["workloads"]]


# ----------------------------------------------------------------- the data
def test_lineitem_is_deterministic_by_seed():
    a = lineitem.chunks(2**31 + 7, 3, 4096, 1)
    assert np.array_equal(a, lineitem.chunks(2**31 + 7, 3, 4096, 1))
    assert not np.array_equal(a, lineitem.chunks(2**31 + 8, 3, 4096, 1))
    assert a.shape == (3, 4096) and a.dtype == np.uint8


def test_lineitem_rows_have_sixteen_columns_and_a_trailing_bar():
    text = bytes(lineitem.rows(11, 200_000, 1)).decode()
    rows = text.split("\n")
    assert rows[-1] == "" and len(rows) > 1000
    parts = [r.split("|") for r in rows[:-1]]
    assert all(len(p) == 17 and p[-1] == "" for p in parts)
    keys = [int(p[0]) for p in parts]
    assert keys[0] == 1 and all(k % 32 < 8 for k in keys)  # sparse order keys
    assert max(int(p[1]) for p in parts) > 100_000  # part keys over 200,000 at SF 1
    assert max(int(p[2]) for p in parts) > 5_000  # supplier keys over 10,000
    assert {p[14] for p in parts} <= set(lineitem.SHIP_MODE)
    assert {p[13] for p in parts} <= set(lineitem.SHIP_INSTRUCT)
    for p in parts[:500]:
        qty, price = int(p[4]), float(p[5])
        pk = int(p[1])
        retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
        assert round(price * 100) == qty * retail
        assert 0 <= float(p[6]) <= 0.10 and 0 <= float(p[7]) <= 0.08
        assert p[10] < p[12] and 10 <= len(p[15]) <= 43


# ------------------------------------------------------------ the references
def _one(fn, data: bytes) -> int:
    rows = np.frombuffer(data, np.uint8)[None, :] if data else np.zeros((1, 1), np.uint8)
    return int(fn(rows, np.array([len(data)]))[0])


@pytest.mark.parametrize("fn, data, want", [
    (hashes.xxh64, b"", 0xEF46DB3751D8E999),
    (hashes.xxh64, b"abc", 0x44BC2CF5AD770999),
    (hashes.xxh64, b"Nobody inspects the spammish repetition", 0xFBCEA83C8A378BF1),
    (hashes.xxh32, b"", 0x02CC5D05),
    (hashes.xxh32, b"abc", 0x32D153FF),
    (hashes.xxh32, b"Nobody inspects the spammish repetition", 0xE2293B2F),
    (hashes.crc32c, b"", 0),
    (hashes.crc32c, b"123456789", 0xE3069283),
    (hashes.crc32c, bytes(32), 0x8A9136AA),
])
def test_reference_hashes_equal_known_vectors(fn, data, want):
    assert _one(fn, data) == want


def test_reference_hashes_take_each_row_length():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (40, 200), dtype=np.uint8)
    lens = rng.integers(0, 201, 40)
    for fn in (hashes.xxh64, hashes.xxh32, hashes.crc32c):
        got = fn(rows, lens)
        for i in range(40):
            one = np.zeros((1, 200), np.uint8)
            one[0, :lens[i]] = rows[i, :lens[i]]
            assert got[i] == fn(one, lens[i:i + 1])[0]


def test_mask_crc_is_the_framing_formats():
    assert int(hashes.mask_crc(np.array([0]))[0]) == 0xA282EAD8
    c = 0x12345678
    assert int(hashes.mask_crc(np.array([c]))[0]) == (((c >> 15) | (c << 17)) + 0xA282EAD8) % 2**32


@pytest.mark.parametrize("codec", ["snappy", "lz4"])
def test_reference_decoders_invert_the_frozen_compressor(codec):
    chunks = lineitem.chunks(5, 3, 65536, 1)
    dec = blocks.snappy_decode if codec == "snappy" else blocks.lz4_decode
    out, lens = native.compress(codec, chunks)
    assert 0.45 < lens.sum() / chunks.size < 0.6
    for i in range(3):
        block = out[i, :lens[i]].tobytes()
        assert dec(block) == chunks[i].tobytes()
        with pytest.raises(ValueError):
            dec(block[:-1])
        assert dec(block, window=4000) != chunks[i].tobytes()
    bad, bad_lens = native.compress(codec, chunks, unchecked=True)
    assert any(_decodes_wrong(dec, bad[i, :bad_lens[i]].tobytes(), chunks[i]) for i in range(3))


@pytest.mark.parametrize("codec", ["snappy", "lz4"])
def test_native_decoder_agrees_with_the_plain_one(codec):
    """The check's C++ decoder gives what ``reference/blocks.py`` gives: the
    chunks from sound blocks, the same wrong bytes from the control's, and
    a rejection wherever the plain decoder raises."""
    dec = blocks.snappy_decode if codec == "snappy" else blocks.lz4_decode
    chunks = lineitem.chunks(6, 4, 65536, 1)
    good, good_lens = native.compress(codec, chunks)
    bad, bad_lens = native.compress(codec, chunks, unchecked=True)
    rng = np.random.default_rng(9)
    cut = np.array([rng.integers(1, n) for n in good_lens])  # truncated blocks
    flip = good.copy()
    flip[np.arange(4), rng.integers(0, good_lens)] ^= 0x55  # one byte altered
    rows = np.concatenate([good, bad, good, flip])
    lens = np.concatenate([good_lens, bad_lens, cut, good_lens])
    out, out_lens = native.decompress(codec, rows, lens, 65536)
    assert np.array_equal(out[:4], chunks) and (out_lens[:4] == 65536).all()
    assert (out_lens[8:12] != 65536).all()  # rejected, or (LZ4) a shorter output
    for i in range(len(rows)):
        try:
            want = dec(rows[i, :lens[i]].tobytes(), 65536)
        except ValueError:
            assert out_lens[i] == -1, i
            continue
        assert out_lens[i] == len(want) and out[i, :len(want)].tobytes() == want, i


def _decodes_wrong(dec, block, chunk) -> bool:
    try:
        return dec(block) != chunk.tobytes()
    except ValueError:
        return True


def test_reference_decoders_reject_bad_offsets():
    with pytest.raises(ValueError):
        blocks.lz4_decode(bytes([0x10, ord("a"), 5, 0, 0x00]))  # offset 5 with 1 byte out
    with pytest.raises(ValueError):
        blocks.snappy_decode(bytes([8, 0x01 | (4 << 2), 1]))  # copy before any output


# -------------------------------------------------------------- byte counts
def test_roofline_bytes_of_a_small_batch():
    run = SimpleNamespace(batch=SimpleNamespace(rows=3, chunk_bytes=100, raw_bytes=300,
                                                comp_bytes=170, digest_bytes=8))
    # compressed 170 + lengths 12 read; 3 rows of 100, lengths 12 and ok 3 written
    assert roofline.kernel_bytes(run, "decode") == 170 + 12 + 300 + 12 + 3
    assert roofline.kernel_bytes(run, "hash") == 300 + 12 + 24
    assert roofline.kernel_bytes(run, "encode") == 300 + 12 + 170 + 12 + 3
    assert roofline.seconds(3.35e12) == pytest.approx(1.0)


def test_roofline_share_reads_the_trace():
    trace = Trace([("void k_kernel<1>(int)", 0, 2000), ("other", 0, 5)], [], (0, 10**6))
    run = SimpleNamespace(trace=trace, batch=SimpleNamespace(
        rows=1, chunk_bytes=3350, raw_bytes=3350, comp_bytes=0, digest_bytes=0))
    # 3354 bytes of the hash at 3.35e12 B/s is 1.0012 ns, over 2000 ns
    share = roofline.share_pct(run, "hash", r"\bk_kernel\b")
    assert share == pytest.approx(100 * 3354 / 3.35e12 / 2e-6)
    assert roofline.share_pct(run, "hash", r"\bmissing\b") is None


def test_trace_busy_idle_and_gaps():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.enqueue", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "bench.wait", "ts": 40, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 80, "dur": 10},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.enqueue", "ts": 0, "dur": 99},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 200, "dur": 10},
    ]
    t = Trace.from_chrome(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(35e-6)  # [10, 35] and [80, 90]
    assert t.kernel_mean_s("^a$") == pytest.approx(20e-6)
    assert dict(t.idle_gaps()) == pytest.approx(
        {"bench.enqueue": 10e-6, "bench.wait": 45e-6, "other": 10e-6})
    assert [n for n, _ in t.device_ops()] == ["a", "b", "c"]


# ----------------------------------------------------------------- manifest
def test_manifest_names_units_and_parts():
    m = manifest.load()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in m[k]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in m["workloads"]]:
        assert manifest.NAME.fullmatch(name), name
    for c in m["configs"]:
        for key in c["reduced"]:
            assert manifest.NAME.fullmatch(key)
        assert c["file"].startswith(m["paths"][0] + "/")
    for metric in m["end_to_end"] + m["per_layer"]:
        assert manifest.UNIT.fullmatch(metric["unit"]), metric["name"]
        assert metric["better"] in ("lower", "higher")
        assert manifest.reader(metric["name"]).read  # a reader file for each
    for w in m["workloads"]:
        cell = manifest.cell(m, w["name"])
        assert cell["config"]["name"] == w["config"]
        assert manifest.codec(cell["config"]["codec"]).COMPRESSOR
        assert any(e["name"] == "setup_s" for e in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for p in cell["per_layer"]:
            assert any(e["name"] == p["moves"] for e in cell["end_to_end"])
    layers = {}
    for p in m["per_layer"]:
        layers.setdefault(p["layer"], set()).add(p["name"])
    assert all(0 < len(layer) <= 200 and "\n" not in layer for layer in layers)


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    m = manifest.load()
    cfg = json.loads((BENCH / "configs" / "lz4-64k.json").read_text())
    cfg["name"], cfg["distinct_chunks"] = "lz4-32k", 512
    (tmp_path / BENCH.name / "configs" / "lz4-32k.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "scan.json").read_text())
    mix["name"], mix["batch_chunks"] = "scan-512", 512
    (tmp_path / BENCH.name / "traffic" / "scan-512.json").write_text(json.dumps(mix))
    (tmp_path / BENCH.name / "metrics" / "batches_done.py").write_text(
        "def read(run):\n    return run.batches\n")
    m["configs"].append({"name": "lz4-32k", "source": "x", "reduced": [],
                         "file": f"{BENCH.name}/configs/lz4-32k.json", "why": "x"})
    m["workloads"].append({"name": "lz4-32k.scan-512", "config": "lz4-32k",
                           "traffic": "scan-512", "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "batches_done", "unit": "count", "better": "higher",
                           "source": "host_clock", "layer": "x", "moves": "decode_GBps",
                           "workloads": ["lz4-32k.scan-512"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    m2 = manifest.load(tmp_path)
    cell = manifest.cell(m2, "lz4-32k.scan-512", tmp_path)
    assert cell["config"]["distinct_chunks"] == 512
    assert cell["traffic"]["batch_chunks"] == 512
    assert [p["name"] for p in cell["per_layer"]][-1] == "batches_done"
    assert manifest.reader("batches_done", tmp_path).read(SimpleNamespace(batches=7)) == 7


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not _imports(f) & {"jax", "jaxlib", "flax", "aircompressor_tpu"}, f
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "aircompressor_tpu_torch" not in _imports(f), f
    assert _imports(BENCH / "codecs" / "lz4.py") >= {"aircompressor_tpu_torch"}


# ------------------------------------------------------ the harness, small
def _small_cell(name: str) -> dict:
    cell = manifest.cell(manifest.load(), name)
    write = cell["traffic"]["direction"] == "encode"
    cell["config"].update(chunk_bytes=1024 if write else 4096, distinct_chunks=3)
    cell["traffic"].update(batch_chunks=4)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_harness_runs_a_small_cell_on_the_cpu(name):
    r = harness.measure(_small_cell(name), 2**31 + 99, 0.05, False, torch.device("cpu"))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 4
    assert list(r)[-1] == "checks" and all(c["limit"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {m["name"] for m in _small_cell(name)["end_to_end"]}
    assert harness.forbidden_modules() == []


def test_traced_run_reports_per_layer_metrics_it_can_read():
    r = harness.measure(_small_cell("snappy-64k.scan"), 17, 0.05, True, torch.device("cpu"))
    assert r["correct"] and "breakdown" in r and r["device"]["window_s"] > 0
    assert "host_enqueue_us.scan" in r["metrics"]
    assert "snappy_decode_roofline" not in r["metrics"]  # no device kernels on the CPU


@pytest.mark.parametrize("name", CELLS)
def test_control_comes_out_not_correct(name):
    cell = _small_cell(name)
    cell["config"]["chunk_bytes"] = 65536  # long enough for copies past the window
    r = harness.measure(cell, 23, 0.05, False, torch.device("cpu"), fn=control.control_fn)
    assert not r["correct"]
    key = "byte_mismatch_rows" if "scan" in name else "block_mismatch_rows"
    assert r["checks"][key]["value"] > 0


def _op(name: str):
    """The port's op module and function that the cell's timed path runs."""
    from aircompressor_tpu_torch.ops import lz4_decode, lz4_encode, snappy_decode, snappy_encode

    codec, mix = name.split("-64k.")
    mod = {("snappy", "scan"): snappy_decode, ("lz4", "scan"): lz4_decode,
           ("snappy", "write"): snappy_encode, ("lz4", "write"): lz4_encode}[codec, mix]
    return mod, "decode" if mix == "scan" else "encode"


def _unchanged(real):
    prev = []

    def op(*a, **k):
        if not prev:
            prev.append(real(*a, **k))
        return prev[0]
    return op


def _half(real):
    def op(rows, lens, *a, **k):
        h = rows.shape[0] // 2
        out = real(rows[:h], lens[:h], *a, **k)
        pad = [torch.zeros((rows.shape[0] - h,) + t.shape[1:], dtype=t.dtype) for t in out]
        pad[2] = torch.ones_like(pad[2])  # the left-out rows claim success
        return tuple(torch.cat([t, p]) for t, p in zip(out, pad))
    return op


def _token(real):
    def op(*a, **k):
        out, lens, ok = real(*a, **k)
        out = out.clone()
        out[-1, int(lens[-1]) // 2] ^= 0x20  # the batch's last row alone
        return out, lens, ok
    return op


@pytest.mark.parametrize("fault", [_unchanged, _half, _token])
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    mod, fn = _op(name)
    monkeypatch.setattr(mod, fn, fault(getattr(mod, fn)))
    r = harness.measure(_small_cell(name), 31, 0.05, False, torch.device("cpu"))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("codec", ["snappy", "lz4"])
def test_write_check_decodes_every_block_of_the_last_batch(codec):
    """One byte altered in one block of 300 is one mismatching row."""
    chunks = lineitem.chunks(8, 300, 1024, 1)
    rows, lens = native.compress(codec, chunks)
    rows[299, lens[299] // 2] ^= 0x20
    s = SimpleNamespace(chunks=chunks, perms=[np.arange(300)], chunk_bytes=1024,
                        adapter=manifest.codec(codec))
    last = {0: (torch.from_numpy(rows), torch.from_numpy(lens))}
    assert check._block_mismatch(s, last) == 1


def test_check_counts_rows_and_holds_them_to_zero():
    s = SimpleNamespace(
        chunks=np.arange(8, dtype=np.uint8).reshape(2, 4), perms=[np.array([0, 1, 1])],
        chunk_bytes=4, direction="decode", adapter=manifest.codec("snappy"), block_width=8)
    ref = hashes.xxh64(s.chunks, np.full(2, 4)).view(np.int64)
    good = (0, np.full(3, 4, np.int32), np.ones(3, bool), ref[[0, 1, 1]])
    bad = (0, np.array([4, 3, 4], np.int32), np.array([True, True, False]), ref[[0, 0, 1]])
    rows = torch.from_numpy(s.chunks[[0, 1, 1]].copy())
    checks, failed = check.compare(s, [good, bad], {0: (rows, None)})
    assert checks == {"digest_mismatch_rows": (1, 0), "length_mismatch_rows": (1, 0),
                      "not_ok_rows": (1, 0), "byte_mismatch_rows": (0, 0)}
    assert failed == 2  # row 1 fails two comparisons, row 2 one
