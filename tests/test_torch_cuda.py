"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where no CUDA device is present. On a
machine with one, run them with ``JAX_PLATFORMS=cpu python -m pytest -m cuda
tests/test_torch_cuda.py``. Integer codecs: the tolerance is 0. Inputs and
oracles come from the port's own host copies, so the file runs where the
JAX package cannot.
"""

import numpy as np
import pytest
import torch

from aircompressor_tpu_torch.errors import MalformedInputException
from aircompressor_tpu_torch.host import framed
from aircompressor_tpu_torch.host import lz4 as host_lz4
from aircompressor_tpu_torch.host import lzo as host_lzo
from aircompressor_tpu_torch.host import snappy as host_snappy
from aircompressor_tpu_torch.host.crc32c import crc32c_raw
from aircompressor_tpu_torch.host.xxhash import xxh32 as host_xxh32
from aircompressor_tpu_torch.host.xxhash import xxh64 as host_xxh64
from aircompressor_tpu_torch.data import libzstd_frames
from aircompressor_tpu_torch.host.deflate import plan as deflate_plan
from aircompressor_tpu_torch.host.zstd import device_enc, device_prep
from aircompressor_tpu_torch.host.zstd import frame_enc as host_zstd_enc
from aircompressor_tpu_torch.ops import (
    checksum, deflate_decode, lz4_decode, lz4_encode, lzo_decode, profiling,
    snappy_decode, snappy_decode_r2, snappy_encode, xxhash, zstd_decode, zstd_dfast,
    zstd_encode)
from aircompressor_tpu_torch.ops.batch import (
    DeflateBatchCodec, Lz4BatchCodec, LzoBatchCodec, SnappyBatchCodec, ZstdBatchCodec,
    _pack, _selfcheck_payload, deflate_raw, snappy_framed_decompress_device,
    to_device_batch)
from chip_smoke import (
    LZ4_EDGE_BLOCKS, LZO_EDGE_BLOCKS, LZO_EDGE_CAP, R2_MALFORMED, XXH_SEED_LENGTHS,
    XXH_SEEDS,
    backward_cap_case, deflate_cases, deflate_malformed_cases, deflate_slot_cases,
    deflate_window_cases, dfast_cases, dfast_collision_case, dfast_in_round_case,
    emit_edge_rows, encode_round_cases, fse_section_cases, fse_short_match_chunk, full_cases,
    generated_corpus, huffman_lane_batch,
    huffman_lane_cases, lz4_full_cases, lz4_length_edges_case, lz4_malformed_cases,
    lzo_cases, one_sequence_case, r2_window_cases, snappy_window_cases, tile_sections,
    zstd_cases, zstd_full_cases, zstd_malformed_cases)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _blobs(synthetic):
    raws = [c for _, c in synthetic] + [_selfcheck_payload(s) for s in (1, 2)]
    blobs = [host_snappy.compress(r) for r in raws]
    return raws, blobs + [blobs[-1][: len(blobs[-1]) // 2],
                          b"\x08\x0cabcd\x0f\x04\x00\x00\x01"]


@pytest.mark.parametrize("out_cap", [65536, 4096])
def test_decode_kernel_equals_plain(device, synthetic, out_cap):
    raws, blobs = _blobs(synthetic)
    comp, lens = to_device_batch(*_pack(blobs, max(map(len, blobs)) + 3), device)
    before = snappy_decode.launches
    got = snappy_decode.decode(comp, lens, out_cap=out_cap)
    want = snappy_decode.decode_plain(comp, lens, out_cap=out_cap)
    assert snappy_decode.launches == before + 1
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    ok = got[2].cpu().numpy()
    assert ok[:len(raws)].tolist() == [len(r) <= out_cap for r in raws]
    assert not ok[len(raws):].any()


@pytest.mark.parametrize("width", [512, 509])
def test_xxh64_kernel_equals_plain_and_scalar(device, width):
    lens = list(range(48)) + [63, 64, 65, 100, 255, 256, 257, width, width + 4, -1]
    rng = np.random.default_rng(width)
    host = rng.integers(0, 256, (len(lens), width), dtype=np.uint8)
    data = torch.from_numpy(host).to(device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    before = xxhash.launches
    got = xxhash.xxh64(data, lengths)
    assert xxhash.launches == before + 1
    assert torch.equal(got, xxhash.xxh64_plain(data, lengths))
    assert [v & (2**64 - 1) for v in got.tolist()] == [
        host_xxh64(host[i, :min(max(n, 0), width)].tobytes())
        for i, n in enumerate(lens)]


def test_codec_round_trip_on_device(device, synthetic):
    raws, blobs = _blobs(synthetic)
    short = [(r, b) for r, b in zip(raws, blobs) if len(r) <= 65536]
    codec = SnappyBatchCodec(device=device)
    assert codec.decompress_chunks([b for _, b in short]) == [r for r, _ in short]


def _encode_batch(synthetic, cut: int):
    rng = np.random.default_rng(cut)
    raws = [c[:cut] for _, c in synthetic] + [
        _selfcheck_payload(s)[-cut:] for s in (1, 2)] + [backward_cap_case()]
    buf, lens = _pack(raws, cut)
    noisy = buf.copy()
    for i, n in enumerate(lens):
        noisy[i, n:] = rng.integers(0, 256, cut - n, dtype=np.uint8)
    return raws, buf, noisy, lens


@pytest.mark.parametrize("cut", [2048, 6000, 65536])
def test_encode_kernel_equals_plain(device, synthetic, cut):
    raws, buf, noisy, lens = _encode_batch(synthetic, cut)
    data, lengths = to_device_batch(buf, lens, device)
    before = snappy_encode.launches
    got = snappy_encode.encode(data, lengths)
    assert snappy_encode.launches == before + 1
    want = snappy_encode.encode_plain(data, lengths)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    again = snappy_encode.encode(*to_device_batch(noisy, lens, device))
    for g, a in zip(got, again):  # bytes past each length change nothing
        assert torch.equal(g, a)
    comp, comp_lens, ok = (t.cpu().numpy() for t in got)
    assert ok.all()
    for i, r in enumerate(raws):
        assert host_snappy.decompress(comp[i, :comp_lens[i]].tobytes(), len(r)) == r


def test_codec_compress_round_trip_on_device(device, synthetic):
    raws = [c for _, c in synthetic if len(c) <= 65536] + [
        _selfcheck_payload(s) for s in (1, 2)]
    codec = SnappyBatchCodec(device=device)
    before = snappy_encode.rows
    blobs = codec.compress_chunks(raws)
    assert snappy_encode.rows - before >= len(raws)
    assert codec.decompress_chunks(blobs) == raws
    assert [host_snappy.decompress(b, 65536) for b in blobs[-2:]] == raws[-2:]


def test_crc32c_on_device_equals_host(device):
    rng = np.random.default_rng(3)
    lens = np.array(list(range(40)) + [255, 256, 1000, 4096], np.int32)
    host = rng.integers(0, 256, (len(lens), 4096), dtype=np.uint8)
    got = checksum.crc32c(*to_device_batch(host, lens, device)).cpu().tolist()
    assert got == [crc32c_raw(host[i, :n]) for i, n in enumerate(lens)]


@pytest.mark.parametrize("width, shift", [(4096, 0), (4091, 0), (4096, 1)])
def test_crc32c_kernel_equals_plain_and_host(device, width, shift):
    """The kernel's aligned variant (16-byte rows), and its byte variant
    (an odd width, a base one byte past alignment), against the plain
    version and the host on the length grid, clamped lengths included."""
    grid = list(range(36)) + [63, 64, 65, 4095, 4096, 4097, -7]
    rows = len(grid)
    rng = np.random.default_rng(width + shift)
    buf = torch.from_numpy(rng.integers(0, 256, rows * width + shift, dtype=np.uint8))
    data = buf.to(device)[shift:].view(rows, width)
    lens = torch.tensor(grid, dtype=torch.int32, device=device)
    before = checksum.launches
    got = checksum.crc32c(data, lens)
    assert checksum.launches == before + 1 and got.device.type == "cuda"
    assert torch.equal(got, checksum.crc32c_plain(data, lens))
    host = data.cpu().numpy()
    assert got.tolist() == [crc32c_raw(host[i, :min(max(n, 0), width)])
                            for i, n in enumerate(grid)]


def test_mesh_over_every_card_equals_unsharded(device):
    """The sharded steps on a mesh of every card (8 rows a card) equal the
    unsharded calls on one, and dryrun_multichip runs over every card."""
    from aircompressor_tpu_torch.entry import dryrun_multichip
    from aircompressor_tpu_torch.ops import pipeline

    mesh = pipeline.make_mesh()
    assert mesh.size == torch.cuda.device_count()
    raws = [_selfcheck_payload(i)[-20000:] for i in range(8 * mesh.size)]
    data, lens = to_device_batch(*_pack(raws, 20480), device)
    ck = pipeline.sharded_checksum_step(mesh)(data, lens)
    want = pipeline.checksum_step(data, lens)
    for key in want:
        assert torch.equal(ck[key], want[key]), key
    comp, comp_lens, total = pipeline.sharded_compress(mesh)(data, lens)
    u = snappy_encode.encode(data, lens)
    assert torch.equal(comp, u[0]) and torch.equal(comp_lens, u[1])
    assert int(total) == int(comp_lens.sum())
    out, out_lens, ok, total = pipeline.sharded_decompress(mesh)(comp, comp_lens)
    for a, b in zip((out, out_lens, ok), snappy_decode.decode(comp, comp_lens)):
        assert torch.equal(a, b)
    assert bool(ok.all()) and int(total) == sum(map(len, raws))
    blobs = pipeline.assemble_frames(comp, comp_lens)
    assert [host_snappy.decompress(b, 65536) for b in blobs] == raws
    assert int(dryrun_multichip(mesh.size)["bytes"]) == 4 * mesh.size * 4096


NCCL_RANK = r"""
import json, sys
for name in ("jax", "aircompressor_tpu"):
    sys.modules[name] = None
import torch.distributed as dist
from aircompressor_tpu_torch.host import snappy as host_snappy
from aircompressor_tpu_torch.ops import multihost
from aircompressor_tpu_torch.ops.batch import _pack, _selfcheck_payload

rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
raws = [_selfcheck_payload(100 * rank + i)[-20000:] for i in range(8)]
multihost.initialize(store, world, rank)
mesh = multihost.global_mesh()
data, lens = multihost.make_global_batch(mesh, *_pack(raws, 20480))
comp, comp_lens, c_total = multihost.distributed_compress(mesh)(data, lens)
out, out_lens, ok, d_total = multihost.distributed_decompress(mesh)(comp, comp_lens)
ck = multihost.distributed_checksum(mesh)(data, lens)
rows, blens = multihost.local_rows(comp), multihost.local_rows(comp_lens)
assert [host_snappy.decompress(rows[i, :blens[i]].tobytes(), 65536) for i in range(8)] == raws
assert bool(ok.local.all())
print(json.dumps({"backend": dist.get_backend(), "device": str(data.local.device),
                  "bytes": int(ck["bytes"]), "d_total": int(d_total),
                  "c_total": int(c_total), "mine": sum(map(len, raws)),
                  "comp_mine": int(comp_lens.local.sum())}))
dist.destroy_process_group()
"""


def test_nccl_ranks_one_a_card(device, tmp_path):
    """One NCCL rank a card, as subprocesses: every rank holds the global
    totals, and its local rows decode on the host."""
    import json
    import os
    import subprocess
    import sys

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices (NCCL refuses two ranks on one)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_RANK, str(r), str(n),
                               f"file://{tmp_path / 'store'}"], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=root, env=env)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [e[-3000:] for _, e in outs]
    reps = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert [r["device"] for r in reps] == [f"cuda:{i}" for i in range(n)]
    everything = sum(r["mine"] for r in reps)
    for r in reps:
        assert r["backend"] == "nccl"
        assert r["bytes"] == r["d_total"] == everything
        assert r["c_total"] == sum(q["comp_mine"] for q in reps)


def test_framed_decompress_on_device(device, synthetic):
    noise = np.random.default_rng(9).integers(0, 256, 65536, dtype=np.uint8)
    data = b"".join(c for _, c in synthetic) + noise.tobytes()
    stream = framed.compress_framed(data)
    assert snappy_framed_decompress_device(stream, device=device) == data
    head = len(framed.HEADER) + 4  # the CRC of the first chunk
    bad = stream[:head] + bytes([stream[head] ^ 1]) + stream[head + 1:]
    with pytest.raises(MalformedInputException) as exc:
        snappy_framed_decompress_device(bad, device=device)
    assert exc.value.offset == 0


def _lz4_raws(synthetic, cut: int = 65536) -> list[bytes]:
    return [c[:cut] for c in [c for _, c in synthetic] + [
        backward_cap_case(1000, 200), lz4_length_edges_case()]] + [
        _selfcheck_payload(s)[-cut:] for s in (1, 2)]


@pytest.mark.parametrize("out_cap", [65536, 4096])
def test_lz4_decode_kernel_equals_plain(device, synthetic, out_cap):
    raws = _lz4_raws(synthetic)
    blobs = ([host_lz4.compress(r) for r in raws] + lz4_malformed_cases(host_lz4.compress)
             + [b for b, _, _ in LZ4_EDGE_BLOCKS])
    comp, lens = to_device_batch(*_pack(blobs, max(map(len, blobs)) + 3), device)
    before = lz4_decode.launches
    got = lz4_decode.decode(comp, lens, out_cap=out_cap)
    want = lz4_decode.decode_plain(comp, lens, out_cap=out_cap)
    assert lz4_decode.launches == before + 1
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    ok, out_lens = got[2].cpu().tolist(), got[1].cpu().tolist()
    assert ok[:len(raws)] == [len(r) <= out_cap for r in raws]
    edge = list(zip(ok, out_lens))[-len(LZ4_EDGE_BLOCKS):]
    assert edge == [(k, n) for _, k, n in LZ4_EDGE_BLOCKS]


@pytest.mark.parametrize("cut", [2048, 6000, 65536])
def test_lz4_encode_kernel_equals_plain(device, synthetic, cut):
    raws = _lz4_raws(synthetic, cut)
    buf, lens = _pack(raws, cut)
    noisy = buf.copy()
    rng = np.random.default_rng(cut)
    for i, n in enumerate(lens):
        noisy[i, n:] = rng.integers(0, 256, cut - n, dtype=np.uint8)
    data, lengths = to_device_batch(buf, lens, device)
    before = lz4_encode.launches
    got = lz4_encode.encode(data, lengths)
    assert lz4_encode.launches == before + 1
    want = lz4_encode.encode_plain(data, lengths)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    again = lz4_encode.encode(*to_device_batch(noisy, lens, device))
    for g, a in zip(got, again):  # bytes past each length change nothing
        assert torch.equal(g, a)
    comp, comp_lens, ok = (t.cpu().numpy() for t in got)
    assert ok.all()
    for i, r in enumerate(raws):
        assert host_lz4.decompress(comp[i, :comp_lens[i]].tobytes(), len(r)) == r


@pytest.mark.parametrize("width", [512, 509])
def test_xxh32_kernel_equals_plain_and_scalar(device, width):
    lens = list(range(40)) + [63, 64, 65, 100, 255, 256, 257, width, width + 4, -1]
    rng = np.random.default_rng(width + 1)
    host = rng.integers(0, 256, (len(lens), width), dtype=np.uint8)
    data = torch.from_numpy(host).to(device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    before = xxhash.xxh32_launches
    got = xxhash.xxh32(data, lengths)
    assert xxhash.xxh32_launches == before + 1
    assert torch.equal(got, xxhash.xxh32_plain(data, lengths))
    assert got.tolist() == [host_xxh32(host[i, :min(max(n, 0), width)].tobytes())
                            for i, n in enumerate(lens)]


def test_lz4_codec_round_trip_on_device(device, synthetic):
    raws = [c for _, c in synthetic if len(c) <= 65536] + [
        _selfcheck_payload(s) for s in (1, 2)]
    codec = Lz4BatchCodec(device=device)
    before = lz4_encode.rows, lz4_decode.rows
    blobs = codec.compress_chunks(raws)
    assert codec.decompress_chunks(blobs) == raws
    assert lz4_encode.rows - before[0] >= len(raws)
    assert lz4_decode.rows - before[1] >= len(raws)
    assert [host_lz4.decompress(b, 65536) for b in blobs[-2:]] == raws[-2:]
    assert codec.decompress_chunks([host_lz4.compress(r) for r in raws]) == raws


def _zstd_batch(device):
    """Frames of the synthetic cases, the libzstd fixture, 64 KB chunks at
    level 3 (as the decode path gives them) and the malformed cases, packed
    on ``device``, with the originals of the good ones."""
    raws = zstd_cases()
    fixture = libzstd_frames()
    full = zstd_full_cases()
    frames = ([host_zstd_enc.compress_bytes(r) for r in raws]
              + [f["frame"] for f in fixture]
              + [host_zstd_enc.compress_bytes(c, 3) for c in full]
              + [b for _, b, _ in zstd_malformed_cases()])
    plan = device_prep.plan_batch(frames, 65536)
    return raws + [f["original"] for f in fixture] + full, zstd_decode.pack(plan, device)


def test_zstd_huffman_kernel_equals_plain(device):
    _, pk = _zstd_batch(device)
    before = zstd_decode.huffman_launches
    got = zstd_decode.huffman_decode(pk.src, pk.h_params, pk.h_perm, pk.lit_size)
    assert zstd_decode.huffman_launches == before + 1
    want = zstd_decode.huffman_decode_plain(pk.src, pk.h_params, pk.h_perm, pk.lit_size)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    assert int((got[1] != 0).sum()) == 2  # the short stream and the one after it


def test_zstd_huffman_kernel_on_the_lane_cases(device):
    """Codes of one length, a table of log 11, a short stream, bits left,
    a stream read past its start, a table of log 12, a broken walk, and
    streams of two and three segments; then the zstd batch."""
    _, pk = _zstd_batch(device)
    for args in (huffman_lane_batch(huffman_lane_cases(), device),
                 (pk.src, pk.h_params, pk.h_perm, pk.lit_size)):
        got = zstd_decode.huffman_decode(*args)
        for g, w in zip(got, zstd_decode.huffman_decode_plain(*args)):
            assert g.device.type == "cuda"
            assert torch.equal(g, w)


def test_zstd_fse_kernel_equals_plain(device):
    _, pk = _zstd_batch(device)
    args = (pk.src, pk.s_params, pk.s_tabs, pk.s_frames, pk.seq_slots)
    before = zstd_decode.fse_launches
    got = zstd_decode.fse_sequences(*args)
    assert zstd_decode.fse_launches == before + 1
    for g, w in zip(got, zstd_decode.fse_sequences_plain(*args)):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)


def test_zstd_fse_kernel_on_the_hand_built_sections(device):
    """The hand-built sections, three copies of each
    frame: tables at logs 9/8/9, predefined and RLE tables, one sequence,
    an OF code above 23, a repeat offset of 0, reads below the start and
    past the input, three sections a frame, a frame without sections."""
    _, a = fse_section_cases()
    t = tile_sections(a, 3)
    args = tuple(torch.from_numpy(t[k]).to(device) for k in ("src", "params", "tabs", "frames"))
    args += (t["seq_slots"],)
    got = zstd_decode.fse_sequences(*args)
    for g, w in zip(got, zstd_decode.fse_sequences_plain(*args)):
        assert torch.equal(g, w)


def test_zstd_fse_kernel_on_a_long_section(device):
    """A section of short matches over many ring slices (a 16 KB cut of the
    short-match chunk), with the libzstd fixture's multi-block frames; the
    frames decode to their originals."""
    fixture = libzstd_frames()
    raw = fse_short_match_chunk(16384)
    frames = [host_zstd_enc.compress_bytes(raw, 3)] + [f["frame"] for f in fixture]
    pk = zstd_decode.pack(device_prep.plan_batch(frames, 65536), device)
    args = (pk.src, pk.s_params, pk.s_tabs, pk.s_frames, pk.seq_slots)
    got = zstd_decode.fse_sequences(*args)
    for g, w in zip(got, zstd_decode.fse_sequences_plain(*args)):
        assert torch.equal(g, w)
    res = zstd_decode.decode_plan(pk)
    assert res["ok"].all()
    for i, want in enumerate([raw] + [f["original"] for f in fixture]):
        assert res["out"][i, :len(want)].cpu().numpy().tobytes() == want


def test_zstd_execute_kernel_equals_plain(device):
    raws, pk = _zstd_batch(device)
    lit, _ = zstd_decode.huffman_decode_plain(pk.src, pk.h_params, pk.h_perm, pk.lit_size)
    seq3, _, _ = zstd_decode.fse_sequences_plain(
        pk.src, pk.s_params, pk.s_tabs, pk.s_frames, pk.seq_slots)
    args = (pk.src, lit, seq3, pk.b_frames, pk.blocks)
    for out_cap in (65536, 4096):
        before = zstd_decode.execute_launches
        got = zstd_decode.execute(*args, out_cap=out_cap)
        assert zstd_decode.execute_launches == before + 1
        for g, w in zip(got, zstd_decode.execute_plain(*args, out_cap=out_cap)):
            assert g.device.type == "cuda"
            assert torch.equal(g, w)
        out, out_len, ok = (t.cpu().numpy() for t in got)
        for i, r in enumerate(raws):
            assert ok[i] == (len(r) <= out_cap), i
            if ok[i]:
                assert out_len[i] == len(r) and out[i, :len(r)].tobytes() == r


def test_zstd_decode_on_device(device):
    raws = zstd_cases() + [_selfcheck_payload(s) for s in (1, 2)]
    frames = [host_zstd_enc.compress_bytes(r) for r in raws]
    fixture = libzstd_frames()
    before = (zstd_decode.huffman_launches, zstd_decode.fse_launches,
              zstd_decode.execute_frames, xxhash.launches)
    codec = ZstdBatchCodec(device=device)
    assert codec.decompress_chunks(frames) == raws
    assert codec.decompress_chunks([f["frame"] for f in fixture]) == [
        f["original"] for f in fixture]
    after = (zstd_decode.huffman_launches, zstd_decode.fse_launches,
             zstd_decode.execute_frames, xxhash.launches)
    assert after[0] > before[0] and after[1] > before[1] and after[3] > before[3]
    assert after[2] - before[2] == 1 + len(frames) + len(fixture)  # and the canary
    for name, bad, reason in zstd_malformed_cases():
        with pytest.raises(MalformedInputException) as exc:
            zstd_decode.decode_batch([frames[0], bad, frames[1]], device=device)
        assert (exc.value.offset, exc.value.reason) == (1, reason), name


@pytest.mark.parametrize("out_cap", [65536, LZO_EDGE_CAP])
def test_lzo_decode_kernel_equals_plain(device, out_cap):
    raws = lzo_cases() + [_selfcheck_payload(s) for s in (1, 2)]
    blobs = [host_lzo.compress(r) for r in raws] + [b for b, _, _ in LZO_EDGE_BLOCKS]
    comp, lens = to_device_batch(*_pack(blobs, max(map(len, blobs)) + 3), device)
    before = lzo_decode.launches
    got = lzo_decode.decode(comp, lens, out_cap=out_cap)
    assert lzo_decode.launches == before + 1
    for g, w in zip(got, lzo_decode.decode_plain(comp, lens, out_cap=out_cap)):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    out, out_lens, ok = (t.cpu().numpy() for t in got)
    for i, r in enumerate(raws):
        assert ok[i] == (len(r) <= out_cap) and out_lens[i] == len(r), i
        assert out[i, :min(len(r), out_cap)].tobytes() == r[:out_cap], i
    if out_cap == LZO_EDGE_CAP:
        edge = list(zip(ok.tolist(), out_lens.tolist()))[len(raws):]
        assert edge == [(o, n) for _, o, n in LZO_EDGE_BLOCKS]


@pytest.mark.parametrize("out_cap", [65536, 4096])
def test_deflate_decode_kernel_equals_plain(device, out_cap):
    """The deflate cases, the malformed streams, and a stream cut after
    planning."""
    blobs, raws = deflate_cases()
    items = blobs + [b for _, b in deflate_malformed_cases()] + [blobs[-1]]
    buf, lens = _pack(items, max(map(len, items)) + 3)
    plan = deflate_plan.plan(buf, lens)
    lens[-1] //= 2
    comp, comp_lens = to_device_batch(buf, lens, device)
    dplan = deflate_decode.upload(plan, device)
    before = deflate_decode.launches
    got = deflate_decode.decode(comp, comp_lens, dplan, out_cap=out_cap)
    assert deflate_decode.launches == before + 1
    for g, w in zip(got, deflate_decode.decode_plain(comp, comp_lens, dplan, out_cap=out_cap)):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    out, out_lens, ok = (t.cpu().numpy() for t in got)
    for i, r in enumerate(raws):
        assert ok[i] == (len(r) <= out_cap) and out_lens[i] == len(r), i
        assert out[i, :min(len(r), out_cap)].tobytes() == r[:out_cap], i
    assert not ok[len(raws):].any()
    assert 0 < out_lens[-1] < len(raws[-1])


def test_lzo_and_deflate_codecs_on_device(device, synthetic):
    raws = [c[:65536] for _, c in synthetic] + [_selfcheck_payload(4)]
    for codec, mod in ((LzoBatchCodec(device=device), lzo_decode),
                       (DeflateBatchCodec(device=device), deflate_decode)):
        blobs = codec.compress_chunks(raws)
        before = mod.rows
        assert codec.decompress_chunks(blobs) == raws
        assert mod.rows - before == 1 + len(raws)  # and the canary
        bad = blobs[:2] + [blobs[2][:len(blobs[2]) // 2]]
        with pytest.raises(MalformedInputException) as exc:
            codec.decompress_chunks(bad)
        assert exc.value.offset == 2
    with pytest.raises(MalformedInputException) as exc:
        DeflateBatchCodec(device=device).decompress_chunks(
            [deflate_raw(b"abc")] + [b for _, b in deflate_malformed_cases()])
    assert exc.value.offset == 1


@pytest.mark.parametrize("width", [1024, 1021])
def test_xxh_kernels_take_a_seed(device, width):
    """Aligned rows, then unaligned; kernel == plain == host at each seed."""
    rng = np.random.default_rng(width)
    host = rng.integers(0, 256, (len(XXH_SEED_LENGTHS), width), dtype=np.uint8)
    data = torch.from_numpy(host).to(device)
    lens = torch.tensor(XXH_SEED_LENGTHS, dtype=torch.int32, device=device)
    for bits, kernel, plain, scalar in ((64, xxhash.xxh64, xxhash.xxh64_plain, host_xxh64),
                                        (32, xxhash.xxh32, xxhash.xxh32_plain, host_xxh32)):
        for seed in (*XXH_SEEDS, (1 << bits) - 1):
            got = [v & ((1 << bits) - 1) for v in kernel(data, lens, seed).tolist()]
            want = [v & ((1 << bits) - 1) for v in plain(data, lens, seed).tolist()]
            assert got == want == [scalar(host[i, :n], seed)
                                   for i, n in enumerate(XXH_SEED_LENGTHS)], (bits, seed)


def _dfast_batch(device):
    chunks = dfast_cases() + zstd_full_cases()[:3]
    return chunks, to_device_batch(*_pack(chunks, 65536), device)


def test_zstd_dfast_kernel_equals_plain(device):
    chunks, (data, lens) = _dfast_batch(device)
    before = zstd_dfast.launches
    got = zstd_dfast.find_sequences(data, lens)
    assert zstd_dfast.launches == before + 1
    for g, w in zip(got, zstd_dfast.find_sequences_plain(data, lens)):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    assert bool(got[5].all()) and int(got[3][-1]) > 100


def test_zstd_emit_kernel_equals_plain(device):
    """The plans of the matcher kernel's proposals and of the host matcher
    at level 1."""
    chunks, (data, lens) = _dfast_batch(device)
    packs = [zstd_encode.plan(chunks, 3, zstd_encode.match(chunks, data, lens)).pack(),
             zstd_encode.plan(chunks, 1, [None] * len(chunks)).pack()]
    packed = {k: np.concatenate([p[k] for p in packs]) for k in packs[0]}
    args = [torch.from_numpy(packed[name]).to(device) for name, _, _ in zstd_encode.EMIT_INPUTS]
    before = zstd_encode.launches
    got = zstd_encode.emit(*args)
    assert zstd_encode.launches == before + 1
    for g, w in zip(got, zstd_encode.emit_plain(*args)):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)


def test_zstd_emit_kernel_on_the_edge_rows(device, monkeypatch):
    """One sequence, nseq 0, random fields inside the clamps; then a row
    that overflows: both raise, and with the check off they agree."""
    plans = [device_enc._plan_chunk(c, 3) for c in (one_sequence_case(), _selfcheck_payload(7))]
    packed = device_enc.pack_plans(plans)
    edge, over = emit_edge_rows(packed)
    for rows in ({k: np.concatenate([v, edge[k]]) for k, v in packed.items()}, over):
        args = [torch.from_numpy(rows[name]).to(device) for name, _, _ in zstd_encode.EMIT_INPUTS]
        if rows is over:
            for fn in (zstd_encode.emit, zstd_encode.emit_plain):
                with pytest.raises(RuntimeError, match="overflowed a stream of row 0"):
                    fn(*args)
            monkeypatch.setattr(zstd_encode, "_check_totals", lambda *a: None)
        for g, w in zip(zstd_encode.emit(*args), zstd_encode.emit_plain(*args)):
            assert g.device.type == "cuda"
            assert torch.equal(g, w)


def test_zstd_compress_round_trip_on_device(device, synthetic):
    raws = [c[:65536] for _, c in synthetic] + [_selfcheck_payload(s) for s in (1, 2)]
    codec = ZstdBatchCodec(device=device)
    before = (zstd_dfast.rows, zstd_encode.rows)
    frames = codec.compress_chunks(raws)
    assert (zstd_dfast.rows - before[0], zstd_encode.rows - before[1] > 2) == (
        2 + len(raws), True)  # the canary's two chunks and the batch
    assert codec.decompress_chunks(frames) == raws


def _r2_batch(synthetic, device):
    """45 rows, two groups of the r2 kernel: the decode cases, malformed
    rows and 64 KB text blocks."""
    _, blobs = _blobs(synthetic)
    blobs = blobs + R2_MALFORMED
    blobs += [host_snappy.compress(_selfcheck_payload(s)) for s in range(3, 48 - len(blobs))]
    return to_device_batch(*_pack(blobs, max(map(len, blobs))), device)


@pytest.mark.parametrize("out_cap", [65536, 4096])
def test_snappy_r2_kernel_equals_plain(device, synthetic, out_cap):
    comp, lens = _r2_batch(synthetic, device)
    assert comp.shape[0] == 45
    before = snappy_decode_r2.launches
    got = snappy_decode_r2.decode(comp, lens, out_cap=out_cap, with_steps=True)
    want = snappy_decode_r2.decode_plain(comp, lens, out_cap=out_cap, with_steps=True)
    assert snappy_decode_r2.launches == before + 1
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    for g, w in zip(got, snappy_decode.decode(comp, lens, out_cap=out_cap)):
        assert torch.equal(g, w)
    assert len(set(got[3].tolist())) == 2  # two groups, different maxima


def test_snappy_r2_kernel_counts_each_chunk(device, synthetic):
    """One chunk a launch: the group maximum is that chunk's own count."""
    comp, lens = _r2_batch(synthetic, device)
    want = snappy_decode_r2.chunk_steps(snappy_decode.token_table(comp, lens), lens)
    got = [int(snappy_decode_r2.decode(comp[i:i + 1], lens[i:i + 1], with_steps=True)[3][0])
           for i in range(comp.shape[0])]
    assert got == want.tolist()


@pytest.mark.parametrize("rows", [257, snappy_decode_r2.SMALL_BATCH + 1])
@pytest.mark.parametrize("out_cap", [65536, 4096, 4093])
def test_snappy_r2_kernel_window_cases(device, synthetic, rows, out_cap):
    """Both windows of the r2 kernel (32 KB at 257 rows, 4 KB above
    SMALL_BATCH) on rows of an odd width: the 45 rows and the hand-built
    window cases (copies at each reach - 1, reach and reach + 1, dist
    65,535, dist-1 and dist-3 runs, literals across ring slices), with
    steps; bytes, lengths and ok also equal kernel #1's."""
    comp, lens = _r2_batch(synthetic, "cpu")
    blobs = [comp[i, :int(lens[i])].numpy().tobytes() for i in range(comp.shape[0])]
    blobs += [b for _, b in r2_window_cases()]
    batch = (blobs * (rows // len(blobs) + 1))[:rows]
    comp, lens = to_device_batch(*_pack(batch, max(map(len, batch)) | 1), device)
    got = snappy_decode_r2.decode(comp, lens, out_cap=out_cap, with_steps=True)
    want = snappy_decode_r2.decode_plain(comp, lens, out_cap=out_cap, with_steps=True)
    for name, g, w in zip(("out", "out_lens", "ok", "steps"), got, want):
        assert torch.equal(g, w), name
    for g, w in zip(got, snappy_decode.decode(comp, lens, out_cap=out_cap)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("codec", ["snappy", "lz4"])
def test_decode_kernels_with_steps_equal_plain(device, synthetic, codec):
    if codec == "snappy":
        mod, (_, blobs) = snappy_decode, _blobs(synthetic)
        blobs = blobs + R2_MALFORMED
    else:
        mod = lz4_decode
        blobs = ([host_lz4.compress(r) for r in _lz4_raws(synthetic)]
                 + lz4_malformed_cases(host_lz4.compress) + [b for b, _, _ in LZ4_EDGE_BLOCKS])
    comp, lens = to_device_batch(*_pack(blobs, max(map(len, blobs)) + 3), device)
    got = mod.decode(comp, lens, with_steps=True)
    for g, w in zip(got, mod.decode_plain(comp, lens, with_steps=True)):
        assert torch.equal(g, w)
    for g, w in zip(got, mod.decode(comp, lens)):
        assert torch.equal(g, w)
    assert int(got[3].max()) > 0


def test_kernel_rows_on_the_card(device):
    rows = profiling.kernel_rows(batch=32, trials=1)
    assert [r["kernel"] for r in rows] == ["snappy_decode", "lz4_decode", "xxh64"]
    for r in rows:
        assert r["GBps"] > 0 and r["bound_ms"] > 0 and r["card"]
    for r in rows[:2]:
        assert r["chunks"] == 32 and r["loop_iterations"] >= r["longest_chain"] > 0


def _window_blobs(synthetic) -> list[bytes]:
    """The decode checks' blobs, the r2 malformed blobs and the hand-built
    window cases: a 64 KB dist-1 run, a 64 KB literal, copies just inside
    and outside each window's reach, a mixed block."""
    _, blobs = _blobs(synthetic)
    return blobs + R2_MALFORMED + [b for _, b in snappy_window_cases()]


@pytest.mark.parametrize("rows", [257, snappy_decode.SMALL_BATCH + 1])
@pytest.mark.parametrize("out_cap", [65536, 4093])
def test_decode_kernel_window_cases(device, synthetic, rows, out_cap):
    """Both windows of the redesigned decode (32 KB at 257 rows, 4 KB above
    SMALL_BATCH) on rows of an odd width, with steps, and each row alone."""
    blobs = _window_blobs(synthetic)
    batch = (blobs * (rows // len(blobs) + 1))[:rows]
    cap = max(map(len, batch)) | 1
    comp, lens = to_device_batch(*_pack(batch, cap), device)
    got = snappy_decode.decode(comp, lens, out_cap=out_cap, with_steps=True)
    want = snappy_decode.decode_plain(comp, lens, out_cap=out_cap, with_steps=True)
    for name, g, w in zip(("out", "out_lens", "ok", "steps"), got, want):
        assert torch.equal(g, w), name
    for g, w in zip(got, snappy_decode.decode(comp, lens, out_cap=out_cap)):
        assert torch.equal(g, w)
    for i in range(len(blobs)):  # B = 1
        one = snappy_decode.decode(comp[i:i + 1], lens[i:i + 1], out_cap=out_cap,
                                   with_steps=True)
        for name, g, w in zip(("out", "out_lens", "ok", "steps"), one, want):
            assert torch.equal(g[0], w[i]), (i, name)
    ok = got[2].cpu().tolist()
    assert sum(ok) >= len(snappy_window_cases()) and not all(ok)


@pytest.mark.parametrize("width", [65536, 65531])
@pytest.mark.parametrize("batch", [1, 7, 257])
def test_xxh64_kernel_batches_and_widths(device, width, batch):
    """Aligned and unaligned 64 KB rows, 1 to 257 of them (1 to 8 streams a
    warp), lengths -1, 0, 31, 32, past the row and random; kernel == plain
    at each seed of the seed test, and == the host for the first rows."""
    rng = np.random.default_rng(width + batch)
    host = rng.integers(0, 256, (batch, width), dtype=np.uint8)
    lens = ([-1, 0, 31, 32, width + 9, width, 65]
            + rng.integers(0, width, batch, dtype=np.int64).tolist())[:batch]
    data = torch.from_numpy(host).to(device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    for seed in (*XXH_SEEDS, (1 << 64) - 1):
        got = xxhash.xxh64(data, lengths, seed)
        assert torch.equal(got, xxhash.xxh64_plain(data, lengths, seed)), seed
        assert [v & (2**64 - 1) for v in got[:8].tolist()] == [
            host_xxh64(host[i, :min(max(n, 0), width)], seed)
            for i, n in enumerate(lens[:8])], seed


@pytest.mark.parametrize("codec", ["lzo", "deflate", "snappy_encode", "lz4_encode"])
def test_kernels_with_steps_equal_plain(device, synthetic, codec):
    """The four kernels that gained a step count: kernel == plain on all
    four outputs with steps on, and the three outputs as with steps off."""
    if codec == "lzo":
        raws = lzo_cases() + [_selfcheck_payload(s) for s in (1, 2)]
        blobs = [host_lzo.compress(r) for r in raws] + [b for b, _, _ in LZO_EDGE_BLOCKS]
        blobs.append(blobs[-len(LZO_EDGE_BLOCKS) - 1][:-3])  # the stop command cut off
        args = to_device_batch(*_pack(blobs, max(map(len, blobs)) + 3), device)
        run = lambda fn, **kw: fn(*args, out_cap=LZO_EDGE_CAP, **kw)  # noqa: E731
        kernel, plain = lzo_decode.decode, lzo_decode.decode_plain
    elif codec == "deflate":
        blobs, _ = deflate_cases()
        items = blobs + [b for _, b in deflate_malformed_cases()] + [blobs[-1]]
        buf, lens = _pack(items, max(map(len, items)) + 3)
        plan = deflate_decode.upload(deflate_plan.plan(buf, lens), device)
        lens[-1] //= 2
        comp, comp_lens = to_device_batch(buf, lens, device)
        run = lambda fn, **kw: fn(comp, comp_lens, plan, **kw)  # noqa: E731
        kernel, plain = deflate_decode.decode, deflate_decode.decode_plain
    else:
        mod = snappy_encode if codec == "snappy_encode" else lz4_encode
        _, buf, _, lens = _encode_batch(synthetic, 6000)
        args = to_device_batch(buf, lens, device)
        run = lambda fn, **kw: fn(*args, **kw)  # noqa: E731
        kernel, plain = mod.encode, mod.encode_plain
    got = run(kernel, with_steps=True)
    for g, w in zip(got, run(plain, with_steps=True)):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    for g, w in zip(got, run(kernel)):
        assert torch.equal(g, w)
    assert int(got[3].max()) > 0


@pytest.mark.parametrize("rows", [3, 397])
def test_zstd_dfast_kernel_rounds_with_steps(device, rows):
    """The two round chunks (an in-round hash collision, an in-round match)
    and the edge chunks, tiled past one wave at 397 rows: kernel == plain on
    all seven outputs, and the six outputs as with steps off."""
    chunks = [dfast_collision_case()[0], dfast_in_round_case()[0]] + dfast_cases()
    tiled = (chunks * (rows // len(chunks) + 1))[:rows]
    data, lens = to_device_batch(*_pack(tiled, 8193), device)
    got = zstd_dfast.find_sequences(data, lens, with_steps=True)
    for g, w in zip(got, zstd_dfast.find_sequences_plain(data, lens, with_steps=True)):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    for g, w in zip(got, zstd_dfast.find_sequences(data, lens)):
        assert torch.equal(g, w)
    assert int(got[6].max()) > 1000


@pytest.mark.parametrize("rows", [7, deflate_decode.SMALL_BATCH + 1])
@pytest.mark.parametrize("out_cap", [65536, 4093])
def test_deflate_decode_kernel_window_and_slot_cases(device, rows, out_cap):
    """Both instantiations (7 rows: 32 KB window; SMALL_BATCH + 1: 1 KB) on
    the window cases and the slot cases at an odd width: kernel == plain
    with steps, the plain version run once on the distinct rows."""
    items = [b for _, b in deflate_window_cases() + deflate_slot_cases()]
    buf, lens = _pack(items, max(map(len, items)) + 3)
    plan = deflate_plan.plan(buf, lens)
    comp, comp_lens = to_device_batch(buf, lens, device)
    want = deflate_decode.decode_plain(comp, comp_lens, deflate_decode.upload(plan, device),
                                       out_cap=out_cap, with_steps=True)
    reps = rows // len(items) + 1
    from chip_smoke import tile_plan

    got = deflate_decode.decode(comp.repeat(reps, 1), comp_lens.repeat(reps),
                                deflate_decode.upload(tile_plan(plan, reps), device),
                                out_cap=out_cap, with_steps=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w.repeat(reps, *[1] * (w.dim() - 1)))
    assert bool(want[2].all()) or out_cap < 65536


_ENCODERS = {"snappy": snappy_encode, "lz4": lz4_encode}


@pytest.mark.parametrize("rows", [3, 793])
@pytest.mark.parametrize("codec", list(_ENCODERS))
def test_encode_kernel_rounds_with_steps(device, codec, rows):
    """The round chunks of chip_smoke.encode_round_cases (an in-round hash
    collision, an in-round hit, a write past the hit, the step growing, a
    round cut by the find limit, the match limit at each byte of a lane's
    window), tiled past one wave at 793 rows: kernel == plain on all four
    outputs, and the three outputs as with steps off."""
    mod = _ENCODERS[codec]
    chunks = [c for _, c in encode_round_cases(codec)]
    tiled = (chunks * (rows // len(chunks) + 1))[:rows]
    data, lens = to_device_batch(*_pack(tiled, 8193), device)
    got = mod.encode(data, lens, with_steps=True)
    for g, w in zip(got, mod.encode_plain(data, lens, with_steps=True)):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    for g, w in zip(got, mod.encode(data, lens)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("codec", list(_ENCODERS))
def test_encode_kernel_with_steps_on_64kb_rows(device, codec):
    """The 64 KB rows of chip_smoke's encode comparison: kernel == plain on
    all four outputs with steps on."""
    mod = _ENCODERS[codec]
    rows = (full_cases if codec == "snappy" else lz4_full_cases)(generated_corpus())
    data, lens = to_device_batch(*_pack(rows, 65536), device)
    got = mod.encode(data, lens, with_steps=True)
    for g, w in zip(got, mod.encode_plain(data, lens, with_steps=True)):
        assert torch.equal(g, w)
    assert int(got[3].max()) > 1000
