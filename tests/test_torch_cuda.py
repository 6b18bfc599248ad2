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
from aircompressor_tpu_torch.host import snappy as host_snappy
from aircompressor_tpu_torch.host.crc32c import crc32c_raw
from aircompressor_tpu_torch.host.xxhash import xxh32 as host_xxh32
from aircompressor_tpu_torch.host.xxhash import xxh64 as host_xxh64
from aircompressor_tpu_torch.ops import (
    checksum, lz4_decode, lz4_encode, snappy_decode, snappy_encode, xxhash)
from aircompressor_tpu_torch.ops.batch import (
    Lz4BatchCodec, SnappyBatchCodec, _pack, _selfcheck_payload,
    snappy_framed_decompress_device, to_device_batch)
from chip_smoke import (
    LZ4_EDGE_BLOCKS, backward_cap_case, lz4_length_edges_case, lz4_malformed_cases)

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
