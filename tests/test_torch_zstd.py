"""The port's zstd decode against the JAX package's host tier and planner.

The JAX package's device path (``zstd_jax.decode_batch``) is not run here:
its fixed launch geometry makes one interpret-mode call on two 16 KB frames
take minutes. So the port's plain versions, what the port runs for CPU
tensors and what its CUDA kernels are held to on the card, are compared
with the JAX package's host decoder (``frame_dec``), its Huffman stream
decoders and its planner, exactly: these are integer codecs, so the
tolerance is 0. Frames are at most 8 KB; the batch is decoded once for the
module.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aircompressor_tpu.errors import MalformedInputException
from aircompressor_tpu.zstd import device_prep as jax_prep
from aircompressor_tpu.zstd import frame_dec as jax_dec
from aircompressor_tpu.zstd import frame_enc as jax_enc
from aircompressor_tpu_torch.data import libzstd_frames, zstandard_version
from aircompressor_tpu_torch.errors import MalformedInputException as PortMalformed
from aircompressor_tpu_torch.host.zstd import device_prep, frame_enc
from aircompressor_tpu_torch.ops import zstd_decode
from aircompressor_tpu_torch.ops.batch import ZstdBatchCodec, _selfcheck_payload
from chip_smoke import ZSTD_CUT, zstd_cases, zstd_malformed_cases

CUT = 8192  # the largest original decoded here
FIXTURE = libzstd_frames()
MULTI_BLOCK = 0  # the fixture frame of 8 KB with a block every 1 KB
MALFORMED = zstd_malformed_cases()


def _host_decode(decompress, frame: bytes, cap: int = 65536) -> bytes:
    dst = np.zeros(cap, np.uint8)
    return dst[:decompress(np.frombuffer(frame, np.uint8), dst)].tobytes()


@pytest.fixture(scope="module")
def batch():
    raws = zstd_cases()
    fixture = [f for f in FIXTURE if f["cut"] <= CUT]
    frames = [frame_enc.compress_bytes(r) for r in raws] + [f["frame"] for f in fixture]
    plan = device_prep.plan_batch(frames, 65536)
    res = zstd_decode.decode_plan(zstd_decode.pack(plan, "cpu"))
    return dict(raws=raws + [f["original"] for f in fixture], frames=frames,
                plan=plan, res=res)


@pytest.mark.parametrize("i", range(len(FIXTURE)))
def test_fixture_frame_decodes_with_the_jax_host_decoder(i):
    f = FIXTURE[i]
    assert f["cut"] <= 16384 and f["level"] in (1, 3, 19)
    assert _host_decode(jax_dec.decompress, f["frame"]) == f["original"]


def test_fixture_records_its_sources():
    assert zstandard_version() == "0.25.0"
    assert sum(len(f["frame"]) for f in FIXTURE) < 65536
    assert {f["level"] for f in FIXTURE} == {1, 3, 19}
    assert {f["checksum"] for f in FIXTURE} == {True, False}
    multi = FIXTURE[MULTI_BLOCK]
    assert (multi["cut"], multi["flush"]) == (CUT, 1024)


def test_huffman_plain_equals_the_jax_stream_decoders(batch):
    """Every block's Huffman-coded literals, as the port's plain version
    decodes its streams, equal what the JAX package's
    ``huffman.decode_single_stream`` / ``decode_4_streams`` give for the
    block (through ``frame_dec._decode_literals``)."""
    lit = batch["res"]["lit"].numpy()
    assert not batch["res"]["h_rem"].any()
    n_huff = 0
    for frame, fp in zip(batch["frames"], batch["plan"].frames):
        src = np.frombuffer(frame, np.uint8)
        ip = 4 + jax_dec.read_frame_header(src, 4).header_size
        ctx = jax_dec._FrameContext()
        for bp in fp.blocks:
            bh = jax_dec._u24le(src, ip)
            ip += 3
            size = bh >> 3
            if (bh >> 1) & 3 == 2 and bp.piece_kind[0] == device_prep.PIECE_HUFF:
                want, n, _ = jax_dec._decode_literals(src, ip, ip + size, ctx)
                ends = [0] + bp.piece_end
                got = b"".join(lit[s:s + ends[k + 1] - ends[k]].tobytes()
                               for k, s in enumerate(bp.piece_src))
                assert got == want[:n].tobytes()
                n_huff += 1
            elif (bh >> 1) & 3 == 2:
                jax_dec._decode_literals(src, ip, ip + size, ctx)
            ip += size if (bh >> 1) & 3 != 1 else 1
    assert n_huff >= 20


def test_execute_of_fse_plain_equals_frame_dec(batch):
    res = batch["res"]
    assert res["ok"].all() and res["checksum_ok"].all()
    assert not res["s_rem"].any() and not res["s_err"].any()
    out, out_len = res["out"].numpy(), res["out_len"].numpy()
    for i, (frame, raw) in enumerate(zip(batch["frames"], batch["raws"])):
        assert out_len[i] == len(raw)
        assert out[i, :len(raw)].tobytes() == raw == _host_decode(jax_dec.decompress, frame)
        assert not out[i, len(raw):].any()


def _assert_plans_equal(got, want):
    np.testing.assert_array_equal(got.src, want.src)
    assert (got.litpad_size, got.seq_size, got.out_cap) == (
        want.litpad_size, want.seq_size, want.out_cap)
    for name in ("frames", "huff_streams", "seq_streams"):
        g, w = getattr(got, name), getattr(want, name)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            for fa, fb in zip(dataclasses.astuple(a), dataclasses.astuple(b)):
                np.testing.assert_equal(fa, fb)


def test_plan_equals_the_jax_planner(batch):
    """Field by field: the port's copy keeps the JAX planner's alignment."""
    _assert_plans_equal(batch["plan"], jax_prep.plan_batch(batch["frames"], 65536))


@pytest.mark.parametrize("level", [1, 3, 19])
def test_host_encoder_equals_the_jax_encoder(level):
    raws = zstd_cases()[2:8] + [_selfcheck_payload(4)[:ZSTD_CUT]]
    for raw in raws:
        frame = frame_enc.compress_bytes(raw, level)
        assert frame == jax_enc.compress_bytes(raw, level)


def _malformed_host_frames() -> list[bytes]:
    """The smoke's malformed frames and, from a valid frame: cuts, a bad
    magic, a reserved block type and flipped bits in each part."""
    good = frame_enc.compress_bytes(_selfcheck_payload(12)[:3000])
    flips = [good[:p] + bytes([good[p] ^ 0x10]) + good[p + 1:]
             for p in (4, 9, 30, len(good) // 2, len(good) - 12)]
    reserved = good[:7] + bytes([good[7] | 6]) + good[8:]
    return [b for _, b, _ in MALFORMED] + flips + [
        good[:3], good[:len(good) // 2], good[:-1], b"\0" + good[1:], reserved]


@pytest.mark.parametrize("case", range(len(_malformed_host_frames())))
def test_port_rejects_as_the_jax_decoder(case):
    """The port's planner raises where the JAX planner does, at the same
    offset for the same reason, and plans the other frames as it does; the
    port's decode rejects exactly the frames that the JAX host decoder
    rejects, naming the item, and gives the others the same bytes."""
    frame = _malformed_host_frames()[case]
    try:
        want_plan = jax_prep.plan_batch([frame], 65536)
    except MalformedInputException as exc:
        with pytest.raises(PortMalformed) as got:
            device_prep.plan_batch([frame], 65536)
        assert (got.value.offset, got.value.reason) == (exc.offset, exc.reason)
    else:
        _assert_plans_equal(device_prep.plan_batch([frame], 65536), want_plan)
    try:
        want = _host_decode(jax_dec.decompress, frame)
    except MalformedInputException:
        with pytest.raises(PortMalformed) as got:
            zstd_decode.decode_batch([frame], device="cpu")
        assert got.value.offset == 0
    else:
        assert zstd_decode.decode_batch([frame], device="cpu") == [want]


@pytest.mark.parametrize("name, bad, reason", MALFORMED, ids=[m[0] for m in MALFORMED])
def test_decode_batch_names_the_malformed_item(batch, name, bad, reason):
    """As zstd_jax.decode_batch: the item's index, with its reason."""
    with pytest.raises(MalformedInputException):
        _host_decode(jax_dec.decompress, bad)
    good = batch["frames"][:2]
    with pytest.raises(PortMalformed) as exc:
        zstd_decode.decode_batch([good[0], bad, good[1]], device="cpu")
    assert (exc.value.offset, exc.value.reason) == (1, reason)


def test_planning_failure_names_the_item(batch):
    """F8: the JAX planner raises at a byte offset in the flat batch; the
    port's decode_batch raises at the index of the item."""
    good = batch["frames"][2]
    bad = b"\0" + good[1:]
    with pytest.raises(MalformedInputException) as want:
        jax_prep.plan_batch([good, bad], 65536)
    assert want.value.offset == len(good)
    for items in ([good, bad], [good, bad, good]):
        with pytest.raises(PortMalformed) as got:
            zstd_decode.decode_batch(items, device="cpu")
        assert got.value.offset == 1 and got.value.reason == "invalid magic"
    with pytest.raises(ValueError):
        zstd_decode.decode_batch([good], out_cap=65537, device="cpu")
    zeros = batch["frames"][3]  # 8 KB
    with pytest.raises(PortMalformed) as got:
        zstd_decode.decode_batch([good, zeros], out_cap=1000, device="cpu")
    assert got.value.offset == 1 and got.value.reason == "frame exceeds batch out_cap"


def test_repeat_offsets_carry_across_blocks(batch, monkeypatch):
    """F7: the multi-block fixture frame decodes exactly in the port, and
    needs the repeat offsets carried from block to block: the JAX host
    decoder with them reset at each block rejects it."""
    f = FIXTURE[MULTI_BLOCK]
    assert zstd_decode.decode_batch([f["frame"]], device="cpu") == [f["original"]]
    fp = device_prep.plan_batch([f["frame"]], 65536).frames[0]
    assert sum(bp.n_seq > 0 for bp in fp.blocks) >= 6
    real = jax_dec._decode_and_execute_sequences

    def reset_each_block(*args):
        args[-1].rep[:] = [1, 4, 8]
        return real(*args)

    monkeypatch.setattr(jax_dec, "_decode_and_execute_sequences", reset_each_block)
    with pytest.raises(MalformedInputException):
        _host_decode(jax_dec.decompress, f["frame"])


def test_zstd_batch_codec_on_the_cpu(batch):
    codec = ZstdBatchCodec(device="cpu")
    before = zstd_decode.execute_launches
    assert codec.decompress_chunks(batch["frames"]) == batch["raws"]
    assert zstd_decode.execute_launches == before  # the CPU runs the plain versions
    assert codec.decompress_chunks([]) == []
    with pytest.raises(ValueError, match="chunk 1 exceeds capacity 4096"):
        ZstdBatchCodec(4096, device="cpu").compress_chunks([b"abc", bytes(4097)])
    with pytest.raises(ValueError):
        ZstdBatchCodec(65537, device="cpu")
    with pytest.raises(PortMalformed) as exc:
        ZstdBatchCodec(4096, device="cpu").decompress_chunks(batch["frames"][:4])
    assert exc.value.offset == 3  # zeros: 8 KB


def test_wrappers_take_empty_batches():
    src = torch.zeros(16, dtype=torch.uint8)
    lit, rem = zstd_decode.huffman_decode(
        src, torch.zeros((0, 32), dtype=torch.int32), torch.zeros((0, 256), dtype=torch.uint8), 128)
    assert lit.shape == (128,) and rem.shape == (0,)
    seq3, rem, err = zstd_decode.fse_sequences(
        src, torch.zeros((0, 8), dtype=torch.int32), torch.zeros((0, 1280), dtype=torch.int32),
        torch.zeros((0, 2), dtype=torch.int32), 128)
    assert seq3.shape == (128, 3) and rem.shape == err.shape == (0,)
    out, out_len, ok = zstd_decode.execute(
        src, lit, seq3, torch.zeros((0, 2), dtype=torch.int32),
        torch.zeros((0, 16), dtype=torch.int32))
    assert out.shape == (0, 65536) and out_len.shape == ok.shape == (0,)
    with pytest.raises(ValueError):  # a params row of the wrong width
        zstd_decode.huffman_decode(src, torch.zeros((1, 31), dtype=torch.int32),
                                   torch.zeros((1, 256), dtype=torch.uint8), 128)
    with pytest.raises(ValueError):  # int64 triples
        zstd_decode.execute(src, lit, seq3.long(), torch.zeros((0, 2), dtype=torch.int32),
                            torch.zeros((0, 16), dtype=torch.int32))
