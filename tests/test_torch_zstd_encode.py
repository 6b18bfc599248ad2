"""The port's batched zstd compress against the JAX package's.

``emit_plain`` (what the port runs for CPU tensors, and what the emission
kernel is held to on the card) must give the outputs of the jitted
``zstd_encode_jax._emit_device`` on the same packed plans, and
``compress_batch`` the frames of ``zstd_encode_jax.compress_batch``, byte
for byte: with the matcher off both equal the host encoder's
(``frame_enc.compress_bytes``), and with it forced on (monkeypatched in the
JAX package for these tests only) the JAX function runs the Pallas DFAST
kernel in interpret mode. The chunks are at most 8 KB; the JAX calls run
once for the module.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aircompressor_tpu.ops import zstd_encode_jax as ze  # noqa: E402
from aircompressor_tpu_torch.host.zstd import device_enc, frame_enc  # noqa: E402
from aircompressor_tpu_torch.ops import zstd_decode, zstd_dfast, zstd_encode  # noqa: E402
from aircompressor_tpu_torch.ops.batch import ZstdBatchCodec, _selfcheck_payload  # noqa: E402

CUT = 8192


def _one_sequence() -> bytes:
    """600 random bytes of 64 values (compressible literals) and a repeat of
    their first 100: one sequence, and a plan that reaches the emission."""
    head = np.random.default_rng(1).integers(0, 64, 600, dtype=np.uint8).tobytes()
    return head + head[:100]


HEADS = [_selfcheck_payload(s)[:CUT] for s in range(5)] + [_one_sequence()]
ROUTES = [b"", bytes(CUT), bytes(range(64)),
          np.random.default_rng(2).integers(0, 256, CUT, dtype=np.uint8).tobytes()]


def _to_jax_args(pk: dict, rows: int) -> list:
    """``_emit_device``'s 24 arguments from ``pack_plans``' arrays, padded
    with empty rows to ``rows`` (the JAX encoder's launch size, so that its
    compiled program is reused)."""
    def pad(a):
        return jnp.asarray(np.concatenate(
            [a, np.zeros((rows - a.shape[0], *a.shape[1:]), a.dtype)]))

    args = [pad(pk["lit"].astype(np.int32)), pad(pk["lit_seg"]), pad(pk["huff"][:, 0]),
            pad(pk["huff"][:, 1])]
    args += [pad(pk["seq"][:, k]) for k in range(9)] + [pad(pk["nseq"])]
    for f in range(3):  # LL, ML, OF
        args += [pad(pk["fse_sym"][:, f, 0]), pad(pk["fse_sym"][:, f, 1]),
                 pad(pk["fse_ns"][:, f])]
    return args + [pad(pk["flush_bits"])]


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX encoder's frames of HEADS, the empty chunk and 64 distinct
    bytes, with the matcher forced on."""
    chunks = HEADS + [ROUTES[0], ROUTES[2]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ze, "USE_DEVICE_MATCHER", True)
        mp.setattr(ze, "_FORCE_MATCHER", True)
        return chunks, ze.compress_batch(chunks)


@pytest.fixture(scope="module")
def packed():
    plans = [device_enc._plan_chunk(c, 3) for c in HEADS]
    assert all(p.device for p in plans)
    return device_enc.pack_plans(plans)


def test_emit_plain_equals_the_jax_emission(packed, jax_frames):
    assert sorted(packed["nseq"].tolist())[0] == 1
    args = [torch.from_numpy(packed[name]) for name, _, _ in zstd_encode.EMIT_INPUTS]
    got = zstd_encode.emit(*args)
    want = ze._emit()(*_to_jax_args(packed, ze.B_PER_LAUNCH))
    rows = len(HEADS)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)[:rows])


def test_compress_batch_without_the_matcher_equals_the_host_encoder():
    chunks = HEADS + ROUTES
    frames_before = zstd_encode.host_frame_rows
    got = zstd_encode.compress_batch(chunks, device_matcher=False, device="cpu")
    assert got == [frame_enc.compress_bytes(c) for c in chunks]
    assert zstd_encode.host_frame_rows - frames_before == len(ROUTES)


def test_compress_batch_equals_the_jax_encoder_with_the_matcher(jax_frames):
    chunks, want = jax_frames
    before = (zstd_encode.host_matcher_rows, zstd_encode.host_frame_rows,
              zstd_dfast.launches, zstd_encode.launches)
    got = zstd_encode.compress_batch(chunks, device="cpu")
    assert got == want
    # the 64 distinct bytes take the host matcher (no sequence), the empty
    # chunk no matcher; both are written by the host encoder; the CPU
    # launches no kernel
    after = (zstd_encode.host_matcher_rows, zstd_encode.host_frame_rows,
             zstd_dfast.launches, zstd_encode.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 2, 0, 0]
    assert zstd_decode.decode_batch(got, device="cpu") == chunks


@pytest.mark.parametrize("fault", ["offset", "not ok"])
def test_a_bad_proposal_raises_naming_its_chunk(monkeypatch, fault):
    real = zstd_dfast.find_sequences

    def faulty(data, lengths):
        ll, ml, of, nseq, last, ok = real(data, lengths)
        if fault == "offset":
            of[1, 0] += 1
        else:
            ok[1] = False
        return ll, ml, of, nseq, last, ok

    monkeypatch.setattr(zstd_dfast, "find_sequences", faulty)
    with pytest.raises(RuntimeError, match=r"\bchunk 1\b"):
        zstd_encode.compress_batch([HEADS[5], b"abcdefgh" * 100, b""], device="cpu")


def test_emit_raises_on_an_overflowing_stream():
    args = [torch.zeros((1, *shape), dtype=dtype) for _, dtype, shape in zstd_encode.EMIT_INPUTS]
    args[1][0, 0] = torch.tensor([0, device_enc.SEG_CAP])  # 16384 symbols ...
    args[2][0, 1] = 31  # ... of 31 bits each
    with pytest.raises(RuntimeError, match="overflowed a stream of row 0"):
        zstd_encode.emit(*args)
    with pytest.raises(ValueError, match="seq must be"):
        zstd_encode.emit(*args[:3], args[3][:, :, :100], *args[4:])


def test_zstd_batch_codec_round_trips_on_the_cpu():
    codec = ZstdBatchCodec(level=1, device="cpu")
    chunks = HEADS[:2] + ROUTES[:3]
    assert codec.decompress_chunks(codec.compress_chunks(chunks)) == chunks
    assert codec.compress_chunks([]) == []
    with pytest.raises(ValueError):
        ZstdBatchCodec(65537, device="cpu")
    with pytest.raises(ValueError, match="chunk 0 exceeds capacity 100"):
        ZstdBatchCodec(100, device="cpu").compress_chunks([bytes(101)])
    with pytest.raises(ValueError, match="exceeds the 65536-byte"):
        zstd_encode.compress_batch([bytes(65537)], device="cpu")
