"""The port's zstd host frame decoder, zstd family and zstd streams against
the JAX package, on the CPU.

``zstd.frame_dec`` must decode every frame of ``data.libzstd_frames()``
(libzstd: multi-block frames with repeat offsets across blocks, treeless
literals, raw blocks) and of the host encoder to the original, as the JAX
``frame_dec`` does, and must reject the malformed frames of
``chip_smoke.zstd_malformed_cases`` and truncations with its own
``MalformedInputException`` at the JAX offset. ``zstd.streams`` must write
the JAX streams' bytes, whole and written one byte at a time, and read them
back whole, one byte of input at a time (the incremental decoder and the
input stream) and into a caller's buffer. Inputs are at most 16 KB each
through the numpy encoder. Integer codecs: the tolerance is 0.
"""

import io

import numpy as np
import pytest

import chip_smoke
from aircompressor_tpu.errors import MalformedInputException
from aircompressor_tpu.zstd import ZstdRefCompressor as JaxZstdRef
from aircompressor_tpu.zstd import frame_dec as jax_frame_dec
from aircompressor_tpu.zstd import streams as jax_streams
from aircompressor_tpu_torch.data import libzstd_frames
from aircompressor_tpu_torch.errors import MalformedInputException as PortMalformed
from aircompressor_tpu_torch.ops.batch import _selfcheck_payload
from aircompressor_tpu_torch.zstd import ZstdDecompressor, ZstdRefCompressor, ZstdRefDecompressor
from aircompressor_tpu_torch.zstd import frame_dec, streams

FRAMES = libzstd_frames()


def _decode(module, blob: bytes, cap: int) -> bytes:
    dst = np.empty(cap, np.uint8)
    return dst[:module.decompress(np.frombuffer(blob, np.uint8), dst)].tobytes()


@pytest.mark.parametrize("case", range(len(FRAMES)))
def test_frame_dec_decodes_the_libzstd_frames(case):
    f = FRAMES[case]
    cap = len(f["original"]) + 64
    assert _decode(frame_dec, f["frame"], cap) == f["original"]
    assert _decode(jax_frame_dec, f["frame"], cap) == f["original"]
    assert frame_dec.get_decompressed_size(np.frombuffer(f["frame"], np.uint8)) == \
        jax_frame_dec.get_decompressed_size(np.frombuffer(f["frame"], np.uint8))


def test_frame_dec_decodes_concatenated_and_skippable_frames():
    skip = (0x184D2A5F).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"01234"
    blob = skip + b"".join(f["frame"] for f in FRAMES) + skip
    want = b"".join(f["original"] for f in FRAMES)
    assert _decode(frame_dec, blob, len(want)) == want == _decode(jax_frame_dec, blob, len(want))
    assert ZstdRefDecompressor().decompress(blob, len(want)) == want


def _inputs() -> list[bytes]:
    rng = np.random.default_rng(19)
    return [b"", b"Z", _selfcheck_payload(7)[:16000],
            rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
            dict(chip_smoke.synthetic_cases())["small-period"]]


INPUTS = _inputs()


@pytest.mark.parametrize("case", range(len(INPUTS)))
def test_ref_codec_round_trips_as_in_jax(case):
    raw = INPUTS[case]
    blob = ZstdRefCompressor().compress(raw)
    assert blob == JaxZstdRef().compress(raw)
    assert _decode(frame_dec, blob, len(raw)) == raw == _decode(jax_frame_dec, blob, len(raw))
    assert ZstdDecompressor.get_decompressed_size(blob) == len(raw)


def _malformed() -> list[tuple[str, bytes]]:
    cases = [(name, blob) for name, blob, _ in chip_smoke.zstd_malformed_cases()]
    good = FRAMES[0]["frame"]
    cases += [(f"cut at {n}", good[:n]) for n in (2, 5, 7, 12, len(good) // 2, len(good) - 1)]
    cases += [("bad magic", b"\x28\xb5\x2f\xfe" + good[4:]),
              ("legacy v0.7 magic", (0xFD2FB527).to_bytes(4, "little") + good[4:]),
              ("reserved header bit", good[:4] + bytes([good[4] | 0x08]) + good[5:]),
              ("reserved block type", good[:4] + bytes([0x20, 0]) + b"\x07\x00\x00"),
              ("skippable frame alone", (0x184D2A50).to_bytes(4, "little") + bytes(4)),
              ("nothing", b"")]
    return cases


MALFORMED = _malformed()


@pytest.mark.parametrize("case", range(len(MALFORMED)))
def test_frame_dec_rejects_as_in_jax(case):
    name, blob = MALFORMED[case]
    cap = 1 << 17
    with pytest.raises(MalformedInputException) as want:
        _decode(jax_frame_dec, blob, cap)
    with pytest.raises(PortMalformed) as got:
        _decode(frame_dec, blob, cap)
    assert (got.value.offset, got.value.reason) == (want.value.offset, want.value.reason), name


@pytest.mark.parametrize("level", [1, 3])
@pytest.mark.parametrize("case", range(len(INPUTS)))
def test_output_stream_writes_the_jax_bytes(case, level):
    raw = INPUTS[case]
    whole = streams.compress_stream(raw, level)
    assert whole == jax_streams.compress_stream(raw, level)
    sink = io.BytesIO()
    s = streams.ZstdOutputStream(sink, level)
    for i in range(0, len(raw), 997):
        s.write(raw[i:i + 997])
    s.close()
    assert sink.getvalue() == whole
    assert streams.decompress_stream(whole) == raw
    assert _decode(frame_dec, whole, len(raw)) == raw


def test_output_stream_one_byte_at_a_time():
    raw = INPUTS[2][:3000]
    sink = io.BytesIO()
    s = streams.ZstdOutputStream(sink)
    for i in range(len(raw)):
        s.write(raw[i:i + 1])
    s.finish()
    assert sink.getvalue() == jax_streams.compress_stream(raw)


def test_output_stream_carries_the_window_across_blocks():
    """Over 128 KB: two blocks, the second matching into the first."""
    raw = _selfcheck_payload(8)[:70000] * 2
    blob = streams.compress_stream(raw)
    assert blob == jax_streams.compress_stream(raw)
    assert len(blob) < len(streams.compress_stream(raw[:70000])) + 2000
    assert streams.decompress_stream(blob) == raw


STREAM_SOURCES = [f["frame"] for f in FRAMES[:3]] + [
    streams.compress_stream(INPUTS[2])]


@pytest.mark.parametrize("case", range(len(STREAM_SOURCES)))
def test_incremental_decoder_fed_one_byte_at_a_time(case):
    blob = STREAM_SOURCES[case]
    want = _decode(jax_frame_dec, blob, 1 << 18)
    port, jax = streams.ZstdIncrementalFrameDecompressor(), \
        jax_streams.ZstdIncrementalFrameDecompressor()
    got, jax_got = bytearray(), bytearray()
    for i in range(len(blob)):
        got += port.partial_decompress(blob[i:i + 1])
        jax_got += jax.partial_decompress(blob[i:i + 1])
        assert port.input_required == jax.input_required
    assert bytes(got) == bytes(jax_got) == want
    assert port.finished() and port.is_at_stopping_point()
    assert streams.ZstdInputStream(io.BytesIO(blob), read_chunk=1).read() == want
    assert streams.ZstdInputStream(io.BytesIO(blob)).read(7) == want[:7]


def test_incremental_decoder_into_a_caller_buffer():
    blob = b"".join(STREAM_SOURCES)
    want = b"".join(_decode(jax_frame_dec, s, 1 << 18) for s in STREAM_SOURCES)
    for dec in (streams.ZstdIncrementalFrameDecompressor(),
                jax_streams.ZstdIncrementalFrameDecompressor()):
        out, buf, pos = bytearray(), bytearray(1000), 0
        while pos < len(blob) or not dec.is_at_stopping_point():
            dec.partial_decompress_into(blob[pos:pos + 4096], buf, 0, len(buf))
            pos += dec.input_consumed
            out += buf[:dec.output_buffer_used]
        assert bytes(out) == want


@pytest.mark.parametrize("cut", [3, 9, 40, -5, -1])
def test_truncated_streams_raise_as_in_jax(cut):
    blob = STREAM_SOURCES[3][:cut]
    with pytest.raises(MalformedInputException) as want:
        jax_streams.decompress_stream(blob)
    with pytest.raises(PortMalformed) as got:
        streams.decompress_stream(blob)
    assert (got.value.offset, got.value.reason) == (want.value.offset, want.value.reason)


def test_corrupt_stream_checksum_raises_as_in_jax():
    good = STREAM_SOURCES[3]
    bad = good[:-1] + bytes([good[-1] ^ 1])
    with pytest.raises(MalformedInputException) as want:
        jax_streams.decompress_stream(bad)
    with pytest.raises(PortMalformed) as got:
        streams.decompress_stream(bad)
    assert (got.value.offset, got.value.reason) == (want.value.offset, want.value.reason)
