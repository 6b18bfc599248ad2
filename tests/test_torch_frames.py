"""The port's frame and stream formats against the JAX package, on the CPU:
the LZ4 frame (``lz4.frame``, ``lz4.frame_codec``, ``lz4.streams``),
x-snappy-framed (``snappy.framed``) and lzop (``lzo.lzop``).

The same inputs (seeded text, random bytes and ``conftest.synthetic_cases``,
at most 16 KB each through the numpy block codecs) go through the JAX
writers and their ports, whole and written one byte at a time: the bytes
must be equal, and each side's reader, read whole and one byte at a time,
must give the input back from the other's bytes. Malformed streams (the
hand-made frames of ``tests/test_lz4.py::TestLz4FrameFeatures``,
truncations, flipped checksums, bad headers and chunk kinds) raise each
package's own ``MalformedInputException`` at the same offset. Integer
codecs: the tolerance is 0.
"""

import io

import numpy as np
import pytest

import chip_smoke
from aircompressor_tpu import lz4 as jax_lz4
from aircompressor_tpu.errors import MalformedInputException
from aircompressor_tpu.lz4 import frame_codec as jax_frame_codec
from aircompressor_tpu.lz4 import streams as jax_lz4_streams
from aircompressor_tpu.lzo import lzop as jax_lzop
from aircompressor_tpu.snappy import SnappyRefCompressor as JaxSnappyRef
from aircompressor_tpu.snappy import framed as jax_framed
from aircompressor_tpu.xxhash import xxh32 as jax_xxh32
from aircompressor_tpu_torch import lz4
from aircompressor_tpu_torch.errors import MalformedInputException as PortMalformed
from aircompressor_tpu_torch.host.framed import chunk_spans
from aircompressor_tpu_torch.lz4 import frame_codec
from aircompressor_tpu_torch.lz4 import streams as lz4_streams
from aircompressor_tpu_torch.lzo import lzop
from aircompressor_tpu_torch.ops.batch import _selfcheck_payload
from aircompressor_tpu_torch.snappy import SnappyRefCompressor, SnappyRefDecompressor
from aircompressor_tpu_torch.snappy import framed


def _inputs() -> list[bytes]:
    rng = np.random.default_rng(18)
    return [b"", b"X", _selfcheck_payload(5)[:16000],
            rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
            dict(chip_smoke.synthetic_cases())["text"][:12000]]


INPUTS = _inputs()
CASES = range(len(INPUTS))


def _bytewise_write(stream_cls, sink, raw: bytes, **kw):
    s = stream_cls(sink, **kw)
    for i in range(len(raw)):
        s.write(raw[i:i + 1])
    return s


def _read_all_bytewise(stream) -> bytes:
    out = bytearray()
    while True:
        b = stream.read(1)
        if not b:
            return bytes(out)
        out += b


def _raise_alike(jax_call, port_call) -> None:
    with pytest.raises(MalformedInputException) as want:
        jax_call()
    with pytest.raises(PortMalformed) as got:
        port_call()
    assert got.value.offset == want.value.offset
    assert got.value.reason == want.value.reason


# ------------------------------------------------------------------ LZ4 frame
FRAME_OPTIONS = [
    {},
    {"block_max_id": 4, "block_checksums": True, "content_checksum": True,
     "content_size": True},
    {"block_max_id": 5, "content_size": True},
]


@pytest.mark.parametrize("options", range(len(FRAME_OPTIONS)))
@pytest.mark.parametrize("case", CASES)
def test_lz4_frame_codec_writes_the_jax_bytes(case, options):
    raw, kw = INPUTS[case], FRAME_OPTIONS[options]
    port = frame_codec.Lz4FrameCompressor(lz4.Lz4RefCompressor(), **kw)
    jax = jax_frame_codec.Lz4FrameCompressor(jax_lz4.Lz4RefCompressor(), **kw)
    blob = port.compress(raw)
    assert blob == jax.compress(raw)
    assert port.max_compressed_length(len(raw)) == jax.max_compressed_length(len(raw))
    d = frame_codec.Lz4FrameDecompressor(lz4.Lz4RefDecompressor())
    assert d.decompress(blob, len(raw) + 1) == raw
    assert jax_frame_codec.Lz4FrameDecompressor(
        jax_lz4.Lz4RefDecompressor()).decompress(blob, len(raw) + 1) == raw


def test_lz4_frame_codec_on_native_blocks_and_several_frames():
    raw = _selfcheck_payload(6) * 3  # 3 blocks of 64 KB at block_max_id 4
    port = frame_codec.Lz4FrameCompressor(lz4.Lz4NativeCompressor(), block_max_id=4,
                                          content_checksum=True)
    jax = jax_frame_codec.Lz4FrameCompressor(jax_lz4.Lz4NativeCompressor(), block_max_id=4,
                                             content_checksum=True)
    blob = port.compress(raw)
    assert blob == jax.compress(raw)
    skip = (0x184D2A53).to_bytes(4, "little") + (2).to_bytes(4, "little") + b"zz"
    two = blob + skip + frame_codec.Lz4FrameCompressor.create().compress(b"tail")
    assert frame_codec.Lz4FrameDecompressor.create().decompress(two, 1 << 20) == raw + b"tail"
    assert jax_frame_codec.Lz4FrameDecompressor.create().decompress(two, 1 << 20) == raw + b"tail"


@pytest.mark.parametrize("block_max_id", [4, 7])
@pytest.mark.parametrize("case", CASES)
def test_lz4_streams_write_the_jax_bytes(case, block_max_id):
    raw = INPUTS[case]
    kw = {"block_max_id": block_max_id, "block_checksums": block_max_id == 4}
    whole = lz4_streams.compress_stream(raw, compressor=lz4.Lz4RefCompressor(), **kw)
    assert whole == jax_lz4_streams.compress_stream(
        raw, compressor=jax_lz4.Lz4RefCompressor(), **kw)
    sink = io.BytesIO()
    _bytewise_write(lz4_streams.Lz4FrameOutputStream, sink, raw,
                    compressor=lz4.Lz4RefCompressor(), **kw).finish()
    assert sink.getvalue() == whole
    assert lz4_streams.decompress_stream(whole) == raw
    assert _read_all_bytewise(lz4_streams.Lz4FrameInputStream(
        io.BytesIO(whole), lz4.Lz4RefDecompressor())) == raw


def _lz4_header(flg: int, bd: int, extra: bytes = b"") -> bytes:
    body = bytes([flg, bd]) + extra
    return (0x184D2204).to_bytes(4, "little") + body + bytes([(jax_xxh32(body) >> 8) & 0xFF])


def _lz4_malformed() -> list[bytes]:
    """``tests/test_lz4.py::TestLz4FrameFeatures``'s frames, then a frame
    with every checksum and its truncations and flipped checksums, a bad
    magic, a bad version and an oversized block."""
    end = (0).to_bytes(4, "little")
    stored = (4 | 0x80000000).to_bytes(4, "little") + b"abcd"
    cases = [
        _lz4_header(0x40, 0x70) + end,
        _lz4_header(0x61, 0x70, b"\x01\x02\x03\x04") + end,
        _lz4_header(0x62, 0x70) + end,
        _lz4_header(0x60, 0x71) + end,
        _lz4_header(0x68, 0x70, (99).to_bytes(8, "little")) + end,
        _lz4_header(0x70, 0x70) + stored + (0xDEADBEEF).to_bytes(4, "little") + end,
        _lz4_header(0x64, 0x70) + end + (0xDEADBEEF).to_bytes(4, "little"),
        (0x184D2A50).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"xyz",
        (0x184D2205).to_bytes(4, "little") + bytes(8),
        _lz4_header(0x80 | 0x20, 0x70) + end,
        _lz4_header(0x60, 0x40) + (70000).to_bytes(4, "little") + bytes(8),
    ]
    good = frame_codec.Lz4FrameCompressor(
        lz4.Lz4RefCompressor(), block_max_id=4, block_checksums=True,
        content_checksum=True, content_size=True).compress(INPUTS[2])
    cases += [good[:n] for n in (3, 6, 10, 15, 20, 100, len(good) - 5, len(good) - 1)]
    for pos in (14, 22, len(good) - 2):  # header, block and content checksums
        cases.append(good[:pos] + bytes([good[pos] ^ 1]) + good[pos + 1:])
    return cases


LZ4_MALFORMED = _lz4_malformed()


@pytest.mark.parametrize("case", range(len(LZ4_MALFORMED)))
def test_lz4_frames_malformed_raise_as_in_jax(case):
    blob = LZ4_MALFORMED[case]
    _raise_alike(
        lambda: jax_frame_codec.Lz4FrameDecompressor(
            jax_lz4.Lz4RefDecompressor()).decompress(blob, 1 << 17),
        lambda: frame_codec.Lz4FrameDecompressor(
            lz4.Lz4RefDecompressor()).decompress(blob, 1 << 17))
    try:
        want = jax_lz4_streams.Lz4FrameInputStream(
            io.BytesIO(blob), jax_lz4.Lz4RefDecompressor()).read()
    except MalformedInputException:
        _raise_alike(
            lambda: jax_lz4_streams.Lz4FrameInputStream(
                io.BytesIO(blob), jax_lz4.Lz4RefDecompressor()).read(),
            lambda: lz4_streams.Lz4FrameInputStream(
                io.BytesIO(blob), lz4.Lz4RefDecompressor()).read())
    else:  # the stream reader checks less than the frame decoder
        assert lz4_streams.Lz4FrameInputStream(
            io.BytesIO(blob), lz4.Lz4RefDecompressor()).read() == want


# -------------------------------------------------------------- snappy framed
SNAPPY_OPTIONS = [
    {},
    {"block_size": 4096, "min_compression_ratio": 0.5},
    {"block_size": 1000, "write_checksums": False},
]


@pytest.mark.parametrize("options", range(len(SNAPPY_OPTIONS)))
@pytest.mark.parametrize("case", CASES)
def test_snappy_framed_streams_write_the_jax_bytes(case, options):
    raw, kw = INPUTS[case], SNAPPY_OPTIONS[options]
    whole = framed.compress_framed(raw, compressor=SnappyRefCompressor(), **kw)
    assert whole == jax_framed.compress_framed(raw, compressor=JaxSnappyRef(), **kw)
    sink = io.BytesIO()
    _bytewise_write(framed.SnappyFramedOutputStream, sink, raw,
                    compressor=SnappyRefCompressor(), **kw).close()
    assert sink.getvalue() == whole
    verify = kw.get("write_checksums", True)
    assert framed.decompress_framed(whole, verify_checksums=verify) == raw
    assert _read_all_bytewise(framed.SnappyFramedInputStream(
        io.BytesIO(whole), verify, SnappyRefDecompressor())) == raw
    assert list(framed.iter_frames(whole)) == list(jax_framed.iter_frames(whole))


def _snappy_malformed() -> list[bytes]:
    """Truncations and flipped CRCs of a stream with a stored chunk, a
    padding and a second identifier chunk; a bad header, a bad identifier
    chunk, a reserved unskippable kind, a chunk shorter than its CRC and an
    oversized stored chunk."""
    good = jax_framed.compress_framed(INPUTS[2] + INPUTS[3], block_size=8192,
                                      compressor=JaxSnappyRef())
    head = len(framed.HEADER)
    good = (good[:head] + bytes([0xFE, 2, 0, 0, 7, 7]) + framed.HEADER
            + good[head:])
    cases = [good[:n] for n in (5, head + 3, head + 5, head + 40, len(good) - 1)]
    for kind, pos in chunk_spans(good):
        if kind in (framed.COMPRESSED_CHUNK, framed.UNCOMPRESSED_CHUNK):
            cases.append(good[:pos + 4] + bytes([good[pos + 4] ^ 1]) + good[pos + 5:])
    cases += [b"\xff\x06\x00\x00sNaPpZ",
              framed.HEADER + b"\xff\x06\x00\x00sNaPpZ",
              framed.HEADER + b"\x02\x01\x00\x00x",
              framed.HEADER + b"\x00\x03\x00\x00abc",
              framed.HEADER + b"\x01\x05\x00\x01" + bytes(65541)]
    return cases


SNAPPY_MALFORMED = _snappy_malformed()


@pytest.mark.parametrize("case", range(len(SNAPPY_MALFORMED)))
def test_snappy_framed_malformed_raise_as_in_jax(case):
    blob = SNAPPY_MALFORMED[case]
    _raise_alike(lambda: jax_framed.decompress_framed(blob),
                 lambda: framed.decompress_framed(blob))


def test_snappy_framed_option_bounds():
    for module in (framed, jax_framed):
        for kw in ({"block_size": 0}, {"block_size": 65537},
                   {"min_compression_ratio": 0}, {"min_compression_ratio": 1.5}):
            with pytest.raises(ValueError):
                module.SnappyFramedOutputStream(io.BytesIO(), **kw)


# ----------------------------------------------------------------------- lzop
LZOP_FLAGS = [lzop.F_ADLER32_D, lzop.F_ADLER32_D | lzop.F_ADLER32_C,
              lzop.F_CRC32_D | lzop.F_CRC32_C | lzop.F_H_CRC32, 0]


@pytest.mark.parametrize("flags", LZOP_FLAGS)
@pytest.mark.parametrize("case", CASES)
def test_lzop_writes_the_jax_bytes(case, flags):
    raw = INPUTS[case]
    whole = lzop.compress_file(raw, flags)
    assert whole == jax_lzop.compress_file(raw, flags)
    sink = io.BytesIO()
    _bytewise_write(lzop.LzopOutputStream, sink, raw, flags=flags,
                    block_size=4096).finish()
    small = sink.getvalue()
    jsink = io.BytesIO()
    s = jax_lzop.LzopOutputStream(jsink, flags, 4096)
    s.write(raw)
    s.finish()
    assert small == jsink.getvalue()
    for blob in (whole, small):
        assert lzop.decompress_file(blob) == raw
        assert jax_lzop.decompress_file(blob) == raw
        assert _read_all_bytewise(lzop.LzopInputStream(io.BytesIO(blob))) == raw


def _lzop_malformed() -> list[bytes]:
    good = lzop.compress_file(INPUTS[2], lzop.F_ADLER32_D | lzop.F_ADLER32_C)
    hdr = len(lzop.MAGIC) + 25 + 4  # magic, header, its checksum
    cases = [good[:n] for n in (4, 20, hdr, hdr + 2, hdr + 10, len(good) - 6)]
    cases += [b"\x88" + good[1:],
              good[:hdr - 1] + bytes([good[hdr - 1] ^ 1]) + good[hdr:],
              good[:hdr + 8] + bytes([good[hdr + 8] ^ 1]) + good[hdr + 9:],
              good[:hdr + 12] + bytes([good[hdr + 12] ^ 1]) + good[hdr + 13:],
              good[:hdr + 20] + bytes([good[hdr + 20] ^ 0x40]) + good[hdr + 21:]]
    return cases


LZOP_MALFORMED = _lzop_malformed()


@pytest.mark.parametrize("case", range(len(LZOP_MALFORMED)))
def test_lzop_malformed_raise_as_in_jax(case):
    blob = LZOP_MALFORMED[case]
    _raise_alike(lambda: jax_lzop.decompress_file(blob),
                 lambda: lzop.decompress_file(blob))
