"""The port's Hadoop layer against the JAX package's, on the CPU.

A synthetic payload (``conftest.synthetic_cases`` pieces, seeded bytes and
``_selfcheck_payload`` text, 60 KB; not the reference corpus: ROADMAP F2)
goes through every ``CODEC_REGISTRY`` entry of both packages, written in
pieces of 7,001 B: the streams must be byte-equal (both native tiers are
built from the same C++; zlib, libbz2 and the zstd stream encoder are the
same code), and each side must read the other's. The registries name the
same codecs; reads of one byte, ``reset_state`` at a second stream and
empty input behave alike. The LZ4, Snappy and LZO block streams, written
with ``buffer_size`` 16 KB, parse from their wire format
(``chip_smoke.hadoop_block_chunks``) to chunks that the host block decoders
and the batch codecs' CPU versions accept. The smoke's gzip and zlib
parsers read every header field, and its ``compat`` phase runs on the CPU
at a small size up to its launch check. The tolerance is 0.
"""

import io
import time

import numpy as np
import pytest

import chip_smoke
from aircompressor_tpu import hadoop as jax_hadoop
from aircompressor_tpu import native as jax_native
from aircompressor_tpu_torch import hadoop, lz4, lzo, native, snappy
from aircompressor_tpu_torch.ops.batch import (
    DeflateBatchCodec, Lz4BatchCodec, LzoBatchCodec, SnappyBatchCodec, _selfcheck_payload)

CODECS = sorted(hadoop.CODEC_REGISTRY)
BLOCK_CODECS = {"org.apache.hadoop.io.compress.Lz4Codec": "lz4",
                "org.apache.hadoop.io.compress.SnappyCodec": "snappy",
                "org.apache.hadoop.io.compress.LzoCodec": "lzo"}


def _payload() -> bytes:
    rng = np.random.default_rng(20)
    parts = [c[:6000] for _, c in chip_smoke.synthetic_cases()] + [
        rng.integers(0, 256, 2000, dtype=np.uint8).tobytes(), _selfcheck_payload(9)]
    return b"".join(parts)[:61440]


PAYLOAD = _payload()


@pytest.fixture(scope="module")
def natives():
    """Both native tiers, loaded. The JAX library is built next to its
    sources on first use; a process that loads it while another test
    process writes it sees a half-written file, so the load is retried."""
    for _ in range(5):
        if jax_native.is_enabled():
            break
        jax_native._TRIED = False
        time.sleep(2)
    assert jax_native.is_enabled(), jax_native.load_error()
    assert native.is_enabled(), native.load_error()


def _write(streams, data: bytes, piece: int = 7001) -> bytes:
    sink = io.BytesIO()
    out = streams.create_output_stream(sink)
    for i in range(0, len(data), piece):
        out.write(data[i:i + piece])
    out.finish()
    out.finish()
    return sink.getvalue()


def _read(streams, blob: bytes, size: int = -1) -> bytes:
    src = streams.create_input_stream(io.BytesIO(blob))
    if size < 0:
        return src.read()
    pieces = []
    while piece := src.read(size):
        pieces.append(piece)
    return b"".join(pieces)


def test_registries_name_the_same_codecs():
    assert CODECS == sorted(jax_hadoop.CODEC_REGISTRY)
    for name in CODECS:
        port, jax = hadoop.get_codec(name), jax_hadoop.get_codec(name)
        assert type(port).__name__ == type(jax).__name__
        assert port.extension == jax.extension
        assert port.codec_names == jax.codec_names and name in port.codec_names
    with pytest.raises(KeyError):
        hadoop.get_codec("org.example.NoSuchCodec")


@pytest.mark.parametrize("codec", CODECS)
def test_streams_equal_the_jax_streams(codec, natives):
    data = PAYLOAD if "ZStandard" not in codec else PAYLOAD[:32768]
    port, jax = hadoop.get_codec(codec), jax_hadoop.get_codec(codec)
    blob = _write(port, data)
    assert blob == _write(jax, data)
    assert _read(port, blob) == data == _read(jax, blob)


@pytest.mark.parametrize("codec", CODECS)
def test_one_byte_reads(codec, natives):
    data = PAYLOAD[-3000:]
    streams = hadoop.get_codec(codec)
    assert _read(streams, _write(streams, data), size=1) == data
    assert _read(streams, _write(streams, data), size=997) == data


@pytest.mark.parametrize("codec", CODECS)
def test_empty_input(codec, natives):
    port, jax = hadoop.get_codec(codec), jax_hadoop.get_codec(codec)
    blob = _write(port, b"")
    assert blob == _write(jax, b"")
    assert _read(port, blob) == b"" == _read(jax, blob)


@pytest.mark.parametrize("codec", CODECS)
def test_reset_state_restarts_at_a_second_stream(codec, natives):
    """Hadoop's split reset (HadoopInputStream.resetState): a reader that
    has read the first stream is moved to the second and reset."""
    streams = hadoop.get_codec(codec)
    a, b = b"first stream " * 300, b"second stream " * 301
    first = _write(streams, a)
    src = io.BytesIO(first + _write(streams, b))
    reader = streams.create_input_stream(src)
    got = bytearray()
    while len(got) < len(a) and (piece := reader.read(len(a) - len(got))):
        got += piece
    assert bytes(got) == a
    src.seek(len(first))
    reader.reset_state()
    rest = bytearray()
    while piece := reader.read(65536):
        rest += piece
    assert bytes(rest) == b


@pytest.mark.parametrize("codec", sorted(BLOCK_CODECS))
def test_block_wire_format_parses_to_host_and_batch_blocks(codec, natives):
    family = BLOCK_CODECS[codec]
    cls = {"lz4": hadoop.Lz4HadoopStreams, "snappy": hadoop.SnappyHadoopStreams,
           "lzo": hadoop.LzoHadoopStreams}[family]
    port, jax = cls(buffer_size=16384), getattr(jax_hadoop, cls.__name__)(buffer_size=16384)
    blob = _write(port, PAYLOAD)
    assert blob == _write(jax, PAYLOAD)
    lens, payloads = chip_smoke.hadoop_block_chunks(blob)
    assert lens == [16384] * 3 + [len(PAYLOAD) - 3 * 16384]
    dec = {"lz4": lz4.Lz4Decompressor.create(), "snappy": snappy.SnappyDecompressor.create(),
           "lzo": lzo.LzoDecompressor.create()}[family]
    raws = [PAYLOAD[i:i + 16384] for i in range(0, len(PAYLOAD), 16384)]
    assert [dec.decompress(c, n) for n, c in zip(lens, payloads)] == raws
    batch = {"lz4": Lz4BatchCodec, "snappy": SnappyBatchCodec, "lzo": LzoBatchCodec}[family]
    assert batch(device="cpu").decompress_chunks(payloads) == raws
    assert _read(port, blob) == PAYLOAD


def test_block_reader_rejects_what_the_jax_reader_rejects(natives):
    from aircompressor_tpu.errors import MalformedInputException
    from aircompressor_tpu_torch.errors import MalformedInputException as PortMalformed

    blob = _write(hadoop.Lz4HadoopStreams(), PAYLOAD[:5000])
    for bad in (blob[:2], blob[:6], blob[:-3], (1 << 27).to_bytes(4, "big") + blob[4:],
                blob[:4] + (1 << 27).to_bytes(4, "big") + blob[8:]):
        with pytest.raises(MalformedInputException) as want:
            _read(jax_hadoop.Lz4HadoopStreams(), bad)
        with pytest.raises(PortMalformed) as got:
            _read(hadoop.Lz4HadoopStreams(), bad)
        assert got.value.reason == want.value.reason


def _gzip_member(body_raw: bytes) -> bytes:
    """A gzip member with FEXTRA, FNAME, FCOMMENT and FHCRC set, which
    zlib does not write but must read."""
    import zlib

    head = bytearray(b"\x1f\x8b\x08\x1e" + b"\x00" * 4 + b"\x00\xff")
    head += (5).to_bytes(2, "little") + b"AB\x00CD" + b"name.txt\x00" + b"a comment\x00"
    head += (zlib.crc32(head) & 0xFFFF).to_bytes(2, "little")
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    return (bytes(head) + co.compress(body_raw) + co.flush()
            + zlib.crc32(body_raw).to_bytes(4, "little")
            + len(body_raw).to_bytes(4, "little"))


def test_smoke_parsers_read_every_header_field():
    import zlib

    from aircompressor_tpu_torch import gzip

    raw = PAYLOAD[:9000]
    member = _gzip_member(raw)
    assert gzip.decompress_stream(member) == raw  # zlib takes it
    body, crc, isize = chip_smoke.gzip_member_parts(member)
    assert zlib.decompress(body, -15) == raw and crc == zlib.crc32(raw) and isize == len(raw)
    plain = gzip.compress_stream(raw)
    body, crc, isize = chip_smoke.gzip_member_parts(plain)
    assert DeflateBatchCodec(device="cpu").decompress_chunks([body]) == [raw]
    bad = bytearray(member)
    bad[19] ^= 0x01  # inside FNAME: the header CRC16 fails
    with pytest.raises(RuntimeError, match="CRC16"):
        chip_smoke.gzip_member_parts(bytes(bad))
    stream = _write(hadoop.get_codec("org.apache.hadoop.io.compress.DefaultCodec"), raw)
    body, adler = chip_smoke.zlib_stream_parts(stream)
    assert zlib.decompress(body, -15) == raw and adler == zlib.adler32(raw)
    with pytest.raises(RuntimeError, match="zlib header"):
        chip_smoke.zlib_stream_parts(b"\x78\x9a" + stream[2:])


def test_smoke_compat_phase_runs_on_the_cpu(monkeypatch, natives):
    """The phase on six 4,000 B chunks with 4 KB Hadoop buffers: every check
    holds on the plain versions, and the last, that each card kernel
    launched, fails where there is no card."""
    monkeypatch.setattr(chip_smoke, "HADOOP_BUFFER", 4096)
    monkeypatch.setattr(chip_smoke, "SLOW_CUT", 8192)
    corpus = [c[:4000] for c in chip_smoke.generated_corpus()[:6]]  # blocks straddle chunks
    with pytest.raises(RuntimeError, match="the phase launched each kernel"):
        chip_smoke.compat_phase("cpu", corpus, "CPU")
