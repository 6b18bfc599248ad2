"""The port's deflate family (zlib and libdeflate tiers) and gzip against the
JAX package, on the CPU, and their raw-deflate streams through the card's
batch decoder's plain version.

The same inputs (``conftest.synthetic_cases`` cut to 64 KB, seeded random
bytes and ``_selfcheck_payload`` text) go through each JAX class and its
port: compressed bytes must be equal, zlib tier against zlib tier and
libdeflate against libdeflate, at every level the tier takes, and each side
must decode the other's. Malformed streams raise each package's own
``MalformedInputException`` at the same offset. ``create()`` picks the
same tier in both, and the zlib tier with
``AIRCOMPRESSOR_TPU_DISABLE_NATIVE=1``. ``DeflateBatchCodec(device="cpu")``
decodes the streams of both tiers, one of more than the planner's default
16 blocks and one whose dynamic block has a single distance code. Integer
codecs: the tolerance is 0.
"""

import io
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from aircompressor_tpu import deflate as jax_deflate
from aircompressor_tpu import gzip as jax_gzip
from aircompressor_tpu.errors import MalformedInputException
from aircompressor_tpu.native import deflate_binding as jax_binding
from aircompressor_tpu_torch import deflate, gzip
from aircompressor_tpu_torch.errors import MalformedInputException as PortMalformed
from aircompressor_tpu_torch.host.deflate import plan as deflate_plan
from aircompressor_tpu_torch.native import deflate_binding
from aircompressor_tpu_torch.ops.batch import DeflateBatchCodec, _pack, _selfcheck_payload

ROOT = Path(__file__).resolve().parent.parent
CHUNK = chip_smoke.CHUNK
REF_LEVELS = [0, 1, 4, 9]
NATIVE_LEVELS = [0, 1, 4, 9, 12]
needs_libdeflate = pytest.mark.skipif(not deflate_binding.is_enabled(),
                                      reason="libdeflate unavailable")


def _inputs() -> list[bytes]:
    rng = np.random.default_rng(17)
    return [c[:CHUNK] for _, c in chip_smoke.synthetic_cases()] + [
        rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
        np.repeat(rng.integers(0, 4, 2500, dtype=np.uint8), 7).tobytes(),
        _selfcheck_payload(3), _selfcheck_payload(4)[:40000]]


INPUTS = _inputs()


def _round_trip(port_c, port_d, jax_c, jax_d, raw: bytes) -> bytes:
    blob = port_c.compress(raw)
    assert blob == jax_c.compress(raw)
    assert port_d.decompress(blob, len(raw) + 8) == raw
    assert jax_d.decompress(blob, len(raw) + 8) == raw
    return blob


@pytest.mark.parametrize("level", REF_LEVELS)
def test_zlib_tier_writes_the_jax_bytes(level):
    for raw in INPUTS:
        _round_trip(deflate.DeflateRefCompressor(level), deflate.DeflateRefDecompressor(),
                    jax_deflate.DeflateRefCompressor(level),
                    jax_deflate.DeflateRefDecompressor(), raw)


@needs_libdeflate
@pytest.mark.parametrize("level", NATIVE_LEVELS)
def test_libdeflate_tier_writes_the_jax_bytes(level):
    for raw in INPUTS:
        _round_trip(deflate.DeflateNativeCompressor(level),
                    deflate.DeflateNativeDecompressor(),
                    jax_deflate.DeflateNativeCompressor(level),
                    jax_deflate.DeflateNativeDecompressor(), raw)


@needs_libdeflate
def test_tiers_decode_each_other():
    for raw in INPUTS:
        assert deflate.DeflateRefDecompressor().decompress(
            deflate.DeflateNativeCompressor(12).compress(raw), len(raw)) == raw
        assert deflate.DeflateNativeDecompressor().decompress(
            deflate.DeflateRefCompressor(9).compress(raw), len(raw)) == raw


def test_create_picks_the_tier_the_jax_package_picks():
    assert deflate_binding.is_enabled() == jax_binding.is_enabled()
    want = "Native" if deflate_binding.is_enabled() else "Ref"
    for port_f, jax_f in [(deflate.DeflateCompressor.create,
                           jax_deflate.DeflateCompressor.create),
                          (deflate.DeflateDecompressor.create,
                           jax_deflate.DeflateDecompressor.create)]:
        assert type(port_f()).__name__ == type(jax_f()).__name__
        assert want in type(port_f()).__name__
    assert deflate.DeflateCompressor.create().level == deflate.DEFAULT_LEVEL == 4


def test_create_picks_the_zlib_tier_with_native_disabled():
    code = ("from aircompressor_tpu import deflate as j\n"
            "from aircompressor_tpu_torch import deflate as p\n"
            "from aircompressor_tpu_torch.native import deflate_binding\n"
            "assert not deflate_binding.is_enabled()\n"
            "names = [type(f()).__name__ for f in (\n"
            "    p.DeflateCompressor.create, p.DeflateDecompressor.create,\n"
            "    j.DeflateCompressor.create, j.DeflateDecompressor.create)]\n"
            "assert names == ['DeflateRefCompressor', 'DeflateRefDecompressor'] * 2, names\n"
            "try:\n"
            "    deflate_binding.verify_enabled()\n"
            "    raise SystemExit('the native tier did not refuse')\n"
            "except RuntimeError:\n"
            "    pass\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), AIRCOMPRESSOR_TPU_DISABLE_NATIVE="1",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr


def test_levels_and_bound():
    for cls, jcls, top in [(deflate.DeflateRefCompressor, jax_deflate.DeflateRefCompressor, 9),
                           (deflate.DeflateNativeCompressor,
                            jax_deflate.DeflateNativeCompressor, 12)]:
        if cls is deflate.DeflateNativeCompressor and not deflate_binding.is_enabled():
            continue
        for level in (-1, top + 1):
            with pytest.raises(ValueError):
                cls(level)
            with pytest.raises(ValueError):
                jcls(level)
    for n in (0, 1, 7, 64, 65536, 10**6):
        assert deflate.max_compressed_length(n) == jax_deflate.max_compressed_length(n)
        assert deflate.DeflateRefCompressor().max_compressed_length(n) == (
            jax_deflate.DeflateRefCompressor().max_compressed_length(n))


@pytest.mark.parametrize("tier", ["zlib", "libdeflate"])
def test_malformed_streams_raise_as_in_jax(tier):
    """The smoke's malformed streams (truncated, a bad stored length, a
    reserved block type, an over-subscribed and two incomplete codes, a
    distance before the output) and an output over its bound."""
    if tier == "libdeflate" and not deflate_binding.is_enabled():
        pytest.skip("libdeflate unavailable")
    pd, jd = ((deflate.DeflateRefDecompressor, jax_deflate.DeflateRefDecompressor)
              if tier == "zlib" else
              (deflate.DeflateNativeDecompressor, jax_deflate.DeflateNativeDecompressor))
    text = _selfcheck_payload(6)[:5000]
    over = deflate.DeflateRefCompressor(6).compress(text)
    for blob, cap in [(b, CHUNK) for _, b in chip_smoke.deflate_malformed_cases()] + [
            (over, 4000)]:
        with pytest.raises(MalformedInputException) as want:
            jd().decompress(blob, cap)
        with pytest.raises(PortMalformed) as got:
            pd().decompress(blob, cap)
        assert got.value.offset == want.value.offset, blob[:16]


@pytest.mark.parametrize("level", [1, 4, 9])
def test_gzip_writes_the_jax_bytes(level):
    for raw in INPUTS:
        blob = gzip.compress_stream(raw, level)
        assert blob == jax_gzip.compress_stream(raw, level)
        assert gzip.decompress_stream(blob) == raw == jax_gzip.decompress_stream(blob)
    assert gzip.DEFAULT_LEVEL == jax_gzip.DEFAULT_LEVEL == 4


def test_gzip_reads_concatenated_members():
    raws = INPUTS[:6] + [b"", INPUTS[-1]]
    stream = b"".join(gzip.compress_stream(r) for r in raws)
    assert gzip.decompress_stream(stream) == b"".join(raws)
    assert jax_gzip.decompress_stream(stream) == b"".join(raws)
    src = gzip.GzipInputStream(io.BytesIO(stream), read_chunk=997)
    pieces = []
    while piece := src.read(1013):
        pieces.append(piece)
    assert b"".join(pieces) == b"".join(raws)


def test_gzip_finish_does_not_close_the_sink():
    sink = io.BytesIO()
    out = gzip.GzipOutputStream(sink)
    for i in range(0, 30000, 7000):
        out.write(INPUTS[-1][i:min(i + 7000, 30000)])
    out.finish()
    out.finish()
    sink.write(b"TRAILER")
    blob = sink.getvalue()
    assert blob.endswith(b"TRAILER") and not sink.closed
    assert zlib.decompress(blob[:-7], 31) == INPUTS[-1][:30000]
    assert blob[:-7] == jax_gzip.compress_stream(INPUTS[-1][:30000])
    with pytest.raises(ValueError):
        out.write(b"more")
    out.close()
    assert out.closed and not sink.closed


def test_gzip_malformed_raises_as_in_jax():
    good = gzip.compress_stream(INPUTS[-1])
    bad = bytearray(good)
    bad[-8] ^= 0xFF  # the CRC-32 trailer
    size = bytearray(good)
    size[-1] ^= 0xFF  # the ISIZE trailer
    for blob in (bytes(bad), bytes(size), b"\x1f\x8c" + good[2:]):
        with pytest.raises(MalformedInputException) as want:
            jax_gzip.decompress_stream(blob)
        with pytest.raises(PortMalformed) as got:
            gzip.decompress_stream(blob)
        assert got.value.offset == want.value.offset


def _distance_code_lengths(blob: bytes) -> list[int]:
    """The distance code lengths of a stream's first block, which must be
    dynamic (RFC 1951 §3.2.7)."""
    bits = int.from_bytes(blob, "little")
    pos = 0

    def take(n):
        nonlocal pos
        v = (bits >> pos) & ((1 << n) - 1)
        pos += n
        return v

    assert take(3) >> 1 == 2, "a dynamic block"
    hlit, hdist, hclen = take(5) + 257, take(5) + 1, take(4) + 4
    order = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
    cl = [0] * 19
    for i in range(hclen):
        cl[order[i]] = take(3)
    code, table = 0, {}
    for ln in range(1, 8):  # canonical code-length code, read MSB first
        for s in range(19):
            if cl[s] == ln:
                table[(ln, code)] = s
                code += 1
        code <<= 1
    lengths = []
    while len(lengths) < hlit + hdist:
        v, ln = 0, 0
        while (ln, v) not in table:
            v, ln = (v << 1) | take(1), ln + 1
        s = table[(ln, v)]
        if s < 16:
            lengths.append(s)
        elif s == 16:
            lengths += [lengths[-1]] * (3 + take(2))
        else:
            lengths += [0] * ((3 + take(3)) if s == 17 else (11 + take(7)))
    return lengths[hlit:]


def _tier_blobs(raws) -> list[tuple[str, list[bytes]]]:
    """zlib at its default level 4 (what ``create()`` gives without
    libdeflate), and libdeflate at 1, 4 and 12 where it is found."""
    sets = [("zlib 4", [deflate.DeflateRefCompressor(4).compress(r) for r in raws])]
    if deflate_binding.is_enabled():
        sets += [(f"libdeflate {lv}",
                  [deflate.DeflateNativeCompressor(lv).compress(r) for r in raws])
                 for lv in (1, 4, 12)]
    return sets


def test_batch_codec_decodes_both_tiers():
    """The synthetic cases of both tiers through ``DeflateBatchCodec`` on
    the CPU (the decode kernel's plain version), equal to the originals and
    to ``DeflateDecompressor.create()``."""
    raws = [c[:CHUNK] for _, c in chip_smoke.synthetic_cases()]
    sets = _tier_blobs(raws)
    blobs = [b for _, tier in sets for b in tier]
    unique = sorted(set(blobs))  # the plain version walks each chunk's symbols
    got = dict(zip(unique, DeflateBatchCodec(device="cpu").decompress_chunks(unique)))
    assert [got[b] for b in blobs] == raws * len(sets)
    host = deflate.DeflateDecompressor.create()
    assert all(got[b] == host.decompress(b, CHUNK) for b in unique)


def test_libdeflate_fixture_is_what_libdeflate_writes():
    """The fixture that brings libdeflate's streams to the card where the
    machine lacks the library: its streams decode through the plain
    version to their originals, and equal what this machine's libdeflate
    writes (where it has one)."""
    from aircompressor_tpu_torch.data import libdeflate_library, libdeflate_streams

    fixture = libdeflate_streams()
    assert sorted({f["level"] for f in fixture}) == [0, 1, 4, 6, 9, 12]
    assert libdeflate_library().startswith("libdeflate")
    blobs = [f["stream"] for f in fixture]
    assert DeflateBatchCodec(device="cpu").decompress_chunks(blobs) == [
        f["original"] for f in fixture]
    if deflate_binding.is_enabled():
        assert blobs == [deflate.DeflateNativeCompressor(f["level"]).compress(f["original"])
                         for f in fixture]


def test_batch_codec_replans_a_chunk_of_many_blocks():
    """A stream of 65 blocks passes the planner's default 16: the chunk is
    planned again at caps that fit it, and decodes."""
    raw = _selfcheck_payload(3)[:8192]
    blob = chip_smoke.deflate_full_flush(raw, every=256)
    buf, lens = _pack([blob], len(blob))
    info = deflate_plan.plan_batch(buf, lens)[2]
    assert info[0, 3] == deflate_plan.ST_ROOM and info[0, 1] > deflate_plan.MAX_BLOCKS
    plan = deflate_plan.plan(buf, lens)
    assert plan.info[0, 3] == deflate_plan.ST_OK and plan.info[0, 1] == 65
    assert DeflateBatchCodec(device="cpu").decompress_chunks([blob]) == [raw]
    assert deflate.DeflateDecompressor.create().decompress(blob, CHUNK) == raw


def _single_distance_code_block(copies: int = 254) -> bytes:
    """One dynamic block whose distance code is a single code of one bit
    (distance 1), the case RFC 1951 §3.2.7 allows: a literal 0x01, then
    ``copies`` copies of 258 bytes at distance 1, then the end of block."""
    return chip_smoke.deflate_dynamic_block(
        {1: 2, 256: 2, 285: 1}, {0: 1},
        [("ll", 1, 0, 0)] + [("ll", 285, 0, 0), ("d", 0, 0, 0)] * copies
        + [("ll", 256, 0, 0)])


def test_batch_codec_decodes_a_single_distance_code():
    """The 0x01 run (the corpus's chunk 1): every tier writes one dynamic
    block whose matches all use distance code 0; zlib and libdeflate send a
    second, unused 1-bit code beside it (zlib at level 1 sends codes 0 and
    16). A hand-built block with the single distance code alone, which
    zlib's rule allows and the planner follows, decodes in every decoder."""
    raw = b"\x01" * CHUNK
    codec = DeflateBatchCodec(device="cpu")
    for name, (blob,) in _tier_blobs([raw]):
        lengths = _distance_code_lengths(blob)
        assert lengths[0] == 1 and sum(ln > 0 for ln in lengths) == 2, name
        assert codec.decompress_chunks([blob]) == [raw], name
    blob = _single_distance_code_block()
    assert _distance_code_lengths(blob) == [1]
    want = b"\x01" * (1 + 254 * 258)
    assert codec.decompress_chunks([blob]) == [want]
    assert deflate.DeflateRefDecompressor().decompress(blob, CHUNK) == want
    assert jax_deflate.DeflateRefDecompressor().decompress(blob, CHUNK) == want
    if deflate_binding.is_enabled():
        assert deflate.DeflateNativeDecompressor().decompress(blob, CHUNK) == want
