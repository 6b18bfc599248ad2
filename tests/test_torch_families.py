"""The port's block API, codec families and native C++ tier against the JAX
package, on the CPU.

The same inputs (``conftest.synthetic_cases``, seeded random bytes and
``_selfcheck_payload`` text; at most 16 KB each on the numpy tiers) go
through each JAX class and its port: compressed bytes must be equal, numpy
tier against numpy tier and native against native (the two native libraries
are built from the same C++ with other flags), and each side must decode the
other's. Malformed blocks raise each package's own
``MalformedInputException`` at the same offset. ``xxhash`` and ``crc`` must
give the JAX values, one-shot and streamed. With
``AIRCOMPRESSOR_TPU_DISABLE_NATIVE=1`` the port's factories pick the numpy
tiers. Integer codecs: the tolerance is 0.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from aircompressor_tpu import api as jax_api
from aircompressor_tpu import crc as jax_crc
from aircompressor_tpu import lz4 as jax_lz4
from aircompressor_tpu import lzo as jax_lzo
from aircompressor_tpu import native as jax_native
from aircompressor_tpu import snappy as jax_snappy
from aircompressor_tpu import xxhash as jax_xxhash
from aircompressor_tpu import zstd as jax_zstd
from aircompressor_tpu.errors import MalformedInputException
from aircompressor_tpu_torch import api, crc, errors, lz4, lzo, native, snappy, xxhash, zstd
from aircompressor_tpu_torch.errors import MalformedInputException as PortMalformed
from aircompressor_tpu_torch.ops.batch import _selfcheck_payload

ROOT = Path(__file__).resolve().parent.parent
REF_CUT = 16384


def _inputs(cut=None) -> list[bytes]:
    rng = np.random.default_rng(16)
    raws = [c for _, c in chip_smoke.synthetic_cases()] + [
        rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
        np.repeat(rng.integers(0, 4, 2500, dtype=np.uint8), 7).tobytes(),
        _selfcheck_payload(3), _selfcheck_payload(4)[:40000]]
    return [r[:cut] for r in raws] if cut else raws


REF_INPUTS = _inputs(REF_CUT)
NATIVE_INPUTS = _inputs()

# (family, port Ref compressor, port Ref decompressor, JAX Ref pair)
REF_PAIRS = {
    "snappy": (snappy.SnappyRefCompressor, snappy.SnappyRefDecompressor,
               jax_snappy.SnappyRefCompressor, jax_snappy.SnappyRefDecompressor),
    "lz4": (lz4.Lz4RefCompressor, lz4.Lz4RefDecompressor,
            jax_lz4.Lz4RefCompressor, jax_lz4.Lz4RefDecompressor),
    "lzo": (lzo.LzoCompressor, lzo.LzoDecompressor,
            jax_lzo.LzoCompressor, jax_lzo.LzoDecompressor),
    "zstd": (zstd.ZstdRefCompressor, zstd.ZstdRefDecompressor,
             jax_zstd.ZstdRefCompressor, jax_zstd.ZstdRefDecompressor),
}
NATIVE_PAIRS = {
    "snappy": (snappy.SnappyNativeCompressor, snappy.SnappyNativeDecompressor,
               jax_snappy.SnappyNativeCompressor, jax_snappy.SnappyNativeDecompressor),
    "lz4": (lz4.Lz4NativeCompressor, lz4.Lz4NativeDecompressor,
            jax_lz4.Lz4NativeCompressor, jax_lz4.Lz4NativeDecompressor),
}


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


def _round_trip(port_c, port_d, jax_c, jax_d, raw: bytes) -> None:
    blob = port_c.compress(raw)
    assert blob == jax_c.compress(raw)
    assert port_d.decompress(blob, len(raw) + 8) == raw
    assert jax_d.decompress(blob, len(raw) + 8) == raw


@pytest.mark.parametrize("family", sorted(REF_PAIRS))
def test_ref_tiers_write_the_jax_bytes(family):
    pc, pd, jc, jd = REF_PAIRS[family]
    for raw in REF_INPUTS:
        _round_trip(pc(), pd(), jc(), jd(), raw)
    if family == "lz4":
        for accel in (2, 9):
            _round_trip(pc(accel), pd(), jc(accel), jd(), REF_INPUTS[-1])


@pytest.mark.parametrize("family", sorted(NATIVE_PAIRS))
def test_native_tiers_write_the_jax_bytes(family, natives):
    pc, pd, jc, jd = NATIVE_PAIRS[family]
    for raw in NATIVE_INPUTS:
        _round_trip(pc(), pd(), jc(), jd(), raw)
    if family == "lz4":
        for accel in (2, 9, 65537):
            _round_trip(pc(accel), pd(), jc(accel), jd(), NATIVE_INPUTS[-1])


@pytest.mark.parametrize("family", ["snappy", "lz4"])
def test_tiers_decode_each_other(family, natives):
    pc, pd, _, _ = NATIVE_PAIRS[family]
    rc, rd, _, _ = REF_PAIRS[family]
    for raw in REF_INPUTS:
        assert rd().decompress(pc().compress(raw), len(raw)) == raw
        assert pd().decompress(rc().compress(raw), len(raw)) == raw


def test_zstd_native_tier_equals_the_jax_one():
    """libzstd through both bindings where the machine has it; both tiers
    fall back together where it has not."""
    from aircompressor_tpu.native import zstd_binding as jax_binding
    from aircompressor_tpu_torch.native import zstd_binding

    assert zstd_binding.is_enabled() == jax_binding.is_enabled()
    want = "ZstdNativeCompressor" if zstd_binding.is_enabled() else "ZstdRefCompressor"
    assert type(zstd.ZstdCompressor.create()).__name__ == want
    assert type(jax_zstd.ZstdCompressor.create()).__name__ == want
    c, jc = zstd.ZstdCompressor.create(), jax_zstd.ZstdCompressor.create()
    d, jd = zstd.ZstdDecompressor.create(), jax_zstd.ZstdDecompressor.create()
    for raw in NATIVE_INPUTS if zstd_binding.is_enabled() else REF_INPUTS[:4]:
        _round_trip(c, d, jc, jd, raw)
        assert zstd.ZstdRefDecompressor().decompress(c.compress(raw), len(raw)) == raw


def test_create_picks_the_tier_the_jax_package_picks(natives):
    for port_cls, jax_cls in [(snappy.SnappyCompressor, jax_snappy.SnappyCompressor),
                              (snappy.SnappyDecompressor, jax_snappy.SnappyDecompressor),
                              (lz4.Lz4Compressor, jax_lz4.Lz4Compressor),
                              (lz4.Lz4Decompressor, jax_lz4.Lz4Decompressor),
                              (lzo.LzoCompressor, jax_lzo.LzoCompressor),
                              (lzo.LzoDecompressor, jax_lzo.LzoDecompressor),
                              (zstd.ZstdDecompressor, jax_zstd.ZstdDecompressor)]:
        assert type(port_cls.create()).__name__ == type(jax_cls.create()).__name__


def test_create_picks_the_ref_tiers_with_native_disabled():
    code = ("import sys\n"
            "for name in ('jax', 'aircompressor_tpu'): sys.modules[name] = None\n"
            "from aircompressor_tpu_torch import lz4, native, snappy, xxhash, zstd\n"
            "assert not native.is_enabled()\n"
            "names = [type(f()).__name__ for f in (\n"
            "    snappy.SnappyCompressor.create, snappy.SnappyDecompressor.create,\n"
            "    lz4.Lz4Compressor.create, lz4.Lz4Decompressor.create,\n"
            "    zstd.ZstdCompressor.create, zstd.ZstdDecompressor.create)]\n"
            "assert names == ['SnappyRefCompressor', 'SnappyRefDecompressor',\n"
            "                 'Lz4RefCompressor', 'Lz4RefDecompressor',\n"
            "                 'ZstdRefCompressor', 'ZstdRefDecompressor'], names\n"
            "try:\n"
            "    snappy.SnappyNativeCompressor()\n"
            "    raise SystemExit('the native tier did not refuse')\n"
            "except RuntimeError:\n"
            "    pass\n"
            "assert xxhash.xxh64(b'abc') == 0x44BC2CF5AD770999\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), AIRCOMPRESSOR_TPU_DISABLE_NATIVE="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr


def _malformed_blocks(family: str) -> list[bytes]:
    if family == "snappy":
        blobs = chip_smoke.malformed_cases(jax_snappy.SnappyRefCompressor().compress)
        return blobs + chip_smoke.R2_MALFORMED + [b"", b"\x80\x80\x80\x80\x80\x01"]
    blobs = chip_smoke.lz4_malformed_cases(jax_lz4.Lz4RefCompressor().compress)
    return blobs + [b for b, ok, _ in chip_smoke.LZ4_EDGE_BLOCKS if not ok] + [
        b"\xf0\xff\xff", b"\x14a\x01", b"\x1fa\x01\x00\xff", b"\x14a\x02\x00\x00"]


@pytest.mark.parametrize("tier", ["ref", "native"])
@pytest.mark.parametrize("family", ["snappy", "lz4"])
def test_malformed_blocks_raise_as_in_jax(family, tier, natives):
    _, pd, _, jd = (REF_PAIRS if tier == "ref" else NATIVE_PAIRS)[family]
    for blob in _malformed_blocks(family):
        with pytest.raises(MalformedInputException) as want:
            jd().decompress(blob, 65536)
        with pytest.raises(PortMalformed) as got:
            pd().decompress(blob, 65536)
        assert got.value.offset == want.value.offset, blob[:16]


def test_lzo_malformed_blocks_raise_as_in_jax():
    for blob, ok, _ in chip_smoke.LZO_EDGE_BLOCKS:
        if ok:
            continue
        with pytest.raises(MalformedInputException) as want:
            jax_lzo.LzoDecompressor().decompress(blob, chip_smoke.LZO_EDGE_CAP)
        with pytest.raises(PortMalformed) as got:
            lzo.LzoDecompressor().decompress(blob, chip_smoke.LZO_EDGE_CAP)
        assert got.value.offset == want.value.offset, blob.hex()


def test_block_api_buffers_and_bounds():
    raw = REF_INPUTS[-1]
    for port_c, jax_c in [(snappy.SnappyRefCompressor(), jax_snappy.SnappyRefCompressor()),
                          (lz4.Lz4RefCompressor(), jax_lz4.Lz4RefCompressor()),
                          (lzo.LzoCompressor(), jax_lzo.LzoCompressor()),
                          (zstd.ZstdRefCompressor(), jax_zstd.ZstdRefCompressor())]:
        for n in (0, 1, 255, 65536, 10**6):
            assert port_c.max_compressed_length(n) == jax_c.max_compressed_length(n)
        dst = bytearray(port_c.max_compressed_length(len(raw)))
        n = port_c.compress_into(memoryview(raw), dst)
        assert bytes(dst[:n]) == jax_c.compress(np.frombuffer(raw, np.uint8))
    with pytest.raises(ValueError):
        snappy.SnappyRefCompressor().compress_into(raw, bytearray(10))
    with pytest.raises(ValueError, match="read-only"):
        api.as_writable_u8(b"abc")
    with pytest.raises(ValueError, match="read-only"):
        arr = np.zeros(4, np.uint8)
        arr.flags.writeable = False
        api.as_writable_u8(arr)
    words = np.arange(6, dtype=np.uint32)
    np.testing.assert_array_equal(api.as_u8(words), jax_api.as_u8(words))
    np.testing.assert_array_equal(api.as_writable_u8(bytearray(b"ab")), [97, 98])
    assert snappy.SnappyDecompressor.create().get_uncompressed_length(
        snappy.SnappyRefCompressor().compress(raw)) == len(raw)
    blob = zstd.ZstdRefCompressor().compress(raw)
    assert zstd.ZstdDecompressor.get_decompressed_size(blob) == \
        jax_zstd.ZstdDecompressor.get_decompressed_size(blob) == len(raw)
    assert issubclass(errors.IncompatiblePlatformException, RuntimeError)


def test_lz4_acceleration_bounds():
    for cls in (lz4.Lz4RefCompressor, jax_lz4.Lz4RefCompressor):
        for bad in (0, 65538):
            with pytest.raises(ValueError):
                cls(bad)
        cls(65537)


def test_zstd_level_bounds():
    for cls in (zstd.ZstdRefCompressor, jax_zstd.ZstdRefCompressor):
        with pytest.raises(ValueError):
            cls(23)
        assert cls(0).level == 3


HASH_DATA = np.random.default_rng(17).integers(0, 256, 5000, dtype=np.uint8)
HASH_LENGTHS = list(range(0, 70)) + [255, 256, 1000, 4999, 5000]


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B1, 2**32 - 1])
def test_xxhash_equals_the_jax_family(seed, natives):
    for n in HASH_LENGTHS:
        piece = HASH_DATA[:n]
        assert xxhash.xxh32(piece, seed) == jax_xxhash.xxh32(piece, seed)
        assert xxhash.xxh64(piece, seed) == jax_xxhash.xxh64(piece, seed)
        assert native.xxh64(piece.tobytes(), seed) == jax_native.xxh64(piece, seed)
        assert native.xxh32(piece, seed) == jax_native.xxh32(piece, seed)


@pytest.mark.parametrize("step", [1, 7, 16, 33, 1000])
def test_xxhash_states_stream_as_one_shot(step):
    for seed in (0, 5):
        s32, s64 = xxhash.XxHash32State(seed), xxhash.XxHash64State(seed)
        j32, j64 = jax_xxhash.XxHash32State(seed), jax_xxhash.XxHash64State(seed)
        for i in range(0, 2100, step):
            piece = HASH_DATA[i:min(i + step, 2100)]
            for state in (s32, s64, j32, j64):
                state.update(piece)
            if i % (step * 13) == 0:
                assert s32.digest() == j32.digest() and s64.digest() == j64.digest()
        assert s32.digest() == j32.digest() == xxhash.xxh32(HASH_DATA[:2100], seed)
        assert s64.digest() == j64.digest() == xxhash.xxh64(HASH_DATA[:2100], seed)


def test_crc_equals_the_jax_family(natives):
    for n in HASH_LENGTHS:
        piece = HASH_DATA[:n]
        assert crc.crc32c_raw(piece) == jax_crc.crc32c_raw(piece) == native.crc32c(piece)
        assert native.crc32c(piece, 0x1234) == jax_native.crc32c(piece, 0x1234)
        assert crc.masked_crc32c(piece) == jax_crc.masked_crc32c(piece)
    s, j = crc.Crc32C(), jax_crc.Crc32C()
    for i in range(0, 5000, 777):
        s.update(HASH_DATA[i:i + 777])
        j.update(HASH_DATA[i:i + 777])
    assert s.digest() == j.digest() == crc.crc32c_raw(HASH_DATA)
    assert s.masked_digest() == j.masked_digest() == crc.mask_crc(s.digest())
