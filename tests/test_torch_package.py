"""The port stands without JAX, without the JAX package and without a CPU
fallback for the card.

Nothing here builds a kernel: the package and ``chip_smoke.py`` are only
imported, and ``chip_smoke.py`` is run where there is no CUDA device.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "aircompressor_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
NATIVE_FILES = sorted(p for ext in ("*.cc", "*.cu", "*.h", "*.cuh")
                      for p in (ROOT / "aircompressor_tpu_torch").rglob(ext))
BLOCKED = ("jax", "aircompressor_tpu")


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env, **kw)


def test_port_imports_with_jax_blocked():
    """With jax and the JAX package blocked, the port and every one of its
    modules import, and neither blocked name is loaded."""
    modules = sorted(
        "aircompressor_tpu_torch." + ".".join(p.relative_to(
            ROOT / "aircompressor_tpu_torch").with_suffix("").parts)
        for p in PORT_FILES[:-1] if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for name in {BLOCKED!r}: sys.modules[name] = None\n"
            "import aircompressor_tpu_torch, chip_smoke\n"
            "import aircompressor_tpu_torch.ops.zstd_decode\n"
            "import aircompressor_tpu_torch.host.zstd, aircompressor_tpu_torch.data\n"
            "import aircompressor_tpu_torch.host.deflate.plan\n"
            "import aircompressor_tpu_torch.ops.lzo_decode\n"
            "import aircompressor_tpu_torch.ops.deflate_decode\n"
            "import aircompressor_tpu_torch.ops.snappy_decode_r2\n"
            "import aircompressor_tpu_torch.ops.profiling\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "assert aircompressor_tpu_torch.ops.xxhash.launches == 0\n"
            "assert aircompressor_tpu_torch.ops.snappy_decode_r2.launches == 0\n"
            "loaded = sorted(m for m in sys.modules\n"
            f"                if m.split('.')[0] in {BLOCKED!r})\n"
            f"assert loaded == sorted({BLOCKED!r}), loaded\n"
            f"assert all(sys.modules[m] is None for m in {BLOCKED!r})\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


def _imported_roots(line: str) -> list[str]:
    """The top-level packages an ``import``/``from`` line names."""
    words = line.split()
    if words[:1] == ["from"] and len(words) > 1:
        return [words[1].split(".")[0]]
    if words[:1] == ["import"]:
        return [clause.split()[0].split(".")[0]
                for clause in line[len("import"):].split(",") if clause.strip()]
    return []


def _assert_sources_never_import(package: str) -> None:
    for path in PORT_FILES:
        for line in path.read_text().splitlines():
            assert package not in _imported_roots(line.strip()), (path, line)


def test_port_sources_name_no_jax():
    _assert_sources_never_import("jax")


def test_port_sources_name_no_jax_package():
    """No module of the port and no line of chip_smoke.py imports
    ``aircompressor_tpu`` (``aircompressor_tpu_torch`` is the port)."""
    _assert_sources_never_import("aircompressor_tpu")


def _code_lines(path: Path) -> list[str]:
    """The lines of a C++ or CUDA source with // comments cut off."""
    return [line.split("//")[0] for line in path.read_text().splitlines()]


def test_native_sources_stand_alone():
    """The port's C++ and CUDA sources (the deflate planner's copy
    included) name no file of the JAX package in their code, and include
    only system headers or headers of their own."""
    assert any(p.suffix == ".cc" for p in NATIVE_FILES)
    for path in NATIVE_FILES:
        for line in _code_lines(path):
            assert "aircompressor_tpu" not in line, (path, line)
            words = line.split()
            if words[:1] == ["#include"] and not words[1].startswith("<"):
                assert (path.parent / words[1].strip('"')).exists(), (path, line)


def test_lzo_and_deflate_run_with_jax_blocked():
    """The LZO and deflate codecs round-trip on the CPU with jax and the JAX
    package blocked: the host LZO encoder, zlib, the g++-built planner and
    the plain decodes."""
    code = ("import sys\n"
            f"for name in {BLOCKED!r}: sys.modules[name] = None\n"
            "from aircompressor_tpu_torch.ops.batch import (\n"
            "    DeflateBatchCodec, LzoBatchCodec, _selfcheck_payload)\n"
            "raws = [_selfcheck_payload(i)[-3000:] for i in range(3)] + [b'ab' * 900]\n"
            "for c in (LzoBatchCodec(device='cpu'), DeflateBatchCodec(device='cpu')):\n"
            "    assert c.decompress_chunks(c.compress_chunks(raws)) == raws\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


def test_families_and_streams_run_with_jax_blocked():
    """Every codec family (both tiers where there are two), frame and
    stream format round-trips on the CPU with jax and the JAX package
    blocked, and the module scan above covers their modules."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for module in ("api", "native/__init__", "native/zstd_binding", "xxhash/__init__",
                   "crc/__init__", "snappy/framed", "lz4/frame", "lz4/frame_codec",
                   "lz4/streams", "lzo/lzop", "zstd/frame_dec", "zstd/streams"):
        assert f"aircompressor_tpu_torch/{module}.py" in names, module
    code = ("import sys\n"
            f"for name in {BLOCKED!r}: sys.modules[name] = None\n"
            "from aircompressor_tpu_torch import crc, lz4, lzo, native, snappy, xxhash, zstd\n"
            "from aircompressor_tpu_torch.lz4 import frame_codec, streams as lz4s\n"
            "from aircompressor_tpu_torch.lzo import lzop\n"
            "from aircompressor_tpu_torch.snappy import framed\n"
            "from aircompressor_tpu_torch.zstd import frame_dec, streams as zs\n"
            "from aircompressor_tpu_torch.ops.batch import _selfcheck_payload\n"
            "raw = _selfcheck_payload(2)[:9000] + bytes(3000)\n"
            "assert native.is_enabled(), native.load_error()\n"
            "pairs = [(snappy.SnappyRefCompressor(), snappy.SnappyRefDecompressor()),\n"
            "         (snappy.SnappyNativeCompressor(), snappy.SnappyNativeDecompressor()),\n"
            "         (lz4.Lz4RefCompressor(), lz4.Lz4RefDecompressor()),\n"
            "         (lz4.Lz4NativeCompressor(), lz4.Lz4NativeDecompressor()),\n"
            "         (lzo.LzoCompressor.create(), lzo.LzoDecompressor.create()),\n"
            "         (zstd.ZstdRefCompressor(), zstd.ZstdRefDecompressor()),\n"
            "         (zstd.ZstdCompressor.create(), zstd.ZstdDecompressor.create()),\n"
            "         (frame_codec.Lz4FrameCompressor.create(content_checksum=True),\n"
            "          frame_codec.Lz4FrameDecompressor.create())]\n"
            "for c, d in pairs:\n"
            "    assert d.decompress(c.compress(raw), len(raw)) == raw, type(c)\n"
            "assert framed.decompress_framed(framed.compress_framed(raw)) == raw\n"
            "assert lz4s.decompress_stream(lz4s.compress_stream(raw)) == raw\n"
            "assert lzop.decompress_file(lzop.compress_file(raw)) == raw\n"
            "assert zs.decompress_stream(zs.compress_stream(raw)) == raw\n"
            "assert xxhash.xxh64(raw) == native.xxh64(raw)\n"
            "assert crc.crc32c_raw(raw) == native.crc32c(raw)\n"
            "loaded = sorted(m for m in sys.modules\n"
            f"                if m.split('.')[0] in {BLOCKED!r})\n"
            f"assert loaded == sorted({BLOCKED!r}), loaded\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


def test_compat_families_run_with_jax_blocked():
    """deflate (zlib and libdeflate), gzip, bzip2 (both tiers, the own
    engine in ``host/bzip2.py``), XXH3 and every Hadoop codec round-trip on
    the CPU with jax and the JAX package blocked, and the module scan above
    covers their modules."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for module in ("native/deflate_binding", "deflate/__init__", "gzip/__init__",
                   "host/bzip2", "bzip2/__init__", "xxhash/xxh3", "hadoop/__init__"):
        assert f"aircompressor_tpu_torch/{module}.py" in names, module
    code = ("import io, sys\n"
            f"for name in {BLOCKED!r}: sys.modules[name] = None\n"
            "from aircompressor_tpu_torch import bzip2, deflate, gzip, hadoop, xxhash\n"
            "from aircompressor_tpu_torch.native import deflate_binding\n"
            "from aircompressor_tpu_torch.ops.batch import _selfcheck_payload\n"
            "raw = _selfcheck_payload(5)[:6000] + bytes(2000)\n"
            "pairs = [(deflate.DeflateRefCompressor(), deflate.DeflateRefDecompressor()),\n"
            "         (deflate.DeflateCompressor.create(), deflate.DeflateDecompressor.create())]\n"
            "if deflate_binding.is_enabled():\n"
            "    pairs.append((deflate.DeflateNativeCompressor(12),\n"
            "                  deflate.DeflateNativeDecompressor()))\n"
            "for c, d in pairs:\n"
            "    assert d.decompress(c.compress(raw), len(raw)) == raw, type(c)\n"
            "assert gzip.decompress_stream(gzip.compress_stream(raw)) == raw\n"
            "for c, d in [(bzip2.BZip2RefCompressor(1), bzip2.BZip2NativeDecompressor()),\n"
            "             (bzip2.BZip2NativeCompressor(), bzip2.BZip2RefDecompressor())]:\n"
            "    assert d.decompress(c.compress(raw)) == raw, type(c)\n"
            "assert bzip2.decompress_stream(bzip2.compress_stream(raw)) == raw\n"
            "if xxhash.xxh3_is_enabled():\n"
            "    h = xxhash.XxHash3Hasher128().update(raw[:77]).update(raw[77:])\n"
            "    assert h.digest() == xxhash.xxh3_128(raw)\n"
            "for name, streams in hadoop.CODEC_REGISTRY.items():\n"
            "    sink = io.BytesIO()\n"
            "    out = streams.create_output_stream(sink)\n"
            "    out.write(raw)\n"
            "    out.finish()\n"
            "    assert streams.create_input_stream(io.BytesIO(sink.getvalue())).read() == raw\n"
            "loaded = sorted(m for m in sys.modules\n"
            f"                if m.split('.')[0] in {BLOCKED!r})\n"
            f"assert loaded == sorted({BLOCKED!r}), loaded\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


def test_top_level_exports_equal_the_jax_package():
    """The port's top level has the JAX package's names, its version and
    lazy access to every codec family the JAX package's top level names."""
    import aircompressor_tpu
    import aircompressor_tpu_torch as port
    from aircompressor_tpu_torch import api, errors

    assert port.__all__ == aircompressor_tpu.__all__
    assert port.__version__ == aircompressor_tpu.__version__ == "0.1.0"
    assert port.Compressor is api.Compressor and port.Decompressor is api.Decompressor
    assert port.BufferLike == api.BufferLike
    assert port.MalformedInputException is errors.MalformedInputException
    assert port.IncompatiblePlatformException is errors.IncompatiblePlatformException
    for name in ("lz4", "snappy", "zstd", "lzo", "bzip2", "deflate", "gzip", "xxhash",
                 "crc", "hadoop", "ops", "native"):
        module = getattr(port, name)
        assert module.__name__ == f"aircompressor_tpu_torch.{name}"
    with pytest.raises(AttributeError):
        port.no_such_family  # noqa: B018


def test_source_scan_sees_package_imports():
    assert _imported_roots("from aircompressor_tpu.ops.batch import _pack") == [
        "aircompressor_tpu"]
    assert _imported_roots("import aircompressor_tpu.snappy as s, numpy") == [
        "aircompressor_tpu", "numpy"]
    assert _imported_roots("from aircompressor_tpu_torch.ops import batch") == [
        "aircompressor_tpu_torch"]
    assert _imported_roots("from ..errors import MalformedInputException") == [""]


def test_port_host_helpers_equal_the_jax_package():
    """The port's copies of the JAX package's numpy helpers give the same
    arrays: the canary payload, the batch packing and the entry's batch."""
    import __graft_entry__
    from aircompressor_tpu.ops import batch as jax_batch
    from aircompressor_tpu_torch import entry as port_entry
    from aircompressor_tpu_torch.ops import batch as port_batch

    for seed in (0xA1C0, 0, 7):
        assert port_batch._selfcheck_payload(seed) == jax_batch._selfcheck_payload(seed)
    blobs = [b"", b"abc", bytes(range(200))]
    for a, b in zip(port_batch._pack(blobs, 208), jax_batch._pack(blobs, 208)):
        np.testing.assert_array_equal(a, b)
    assert port_batch._round_up(17, 16) == jax_batch._round_up(17, 16) == 32
    for a, b in zip(port_entry._sample_batch(8), __graft_entry__._sample_batch(8)):
        np.testing.assert_array_equal(a, b)


def _host_snappy_inputs() -> list[bytes]:
    import chip_smoke
    from aircompressor_tpu_torch.ops.batch import _selfcheck_payload

    return [c for _, c in chip_smoke.synthetic_cases()] + [
        chip_smoke.backward_cap_case(), _selfcheck_payload(1)]


def _malformed_snappy_blobs() -> list[bytes]:
    """The smoke's malformed blocks, then: no varint, an overlong varint, a
    literal past the input, a short block, a zero offset, an offset past
    the output, a truncated copy."""
    import chip_smoke
    from aircompressor_tpu_torch.host import snappy as host_snappy

    return chip_smoke.malformed_cases(host_snappy.compress) + [
        b"", b"\x80\x80\x80\x80\x80\x01", b"\x05\x10ab", b"\x05\x04ab",
        b"\x08\x0cabcd\x01\x00", b"\x08\x0cabcd\x01\x09", b"\x08\x0cabcd\x02\x04"]


def _malformed_lz4_blobs() -> list[bytes]:
    """The smoke's malformed LZ4 blocks and those of its F6 blocks that the
    host rejects, then: an unended literal-length extension, a truncated
    offset, an unended match-length extension, an offset past the output,
    a match past the output buffer."""
    import chip_smoke
    from aircompressor_tpu_torch.host import lz4 as host_lz4

    return chip_smoke.lz4_malformed_cases(host_lz4.compress) + [
        b for b, ok, _ in chip_smoke.LZ4_EDGE_BLOCKS if not ok] + [
        b"\xf0\xff\xff", b"\x14a\x01", b"\x1fa\x01\x00\xff", b"\x14a\x02\x00\x00",
        b"\x1fa\x01\x00" + b"\xff" * 257 + b"\x00\x00"]


HOST_INPUTS = _host_snappy_inputs()
MALFORMED = _malformed_snappy_blobs()
MALFORMED_LZ4 = _malformed_lz4_blobs()


@pytest.mark.parametrize("case", range(len(HOST_INPUTS)))
def test_port_host_snappy_equals_the_jax_reference(case):
    """The port's host Snappy copy writes and reads the JAX package's
    reference codec's bytes."""
    from aircompressor_tpu.snappy import SnappyRefCompressor, SnappyRefDecompressor
    from aircompressor_tpu_torch.host import snappy as host_snappy

    raw = HOST_INPUTS[case]
    blob = host_snappy.compress(raw)
    assert blob == SnappyRefCompressor().compress(raw)
    assert host_snappy.decompress(blob, len(raw)) == raw
    assert SnappyRefDecompressor().decompress(blob, len(raw)) == raw


@pytest.mark.parametrize("case", range(len(MALFORMED)))
def test_port_host_snappy_rejects_as_the_jax_reference(case):
    """A malformed block raises in both, at the same offset."""
    from aircompressor_tpu.errors import MalformedInputException
    from aircompressor_tpu.snappy import SnappyRefDecompressor
    from aircompressor_tpu_torch.errors import MalformedInputException as PortMalformed
    from aircompressor_tpu_torch.host import snappy as host_snappy

    blob = MALFORMED[case]
    with pytest.raises(MalformedInputException) as want:
        SnappyRefDecompressor().decompress(blob, 65536)
    with pytest.raises(PortMalformed) as got:
        host_snappy.decompress(blob, 65536)
    assert got.value.offset == want.value.offset


@pytest.mark.parametrize("case", range(len(HOST_INPUTS)))
def test_port_host_lz4_equals_the_jax_reference(case):
    """The port's host LZ4 copy writes and reads the JAX package's
    reference codec's bytes."""
    from aircompressor_tpu.lz4 import Lz4RefCompressor, Lz4RefDecompressor
    from aircompressor_tpu_torch.host import lz4 as host_lz4

    raw = HOST_INPUTS[case]
    blob = host_lz4.compress(raw)
    assert blob == Lz4RefCompressor().compress(raw)
    assert host_lz4.decompress(blob, len(raw)) == raw
    assert Lz4RefDecompressor().decompress(blob, len(raw)) == raw


@pytest.mark.parametrize("case", range(len(MALFORMED_LZ4)))
def test_port_host_lz4_rejects_as_the_jax_reference(case):
    """A malformed LZ4 block raises in both, at the same offset."""
    from aircompressor_tpu.errors import MalformedInputException
    from aircompressor_tpu.lz4 import Lz4RefDecompressor
    from aircompressor_tpu_torch.errors import MalformedInputException as PortMalformed
    from aircompressor_tpu_torch.host import lz4 as host_lz4

    blob = MALFORMED_LZ4[case]
    with pytest.raises(MalformedInputException) as want:
        Lz4RefDecompressor().decompress(blob, 65536)
    with pytest.raises(PortMalformed) as got:
        host_lz4.decompress(blob, 65536)
    assert got.value.offset == want.value.offset


def test_port_host_xxh32_equals_the_jax_scalar():
    from aircompressor_tpu.xxhash import _scalar
    from aircompressor_tpu_torch.host.xxhash import xxh32

    data = np.random.default_rng(5).integers(0, 256, 65536, dtype=np.uint8)
    for n in list(range(101)) + [65536]:
        assert xxh32(data[:n]) == _scalar.xxh32(data[:n]), n
        assert xxh32(data[:n].tobytes()) == _scalar.xxh32(data[:n].tobytes()), n


def test_port_host_xxh64_equals_the_jax_scalar():
    from aircompressor_tpu.xxhash import _scalar
    from aircompressor_tpu_torch.host.xxhash import xxh64

    data = np.random.default_rng(4).integers(0, 256, 65536, dtype=np.uint8)
    for n in list(range(101)) + [65536]:
        assert xxh64(data[:n]) == _scalar.xxh64(data[:n]), n
        assert xxh64(data[:n].tobytes()) == _scalar.xxh64(data[:n].tobytes()), n


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_cases_are_the_test_cases(synthetic):
    import chip_smoke

    assert chip_smoke.synthetic_cases() == synthetic
