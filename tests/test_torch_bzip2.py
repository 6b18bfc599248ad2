"""The port's bzip2 family and its own engine (``host/bzip2.py``) against the
JAX package, on the CPU.

The same inputs (``conftest.synthetic_cases`` cut to 8 KB, seeded bytes
and ``_selfcheck_payload`` text, one of 105,000 B that block size 1 splits
in two) go through the JAX engine (``aircompressor_tpu.bzip2.block_ref``)
and its copy: the streams must be equal at block sizes 1 and 9, stdlib
``bz2`` must decode them, and the copy must decode ``bz2``'s streams. The
stream classes write the JAX bytes. Malformed streams raise each package's
own ``MalformedInputException`` at the same offset. ``create_compressor``
follows the kill-switch rule of the other native tiers, where the JAX
package's bzip2 alone differs (ROADMAP F12). Integer codecs: the tolerance
is 0. The engine's CRC and MTF loops run in Python, so inputs stay small.
"""

import bz2
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from aircompressor_tpu import bzip2 as jax_bzip2
from aircompressor_tpu.bzip2 import block_ref as jax_engine
from aircompressor_tpu.errors import MalformedInputException
from aircompressor_tpu_torch import bzip2
from aircompressor_tpu_torch.errors import MalformedInputException as PortMalformed
from aircompressor_tpu_torch.host import bzip2 as engine
from aircompressor_tpu_torch.ops.batch import _selfcheck_payload

ROOT = Path(__file__).resolve().parent.parent
CUT = 8000


def _inputs() -> list[bytes]:
    rng = np.random.default_rng(18)
    return [c[:CUT] for _, c in chip_smoke.synthetic_cases()] + [
        np.repeat(rng.integers(0, 4, 1500, dtype=np.uint8), 5).tobytes(),
        b"\x07" * 300 + b"xy" * 700 + b"\x07" * 9,
        _selfcheck_payload(6)[:CUT]]


INPUTS = _inputs()
LONG = (_selfcheck_payload(7) * 2)[:105000]  # two blocks at block size 1


@pytest.mark.parametrize("level", [1, 9])
def test_engine_writes_the_jax_bytes(level):
    for raw in INPUTS:
        blob = engine.compress(raw, level)
        assert blob == jax_engine.compress(raw, level)
        assert bz2.decompress(blob) == raw
        assert engine.decompress(blob) == raw


def test_engine_splits_blocks_as_the_jax_engine():
    blob = bzip2.BZip2RefCompressor(1).compress(LONG)
    assert blob == jax_bzip2.BZip2RefCompressor(1).compress(LONG)
    bits = "".join(f"{b:08b}" for b in blob)  # blocks are not byte-aligned
    assert bits.count(f"{engine.BLOCK_MAGIC:048b}") == 2
    assert bz2.decompress(blob) == LONG
    assert bzip2.BZip2RefDecompressor().decompress(blob) == LONG


@pytest.mark.parametrize("level", [1, 9])
def test_engine_decodes_stdlib_streams(level):
    for raw in INPUTS:
        blob = bz2.compress(raw, level)
        assert engine.decompress(blob) == raw == jax_engine.decompress(blob)


def test_engine_reads_concatenated_streams():
    blob = engine.compress(b"hello ") + bz2.compress(b"world") + engine.compress(b"!")
    assert engine.decompress(blob) == b"hello world!" == jax_engine.decompress(blob)


def test_crc_and_tables_equal_the_jax_engine():
    np.testing.assert_array_equal(engine._CRC_TAB, jax_engine._CRC_TAB)
    assert engine.block_crc(np.frombuffer(b"123456789", np.uint8)) == 0xFC891918
    for raw in INPUTS[:6]:
        a = np.frombuffer(raw, np.uint8)
        assert engine.block_crc(a) == jax_engine.block_crc(a) == jax_engine._block_crc_fast(a)
    a = np.frombuffer(INPUTS[-1], np.uint8)
    last, ptr = engine.bwt_forward(a)
    want_last, want_ptr = jax_engine.bwt_forward(a)
    np.testing.assert_array_equal(last, want_last)
    assert ptr == want_ptr
    np.testing.assert_array_equal(engine.bwt_inverse(last, ptr), a)
    np.testing.assert_array_equal(jax_engine.bwt_inverse(last, ptr), a)
    np.testing.assert_array_equal(engine.rle1_encode(a), jax_engine.rle1_encode(a))


def _malformed_streams() -> list[bytes]:
    """A broken end-of-stream CRC, a flipped payload byte, no magic, a bad
    version and block size, a truncated stream and a randomized block."""
    blob = engine.compress(b"The quick brown fox jumps over the lazy dog. " * 200)
    flipped = bytearray(blob)
    flipped[20] ^= 0xFF
    randomized = bytearray(blob)
    randomized[14] |= 0x80  # the bit after the block CRC
    return [blob[:-6] + b"\x00" * 6, bytes(flipped), b"NOTBZ2!!", b"BZx9" + blob[4:],
            b"BZh0" + blob[4:], blob[: len(blob) // 2], bytes(randomized)]


@pytest.mark.parametrize("case", range(7))
def test_malformed_streams_raise_as_in_jax(case):
    blob = _malformed_streams()[case]
    with pytest.raises(MalformedInputException) as want:
        jax_bzip2.BZip2RefDecompressor().decompress(blob)
    with pytest.raises(PortMalformed) as got:
        bzip2.BZip2RefDecompressor().decompress(blob)
    assert got.value.offset == want.value.offset
    with pytest.raises(MalformedInputException):  # libbz2 rejects each of them too
        jax_bzip2.BZip2NativeDecompressor().decompress(blob)
    with pytest.raises(PortMalformed):
        bzip2.BZip2NativeDecompressor().decompress(blob)


@pytest.mark.parametrize("level", [1, 9])
def test_streams_write_the_jax_bytes(level):
    raw = b"".join(INPUTS)
    blob = bzip2.compress_stream(raw, level)
    assert blob == jax_bzip2.compress_stream(raw, level) == bz2.compress(raw, level)
    assert bzip2.decompress_stream(blob) == raw
    assert bzip2.BZip2NativeCompressor(level).compress(raw) == blob
    assert bzip2.BZip2NativeDecompressor().decompress(blob) == raw


def test_stream_finish_without_close_and_small_reads():
    sink = io.BytesIO()
    out = bzip2.BZip2OutputStream(sink, 1)
    for raw in INPUTS:
        out.write(raw)
    out.finish()
    sink.write(b"TRAILER")
    assert not sink.closed and sink.getvalue().endswith(b"TRAILER")
    blob = sink.getvalue()[:-7]
    assert blob == jax_bzip2.compress_stream(b"".join(INPUTS), 1)
    with pytest.raises(ValueError):
        out.write(b"x")
    with pytest.raises(ValueError):
        bzip2.BZip2OutputStream(io.BytesIO(), 10)
    src = bzip2.BZip2InputStream(io.BytesIO(blob + bz2.compress(b"tail")), read_chunk=501)
    pieces = []
    while piece := src.read(777):
        pieces.append(piece)
    assert b"".join(pieces) == b"".join(INPUTS) + b"tail"


def _tiers(value: str) -> list[str]:
    code = ("from aircompressor_tpu import bzip2 as j\n"
            "from aircompressor_tpu_torch import bzip2 as p\n"
            "print(' '.join(type(f()).__name__ for f in (\n"
            "    j.create_compressor, j.create_decompressor,\n"
            "    p.create_compressor, p.create_decompressor)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    env.pop("AIRCOMPRESSOR_TPU_DISABLE_NATIVE", None)
    if value is not None:
        env["AIRCOMPRESSOR_TPU_DISABLE_NATIVE"] = value
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split()


def test_f12_kill_switch_follows_the_other_native_tiers():
    """ROADMAP F12: the JAX package's bzip2 reads ``=0`` as disabled
    (``bool(os.environ.get(...))``); every other native tier, and the
    port's bzip2, reads ``"0"`` as enabled. Unset and ``=1`` agree."""
    assert _tiers("0") == ["BZip2RefCompressor", "BZip2RefDecompressor",
                           "BZip2NativeCompressor", "BZip2NativeDecompressor"]
    assert _tiers("1") == ["BZip2RefCompressor", "BZip2RefDecompressor"] * 2
    assert _tiers(None) == ["BZip2NativeCompressor", "BZip2NativeDecompressor"] * 2
