"""Bzip2 codec family: the port's counterpart of ``aircompressor_tpu.bzip2``
(reference: bzip2/ package), on the host.

Two tiers, mirroring the reference's own-Java + native split:

- **own engine** (``host/bzip2.py``): from-scratch RLE1 + Burrows–Wheeler +
  MTF + RLE2 + multi-table canonical Huffman, the counterpart of the
  reference's CBZip2OutputStream/CBZip2InputStream;
- **native tier**: the system libbz2 via stdlib ``bz2`` (the same library
  the reference downloads, libbz2 1.0.8), used by the streaming classes
  and preferred by :func:`create_compressor` unless
  ``AIRCOMPRESSOR_TPU_DISABLE_NATIVE`` is set to a value other than ``""``
  or ``"0"`` — the rule of every other native tier. (The JAX package's
  bzip2 family alone also reads ``"0"`` as set.)

The reference exposes bzip2 as streams only (no block API); the stream
classes here add the same Hadoop-facing semantics (finish-without-close,
concatenated streams).
"""

from __future__ import annotations

import bz2
import io
import os

from ..errors import MalformedInputException

DEFAULT_BLOCK_SIZE_100K = 9  # "BZh9" — reference CBZip2OutputStream default


def _native_disabled() -> bool:
    return os.environ.get("AIRCOMPRESSOR_TPU_DISABLE_NATIVE", "") not in ("", "0")


class BZip2RefCompressor:
    """Own-engine .bz2 stream compressor (block_ref pipeline)."""

    def __init__(self, block_size_100k: int = DEFAULT_BLOCK_SIZE_100K):
        self.block_size_100k = block_size_100k

    def compress(self, data: bytes) -> bytes:
        from ..host import bzip2 as block_ref

        return block_ref.compress(data, self.block_size_100k)


class BZip2RefDecompressor:
    """Own-engine .bz2 stream decompressor (block_ref pipeline)."""

    def decompress(self, data: bytes) -> bytes:
        from ..host import bzip2 as block_ref

        return block_ref.decompress(data)


class BZip2NativeCompressor:
    def __init__(self, block_size_100k: int = DEFAULT_BLOCK_SIZE_100K):
        self.block_size_100k = block_size_100k

    def compress(self, data: bytes) -> bytes:
        return bz2.compress(data, self.block_size_100k)


class BZip2NativeDecompressor:
    def decompress(self, data: bytes) -> bytes:
        try:
            return bz2.decompress(data)
        except (OSError, ValueError) as e:
            raise MalformedInputException(0, f"bzip2: {e}") from e


def create_compressor(block_size_100k: int = DEFAULT_BLOCK_SIZE_100K):
    """Native-first factory (pattern: reference per-codec ``create()``)."""
    if _native_disabled():
        return BZip2RefCompressor(block_size_100k)
    return BZip2NativeCompressor(block_size_100k)


def create_decompressor():
    if _native_disabled():
        return BZip2RefDecompressor()
    return BZip2NativeDecompressor()


class BZip2OutputStream(io.RawIOBase):
    """Streaming bzip2 writer (reference: bzip2/CBZip2OutputStream.java).

    ``finish()`` ends the compressed stream without closing the sink
    (reference: hadoop/HadoopOutputStream.java:27 contract).
    """

    def __init__(self, sink, block_size_100k: int = DEFAULT_BLOCK_SIZE_100K):
        if not 1 <= block_size_100k <= 9:
            raise ValueError("block size must be in [1, 9]")
        self._sink = sink
        self._comp = bz2.BZ2Compressor(block_size_100k)
        self._finished = False

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        if self._finished:
            raise ValueError("stream already finished")
        out = self._comp.compress(bytes(data))
        if out:
            self._sink.write(out)
        return len(data)

    def finish(self) -> None:
        if not self._finished:
            self._sink.write(self._comp.flush())
            self._finished = True

    def close(self) -> None:
        if not self.closed:
            self.finish()
            super().close()


class BZip2InputStream(io.RawIOBase):
    """Streaming bzip2 reader over a file-like source; handles concatenated
    streams (reference: bzip2/CBZip2InputStream.java multi-block semantics).
    """

    def __init__(self, source, read_chunk: int = 64 * 1024):
        self._source = source
        self._chunk = read_chunk
        self._dec = bz2.BZ2Decompressor()
        self._buf = b""
        self._eof = False

    def readable(self) -> bool:
        return True

    def _fill(self) -> None:
        while not self._buf and not self._eof:
            if self._dec.eof:
                leftover = self._dec.unused_data
                self._dec = bz2.BZ2Decompressor()
                if leftover:
                    try:
                        self._buf = self._dec.decompress(leftover)
                    except OSError as e:
                        raise MalformedInputException(0, f"bzip2: {e}") from e
                    continue
            raw = self._source.read(self._chunk)
            if not raw:
                if not self._dec.eof and self._dec.needs_input and self._buf == b"":
                    # truncated stream only matters if mid-stream
                    pass
                self._eof = True
                return
            try:
                self._buf = self._dec.decompress(raw)
            except OSError as e:
                raise MalformedInputException(0, f"bzip2: {e}") from e

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            chunks = []
            while True:
                self._fill()
                if not self._buf:
                    return b"".join(chunks)
                chunks.append(self._buf)
                self._buf = b""
        self._fill()
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


def compress_stream(data: bytes, block_size_100k: int = DEFAULT_BLOCK_SIZE_100K) -> bytes:
    sink = io.BytesIO()
    s = BZip2OutputStream(sink, block_size_100k)
    s.write(data)
    s.finish()
    return sink.getvalue()


def decompress_stream(data: bytes) -> bytes:
    return BZip2InputStream(io.BytesIO(data)).read()


__all__ = [
    "BZip2OutputStream",
    "BZip2InputStream",
    "BZip2RefCompressor",
    "BZip2RefDecompressor",
    "BZip2NativeCompressor",
    "BZip2NativeDecompressor",
    "create_compressor",
    "create_decompressor",
    "compress_stream",
    "decompress_stream",
    "DEFAULT_BLOCK_SIZE_100K",
]
