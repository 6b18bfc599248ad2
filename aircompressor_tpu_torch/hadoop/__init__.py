"""Hadoop compatibility layer: the port's counterpart of
``aircompressor_tpu.hadoop`` (reference: hadoop/ package + per-codec
adapters), on the host over the port's own families.

- ``HadoopStreams`` — per-codec factory: file extension, Hadoop codec class
  names, stream constructors (reference: hadoop/HadoopStreams.java:25-36).
- ``HadoopInputStream`` adds ``reset_state()`` for Hadoop's split-reset
  semantics; ``HadoopOutputStream`` adds ``finish()`` — end the compressed
  stream without closing the sink (reference: hadoop/HadoopInputStream.java,
  hadoop/HadoopOutputStream.java:27).
- ``CODEC_REGISTRY`` — Hadoop codec class name → HadoopStreams (the
  CodecAdapter analogue, reference: hadoop/CodecAdapter.java:35-110).

The LZ4/Snappy/LZO Hadoop block-stream wire format: big-endian uncompressed
block length, then (big-endian compressed chunk length, chunk) pairs until
the block is complete (reference: lz4/Lz4HadoopInputStream.java:100-156).
Written with ``buffer_size`` of 64 KB or less, its chunks are blocks that
the card's batch decoders take (``ops.batch``).
"""

from __future__ import annotations

import io
import zlib

import numpy as np

from ..errors import MalformedInputException


class HadoopInputStream(io.RawIOBase):
    def readable(self) -> bool:
        return True

    def reset_state(self) -> None:
        """Drop decoder state so reading can restart at a split boundary."""
        raise NotImplementedError


class HadoopOutputStream(io.RawIOBase):
    def writable(self) -> bool:
        return True

    def finish(self) -> None:
        raise NotImplementedError


class HadoopStreams:
    """Factory interface (reference: hadoop/HadoopStreams.java)."""

    extension: str = ""
    codec_names: tuple = ()

    def create_input_stream(self, source) -> HadoopInputStream:
        raise NotImplementedError

    def create_output_stream(self, sink) -> HadoopOutputStream:
        raise NotImplementedError


# ----------------------------------------------------- generic block streams
class BlockHadoopOutputStream(HadoopOutputStream):
    """[BE uncompressed block len][BE compressed chunk len][chunk]… writer."""

    def __init__(self, sink, compressor, buffer_size: int):
        self._sink = sink
        self._comp = compressor
        self._cap = buffer_size
        self._buf = bytearray()
        self._finished = False

    def write(self, data) -> int:
        b = bytes(data)
        self._buf += b
        while len(self._buf) >= self._cap:
            self._flush_block(bytes(self._buf[: self._cap]))
            del self._buf[: self._cap]
        return len(b)

    def _flush_block(self, chunk: bytes) -> None:
        comp = self._comp.compress(chunk)
        self._sink.write(len(chunk).to_bytes(4, "big"))
        self._sink.write(len(comp).to_bytes(4, "big"))
        self._sink.write(comp)

    def finish(self) -> None:
        if not self._finished:
            if self._buf:
                self._flush_block(bytes(self._buf))
                self._buf.clear()
            self._finished = True

    def close(self) -> None:
        if not self.closed:
            self.finish()
            super().close()


class BlockHadoopInputStream(HadoopInputStream):
    def __init__(self, source, decompressor, max_block: int = 1 << 26):
        self._source = source
        self._dec = decompressor
        self._max = max_block
        self._buf = b""
        self._eof = False

    def _read_be32(self):
        b = self._source.read(4)
        if not b:
            return None
        if len(b) != 4:
            raise MalformedInputException(0, "truncated block length")
        return int.from_bytes(b, "big")

    def _fill(self) -> None:
        while not self._buf and not self._eof:
            un_len = self._read_be32()
            if un_len is None:
                self._eof = True
                return
            if un_len > self._max:
                raise MalformedInputException(0, f"block too large: {un_len}")
            out = bytearray()
            while len(out) < un_len:
                comp_len = self._read_be32()
                if comp_len is None:
                    raise MalformedInputException(0, "truncated block stream")
                if comp_len > self._max:
                    raise MalformedInputException(0, f"chunk too large: {comp_len}")
                payload = self._source.read(comp_len)
                if len(payload) != comp_len:
                    raise MalformedInputException(0, "truncated chunk")
                out += self._dec.decompress(payload, un_len - len(out))
            self._buf = bytes(out)

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

    def reset_state(self) -> None:
        self._buf = b""
        self._eof = False


# --------------------------------------------------------------- per codec
class Lz4HadoopStreams(HadoopStreams):
    extension = ".lz4"
    codec_names = ("org.apache.hadoop.io.compress.Lz4Codec",)
    DEFAULT_BUFFER = 256 * 1024  # reference: Lz4HadoopStreams.java:29

    def __init__(self, buffer_size: int = DEFAULT_BUFFER):
        self._buffer = buffer_size

    def create_input_stream(self, source):
        from ..lz4 import Lz4Decompressor

        return BlockHadoopInputStream(source, Lz4Decompressor.create())

    def create_output_stream(self, sink):
        from ..lz4 import Lz4Compressor

        return BlockHadoopOutputStream(sink, Lz4Compressor.create(), self._buffer)


class SnappyHadoopStreams(HadoopStreams):
    extension = ".snappy"
    codec_names = ("org.apache.hadoop.io.compress.SnappyCodec",)
    DEFAULT_BUFFER = 256 * 1024

    def __init__(self, buffer_size: int = DEFAULT_BUFFER):
        self._buffer = buffer_size

    def create_input_stream(self, source):
        from ..snappy import SnappyDecompressor

        return BlockHadoopInputStream(source, SnappyDecompressor.create())

    def create_output_stream(self, sink):
        from ..snappy import SnappyCompressor

        return BlockHadoopOutputStream(sink, SnappyCompressor.create(), self._buffer)


class LzoHadoopStreams(HadoopStreams):
    extension = ".lzo_deflate"
    codec_names = (
        "org.apache.hadoop.io.compress.LzoCodec",
        "com.hadoop.compression.lzo.LzoCodec",
    )
    DEFAULT_BUFFER = 256 * 1024

    def __init__(self, buffer_size: int = DEFAULT_BUFFER):
        self._buffer = buffer_size

    def create_input_stream(self, source):
        from ..lzo import LzoDecompressor

        return BlockHadoopInputStream(source, LzoDecompressor())

    def create_output_stream(self, sink):
        from ..lzo import LzoCompressor

        return BlockHadoopOutputStream(sink, LzoCompressor(), self._buffer)


class LzopHadoopStreams(HadoopStreams):
    extension = ".lzo"
    codec_names = ("com.hadoop.compression.lzo.LzopCodec",)

    def create_input_stream(self, source):
        from ..lzo.lzop import LzopInputStream

        return _wrap_hadoop_input(LzopInputStream, source)

    def create_output_stream(self, sink):
        from ..lzo.lzop import LzopOutputStream

        return _wrap_hadoop_output(LzopOutputStream(sink))


class ZstdHadoopStreams(HadoopStreams):
    """Hadoop zstd = plain zstd frames (reference: ZstdHadoopStreams)."""

    extension = ".zst"
    codec_names = ("org.apache.hadoop.io.compress.ZStandardCodec",)

    def create_input_stream(self, source):
        from ..zstd.streams import ZstdInputStream

        return _wrap_hadoop_input(ZstdInputStream, source)

    def create_output_stream(self, sink):
        from ..zstd.streams import ZstdOutputStream

        return _wrap_hadoop_output(ZstdOutputStream(sink))


class BZip2HadoopStreams(HadoopStreams):
    extension = ".bz2"
    codec_names = ("org.apache.hadoop.io.compress.BZip2Codec",)

    def create_input_stream(self, source):
        from ..bzip2 import BZip2InputStream

        return _wrap_hadoop_input(BZip2InputStream, source)

    def create_output_stream(self, sink):
        from ..bzip2 import BZip2OutputStream

        return _wrap_hadoop_output(BZip2OutputStream(sink))


class JdkGzipHadoopStreams(HadoopStreams):
    extension = ".gz"
    codec_names = ("org.apache.hadoop.io.compress.GzipCodec",)

    def create_input_stream(self, source):
        from ..gzip import GzipInputStream

        return _wrap_hadoop_input(GzipInputStream, source)

    def create_output_stream(self, sink):
        from ..gzip import GzipOutputStream

        return _wrap_hadoop_output(GzipOutputStream(sink))


class JdkDeflateHadoopStreams(HadoopStreams):
    extension = ".deflate"
    codec_names = (
        "org.apache.hadoop.io.compress.DefaultCodec",
        "org.apache.hadoop.io.compress.DeflateCodec",
    )

    def create_input_stream(self, source):
        return _ZlibHadoopInputStream(source)

    def create_output_stream(self, sink):
        return _ZlibHadoopOutputStream(sink)


class _ZlibHadoopOutputStream(HadoopOutputStream):
    """zlib-wrapped deflate (Hadoop DefaultCodec)."""

    def __init__(self, sink, level: int = 4):
        self._sink = sink
        self._comp = zlib.compressobj(level, zlib.DEFLATED, zlib.MAX_WBITS)
        self._finished = False

    def write(self, data) -> int:
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


class _ZlibHadoopInputStream(HadoopInputStream):
    def __init__(self, source, read_chunk: int = 64 * 1024):
        self._source = source
        self._chunk = read_chunk
        self._dec = zlib.decompressobj(zlib.MAX_WBITS)
        self._buf = b""
        self._eof = False

    def _fill(self) -> None:
        while not self._buf and not self._eof:
            raw = self._source.read(self._chunk)
            if not raw:
                self._eof = True
                return
            try:
                self._buf = self._dec.decompress(raw)
            except zlib.error as e:
                raise MalformedInputException(0, f"deflate: {e}") from e

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

    def reset_state(self) -> None:
        self._dec = zlib.decompressobj(zlib.MAX_WBITS)
        self._buf = b""


# ------------------------------------------------------------------ adapters
def _wrap_hadoop_input(make_stream, source) -> HadoopInputStream:
    """Adapt a file-like reader factory to the Hadoop contract.

    reset_state() REBUILDS the reader from the (possibly re-seeked)
    source: Hadoop calls it after seeking to a new split boundary, so
    both the decoder state AND any raw bytes the old reader buffered
    ahead must be discarded (reference: HadoopInputStream.resetState)."""

    class _In(HadoopInputStream):
        def __init__(self):
            self._s = make_stream(source)

        def read(self, n: int = -1):
            return self._s.read(n)

        def reset_state(self):
            self._s = make_stream(source)

    return _In()


def _wrap_hadoop_output(stream) -> HadoopOutputStream:
    class _Out(HadoopOutputStream):
        def write(self, data):
            return stream.write(data)

        def finish(self):
            stream.finish()

        def close(self):
            if not self.closed:
                stream.finish()
                super().close()

    return _Out()


def _build_registry():
    reg = {}
    for streams in (
        Lz4HadoopStreams(),
        SnappyHadoopStreams(),
        LzoHadoopStreams(),
        LzopHadoopStreams(),
        ZstdHadoopStreams(),
        BZip2HadoopStreams(),
        JdkGzipHadoopStreams(),
        JdkDeflateHadoopStreams(),
    ):
        for name in streams.codec_names:
            reg[name] = streams
    return reg


CODEC_REGISTRY = _build_registry()


def get_codec(name: str) -> HadoopStreams:
    """Look up a HadoopStreams factory by Hadoop codec class name
    (reference: CodecAdapter's codec-class dispatch)."""
    if name not in CODEC_REGISTRY:
        raise KeyError(f"unknown Hadoop codec: {name}")
    return CODEC_REGISTRY[name]
