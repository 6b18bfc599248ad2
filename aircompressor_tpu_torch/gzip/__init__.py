"""Gzip stream codec: the port's counterpart of ``aircompressor_tpu.gzip``
(reference: gzip/ package), on the host.

The reference wraps the JDK's GZIPInputStream/GZIPOutputStream (zlib); here
the stdlib ``zlib`` with gzip headers (wbits=31) plays the same role.
``GzipOutputStream.finish()`` ends the member without closing the sink,
for the Hadoop layer (reference: gzip/JdkGzipHadoopStreams.java), and
``GzipInputStream`` reads concatenated members.
"""

from __future__ import annotations

import io
import zlib

from ..errors import MalformedInputException

DEFAULT_LEVEL = 4  # parity with JdkGzipHadoopStreams' OutputStreamAdapter


class GzipOutputStream(io.RawIOBase):
    def __init__(self, sink, level: int = DEFAULT_LEVEL):
        self._sink = sink
        self._comp = zlib.compressobj(level, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
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


class GzipInputStream(io.RawIOBase):
    """Reads (possibly concatenated) gzip streams."""

    def __init__(self, source, read_chunk: int = 64 * 1024):
        self._source = source
        self._chunk = read_chunk
        self._dec = zlib.decompressobj(16 + zlib.MAX_WBITS)
        self._buf = b""
        self._eof = False

    def readable(self) -> bool:
        return True

    def _fill(self) -> None:
        while not self._buf and not self._eof:
            if self._dec.eof:
                leftover = self._dec.unused_data
                self._dec = zlib.decompressobj(16 + zlib.MAX_WBITS)
                if leftover:
                    try:
                        self._buf = self._dec.decompress(leftover)
                    except zlib.error as e:
                        raise MalformedInputException(0, f"gzip: {e}") from e
                    continue
            raw = self._source.read(self._chunk)
            if not raw:
                self._eof = True
                return
            try:
                self._buf = self._dec.decompress(raw)
            except zlib.error as e:
                raise MalformedInputException(0, f"gzip: {e}") from e

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


def compress_stream(data: bytes, level: int = DEFAULT_LEVEL) -> bytes:
    sink = io.BytesIO()
    s = GzipOutputStream(sink, level)
    s.write(data)
    s.finish()
    return sink.getvalue()


def decompress_stream(data: bytes) -> bytes:
    return GzipInputStream(io.BytesIO(data)).read()


__all__ = ["GzipOutputStream", "GzipInputStream", "compress_stream", "decompress_stream"]
