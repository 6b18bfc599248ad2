"""Snappy framing format (x-snappy-framed, spec: snappy framing_format.txt):
the port's counterpart of ``aircompressor_tpu.snappy.framed``.

Parity targets: reference snappy/SnappyFramed.java:21-31 (constants),
SnappyFramedOutputStream.java (64KB chunks, 0.85 min-compression-ratio gate,
masked CRC32C of uncompressed data), SnappyFramedInputStream.java (header
verification, per-chunk CRC, skippable sections).

The constants, the chunk writer (``data_chunk``) and the walk
(``iter_frames``) are ``host/framed.py``'s, shared with the card's framed
decode (``ops.batch.snappy_framed_decompress_device``); the streams are on
the host. ``compress_framed`` here is the stream's one-shot wrapper, as in
the JAX module; ``host.framed.compress_framed`` is the batch framer.
"""

from __future__ import annotations

import io

import numpy as np

from ..errors import MalformedInputException
from ..host.crc32c import crc32c_raw, mask_crc
from ..host.framed import (
    COMPRESSED_CHUNK, HEADER, MAX_UNCOMPRESSED_CHUNK, PADDING_CHUNK, STREAM_IDENTIFIER,
    UNCOMPRESSED_CHUNK, data_chunk, iter_frames)
from ..host.snappy import max_compressed_length
from . import SnappyCompressor, SnappyDecompressor

DEFAULT_BLOCK_SIZE = MAX_UNCOMPRESSED_CHUNK
DEFAULT_MIN_COMPRESSION_RATIO = 0.85

__all__ = [
    "COMPRESSED_CHUNK", "HEADER", "PADDING_CHUNK", "STREAM_IDENTIFIER",
    "UNCOMPRESSED_CHUNK", "SnappyFramedInputStream", "SnappyFramedOutputStream",
    "compress_framed", "decompress_framed", "iter_frames"]


class SnappyFramedOutputStream(io.RawIOBase):
    def __init__(self, sink, block_size: int = DEFAULT_BLOCK_SIZE,
                 min_compression_ratio: float = DEFAULT_MIN_COMPRESSION_RATIO,
                 compressor: SnappyCompressor | None = None,
                 write_checksums: bool = True):
        if not 0 < block_size <= MAX_UNCOMPRESSED_CHUNK:
            raise ValueError(f"block size must be in (0, 65536]: {block_size}")
        if not 0 < min_compression_ratio <= 1.0:
            raise ValueError(f"min compression ratio must be in (0, 1]: {min_compression_ratio}")
        self._sink = sink
        self._block_size = block_size
        self._min_ratio = min_compression_ratio
        self._compressor = compressor or SnappyCompressor.create()
        self._write_checksums = write_checksums
        self._buf = bytearray()
        self._scratch = np.empty(max_compressed_length(block_size), dtype=np.uint8)
        sink.write(HEADER)

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        data = bytes(memoryview(data))
        self._buf += data
        while len(self._buf) >= self._block_size:
            self._flush_chunk(bytes(self._buf[: self._block_size]))
            del self._buf[: self._block_size]
        return len(data)

    def _flush_chunk(self, chunk: bytes) -> None:
        crc = mask_crc(crc32c_raw(chunk)) if self._write_checksums else 0
        n = self._compressor.compress_into(np.frombuffer(chunk, np.uint8), self._scratch)
        self._sink.write(data_chunk(chunk, self._scratch[:n].tobytes(), crc, self._min_ratio))

    def flush(self) -> None:
        if self._buf:
            self._flush_chunk(bytes(self._buf))
            self._buf.clear()
        self._sink.flush()

    def close(self) -> None:
        if not self.closed:
            self.flush()
        super().close()


class SnappyFramedInputStream(io.RawIOBase):
    def __init__(self, source, verify_checksums: bool = True,
                 decompressor: SnappyDecompressor | None = None):
        self._source = source
        self._verify = verify_checksums
        self._decompressor = decompressor or SnappyDecompressor.create()
        self._pending = b""
        self._pos = 0
        self._consumed = 0
        header = source.read(len(HEADER))
        self._consumed += len(header or b"")
        if header != HEADER:
            raise MalformedInputException(0, "invalid snappy framed stream header")

    def readable(self) -> bool:
        return True

    def _read_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self._source.read(n - len(out))
            if not chunk:
                raise MalformedInputException(self._consumed, "truncated snappy framed stream")
            out += chunk
        self._consumed += n
        return out

    def _next_chunk(self) -> bool:
        while True:
            hdr = self._source.read(4)
            if not hdr:
                return False
            self._consumed += len(hdr)
            if len(hdr) < 4:
                raise MalformedInputException(self._consumed, "truncated chunk header")
            kind = hdr[0]
            length = hdr[1] | (hdr[2] << 8) | (hdr[3] << 16)
            if kind == STREAM_IDENTIFIER:
                ident = self._read_exact(length)
                if ident != HEADER[4:]:
                    raise MalformedInputException(self._consumed, "invalid stream identifier chunk")
                continue
            if kind == PADDING_CHUNK or 0x80 <= kind <= 0xFD:
                self._read_exact(length)  # skippable
                continue
            if 0x02 <= kind <= 0x7F:
                raise MalformedInputException(self._consumed, f"unskippable reserved chunk 0x{kind:02x}")
            if length < 4:
                raise MalformedInputException(self._consumed, "chunk too short for checksum")
            body = self._read_exact(length)
            expected_crc = int.from_bytes(body[:4], "little")
            payload = body[4:]
            if kind == UNCOMPRESSED_CHUNK:
                if len(payload) > MAX_UNCOMPRESSED_CHUNK:
                    raise MalformedInputException(self._consumed, "uncompressed chunk too large")
                data = payload
            else:
                src = np.frombuffer(payload, np.uint8)
                declared = self._decompressor.get_uncompressed_length(src)
                if declared > MAX_UNCOMPRESSED_CHUNK:
                    raise MalformedInputException(self._consumed, "chunk decodes above 64KB limit")
                data = self._decompressor.decompress(src, declared)
            if self._verify and mask_crc(crc32c_raw(data)) != expected_crc:
                raise MalformedInputException(self._consumed, "chunk checksum mismatch")
            self._pending = data
            self._pos = 0
            return True

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while n < 0 or len(out) < n:
            if self._pos >= len(self._pending):
                if not self._next_chunk():
                    break
            take = len(self._pending) - self._pos if n < 0 else min(
                n - len(out), len(self._pending) - self._pos)
            out += self._pending[self._pos : self._pos + take]
            self._pos += take
        return bytes(out)


def compress_framed(data: bytes, **kw) -> bytes:
    sink = io.BytesIO()
    s = SnappyFramedOutputStream(sink, **kw)
    s.write(data)
    s.close()
    return sink.getvalue()


def decompress_framed(data: bytes, **kw) -> bytes:
    return SnappyFramedInputStream(io.BytesIO(data), **kw).read()
