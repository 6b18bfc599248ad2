"""LZ4 frame file-like streams: the port's counterpart of
``aircompressor_tpu.lz4.streams``, on the host.

Streaming wrappers over the frame engine (lz4/frame.py) — each buffered
window becomes one frame block; reading walks blocks incrementally. Role
parity: the reference exposes frame compression as one-shot codecs
(lz4/Lz4FrameCompressor.java); streams here additionally support the
finish-without-close contract used by the Hadoop layer.
"""

from __future__ import annotations

import io

import numpy as np

from ..errors import MalformedInputException
from ..xxhash import XxHash32State, xxh32
from . import Lz4Compressor, Lz4Decompressor, frame


class Lz4FrameOutputStream(io.RawIOBase):
    """Streaming writer: one frame, 4MB-max independent blocks, header and
    optional content checksum handled by the frame engine on finish.

    Buffers up to ``block_size`` bytes and emits one frame block per flush.
    """

    def __init__(self, sink, block_max_id: int = 4,
                 block_checksums: bool = False,
                 compressor: Lz4Compressor | None = None):
        if block_max_id not in frame.BLOCK_SIZES:
            raise ValueError(f"invalid block size id {block_max_id}")
        self._sink = sink
        self._block_max_id = block_max_id
        self._block_size = frame.BLOCK_SIZES[block_max_id]
        self._block_checksums = block_checksums
        self._comp = compressor or Lz4Compressor.create()
        self._buf = bytearray()
        self._finished = False
        self._wrote_header = False

    def writable(self) -> bool:
        return True

    def _write_header(self) -> None:
        flg = frame.FLG_VERSION | frame.FLG_BLOCK_INDEPENDENCE
        if self._block_checksums:
            flg |= frame.FLG_BLOCK_CHECKSUM
        bd = self._block_max_id << 4
        hdr = bytes([flg, bd])
        hc = (xxh32(hdr) >> 8) & 0xFF
        self._sink.write(int(frame.MAGIC).to_bytes(4, "little"))
        self._sink.write(hdr + bytes([hc]))
        self._wrote_header = True

    def _flush_block(self, chunk: bytes) -> None:
        if not self._wrote_header:
            self._write_header()
        out = np.empty(self._comp.max_compressed_length(len(chunk)), np.uint8)
        n = self._comp.compress_into(np.frombuffer(chunk, np.uint8), out)
        if n < len(chunk):
            self._sink.write(int(n).to_bytes(4, "little"))
            payload = out[:n].tobytes()
        else:
            self._sink.write(int(len(chunk) | frame.UNCOMPRESSED_FLAG).to_bytes(4, "little"))
            payload = chunk
        self._sink.write(payload)
        if self._block_checksums:
            self._sink.write(int(xxh32(payload)).to_bytes(4, "little"))

    def write(self, data) -> int:
        if self._finished:
            raise ValueError("stream already finished")
        self._buf += bytes(data)
        while len(self._buf) >= self._block_size:
            self._flush_block(bytes(self._buf[: self._block_size]))
            del self._buf[: self._block_size]
        return len(data)

    def finish(self) -> None:
        if not self._finished:
            if self._buf:
                self._flush_block(bytes(self._buf))
                self._buf.clear()
            if not self._wrote_header:
                self._write_header()
            self._sink.write(int(frame.END_MARK).to_bytes(4, "little"))
            self._finished = True

    def close(self) -> None:
        if not self.closed:
            self.finish()
            super().close()


class Lz4FrameInputStream(io.RawIOBase):
    """Streaming reader over (possibly concatenated) LZ4 frames; validates
    header checksums, handles skippable frames and stored blocks."""

    def __init__(self, source, decompressor: Lz4Decompressor | None = None):
        self._source = source
        self._dec = decompressor or Lz4Decompressor.create()
        self._buf = b""
        self._eof = False
        self._in_frame = False
        self._flags = 0
        self._block_max = 0
        self._content_hash = None

    def readable(self) -> bool:
        return True

    def _read_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            c = self._source.read(n - len(out))
            if not c:
                raise MalformedInputException(0, "truncated lz4 frame stream")
            out += c
        return out

    def _begin_frame(self) -> bool:
        while True:
            magic_b = self._source.read(4)
            if not magic_b:
                return False
            if len(magic_b) < 4:
                raise MalformedInputException(0, "truncated magic")
            magic = int.from_bytes(magic_b, "little")
            if (magic & frame.SKIPPABLE_MASK) == frame.SKIPPABLE_BASE:
                skip = int.from_bytes(self._read_exact(4), "little")
                self._read_exact(skip)
                continue
            if magic != frame.MAGIC:
                raise MalformedInputException(0, f"invalid lz4 frame magic {magic:#x}")
            break
        flg = self._read_exact(1)[0]
        bd = self._read_exact(1)[0]
        if (flg & 0xC0) != frame.FLG_VERSION:
            raise MalformedInputException(0, "unsupported lz4 frame version")
        if not flg & frame.FLG_BLOCK_INDEPENDENCE:
            raise MalformedInputException(0, "linked blocks not supported")
        if flg & frame.FLG_DICT_ID:
            raise MalformedInputException(0, "dictionaries not supported")
        if flg & frame.FLG_RESERVED or bd & frame.BD_RESERVED_MASK:
            raise MalformedInputException(0, "reserved bits set")
        hdr = bytes([flg, bd])
        if flg & frame.FLG_CONTENT_SIZE:
            hdr += self._read_exact(8)
        hc = self._read_exact(1)[0]
        if ((xxh32(hdr) >> 8) & 0xFF) != hc:
            raise MalformedInputException(0, "frame header checksum mismatch")
        self._flags = flg
        bs_id = (bd >> 4) & 7
        if bs_id not in frame.BLOCK_SIZES:
            raise MalformedInputException(0, "invalid block size id")
        self._block_max = frame.BLOCK_SIZES[bs_id]
        if flg & frame.FLG_CONTENT_CHECKSUM:
            self._content_hash = XxHash32State()
        self._in_frame = True
        return True

    def _next_block(self) -> None:
        size_w = int.from_bytes(self._read_exact(4), "little")
        if size_w == frame.END_MARK:
            if self._flags & frame.FLG_CONTENT_CHECKSUM:
                stored = int.from_bytes(self._read_exact(4), "little")
                if self._content_hash.digest() != stored:
                    raise MalformedInputException(0, "content checksum mismatch")
            self._in_frame = False
            return
        stored = bool(size_w & frame.UNCOMPRESSED_FLAG)
        size = size_w & ~frame.UNCOMPRESSED_FLAG
        if size > self._block_max + (0 if stored else 4):
            raise MalformedInputException(0, "block exceeds declared maximum")
        payload = self._read_exact(size)
        if self._flags & frame.FLG_BLOCK_CHECKSUM:
            bc = int.from_bytes(self._read_exact(4), "little")
            if xxh32(payload) != bc:
                raise MalformedInputException(0, "block checksum mismatch")
        if stored:
            data = payload
        else:
            data = self._dec.decompress(payload, self._block_max)
        if self._content_hash is not None:
            self._content_hash.update(data)
        self._buf = data

    def _fill(self) -> None:
        while not self._buf and not self._eof:
            if not self._in_frame:
                if not self._begin_frame():
                    self._eof = True
                    return
            self._next_block()

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


def compress_stream(data: bytes, **kw) -> bytes:
    sink = io.BytesIO()
    s = Lz4FrameOutputStream(sink, **kw)
    s.write(data)
    s.finish()
    return sink.getvalue()


def decompress_stream(data: bytes) -> bytes:
    return Lz4FrameInputStream(io.BytesIO(data)).read()
