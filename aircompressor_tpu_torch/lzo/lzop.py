"""LZOP file format reader/writer: the port's counterpart of
``aircompressor_tpu.lzo.lzop``, on the host (Adler-32 and CRC-32 from
``zlib``).

Parity: reference lzo/LzopHadoopInputStream.java:36-47 (version gates,
adler32/crc32 checksum flags) and lzo/LzopHadoopOutputStream.java:32-82
(full header: file/format/LZO versions 0x1010/0x0940/0x2050, LZO1X variant,
level 5, flags=0, file mode 0x81a4, mtime, empty filename, big-endian
Adler32 of the header).

Block layout: u32-BE uncompressed length (0 terminates), u32-BE compressed
length, optional uncompressed/compressed checksums per the header flags,
payload (stored raw when compressed length == uncompressed length).
"""

from __future__ import annotations

import io
import zlib

from ..errors import MalformedInputException
from . import LzoCompressor, LzoDecompressor

MAGIC = bytes([0x89, 0x4C, 0x5A, 0x4F, 0x00, 0x0D, 0x0A, 0x1A, 0x0A])

F_ADLER32_D = 0x0001
F_ADLER32_C = 0x0002
F_CRC32_D = 0x0100
F_CRC32_C = 0x0200
F_H_CRC32 = 0x1000
F_H_FILTER = 0x0800
SUPPORTED_FLAGS = F_ADLER32_D | F_ADLER32_C | F_CRC32_D | F_CRC32_C | F_H_CRC32 | 0x03000000

LZOP_FILE_VERSION = 0x1010
LZO_LIB_VERSION = 0x2050
LZOP_FORMAT_VERSION = 0x0940
METHOD_LZO1X_1 = 1
DEFAULT_BLOCK_SIZE = 256 * 1024


def _be32(v: int) -> bytes:
    return int(v).to_bytes(4, "big")


def write_header(sink, flags: int = 0, mtime: int = 0) -> None:
    sink.write(MAGIC)
    hdr = bytearray()
    hdr += int(LZOP_FILE_VERSION).to_bytes(2, "big")
    hdr += int(LZO_LIB_VERSION).to_bytes(2, "big")
    hdr += int(LZOP_FORMAT_VERSION).to_bytes(2, "big")
    hdr.append(METHOD_LZO1X_1)
    hdr.append(5)  # level
    hdr += _be32(flags)
    hdr += _be32(0x81A4)  # mode
    hdr += _be32(mtime)
    hdr += _be32(0)  # mtime high
    hdr.append(0)  # empty filename
    checksum = (
        zlib.crc32(bytes(hdr)) if flags & F_H_CRC32 else zlib.adler32(bytes(hdr))
    )
    sink.write(bytes(hdr))
    sink.write(_be32(checksum))


def read_header(source) -> int:
    """Validates the lzop header; returns the flags word."""
    magic = source.read(len(MAGIC))
    if magic != MAGIC:
        raise MalformedInputException(0, "invalid lzop magic")
    hdr = bytearray()

    def take(k: int) -> bytes:
        b = source.read(k)
        if len(b) != k:
            raise MalformedInputException(len(hdr), "truncated lzop header")
        hdr.extend(b)
        return b

    file_version = int.from_bytes(take(2), "big")
    if file_version < 0x0900:
        raise MalformedInputException(0, f"unsupported lzop file version {file_version:#x}")
    take(2)  # lib version
    format_version = int.from_bytes(take(2), "big")
    # version-needed-to-extract: we implement everything up to lzop 1.040
    # (0x1001 appears in CRC32-flagged files — reference golden fixtures)
    if format_version > 0x1040:
        raise MalformedInputException(0, f"unsupported lzop format version {format_version:#x}")
    method = take(1)[0]
    if method not in (1, 2, 3):
        raise MalformedInputException(0, f"unsupported lzo method {method}")
    if format_version >= 0x0940:
        take(1)  # level
    flags = int.from_bytes(take(4), "big")
    if flags & F_H_FILTER:
        raise MalformedInputException(0, "lzop filter not supported")
    take(4)  # mode
    take(4)  # mtime
    if format_version >= 0x0940:
        take(4)  # mtime high
    name_len = take(1)[0]
    if name_len:
        take(name_len)
    expected = (
        zlib.crc32(bytes(hdr)) if flags & F_H_CRC32 else zlib.adler32(bytes(hdr))
    )
    stored = int.from_bytes(source.read(4), "big")
    if stored != expected:
        raise MalformedInputException(len(hdr), "lzop header checksum mismatch")
    return flags


class LzopOutputStream(io.RawIOBase):
    def __init__(self, sink, flags: int = F_ADLER32_D,
                 block_size: int = DEFAULT_BLOCK_SIZE):
        self._sink = sink
        self._flags = flags
        self._block = block_size
        self._buf = bytearray()
        self._comp = LzoCompressor()
        self._finished = False
        write_header(sink, flags)

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        self._buf += bytes(data)
        while len(self._buf) >= self._block:
            self._flush_block(self._buf[: self._block])
            del self._buf[: self._block]
        return len(data)

    def _flush_block(self, chunk: bytes) -> None:
        comp = self._comp.compress(chunk)
        self._sink.write(_be32(len(chunk)))
        if len(comp) < len(chunk):
            self._sink.write(_be32(len(comp)))
        else:
            comp = chunk
            self._sink.write(_be32(len(chunk)))
        if self._flags & F_ADLER32_D:
            self._sink.write(_be32(zlib.adler32(chunk)))
        if self._flags & F_CRC32_D:
            self._sink.write(_be32(zlib.crc32(chunk)))
        if len(comp) != len(chunk):
            if self._flags & F_ADLER32_C:
                self._sink.write(_be32(zlib.adler32(comp)))
            if self._flags & F_CRC32_C:
                self._sink.write(_be32(zlib.crc32(comp)))
        self._sink.write(comp)

    def finish(self) -> None:
        if not self._finished:
            if self._buf:
                self._flush_block(bytes(self._buf))
                self._buf.clear()
            self._sink.write(_be32(0))
            self._finished = True

    def close(self) -> None:
        if not self.closed:
            self.finish()
            super().close()


class LzopInputStream(io.RawIOBase):
    def __init__(self, source):
        self._source = source
        self._flags = read_header(source)
        self._dec = LzoDecompressor()
        self._buf = b""
        self._eof = False

    def readable(self) -> bool:
        return True

    def _read_be32(self):
        b = self._source.read(4)
        if len(b) != 4:
            raise MalformedInputException(0, "truncated lzop block header")
        return int.from_bytes(b, "big")

    def _fill(self) -> None:
        if self._buf or self._eof:
            return
        un_len = self._read_be32()
        if un_len == 0:
            self._eof = True
            return
        comp_len = self._read_be32()
        d_adler = self._read_be32() if self._flags & F_ADLER32_D else None
        d_crc = self._read_be32() if self._flags & F_CRC32_D else None
        c_adler = c_crc = None
        if comp_len != un_len:
            if self._flags & F_ADLER32_C:
                c_adler = self._read_be32()
            if self._flags & F_CRC32_C:
                c_crc = self._read_be32()
        payload = self._source.read(comp_len)
        if len(payload) != comp_len:
            raise MalformedInputException(0, "truncated lzop block")
        if c_adler is not None and zlib.adler32(payload) != c_adler:
            raise MalformedInputException(0, "lzop compressed-data adler32 mismatch")
        if c_crc is not None and zlib.crc32(payload) != c_crc:
            raise MalformedInputException(0, "lzop compressed-data crc32 mismatch")
        if comp_len == un_len:
            chunk = payload
        else:
            chunk = self._dec.decompress(payload, un_len)
            if len(chunk) != un_len:
                raise MalformedInputException(0, "lzop block size mismatch")
        if d_adler is not None and zlib.adler32(chunk) != d_adler:
            raise MalformedInputException(0, "lzop data adler32 mismatch")
        if d_crc is not None and zlib.crc32(chunk) != d_crc:
            raise MalformedInputException(0, "lzop data crc32 mismatch")
        self._buf = chunk

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


def compress_file(data: bytes, flags: int = F_ADLER32_D) -> bytes:
    sink = io.BytesIO()
    s = LzopOutputStream(sink, flags)
    s.write(data)
    s.finish()
    return sink.getvalue()


def decompress_file(blob: bytes) -> bytes:
    return LzopInputStream(io.BytesIO(blob)).read()
