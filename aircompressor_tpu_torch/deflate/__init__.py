"""Deflate codec family: the port's counterpart of ``aircompressor_tpu.deflate``
(reference: deflate/ package).

Tiers, as in the JAX package, both on the host:
- ``DeflateRefCompressor`` / ``DeflateRefDecompressor`` — the stdlib
  ``zlib`` tier (raw deflate), the analogue of the reference wrapping the
  JDK's Deflater/Inflater (reference: deflate/DeflateJavaCompressor.java:27-88);
- ``DeflateNativeCompressor`` / ``DeflateNativeDecompressor`` — the system
  libdeflate through ``native.deflate_binding`` (levels 0-12).

``create()`` picks libdeflate where it is found, else zlib. It takes no
device: batched raw-deflate decode on the card is
``ops.batch.DeflateBatchCodec``.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..api import BufferLike, Compressor, Decompressor, as_u8, as_writable_u8
from ..errors import MalformedInputException

DEFAULT_LEVEL = 4  # reference: DeflateJavaCompressor default level 4
MAX_LEVEL = 9


def max_compressed_length(n: int) -> int:
    """Mark Adler's worst-case bound for raw deflate
    (reference: DeflateJavaCompressor.java:46-50)."""
    return n + ((n + 7) >> 3) + ((n + 63) >> 6) + 5 + 10


class DeflateCompressor(Compressor):
    @staticmethod
    def create(level: int = DEFAULT_LEVEL) -> "DeflateCompressor":
        from ..native import deflate_binding

        if deflate_binding.is_enabled():
            return DeflateNativeCompressor(level)
        return DeflateRefCompressor(level)

    def max_compressed_length(self, uncompressed_size: int) -> int:
        return max_compressed_length(uncompressed_size)


class DeflateDecompressor(Decompressor):
    @staticmethod
    def create() -> "DeflateDecompressor":
        from ..native import deflate_binding

        if deflate_binding.is_enabled():
            return DeflateNativeDecompressor()
        return DeflateRefDecompressor()


class DeflateRefCompressor(DeflateCompressor):
    def __init__(self, level: int = DEFAULT_LEVEL):
        if not 0 <= level <= MAX_LEVEL:
            raise ValueError(f"level must be in [0, {MAX_LEVEL}]: {level}")
        self.level = level

    def compress_into(self, src: BufferLike, dst: BufferLike) -> int:
        s = as_u8(src)
        d = as_writable_u8(dst)
        co = zlib.compressobj(self.level, zlib.DEFLATED, -zlib.MAX_WBITS)
        blob = co.compress(s.tobytes()) + co.flush()
        if d.size < len(blob):
            raise ValueError("output buffer too small")
        d[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
        return len(blob)


class DeflateRefDecompressor(DeflateDecompressor):
    def decompress_into(self, src: BufferLike, dst: BufferLike) -> int:
        s = as_u8(src)
        d = as_writable_u8(dst)
        try:
            blob = zlib.decompress(s.tobytes(), -zlib.MAX_WBITS, d.size or 1)
        except zlib.error as e:
            raise MalformedInputException(0, f"deflate: {e}") from e
        if len(blob) > d.size:
            raise MalformedInputException(0, "output buffer too small")
        d[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
        return len(blob)


class DeflateNativeCompressor(DeflateCompressor):
    def __init__(self, level: int = DEFAULT_LEVEL):
        from ..native import deflate_binding

        deflate_binding.verify_enabled()
        if not 0 <= level <= 12:  # libdeflate supports up to 12
            raise ValueError(f"level must be in [0, 12]: {level}")
        self.level = level

    def compress_into(self, src: BufferLike, dst: BufferLike) -> int:
        from ..native import deflate_binding

        return deflate_binding.compress(as_u8(src), as_writable_u8(dst), self.level)


class DeflateNativeDecompressor(DeflateDecompressor):
    def decompress_into(self, src: BufferLike, dst: BufferLike) -> int:
        from ..native import deflate_binding

        return deflate_binding.decompress(as_u8(src), as_writable_u8(dst))


__all__ = [
    "DeflateCompressor",
    "DeflateDecompressor",
    "DeflateRefCompressor",
    "DeflateRefDecompressor",
    "DeflateNativeCompressor",
    "DeflateNativeDecompressor",
    "max_compressed_length",
]
