"""Snappy codec family: the port's counterpart of ``aircompressor_tpu.snappy``
(reference: snappy/ package).

Tiers, as in the JAX package, both on the host:
- ``SnappyRefCompressor`` / ``SnappyRefDecompressor`` — the numpy reference
  codec (``host/snappy.py``);
- ``SnappyNativeCompressor`` / ``SnappyNativeDecompressor`` — the C++ tier
  (``native``).

``create()`` picks native when its library loads, else numpy. It takes no
device: batched Snappy on the card is ``ops.batch.SnappyBatchCodec``.
``framed`` is the x-snappy-framed stream format.
"""

from __future__ import annotations

from ..api import BufferLike, Compressor, Decompressor, as_u8, as_writable_u8
from ..host import snappy as block_ref


class SnappyCompressor(Compressor):
    @staticmethod
    def create() -> "SnappyCompressor":
        from .. import native

        if native.is_enabled():
            return SnappyNativeCompressor()
        return SnappyRefCompressor()

    def max_compressed_length(self, uncompressed_size: int) -> int:
        return block_ref.max_compressed_length(uncompressed_size)


class SnappyDecompressor(Decompressor):
    @staticmethod
    def create() -> "SnappyDecompressor":
        from .. import native

        if native.is_enabled():
            return SnappyNativeDecompressor()
        return SnappyRefDecompressor()

    def get_uncompressed_length(self, src: BufferLike) -> int:
        return block_ref.read_uncompressed_length(as_u8(src))[0]


class SnappyRefCompressor(SnappyCompressor):
    def compress_into(self, src: BufferLike, dst: BufferLike) -> int:
        s = as_u8(src)
        d = as_writable_u8(dst)
        if d.size < self.max_compressed_length(s.size):
            raise ValueError("output buffer smaller than max_compressed_length")
        return block_ref.compress_into(s, d)


class SnappyRefDecompressor(SnappyDecompressor):
    def decompress_into(self, src: BufferLike, dst: BufferLike) -> int:
        return block_ref.decompress_into(as_u8(src), as_writable_u8(dst))


class SnappyNativeCompressor(SnappyCompressor):
    def __init__(self):
        from .. import native

        native.verify_enabled()

    def compress_into(self, src: BufferLike, dst: BufferLike) -> int:
        from .. import native

        s = as_u8(src)
        d = as_writable_u8(dst)
        if d.size < self.max_compressed_length(s.size):
            raise ValueError("output buffer smaller than max_compressed_length")
        return native.snappy_compress(s, d)


class SnappyNativeDecompressor(SnappyDecompressor):
    def __init__(self):
        from .. import native

        native.verify_enabled()

    def decompress_into(self, src: BufferLike, dst: BufferLike) -> int:
        from .. import native

        return native.snappy_decompress(as_u8(src), as_writable_u8(dst))


__all__ = [
    "SnappyCompressor",
    "SnappyDecompressor",
    "SnappyRefCompressor",
    "SnappyRefDecompressor",
    "SnappyNativeCompressor",
    "SnappyNativeDecompressor",
]
