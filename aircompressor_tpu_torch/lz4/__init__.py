"""LZ4 codec family: the port's counterpart of ``aircompressor_tpu.lz4``
(reference: lz4/ package).

Tiers, as in the JAX package, both on the host:
- ``Lz4RefCompressor`` / ``Lz4RefDecompressor`` — the numpy reference codec
  (``host/lz4.py``; analogue of Lz4JavaCompressor/Lz4JavaDecompressor);
- ``Lz4NativeCompressor`` / ``Lz4NativeDecompressor`` — the C++ tier
  (``native``; analogue of the reference's FFM bindings to liblz4).

``Lz4Compressor.create()`` / ``Lz4Decompressor.create()`` pick native when
its library loads, else numpy (reference: lz4/Lz4Compressor.java:22-31
native-first factory). They take no device: batched LZ4 on the card is
``ops.batch.Lz4BatchCodec``. ``frame``, ``frame_codec`` and ``streams`` are
the LZ4 frame format, on the host as in the JAX package.
"""

from __future__ import annotations

from ..api import BufferLike, Compressor, Decompressor, as_u8, as_writable_u8
from ..host import lz4 as block_ref


def _check_acceleration(acceleration: int) -> None:
    if not 1 <= acceleration <= 65537:
        raise ValueError(f"acceleration must be in [1, 65537]: {acceleration}")


class Lz4Compressor(Compressor):
    @staticmethod
    def create(acceleration: int = 1) -> "Lz4Compressor":
        from .. import native

        if native.is_enabled():
            return Lz4NativeCompressor(acceleration)
        return Lz4RefCompressor(acceleration)

    def max_compressed_length(self, uncompressed_size: int) -> int:
        return block_ref.max_compressed_length(uncompressed_size)


class Lz4Decompressor(Decompressor):
    @staticmethod
    def create() -> "Lz4Decompressor":
        from .. import native

        if native.is_enabled():
            return Lz4NativeDecompressor()
        return Lz4RefDecompressor()


class Lz4RefCompressor(Lz4Compressor):
    def __init__(self, acceleration: int = 1):
        _check_acceleration(acceleration)
        self.acceleration = acceleration

    def compress_into(self, src: BufferLike, dst: BufferLike) -> int:
        s = as_u8(src)
        d = as_writable_u8(dst)
        if d.size < self.max_compressed_length(s.size):
            raise ValueError("output buffer smaller than max_compressed_length")
        return block_ref.compress_into(s, d, self.acceleration)


class Lz4RefDecompressor(Lz4Decompressor):
    def decompress_into(self, src: BufferLike, dst: BufferLike) -> int:
        return block_ref.decompress_into(as_u8(src), as_writable_u8(dst))


class Lz4NativeCompressor(Lz4Compressor):
    def __init__(self, acceleration: int = 1):
        from .. import native

        native.verify_enabled()
        _check_acceleration(acceleration)
        self.acceleration = acceleration

    def compress_into(self, src: BufferLike, dst: BufferLike) -> int:
        from .. import native

        s = as_u8(src)
        d = as_writable_u8(dst)
        if d.size < self.max_compressed_length(s.size):
            raise ValueError("output buffer smaller than max_compressed_length")
        return native.lz4_compress(s, d, self.acceleration)


class Lz4NativeDecompressor(Lz4Decompressor):
    def __init__(self):
        from .. import native

        native.verify_enabled()

    def decompress_into(self, src: BufferLike, dst: BufferLike) -> int:
        from .. import native

        return native.lz4_decompress(as_u8(src), as_writable_u8(dst))


__all__ = [
    "Lz4Compressor",
    "Lz4Decompressor",
    "Lz4RefCompressor",
    "Lz4RefDecompressor",
    "Lz4NativeCompressor",
    "Lz4NativeDecompressor",
]
