"""Zstd codec family: the port's counterpart of ``aircompressor_tpu.zstd``
(reference: zstd/ package).

Tiers, as in the JAX package, both on the host:
- ``ZstdRefCompressor`` / ``ZstdRefDecompressor`` — own-implementation tier
  (analogue of ZstdJavaCompressor/ZstdJavaDecompressor; compression supports
  the default level-3 pipeline, like the reference's Java path —
  reference: zstd/ZstdCompressor.java:25-43).
- ``ZstdNativeCompressor`` / ``ZstdNativeDecompressor`` — bindings to the
  official libzstd (analogue of zstd/ZstdNative.java FFM downcalls), all
  levels supported.

``create()`` factories are native-first with graceful fallback
(reference: zstd/ZstdCompressor.java create()). They take no device:
batched zstd on the card is ``ops.batch.ZstdBatchCodec``. The own tier is
the host encoder (``host/zstd/frame_enc.py``) and the host frame decoder
(``frame_dec``); ``streams`` are the streaming codecs.
"""

from __future__ import annotations

from ..api import BufferLike, Compressor, Decompressor, as_u8, as_writable_u8
from ..host.zstd import frame_enc
from . import frame_dec

DEFAULT_LEVEL = 3
MAX_LEVEL = 22


def _native():
    from ..native import zstd_binding

    return zstd_binding if zstd_binding.is_enabled() else None


class ZstdCompressor(Compressor):
    @staticmethod
    def create(level: int = DEFAULT_LEVEL) -> "ZstdCompressor":
        nb = _native()
        if nb is not None:
            return ZstdNativeCompressor(level)
        return ZstdRefCompressor(level)

    def max_compressed_length(self, uncompressed_size: int) -> int:
        return frame_enc.max_compressed_length(uncompressed_size)


class ZstdDecompressor(Decompressor):
    @staticmethod
    def create() -> "ZstdDecompressor":
        nb = _native()
        if nb is not None:
            return ZstdNativeDecompressor()
        return ZstdRefDecompressor()

    @staticmethod
    def get_decompressed_size(data: BufferLike) -> int:
        return frame_dec.get_decompressed_size(as_u8(data))


class ZstdRefCompressor(ZstdCompressor):
    def __init__(self, level: int = DEFAULT_LEVEL):
        if not 0 <= level <= MAX_LEVEL:
            raise ValueError(f"level must be in [0, {MAX_LEVEL}]: {level}")
        self.level = level or DEFAULT_LEVEL

    def compress_into(self, src: BufferLike, dst: BufferLike) -> int:
        s = as_u8(src)
        d = as_writable_u8(dst)
        return frame_enc.compress(s, d, self.level)


class ZstdRefDecompressor(ZstdDecompressor):
    def decompress_into(self, src: BufferLike, dst: BufferLike) -> int:
        return frame_dec.decompress(as_u8(src), as_writable_u8(dst))


class ZstdNativeCompressor(ZstdCompressor):
    def __init__(self, level: int = DEFAULT_LEVEL):
        from ..native import zstd_binding

        zstd_binding.verify_enabled()
        if not 0 <= level <= MAX_LEVEL:
            raise ValueError(f"level must be in [0, {MAX_LEVEL}]: {level}")
        self.level = level

    def compress_into(self, src: BufferLike, dst: BufferLike) -> int:
        from ..native import zstd_binding

        return zstd_binding.compress(as_u8(src), as_writable_u8(dst), self.level)


class ZstdNativeDecompressor(ZstdDecompressor):
    def decompress_into(self, src: BufferLike, dst: BufferLike) -> int:
        from ..native import zstd_binding

        return zstd_binding.decompress(as_u8(src), as_writable_u8(dst))


__all__ = [
    "ZstdCompressor",
    "ZstdDecompressor",
    "ZstdRefCompressor",
    "ZstdRefDecompressor",
    "ZstdNativeCompressor",
    "ZstdNativeDecompressor",
]
