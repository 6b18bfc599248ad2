"""LZ4 frame Compressor/Decompressor facades, the port's counterpart of
``aircompressor_tpu.lz4.frame_codec`` (reference:
lz4/Lz4FrameCompressor.java, Lz4FrameJavaCompressor.java:23-45 — thin wrappers
binding a block codec into the frame engine)."""

from __future__ import annotations

from ..api import BufferLike, Compressor, Decompressor, as_u8, as_writable_u8
from . import Lz4Compressor, Lz4Decompressor, frame


class Lz4FrameCompressor(Compressor):
    def __init__(self, block_compressor: Lz4Compressor | None = None,
                 block_max_id: int = frame.DEFAULT_BLOCK_MAX_ID,
                 block_checksums: bool = False,
                 content_checksum: bool = False,
                 content_size: bool = False):
        self.block = block_compressor or Lz4Compressor.create()
        self.block_max_id = block_max_id
        self.block_checksums = block_checksums
        self.content_checksum = content_checksum
        self.content_size = content_size

    @staticmethod
    def create(**kw) -> "Lz4FrameCompressor":
        return Lz4FrameCompressor(Lz4Compressor.create(), **kw)

    def max_compressed_length(self, uncompressed_size: int) -> int:
        return frame.max_compressed_length(
            uncompressed_size, self.block_max_id, self.block_checksums,
            self.content_checksum, self.content_size)

    def compress_into(self, src: BufferLike, dst: BufferLike) -> int:
        return frame.compress(
            self.block.compress_into, as_u8(src), as_writable_u8(dst),
            self.block_max_id, self.block_checksums, self.content_checksum,
            self.content_size)


class Lz4FrameDecompressor(Decompressor):
    def __init__(self, block_decompressor: Lz4Decompressor | None = None):
        self.block = block_decompressor or Lz4Decompressor.create()

    @staticmethod
    def create() -> "Lz4FrameDecompressor":
        return Lz4FrameDecompressor(Lz4Decompressor.create())

    def decompress_into(self, src: BufferLike, dst: BufferLike) -> int:
        return frame.decompress(self.block.decompress_into, as_u8(src), as_writable_u8(dst))
