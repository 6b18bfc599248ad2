"""LZO codec family: the port's counterpart of ``aircompressor_tpu.lzo``
(reference: lzo/ package — Java-only tier by license; compatibility codec for
Hadoop LZO data).

- ``LzoCompressor`` / ``LzoDecompressor`` — LZO1X block codec over the numpy
  reference codec ``host/lzo.py`` (reference: lzo/LzoCompressor.java,
  lzo/LzoRawDecompressor.java); ``create()`` has only that tier, as in the
  JAX package, and takes no device: batched LZO decode on the card is
  ``ops.batch.LzoBatchCodec``.
- ``lzop`` module — the LZOP file format (reference:
  lzo/LzopHadoopInputStream.java / LzopHadoopOutputStream.java), on the host.
"""

from __future__ import annotations

from ..api import BufferLike, Compressor, Decompressor, as_u8, as_writable_u8
from ..host import lzo as block_ref


class LzoCompressor(Compressor):
    @staticmethod
    def create() -> "LzoCompressor":
        return LzoCompressor()

    def max_compressed_length(self, uncompressed_size: int) -> int:
        return block_ref.max_compressed_length(uncompressed_size)

    def compress_into(self, src: BufferLike, dst: BufferLike) -> int:
        s = as_u8(src)
        d = as_writable_u8(dst)
        if d.size < self.max_compressed_length(s.size):
            raise ValueError("output buffer smaller than max_compressed_length")
        return block_ref.compress_into(s, d)


class LzoDecompressor(Decompressor):
    @staticmethod
    def create() -> "LzoDecompressor":
        return LzoDecompressor()

    def decompress_into(self, src: BufferLike, dst: BufferLike) -> int:
        return block_ref.decompress_into(as_u8(src), as_writable_u8(dst))


__all__ = ["LzoCompressor", "LzoDecompressor"]
