"""Host-side helpers of the port, in numpy and plain Python.

The port's own copies of the JAX package's JAX-free host code that it
needs: the Snappy, LZ4 and LZO1X block reference codecs (``snappy``,
``lz4``, ``lzo``), the own bzip2 engine (``bzip2``), the x-snappy-framed
walk and a small framer (``framed``), CRC32-C (``crc32c``), the scalar XXH32 and XXH64
(``xxhash``), the zstd host decoder, planner and encoder (``zstd``), and
the raw-deflate planner (``deflate``: C++ built with g++, and its numpy
side). They serve as oracles in checks and to build inputs; on device
paths are the zstd planner (``zstd.device_prep.plan_batch``), the deflate
planner (``deflate.plan.plan``) and, for ``LzoBatchCodec.compress_chunks``,
the LZO encoder.
"""

__all__ = ["bzip2", "crc32c", "deflate", "framed", "lz4", "lzo", "snappy", "xxhash", "zstd"]
