"""Host-side helpers of the port, in numpy and plain Python.

The port's own copies of the JAX package's JAX-free host code that it
needs: the Snappy and LZ4 block reference codecs (``snappy``, ``lz4``),
the x-snappy-framed walk and a small framer (``framed``), CRC32-C
(``crc32c``), the scalar XXH32 and XXH64 (``xxhash``), and the zstd host
decoder, planner and encoder (``zstd``). They serve as oracles in checks
and to build inputs; of them only the zstd planner
(``zstd.device_prep.plan_batch``) is on a device path.
"""
