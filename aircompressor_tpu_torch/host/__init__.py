"""Host-side helpers of the port, in numpy and plain Python.

The port's own copies of the JAX package's JAX-free host code that it
needs: the Snappy and LZ4 block reference codecs (``snappy``, ``lz4``),
the x-snappy-framed walk and a small framer (``framed``), CRC32-C
(``crc32c``) and the scalar XXH32 and XXH64 (``xxhash``). They serve as
oracles in checks and to build inputs; none of them is on the device path.
"""
