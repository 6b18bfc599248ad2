"""aircompressor_tpu_torch — the PyTorch and CUDA port of aircompressor_tpu.

Runs the codec suite's device tier on an NVIDIA Hopper card (``sm_90a``):
each kernel that ``aircompressor_tpu`` wrote in Pallas for a TPU is a CUDA
C++ kernel here (``csrc/``), built on first use by ``_build`` and bound with
ctypes, beside a plain PyTorch version that runs for tensors on the CPU. It
imports neither JAX nor ``aircompressor_tpu``: the host code it needs (the
Snappy, LZ4 and LZO reference codecs, the x-snappy-framed walk and a
framer, CRC32-C, the scalar XXH32 and XXH64, the zstd planner with its
header and table readers, the zstd host encoder, and the raw-deflate
planner in C++, built with g++ by ``_build``) is its own copy, in ``host``.

Ported so far: batched Snappy and LZ4 block decode (with their loop
counts) and encode, the r2 Snappy decode of the JAX package's ablation,
batched LZO1X, raw-deflate and zstd decode, zstd compress, XXH64, XXH32,
CRC32-C and the per-kernel profiling (``ops``); the
user surface ``ops.batch`` (``SnappyBatchCodec`` and ``Lz4BatchCodec`` with
``compress_chunks`` and ``decompress_chunks``, ``LzoBatchCodec`` and
``DeflateBatchCodec`` with ``decompress_chunks`` on the card and
``compress_chunks`` on the host, ``ZstdBatchCodec.decompress_chunks``, and
``snappy_framed_decompress_device``); the main-path entry ``entry.entry``.
Entry points run on the card unless given ``device="cpu"``. ``data`` holds
the fixtures of the checks.

The JAX package's user surface, on the host as it is there: the block API
(``api``) and its names at the top level, the codec families with their
``create()`` factories (``snappy``, ``lz4``, ``lzo``, ``zstd``, ``deflate``,
``bzip2``, ``xxhash`` with XXH3, ``crc``) and ``gzip``, the native tier
(``native``: the block codecs and hashes of ``host/native``, and the system
libzstd and libdeflate), the frame and stream formats (``snappy.framed``,
``lz4.frame``, ``lz4.frame_codec``, ``lz4.streams``, ``lzo.lzop``,
``zstd.frame_dec``, ``zstd.streams``), and the Hadoop layer (``hadoop``).
No ``create()`` picks the card.
"""

from .api import BufferLike, Compressor, Decompressor
from .errors import IncompatiblePlatformException, MalformedInputException

__version__ = "0.1.0"

__all__ = [
    "BufferLike",
    "Compressor",
    "Decompressor",
    "IncompatiblePlatformException",
    "MalformedInputException",
]

SUBMODULES = ("api", "bzip2", "crc", "data", "deflate", "entry", "errors", "gzip",
              "hadoop", "host", "lz4", "lzo", "native", "ops", "snappy", "xxhash", "zstd")


def __getattr__(name):
    """Lazy submodule access: aircompressor_tpu_torch.ops / entry / lz4 / ..."""
    import importlib

    if name in SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
