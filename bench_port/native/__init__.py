"""The benchmark's own Snappy and LZ4 block compressors (``block_compress.cc``)
and decoders (``block_decode.cc``), built with g++ on first use into
``bench_port/_cache/native/`` and loaded with ctypes. The library's name
carries a hash of the sources and the flags, so an edited source builds
anew and an unchanged one loads what was built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / f
                for f in ("block_compress.cc", "block_decode.cc"))
BUILD_DIR = Path(__file__).resolve().parent.parent / "_cache" / "native"
FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")
CODECS = {"snappy": 0, "lz4": 1}

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for source in SOURCES:
        digest.update(source.read_bytes())
    return BUILD_DIR / f"libbench_compress-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this exact build exists; return its path."""
    lib = library_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("g++ not found: the benchmark's compressors need a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.bench_compress_batch.argtypes = [ctypes.c_int, p, i64, i64, p, i64, p, ctypes.c_int]
        lib.bench_compress_batch.restype = ctypes.c_int
        lib.bench_decompress_batch.argtypes = [ctypes.c_int, p, i64, i64, p, p, i64, p]
        lib.bench_decompress_batch.restype = ctypes.c_int
        _lib = lib
    return _lib


def block_stride(chunk_bytes: int) -> int:
    """Bytes a row of compressed blocks takes: room for the worst case."""
    return -(-(chunk_bytes + chunk_bytes // 6 + 32) // 64) * 64


def compress(codec: str, chunks: np.ndarray,
             unchecked: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Compress each row of a (n, chunk) uint8 array; returns the blocks as
    (n, ``block_stride(chunk)``) uint8, zero past each block, and their
    (n,) int64 lengths. ``unchecked`` makes the control's broken blocks."""
    chunks = np.ascontiguousarray(chunks, np.uint8)
    n, chunk = chunks.shape
    blocks = np.zeros((n, block_stride(chunk)), np.uint8)
    lens = np.zeros(n, np.int64)
    rc = _load().bench_compress_batch(CODECS[codec], chunks.ctypes.data, n, chunk,
                                      blocks.ctypes.data, blocks.shape[1], lens.ctypes.data,
                                      int(unchecked))
    if rc != 0:
        raise RuntimeError(f"bench_compress_batch returned {rc}")
    return blocks, lens


def decompress(codec: str, blocks: np.ndarray, lens: np.ndarray,
               cap: int) -> tuple[np.ndarray, np.ndarray]:
    """Decode row i of a (n, stride) uint8 array, its first ``lens[i]``
    bytes, into row i of a (n, ``cap``) uint8 array; returns it with the
    (n,) int64 decoded lengths, -1 for a block that breaks its format."""
    blocks = np.ascontiguousarray(blocks, np.uint8)
    lens = np.ascontiguousarray(lens, np.int64)
    n, stride = blocks.shape
    out = np.zeros((n, cap), np.uint8)
    out_lens = np.zeros(n, np.int64)
    rc = _load().bench_decompress_batch(CODECS[codec], blocks.ctypes.data, n, stride,
                                        lens.ctypes.data, out.ctypes.data, cap,
                                        out_lens.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"bench_decompress_batch returned {rc}")
    return out, out_lens
