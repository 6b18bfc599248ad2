"""ctypes binding to the system libdeflate: the deflate family's native tier.

The port's counterpart of ``aircompressor_tpu.native.deflate_binding``
(reference: deflate/DeflateNative.java:28-40 — libdeflate_alloc_compressor,
libdeflate_deflate_compress, libdeflate_deflate_compress_bound,
libdeflate_alloc_decompressor, libdeflate_deflate_decompress). The system
libdeflate is looked up at run time with ``ctypes.util.find_library``;
nothing is built. Where it is absent, ``is_enabled()`` is false,
``verify_enabled()`` raises and ``deflate``'s factories pick zlib.
``AIRCOMPRESSOR_TPU_DISABLE_NATIVE=1`` disables it too.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Optional

import numpy as np

from ..errors import MalformedInputException

_LIB: Optional[ctypes.CDLL] = None
_ERR: Optional[BaseException] = None
_TRIED = False


def _try_load() -> None:
    global _LIB, _ERR, _TRIED
    if _TRIED:
        return
    _TRIED = True
    if os.environ.get("AIRCOMPRESSOR_TPU_DISABLE_NATIVE", "") not in ("", "0"):
        _ERR = RuntimeError("native tier disabled")
        return
    name = ctypes.util.find_library("deflate")
    if not name:
        _ERR = RuntimeError("libdeflate not found")
        return
    try:
        lib = ctypes.CDLL(name)
        lib.libdeflate_alloc_compressor.restype = ctypes.c_void_p
        lib.libdeflate_alloc_compressor.argtypes = [ctypes.c_int]
        lib.libdeflate_free_compressor.argtypes = [ctypes.c_void_p]
        lib.libdeflate_deflate_compress.restype = ctypes.c_size_t
        lib.libdeflate_deflate_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
        lib.libdeflate_alloc_decompressor.argtypes = []
        lib.libdeflate_free_decompressor.argtypes = [ctypes.c_void_p]
        lib.libdeflate_deflate_decompress.restype = ctypes.c_int
        lib.libdeflate_deflate_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
        ]
        _LIB = lib
    except BaseException as e:  # noqa: BLE001
        _ERR = e


def is_enabled() -> bool:
    _try_load()
    return _LIB is not None


def verify_enabled() -> None:
    _try_load()
    if _LIB is None:
        raise RuntimeError(f"deflate native tier unavailable: {_ERR}")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def compress(src: np.ndarray, dst: np.ndarray, level: int) -> int:
    verify_enabled()
    comp = _LIB.libdeflate_alloc_compressor(level)
    if not comp:
        raise RuntimeError("libdeflate_alloc_compressor failed")
    try:
        r = _LIB.libdeflate_deflate_compress(comp, _ptr(src), src.size, _ptr(dst), dst.size)
        if r == 0:
            raise ValueError("libdeflate compress: output too small")
        return int(r)
    finally:
        _LIB.libdeflate_free_compressor(comp)


def decompress(src: np.ndarray, dst: np.ndarray) -> int:
    verify_enabled()
    dec = _LIB.libdeflate_alloc_decompressor()
    if not dec:
        raise RuntimeError("libdeflate_alloc_decompressor failed")
    try:
        out_n = ctypes.c_size_t(0)
        r = _LIB.libdeflate_deflate_decompress(
            dec, _ptr(src), src.size, _ptr(dst), dst.size, ctypes.byref(out_n)
        )
        if r != 0:
            raise MalformedInputException(0, f"libdeflate decompress failed: {r}")
        return int(out_n.value)
    finally:
        _LIB.libdeflate_free_decompressor(dec)
