"""ctypes binding to the system libzstd: the zstd family's native tier.

The port's counterpart of ``aircompressor_tpu.native.zstd_binding``: the
reference ships prebuilt libzstd and binds it via FFM downcalls (reference:
zstd/ZstdNative.java:27-41 — ZSTD_compress, ZSTD_decompress,
ZSTD_compressBound, ZSTD_getFrameContentSize, ZSTD_isError). Here the
system libzstd is looked up at run time with ``ctypes.util.find_library``;
where it is absent the tier is disabled and ``zstd`` falls back to its own
codec. ``AIRCOMPRESSOR_TPU_DISABLE_NATIVE=1`` disables it too.
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
    name = ctypes.util.find_library("zstd")
    if not name:
        _ERR = RuntimeError("libzstd not found")
        return
    try:
        lib = ctypes.CDLL(name)
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        _LIB = lib
    except (OSError, AttributeError) as e:  # a library that fails to load or lacks a symbol
        _ERR = e


def is_enabled() -> bool:
    _try_load()
    return _LIB is not None


def verify_enabled() -> None:
    _try_load()
    if _LIB is None:
        raise RuntimeError(f"zstd native tier unavailable: {_ERR}")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def compress(src: np.ndarray, dst: np.ndarray, level: int) -> int:
    verify_enabled()
    r = _LIB.ZSTD_compress(_ptr(dst), dst.size, _ptr(src), src.size, level)
    if _LIB.ZSTD_isError(r):
        raise ValueError(f"ZSTD_compress failed: code {r}")
    return int(r)


def decompress(src: np.ndarray, dst: np.ndarray) -> int:
    verify_enabled()
    r = _LIB.ZSTD_decompress(_ptr(dst), dst.size, _ptr(src), src.size)
    if _LIB.ZSTD_isError(r):
        raise MalformedInputException(0, f"ZSTD_decompress failed: code {r}")
    return int(r)
