"""Native (C++) host tier: loader and ctypes bindings.

The port's counterpart of ``aircompressor_tpu.native`` (reference:
internal/NativeLoader.java:64-196, lz4/Lz4Native.java,
snappy/SnappyNative.java, xxhash/XxHash64Bindings.java): a host-side fast
tier behind the same interfaces as the numpy tier, picked by the families'
``create()`` factories, with a graceful fall back to numpy when the library
cannot be built or loaded. It runs on the CPU only.

The sources are ``host/native/*.cc``, copies of the JAX package's; they are
built by ``_build.build_host`` with g++ into the git-ignored ``build/host/``,
one library with the deflate planner, ``-O3`` without ``-march`` (so CRC32-C
takes its software slicing branch rather than SSE4.2; the values are the
same). Kill switch: ``AIRCOMPRESSOR_TPU_DISABLE_NATIVE=1``, the same variable
as the JAX package's (analogue of sysprop
io.airlift.compress.v3.disable-native, reference:
internal/NativeLoader.java:158-160), so one variable governs both packages.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..errors import MalformedInputException

_LIB: Optional[ctypes.CDLL] = None
_LOAD_ERROR: Optional[BaseException] = None
_TRIED = False


def _disabled() -> bool:
    return os.environ.get("AIRCOMPRESSOR_TPU_DISABLE_NATIVE", "") not in ("", "0")


def _try_load() -> None:
    global _LIB, _LOAD_ERROR, _TRIED
    if _TRIED:
        return
    _TRIED = True
    if _disabled():
        _LOAD_ERROR = RuntimeError("native tier disabled by AIRCOMPRESSOR_TPU_DISABLE_NATIVE")
        return
    try:
        from .. import _build

        _LIB = _build.load_host()
    except (OSError, RuntimeError, AttributeError) as e:  # no compiler, a failed
        _LOAD_ERROR = e  # build or load, a missing symbol: NativeLoader's LinkageError


def is_enabled() -> bool:
    _try_load()
    return _LIB is not None


def load_error() -> Optional[BaseException]:
    _try_load()
    return _LOAD_ERROR


def verify_enabled() -> None:
    if not is_enabled():
        raise RuntimeError(f"native tier is not available: {_LOAD_ERROR}")


def _buf(data) -> tuple:
    arr = data if isinstance(data, np.ndarray) else np.frombuffer(memoryview(data), dtype=np.uint8)
    arr = np.ascontiguousarray(arr.view(np.uint8).reshape(-1))
    return arr, arr.ctypes.data, arr.size


def xxh32(data, seed: int = 0) -> int:
    verify_enabled()
    _, p, n = _buf(data)
    return int(_LIB.actpu_xxh32(p, n, seed & 0xFFFFFFFF))


def xxh64(data, seed: int = 0) -> int:
    verify_enabled()
    _, p, n = _buf(data)
    return int(_LIB.actpu_xxh64(p, n, seed & 0xFFFFFFFFFFFFFFFF))


def crc32c(data, crc: int = 0) -> int:
    verify_enabled()
    _, p, n = _buf(data)
    return int(_LIB.actpu_crc32c(p, n, crc & 0xFFFFFFFF))


def lz4_compress(src: np.ndarray, dst: np.ndarray, acceleration: int = 1) -> int:
    verify_enabled()
    _, sp, sn = _buf(src)
    _, dp, dn = _buf(dst)
    r = int(_LIB.actpu_lz4_compress(sp, sn, dp, dn, acceleration))
    if r < 0:
        raise ValueError(f"native lz4 compress failed ({r})")
    return r


def lz4_decompress(src: np.ndarray, dst: np.ndarray) -> int:
    verify_enabled()
    _, sp, sn = _buf(src)
    _, dp, dn = _buf(dst)
    r = int(_LIB.actpu_lz4_decompress(sp, sn, dp, dn))
    if r < 0:
        raise MalformedInputException(-r - 1, "native lz4 decompress failed")
    return r


def snappy_compress(src: np.ndarray, dst: np.ndarray) -> int:
    verify_enabled()
    _, sp, sn = _buf(src)
    _, dp, dn = _buf(dst)
    r = int(_LIB.actpu_snappy_compress(sp, sn, dp, dn, 0))
    if r < 0:
        raise ValueError(f"native snappy compress failed ({r})")
    return r


def snappy_decompress(src: np.ndarray, dst: np.ndarray) -> int:
    verify_enabled()
    _, sp, sn = _buf(src)
    _, dp, dn = _buf(dst)
    r = int(_LIB.actpu_snappy_decompress(sp, sn, dp, dn))
    if r < 0:
        raise MalformedInputException(-r - 1, "native snappy decompress failed")
    return r
