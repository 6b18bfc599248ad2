"""XXH3 64/128-bit — native binding tier.

The port's counterpart of ``aircompressor_tpu.xxhash.xxh3`` (reference:
xxhash/XxHash3Native.java + XxHash3Bindings.java; XXH3 is NATIVE-ONLY in
the reference too — no Java implementation exists). One-shot and streaming
variants over the system libxxhash, found with ``ctypes.util.find_library``;
the struct-return ``XXH128_hash_t`` is declared as a ``ctypes.Structure``
and returned by value. Where libxxhash is absent, ``is_enabled()`` is false
and every call raises. ``AIRCOMPRESSOR_TPU_DISABLE_NATIVE=1`` disables it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import NamedTuple, Optional

_LIB: Optional[ctypes.CDLL] = None
_ERR: Optional[BaseException] = None
_TRIED = False


class XxHash128(NamedTuple):
    """128-bit hash value (reference: xxhash/XxHash128.java record)."""

    low: int
    high: int


class _XXH128Hash(ctypes.Structure):
    _fields_ = [("low64", ctypes.c_uint64), ("high64", ctypes.c_uint64)]


def _try_load() -> None:
    global _LIB, _ERR, _TRIED
    if _TRIED:
        return
    _TRIED = True
    if os.environ.get("AIRCOMPRESSOR_TPU_DISABLE_NATIVE", "") not in ("", "0"):
        _ERR = RuntimeError("native tier disabled")
        return
    name = ctypes.util.find_library("xxhash")
    if not name:
        _ERR = RuntimeError("libxxhash not found")
        return
    try:
        lib = ctypes.CDLL(name)
        lib.XXH3_64bits.restype = ctypes.c_uint64
        lib.XXH3_64bits.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.XXH3_64bits_withSeed.restype = ctypes.c_uint64
        lib.XXH3_64bits_withSeed.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64]
        lib.XXH3_128bits.restype = _XXH128Hash
        lib.XXH3_128bits.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.XXH3_128bits_withSeed.restype = _XXH128Hash
        lib.XXH3_128bits_withSeed.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64]
        # streaming
        lib.XXH3_createState.restype = ctypes.c_void_p
        lib.XXH3_freeState.argtypes = [ctypes.c_void_p]
        lib.XXH3_64bits_reset.argtypes = [ctypes.c_void_p]
        lib.XXH3_64bits_update.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.XXH3_64bits_digest.restype = ctypes.c_uint64
        lib.XXH3_64bits_digest.argtypes = [ctypes.c_void_p]
        lib.XXH3_128bits_reset.argtypes = [ctypes.c_void_p]
        lib.XXH3_128bits_update.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.XXH3_128bits_digest.restype = _XXH128Hash
        lib.XXH3_128bits_digest.argtypes = [ctypes.c_void_p]
        _LIB = lib
    except BaseException as e:  # noqa: BLE001
        _ERR = e


def is_enabled() -> bool:
    _try_load()
    return _LIB is not None


def verify_enabled() -> None:
    _try_load()
    if _LIB is None:
        raise RuntimeError(f"XXH3 native tier unavailable: {_ERR}")


def xxh3_64(data, seed: int = 0) -> int:
    verify_enabled()
    b = bytes(memoryview(data))
    if seed:
        return int(_LIB.XXH3_64bits_withSeed(b, len(b), seed))
    return int(_LIB.XXH3_64bits(b, len(b)))


def xxh3_128(data, seed: int = 0) -> XxHash128:
    verify_enabled()
    b = bytes(memoryview(data))
    h = (
        _LIB.XXH3_128bits_withSeed(b, len(b), seed)
        if seed
        else _LIB.XXH3_128bits(b, len(b))
    )
    return XxHash128(int(h.low64), int(h.high64))


class _StreamingBase:
    """Owns an XXH3 native state; freed deterministically via close()
    (reference pattern: Cleaner-registered freeState,
    xxhash/XxHash64NativeHasher.java:27-52)."""

    def __init__(self):
        verify_enabled()
        self._state = _LIB.XXH3_createState()
        if not self._state:
            raise MemoryError("XXH3_createState failed")

    def close(self) -> None:
        if self._state:
            _LIB.XXH3_freeState(self._state)
            self._state = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class XxHash3Hasher(_StreamingBase):
    """Streaming 64-bit XXH3 (reference: xxhash/XxHash3Hasher.java)."""

    def __init__(self):
        super().__init__()
        _LIB.XXH3_64bits_reset(self._state)

    def update(self, data) -> "XxHash3Hasher":
        b = bytes(memoryview(data))
        _LIB.XXH3_64bits_update(self._state, b, len(b))
        return self

    def digest(self) -> int:
        return int(_LIB.XXH3_64bits_digest(self._state))


class XxHash3Hasher128(_StreamingBase):
    """Streaming 128-bit XXH3 (reference: xxhash/XxHash3Hasher128.java)."""

    def __init__(self):
        super().__init__()
        _LIB.XXH3_128bits_reset(self._state)

    def update(self, data) -> "XxHash3Hasher128":
        b = bytes(memoryview(data))
        _LIB.XXH3_128bits_update(self._state, b, len(b))
        return self

    def digest(self) -> XxHash128:
        h = _LIB.XXH3_128bits_digest(self._state)
        return XxHash128(int(h.low64), int(h.high64))
