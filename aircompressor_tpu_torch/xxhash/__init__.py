"""xxHash family: the port's counterpart of ``aircompressor_tpu.xxhash``
(reference: xxhash/ package).

The one-shot ``xxh32`` and ``xxh64`` dispatch to the native C++ tier when
its library is built (``native``), else to the scalar tier
(``host/xxhash.py``); the streaming states are the scalar tier's. XXH3 64
and 128, one-shot and streaming, are the system libxxhash's (``xxh3``,
native only, as in the JAX package and the reference). The batched hashes
on the card are ``ops.xxhash``."""

from __future__ import annotations

from ..host.xxhash import XxHash32State, XxHash64State
from ..host.xxhash import xxh32 as _xxh32_scalar
from ..host.xxhash import xxh64 as _xxh64_scalar


def xxh32(data, seed: int = 0) -> int:
    from .. import native

    if native.is_enabled():
        return native.xxh32(data, seed)
    return _xxh32_scalar(data, seed)


def xxh64(data, seed: int = 0) -> int:
    from .. import native

    if native.is_enabled():
        return native.xxh64(data, seed)
    return _xxh64_scalar(data, seed)


from .xxh3 import (  # noqa: E402 — native-only tier, mirrors XxHash3Native
    XxHash3Hasher,
    XxHash3Hasher128,
    XxHash128,
    xxh3_64,
    xxh3_128,
)
from .xxh3 import is_enabled as xxh3_is_enabled  # noqa: E402

__all__ = [
    "xxh32",
    "xxh64",
    "XxHash32State",
    "XxHash64State",
    "xxh3_64",
    "xxh3_128",
    "xxh3_is_enabled",
    "XxHash3Hasher",
    "XxHash3Hasher128",
    "XxHash128",
]
