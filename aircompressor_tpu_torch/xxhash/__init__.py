"""xxHash family: the port's counterpart of ``aircompressor_tpu.xxhash``
(reference: xxhash/ package).

The one-shot ``xxh32`` and ``xxh64`` dispatch to the native C++ tier when
its library is built (``native``), else to the scalar tier
(``host/xxhash.py``); the streaming states are the scalar tier's. XXH3
(``aircompressor_tpu.xxhash.xxh3``) is not ported yet. The batched hashes
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


__all__ = ["xxh32", "xxh64", "XxHash32State", "XxHash64State"]
