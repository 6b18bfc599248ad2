"""Public block-codec API: the same surface as ``aircompressor_tpu.api``.

The reference's L4 API (reference: Compressor.java:18-36,
Decompressor.java:18-31) in Python:

- ``Compressor.compress(data) -> bytes`` one-shot convenience.
- ``Compressor.compress_into(src, dst) -> int`` zero-copy variant over any
  writable buffer (bytearray / memoryview / numpy array), the analogue of the
  reference's (byte[] | MemorySegment) overload pair.
- ``max_compressed_length(n)`` exact worst-case bound per codec.
- Decompress raises :class:`MalformedInputException` on corrupt input.

Every codec family exposes a ``create()`` factory that picks the faster
host tier available (native C++ > numpy), as the JAX package's factories
do (reference: lz4/Lz4Compressor.java:22-31). No factory picks the card:
the card's batch decoders are ``ops.batch``'s codecs.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Union

import numpy as np

BufferLike = Union[bytes, bytearray, memoryview, np.ndarray]


def as_u8(data: BufferLike) -> np.ndarray:
    """View arbitrary buffer-like input as a 1-D uint8 numpy array (no copy
    where possible)."""
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            data = data.view(np.uint8)
        return np.ascontiguousarray(data).reshape(-1)
    return np.frombuffer(data, dtype=np.uint8)


def as_writable_u8(buf: BufferLike) -> np.ndarray:
    """View a writable buffer as a 1-D uint8 numpy array (never copies)."""
    if isinstance(buf, np.ndarray):
        if not buf.flags.writeable:
            raise ValueError("output buffer is read-only")
        return buf.view(np.uint8).reshape(-1)
    mv = memoryview(buf)
    if mv.readonly:
        raise ValueError("output buffer is read-only")
    return np.frombuffer(mv, dtype=np.uint8)


class Compressor(ABC):
    """One-shot block compressor (reference: Compressor.java:18-36)."""

    @abstractmethod
    def max_compressed_length(self, uncompressed_size: int) -> int:
        """Worst-case compressed size for an input of the given length."""

    @abstractmethod
    def compress_into(self, src: BufferLike, dst: BufferLike) -> int:
        """Compress ``src`` into ``dst``; returns the number of bytes written.

        Raises ValueError if ``dst`` is smaller than ``max_compressed_length``
        requires for the worst case actually encountered.
        """

    def compress(self, src: BufferLike) -> bytes:
        src_u8 = as_u8(src)
        out = np.empty(self.max_compressed_length(src_u8.size), dtype=np.uint8)
        n = self.compress_into(src_u8, out)
        return out[:n].tobytes()


class Decompressor(ABC):
    """One-shot block decompressor (reference: Decompressor.java:18-31)."""

    @abstractmethod
    def decompress_into(self, src: BufferLike, dst: BufferLike) -> int:
        """Decompress ``src`` into ``dst``; returns bytes written.

        Raises :class:`MalformedInputException` on corrupt input.
        """

    def decompress(self, src: BufferLike, max_output_length: int) -> bytes:
        out = np.empty(int(max_output_length), dtype=np.uint8)
        n = self.decompress_into(as_u8(src), out)
        return out[:n].tobytes()
