"""The x-snappy-framed stream format (snappy framing_format.txt), host side.

The format's constants and its one walk and one chunk writer, shared by the
device decode (``ops.batch.snappy_framed_decompress_device``) and the
streams of ``snappy.framed``. ``iter_frames`` is a copy of
``aircompressor_tpu.snappy.framed.iter_frames``. ``data_chunk`` writes one
data chunk (kept uncompressed unless it shrinks below 0.85 of its size,
masked CRC32-C of the uncompressed bytes first). ``compress_framed`` is the
batch framer: it writes a stream the way
``aircompressor_tpu.snappy.framed.compress_framed`` does with its defaults
(64 KB chunks), with every chunk compressed in one call of a batch
compressor. ``chunk_spans`` lists where each chunk of a stream starts, for
checks that alter one chunk.
"""

from __future__ import annotations

from typing import Callable, Sequence

from ..errors import MalformedInputException
from . import snappy
from .crc32c import crc32c_raw, mask_crc

HEADER = bytes([0xFF, 0x06, 0x00, 0x00]) + b"sNaPpY"
COMPRESSED_CHUNK = 0x00
UNCOMPRESSED_CHUNK = 0x01
PADDING_CHUNK = 0xFE
STREAM_IDENTIFIER = 0xFF

MAX_UNCOMPRESSED_CHUNK = 65536
MIN_COMPRESSION_RATIO = 0.85


def chunk(kind: int, body: bytes) -> bytes:
    """One chunk: its kind byte, 3-byte little-endian length, then body."""
    n = len(body)
    return bytes([kind, n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF]) + body


def data_chunk(block: bytes, blob: bytes, crc: int,
               min_ratio: float = MIN_COMPRESSION_RATIO) -> bytes:
    """The data chunk of ``block``: its Snappy block ``blob`` if that is
    below ``min_ratio`` of the block's size, else the block stored; ``crc``
    (the masked CRC32-C, or 0) comes first."""
    head = crc.to_bytes(4, "little")
    if len(blob) < len(block) * min_ratio:
        return chunk(COMPRESSED_CHUNK, head + blob)
    return chunk(UNCOMPRESSED_CHUNK, head + block)


def compress_framed(data: bytes,
                    compress_chunks: Callable[[Sequence[bytes]], list[bytes]] | None = None
                    ) -> bytes:
    """An x-snappy-framed stream of ``data``. ``compress_chunks`` maps a list
    of blocks to their Snappy blocks (default: the host reference codec,
    one block at a time)."""
    step = MAX_UNCOMPRESSED_CHUNK
    blocks = [data[i:i + step] for i in range(0, len(data), step)]
    if compress_chunks is None:
        blobs = [snappy.compress(b) for b in blocks]
    else:
        blobs = compress_chunks(blocks)
    return HEADER + b"".join(
        data_chunk(block, blob, mask_crc(crc32c_raw(block)))
        for block, blob in zip(blocks, blobs, strict=True))


def chunk_spans(stream: bytes) -> list[tuple[int, int]]:
    """(kind byte, offset) of every chunk after the stream's header."""
    spans, pos = [], len(HEADER)
    while pos < len(stream):
        spans.append((stream[pos], pos))
        pos += 4 + int.from_bytes(stream[pos + 1:pos + 4], "little")
    return spans


def iter_frames(data: bytes):
    """Walk an x-snappy-framed byte string, yielding
    ("compressed" | "uncompressed", payload_bytes, masked_crc) per data
    chunk."""
    if data[: len(HEADER)] != HEADER:
        raise MalformedInputException(0, "invalid snappy framed stream header")
    pos = len(HEADER)
    n = len(data)
    while pos < n:
        if pos + 4 > n:
            raise MalformedInputException(pos, "truncated chunk header")
        kind = data[pos]
        length = data[pos + 1] | (data[pos + 2] << 8) | (data[pos + 3] << 16)
        pos += 4
        if pos + length > n:
            raise MalformedInputException(pos, "truncated chunk")
        body = data[pos : pos + length]
        pos += length
        if kind == STREAM_IDENTIFIER:
            if body != HEADER[4:]:
                raise MalformedInputException(pos, "invalid stream identifier chunk")
            continue
        if kind == PADDING_CHUNK or 0x80 <= kind <= 0xFD:
            continue
        if 0x02 <= kind <= 0x7F:
            raise MalformedInputException(pos, f"unskippable reserved chunk 0x{kind:02x}")
        if length < 4:
            raise MalformedInputException(pos, "chunk too short for checksum")
        crc = int.from_bytes(body[:4], "little")
        yield ("uncompressed" if kind == UNCOMPRESSED_CHUNK else "compressed",
               body[4:], crc)
