"""LZ4 blocks through the port, and their references.

``decode`` is the batched LZ4 decode, then XXH32 (the LZ4 frame format's
content checksum) of every decoded chunk; ``encode`` the batched LZ4
encode, then XXH32 of every input chunk. Each returns the rows (decoded
chunks or blocks), their lengths, ``ok`` and the digests.
"""

from aircompressor_tpu_torch.ops import lz4_decode, lz4_encode, xxhash

from bench_port.reference import blocks, hashes

COMPRESSOR = "lz4"  # the frozen input compressor's codec
# The scan control's window: the LZ4 decode kernel's reach in its 4 KB
# window (``ops/lz4_decode.copy_reach``).
CONTROL_WINDOW = 3840
DIGEST_BYTES = {"decode": 4, "encode": 4}


def decode(comp, comp_lens, out_cap):
    out, out_lens, ok = lz4_decode.decode(comp, comp_lens, out_cap=out_cap)
    return out, out_lens, ok, xxhash.xxh32(out, out_lens)


def encode(data, lengths):
    comp, comp_lens, ok = lz4_encode.encode(data, lengths)
    return comp, comp_lens, ok, xxhash.xxh32(data, lengths)


def reference_decode(block: bytes, cap: int, window: int | None = None) -> bytes:
    return blocks.lz4_decode(block, cap, window)


def reference_digest(direction: str, rows, lengths):
    return hashes.xxh32(rows, lengths)
