"""Raw Snappy blocks through the port, and their references.

``decode`` is the port's main path, ``entry.decode_and_hash``: the batched
Snappy decode, then XXH64 of every decoded chunk. ``encode`` is the batched
Snappy encode, then the masked CRC32-C of every input chunk, as
x-snappy-framed writes it beside each compressed chunk. Each returns the
rows (decoded chunks or blocks), their lengths, ``ok`` and the digests.
"""

from aircompressor_tpu_torch import entry
from aircompressor_tpu_torch.ops import checksum, snappy_encode

from bench_port.reference import blocks, hashes

COMPRESSOR = "snappy"  # the frozen input compressor's codec
# The scan control's window: the Snappy decode kernel's reach in its 4 KB
# window (``ops/snappy_decode.copy_reach``).
CONTROL_WINDOW = 4032
DIGEST_BYTES = {"decode": 8, "encode": 4}


def decode(comp, comp_lens, out_cap):
    r = entry.decode_and_hash(comp, comp_lens, out_cap=out_cap)
    return r["out"], r["out_lens"], r["ok"], r["xxh64"]


def encode(data, lengths):
    comp, comp_lens, ok = snappy_encode.encode(data, lengths)
    return comp, comp_lens, ok, checksum.mask_crc(checksum.crc32c(data, lengths))


def reference_decode(block: bytes, cap: int, window: int | None = None) -> bytes:
    return blocks.snappy_decode(block, cap, window)


def reference_digest(direction: str, rows, lengths):
    if direction == "decode":
        return hashes.xxh64(rows, lengths)
    return hashes.mask_crc(hashes.crc32c(rows, lengths))
