"""Zstd compression level table for the own tier.

The port's copy of ``aircompressor_tpu.zstd.params``.

Analogue of the reference's ``CompressionParameters.compute()``
(zstd/CompressionParameters.java:40-145, 256-299): the level table maps a
level + input size to match-finder parameters, shrunk for small inputs.
The PARAMETERS differ because the matcher differs — the own tier's
argsort-predecessor finder (zstd/block_enc.py) is tuned by hash width,
chain depth, and whether the second (long) hash runs, rather than the
reference's chainLog/searchLog over mutable hash chains. Strategy names
map roughly: depth 1 + single hash ≈ FAST, depth 2 + dual hash ≈ DFAST
(the only strategy the reference's Java tier implements), deeper chains ≈
GREEDY/LAZY territory.
"""

from __future__ import annotations

from dataclasses import dataclass

DEFAULT_COMPRESSION_LEVEL = 3
MAX_COMPRESSION_LEVEL = 22


@dataclass(frozen=True)
class CompressionParameters:
    window_log: int  # frame-header window (single-segment frames clamp this)
    hash_log: int  # bits of the argsort hash
    depth: int  # predecessor-chain candidates per hash
    use_long_hash: bool  # run the 8-byte hash alongside the 5-byte one


# level → (window_log, hash_log, depth, use_long_hash); the default
# (≥256KB) size class. Levels ≤ 0 clamp to 1 like the reference treats 0
# as DEFAULT; levels > 22 clamp to 22.
_TABLE = {
    1: (19, 15, 1, False),
    2: (19, 16, 1, False),
    3: (21, 17, 2, True),
    4: (21, 17, 3, True),
    5: (21, 18, 3, True),
    6: (21, 18, 4, True),
    7: (21, 19, 4, True),
    8: (21, 19, 6, True),
    9: (22, 20, 6, True),
    10: (22, 20, 8, True),
    11: (22, 20, 8, True),
    12: (22, 20, 10, True),
    13: (22, 20, 10, True),
    14: (22, 20, 12, True),
    15: (22, 21, 12, True),
    16: (22, 21, 14, True),
    17: (23, 21, 14, True),
    18: (23, 21, 16, True),
    19: (23, 22, 16, True),
    20: (23, 22, 20, True),
    21: (23, 22, 24, True),
    22: (23, 22, 32, True),
}


def compute(level: int, input_size: int | None = None) -> CompressionParameters:
    """Resolve a level to parameters, shrinking tables for small inputs
    (pattern: CompressionParameters.compute's size-class adjustment)."""
    if level <= 0:
        level = DEFAULT_COMPRESSION_LEVEL
    level = min(level, MAX_COMPRESSION_LEVEL)
    window_log, hash_log, depth, use_long = _TABLE[level]
    if input_size:
        # no point hashing wider than the input has positions
        size_log = max(int(input_size - 1).bit_length(), 10)
        hash_log = min(hash_log, size_log)
        window_log = min(window_log, size_log)
    return CompressionParameters(window_log, hash_log, depth, use_long)
