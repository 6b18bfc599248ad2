"""Zstandard constants (RFC 8878). Parity target: reference zstd/Constants.java.

The port's copy of ``aircompressor_tpu.zstd.constants``.
"""

import numpy as np

MAGIC = 0xFD2FB528
MAGIC_SKIPPABLE_BASE = 0x184D2A50
MAGIC_SKIPPABLE_MASK = 0xFFFFFFF0
MAGIC_V07 = 0xFD2FB527  # legacy v0.7 (detected, rejected)

MIN_WINDOW_LOG = 10
MAX_WINDOW_LOG = 31
MAX_WINDOW_SIZE = 1 << 23  # decode-side guard (reference: ZstdFrameDecompressor.java:66)

MAX_BLOCK_SIZE = 128 * 1024

# block types
RAW_BLOCK = 0
RLE_BLOCK = 1
COMPRESSED_BLOCK = 2
RESERVED_BLOCK = 3

# literals block types
RAW_LITERALS = 0
RLE_LITERALS = 1
COMPRESSED_LITERALS = 2
TREELESS_LITERALS = 3

# sequence encoding modes
SEQ_PREDEFINED = 0
SEQ_RLE = 1
SEQ_FSE = 2
SEQ_REPEAT = 3

MAX_LL_SYMBOL = 35
MAX_ML_SYMBOL = 52
MAX_OF_SYMBOL = 31  # format limit; window limits make >30 unusable
LL_TABLE_LOG_MAX = 9
ML_TABLE_LOG_MAX = 9
OF_TABLE_LOG_MAX = 8

MIN_SEQUENCES_SIZE = 1
MIN_BLOCK_SIZE = 1 + 1 + 1  # block header + literals header min + seq count

# --- literals-length codes (RFC 8878 §3.1.1.3.2.1.1) -------------------------
LL_BASE = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
     16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
     2048, 4096, 8192, 16384, 32768, 65536],
    dtype=np.int64,
)
LL_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16],
    dtype=np.int64,
)

# --- match-length codes (RFC 8878 §3.1.1.3.2.1.1) ----------------------------
ML_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
     21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
     35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
     4099, 8195, 16387, 32771, 65539],
    dtype=np.int64,
)
ML_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16],
    dtype=np.int64,
)

# --- predefined FSE distributions (RFC 8878 §3.1.1.3.2.2) --------------------
LL_DEFAULT_NORM = np.array(
    [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
     2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1],
    dtype=np.int64,
)
LL_DEFAULT_LOG = 6

ML_DEFAULT_NORM = np.array(
    [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1],
    dtype=np.int64,
)
ML_DEFAULT_LOG = 6

OF_DEFAULT_NORM = np.array(
    [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1],
    dtype=np.int64,
)
OF_DEFAULT_LOG = 5

# repcode initial values (RFC 8878 §3.1.1.5)
REP_INIT = (1, 4, 8)

MAX_HUFFMAN_TABLE_LOG = 12
MAX_FSE_TABLE_LOG = 12  # weights use ≤6; sequences ≤9
