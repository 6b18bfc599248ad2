"""Drive the port's paths once on an NVIDIA GPU and check every result.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds the CUDA kernels of ``aircompressor_tpu_torch`` from ``csrc/`` and
holds each kernel against its plain PyTorch version on the card, the encode
kernels on short cases and on 64 KB rows as the compress paths give them.
Then it drives its paths over a generated corpus of 256 chunks of 64 KB
(16 MB), each with the kernels' launch counts set to 0 just before it and
read just after:

- compress: ``SnappyBatchCodec.compress_chunks`` on the corpus, and the
  corpus tiled 16 times on the device (4096 chunks, 256 MB) through the
  encode kernel;
- decode: ``decompress_chunks`` on the corpus's blocks, and the tiled
  blocks through the decode and xxh64 kernels (``entry.decode_and_hash``);
- r2 decode: the corpus's 256 blocks, then the 4096 tiled blocks, through
  the r2 Snappy decode kernel (``snappy_decode_r2.decode``) with its step
  counts, every byte held to the corpus and to the decode kernel's output;
- framed: an x-snappy-framed stream of the corpus through
  ``snappy_framed_decompress_device``;
- families: the block API, native tier and stream formats on the host
  over the corpus's first 32 chunks, their LZ4 and LZO blocks and zstd
  frames through the batch decoders and a ``SnappyFramedOutputStream``
  through ``snappy_framed_decompress_device`` (``families_phase``);
- compat: the deflate family (zlib level 4, and libdeflate at levels 1, 4
  and 12 where the machine has it) on the corpus, a gzip member a chunk
  and the Hadoop layer's Snappy, LZ4, LZO and DefaultCodec streams over
  the first 32 chunks, their deflate bodies and blocks through
  ``DeflateBatchCodec``, ``SnappyBatchCodec``, ``Lz4BatchCodec`` and
  ``LzoBatchCodec``, every gzip CRC-32 and ISIZE and every Adler-32 held
  to the card's bytes; bzip2 (libbz2, and the own engine on 512 KB) and
  XXH3 on the host (``compat_phase``);
- LZ4: ``Lz4BatchCodec.compress_chunks`` and ``decompress_chunks`` on the
  corpus, and the corpus tiled 16 times through the LZ4 encode kernel, the
  LZ4 decode kernel and the xxh32 kernel;
- zstd: the corpus through the port's host encoder at level 3,
  ``ZstdBatchCodec.decompress_chunks`` on its frames, then the frames tiled
  16 times, planned once, through the Huffman, FSE and execute kernels and
  the xxh64 kernel;
- LZO: ``LzoBatchCodec.compress_chunks`` (the host encoder) and
  ``decompress_chunks`` on the corpus, then its blocks tiled 16 times
  through the LZO decode kernel and the xxh64 kernel;
- deflate: ``DeflateBatchCodec.compress_chunks`` (zlib level 6) and
  ``decompress_chunks`` on the corpus, then its streams planned once (the
  C++ planner, built with g++), plan and streams tiled 16 times, through
  the deflate decode kernel and the xxh64 kernel;
- zstd compress: ``ZstdBatchCodec(level=3).compress_chunks`` on the corpus
  (the DFAST matcher kernel, the host planner, the emission kernel and the
  xxh64 kernel), every frame decoded back through the zstd decode kernels
  and its size held to the host encoder's; the same batch stage by stage
  on the host clock; then the corpus tiled 16 times through the DFAST
  kernel and its packed plans tiled through the emission kernel;
- mesh: the corpus tiled 16 times through a mesh over every card (``cuda:0``)
  (``pipeline.sharded_checksum_step``, ``sharded_compress`` then
  ``sharded_decompress``: the xxh64, xxh32, CRC32-C, Snappy encode and
  decode kernels), every output, length, flag and total equal to the
  unsharded calls; ``dryrun_multichip`` over every card; a world of one
  NCCL rank in this process through ``multihost``'s distributed steps; and
  a world of two gloo ranks on the one card, as subprocesses with a
  ``file://`` store, half of the tiled chunks each (NCCL refuses two ranks
  on one card), their global totals and local results held to the mesh's
  and every local row decoded on the host.

The three zstd kernels are first held against their plain versions on a
batch of frames from the host encoder, the libzstd fixture (multi-block
frames whose sequences use repeat offsets of earlier blocks) and malformed
frames, and on a batch of 64 KB corpus chunks through the host encoder at
level 3, as the zstd path gives them; the Huffman kernel also on
hand-made streams (codes of one length, tables of log 11 and 12, a short
stream, bits left, a stream read past its start, a broken walk) and both
batches at each launch setting it times and at sub-ranges of 32 and 96
bits, and the execute kernel's two windows (257 and 793 frames; out_cap
4093 too at 257) on hand-built round cases (overlapping matches, offsets
at each reach +- 1, blocks of 31 to 65 sequences, every piece kind, bad
sequences in either round, lengths near 2^31, output at and past out_cap
4093); both windows of the LZ4 decode kernel (257 and 793 rows of an odd
width) on its cases, 64 KB blocks and hand-built window cases (matches at
each reach +- 1, offsets 65,520 and 65,535, a 64 KB literal, extensions
over ring slices, overlapping matches at dist 1-63, matches that read
their own literals, a match extended to the 64 KB limit and past it) at
out_cap 65536, 4096 and 4093, steps included; the xxh32 kernel at 1, 7,
257, 529, 1,057 and 2,113 rows of 64 KB and 65,533 B at every seed; the
LZO and deflate kernels likewise, on synthetic, edge, malformed and 64 KB chunks,
the LZO kernel's two windows (257 and 793 rows) on its hand-built window
cases (matches at each reach +- 1, an M4 of dist 49,151, every command
family with 0-3 trailing literals, a 64 KB literal, 300-byte zero runs) at
out_cap 65536 (4096 and 4093 too at 257 rows), and the deflate kernel's two
instantiations
(257 and 661 rows) on its window and table-slot cases;
the DFAST matcher kernel with its step counts on its edge cases, two
hand-built round chunks (tiled to 3 and 397 rows) and six 64 KB chunks,
and the emission kernel on their plans, a one-sequence plan, a row with
nseq 0, a row of random fields and an overflowing row; the xxHash kernels at nonzero seeds, and xxh64 at 1, 7 and 257
rows of 64 KB and 65,531 B; the r2 Snappy decode kernel on 45 rows in two
groups of 32 (synthetic, malformed and 64 KB corpus blocks) at out_cap
65536 and 4096, steps included, and each row alone against its own count,
and both of its windows (257 and 793 rows of an odd width) on those rows
and its hand-built window cases (copies at each reach - 1, reach and reach
+ 1, dist 65,535, dist-1 and dist-3 runs, literals across ring slices) at
out_cap 65536, 4096 and 4093, also against kernel #1; the zstd FSE kernel
on hand-built sections (tables at logs
9/8/9 and the predefined ones, RLE tables, one sequence, an OF code above
23, a repeat offset of 0, reads below the start and past the input, three
sections a frame, a frame without one), on a 64 KB frame of short
matches with the libzstd fixture and on the zstd path's 256 and 4096
frames (the r2 kernel likewise on its path's chunks);
both output windows of the Snappy decode kernel on its window cases (a 64
KB dist-1 run, a 64 KB literal, copies at each window's reach +- 1) at
out_cap 65536 and 4093, 257 and 793 rows of an odd width and each row
alone; the step counts of the Snappy and LZ4 decode, the LZO and deflate
decode and the Snappy and LZ4 encode kernels, the encoders' also on their
hand-built round chunks (tiled to 3 and 793 rows), on 64 KB rows and on
the corpus; the CRC32-C kernel against its plain version and the host on a
length grid (0-35, 63-65, 4095-4097 and 65,536 bytes) at widths 65,536,
65,531 and 4,096 at a base one byte past alignment. It prints the share of the corpus's Snappy, deflate, LZO and
LZ4 copies and zstd matches within each window's reach, the DFAST, deflate,
LZO, LZ4 decode and encode kernels' ns a step of the corpus's longest
chain, the xxh32 kernel's time on one 64 KB stream alone, the zstd
execute and FSE kernels' ns a sequence of the longest frame (the FSE
kernel's also its waves and the frame alone), the r2 decode's ns a window
of its longest group (and the chunk alone) and the zstd Huffman
and emission kernels' ns a symbol of the longest stream, the encode kernels' times at
five shared-memory carveouts and the Huffman kernel's at its launch
settings, and the Huffman and emission kernels alone (device time from a
profiler trace) beside their wrappers' times. Every
byte and hash is checked against the originals and the port's host
reference codecs. After the times it runs ``profiling.kernel_rows`` and a
``profiling.trace`` of both Snappy decode kernels, whose trace file must
name both. It prints the card's name and power limit, kernel and
plain times, then one JSON line of per-kernel results, and last ``{"ok":
true, "device": {...}}``. Any failed check raises, so the exit code is not
0 and that last line is not printed. With no CUDA device it fails at once;
there is no CPU path. It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import time
import zlib
from pathlib import Path

import numpy as np
import torch

CHUNK = 65536
N_CHUNKS = 256  # the generated corpus: 256 chunks of 64 KB, 16 MB
SUSTAIN = 16  # device-side tiling of the corpus: 4096 chunks, 256 MB
ENC_CUT = 8192  # the cut of the synthetic encode cases
ZSTD_CUT = 8192  # the cut of the synthetic zstd decode cases
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
RATIO_LIMIT = 1.03  # encode size against the host reference compressor
ZSTD_RATIO_LIMIT = 1.04  # zstd compress size against the host encoder's frames
                         # (the JAX package's bound, tests/test_zstd_encode.py:231)
DFAST_CUT = 8192  # the cut of the DFAST matcher's edge cases
# The DFAST repeat case: random bytes with [A, A + M) a copy of the bytes D
# before it, G fresh bytes, then [B, B + M2) again a copy from D before.
REP_A, REP_D, REP_M, REP_G, REP_M2 = 2991, 1500, 300, 100, 200
XXH_SEEDS = (0, 1, 0x9E3779B1)  # and 2^64 - 1 (XXH64) or 2^32 - 1 (XXH32)
XXH_SEED_LENGTHS = (0, 3, 31, 32, 33, 1000)
LZ4_RATIO_LIMIT = 1.01  # LZ4 encode size against the host LZ4 compressor on 16
                        # chunks: encode_plain's 1.000624 on the CPU, rounded up
BAD_CRC_BLOCK = 10  # the framed block whose CRC is flipped ...
BAD_CRC_INDEX = 9  # ... and its index among the compressed chunks (block 4
                   # is stored uncompressed), which the decode must report


def synthetic_cases() -> list[tuple[str, bytes]]:
    """The synthetic inputs of tests/conftest.py::synthetic_cases."""
    rng = np.random.default_rng(0)
    return [
        ("empty", b""),
        ("one-byte", b"X"),
        ("short", b"hello world"),
        ("zeros", bytes(10000)),
        ("ones-rle", b"\x01" * 4096),
        ("random-incompressible", rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()),
        ("repeated-pattern", b"abcdefgh" * 8192),
        ("small-period", b"ab" * 5000),
        ("alternating", bytes(bytearray([i & 0xFF for i in range(70000)]))),
        ("text", (b"The quick brown fox jumps over the lazy dog. " * 2000)),
    ]


def malformed_cases(compress) -> list[bytes]:
    """Truncated, copy before any output, declared length > 64 KB (the cases
    of tests/test_pallas_kernels.py, on generated text)."""
    text = (b"The quick brown fox jumps over the lazy dog. 0123456789 "
            * 600)[:30000]
    blob = compress(text)
    return [blob[: len(blob) // 2], blob[:1] + b"\x01\x00" + blob[3:],
            b"\xfe\xff\xff\xff\x0f" + blob[5:]]


# Malformed Snappy blocks of the r2 comparisons: a truncated literal, dist 0,
# dist > op, a 4-byte offset with a high byte, a declared length with bit 31
# set (the r2 kernel's first token fails) and one of 65537 (rejected at
# once), a varint longer than the chunk, and last a 4-byte literal length of
# 0xFFFFFFFF, which the port rejects (ROADMAP F10).
R2_MALFORMED = [
    b"\x0a\x24abcd", b"\x08\x0cabcd\x01\x00", b"\x08\x0cabcd\x01\x09",
    b"\x08\x0cabcd\x0f\x04\x00\x00\x01", b"\xfe\xff\xff\xff\x0f\x0cabcd",
    b"\x81\x80\x04\x0cabcd", b"\x80\x80\x80", b"\x05\xfc\xff\xff\xff\xff\x04abc"]
R2_CORPUS_ROWS = [0, 1, 2, 3] + list(range(4, N_CHUNKS, 13))[:20]  # 24 corpus blocks


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 128:
        out.append((n & 127) | 128)
        n >>= 7
    return bytes(out + bytes([n]))


def snappy_literal(data: bytes) -> bytes:
    """One Snappy literal token of data (1 to 2^32 bytes)."""
    n = len(data) - 1
    if n < 60:
        return bytes([n << 2]) + data
    extra = (n.bit_length() + 7) // 8
    return bytes([(59 + extra) << 2]) + n.to_bytes(extra, "little") + data


def snappy_copy(length: int, dist: int) -> bytes:
    """One Snappy copy token with a 2-byte offset (length 1 to 64)."""
    return bytes([2 | ((length - 1) << 2)]) + dist.to_bytes(2, "little")


def snappy_window_cases() -> list[tuple[str, bytes]]:
    """Hand-built Snappy blocks for the decode kernel's window and input
    ring: a 64 KB run of dist-1 copies, one 64 KB literal, copies at dists
    just below, at and just above each window's reach and size, and a mixed
    block of literals (some longer than the input ring) and copies at every
    kind of dist, up to 64 KB."""
    from aircompressor_tpu_torch.ops.snappy_decode import WINDOWS, copy_reach

    rng = np.random.default_rng(8)

    def block(tokens: list[bytes], n: int) -> bytes:
        return _varint(n) + b"".join(tokens)

    def noise(n: int) -> bytes:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    cases = [("dist1-64k", block([snappy_literal(b"a")] + [snappy_copy(64, 1)] * 1023
                                 + [snappy_copy(63, 1)], CHUNK)),
             ("literal-64k", block([snappy_literal(noise(CHUNK))], CHUNK))]
    for window in WINDOWS:
        reach = copy_reach(window)
        tokens, n = [snappy_literal(noise(window + 200))], window + 200
        for dist in (reach - 1, reach, reach + 1, reach + 30, window - 1, window,
                     window + 1, window + 63):
            lit = noise(1 + dist % 7)
            tokens += [snappy_literal(lit), snappy_copy(64, dist), snappy_copy(37, dist + 5),
                       snappy_copy(9, 3)]
            n += len(lit) + 64 + 37 + 9
        cases.append((f"straddle-{window}", block(tokens, n)))
    tokens, n = [snappy_literal(noise(100))], 100
    while True:
        if rng.random() < 0.3:
            length = int(rng.integers(1, 200)) if rng.random() < 0.9 else int(rng.integers(600, 3000))
            if n + length > CHUNK:
                break
            tokens.append(snappy_literal(noise(length)))
        else:
            length = int(rng.integers(4, 65))
            near = [copy_reach(w) + int(rng.integers(-40, 40)) for w in WINDOWS]
            dist = min(n, int(rng.choice([rng.integers(1, 64), rng.integers(64, 4032),
                                          rng.integers(1, n + 1), *near])))
            if n + length > CHUNK:
                break
            tokens.append(snappy_copy(length, max(dist, 1)))
        n += length
    cases.append(("mixed", block(tokens, n)))
    return cases


def r2_window_cases() -> list[tuple[str, bytes]]:
    """Hand-built Snappy blocks for the r2 decode kernel's input ring and
    output windows: copies at each window's reach - 1, reach and reach + 1
    (reach = window - window / 16), a copy at dist 65,535, dist-1 and dist-3
    runs that double, and literals across input-ring slices (one of 3,000
    bytes at an odd input offset, one of 62,467)."""
    from aircompressor_tpu_torch.ops.snappy_decode_r2 import WINDOWS, copy_reach

    rng = np.random.default_rng(12)

    def noise(n: int) -> bytes:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def block(tokens: list[bytes]) -> bytes:
        n = 0
        for t in tokens:  # a literal's length is its bytes; a copy's its tag
            n += len(t) - (1 + max((t[0] >> 2) - 59, 0)) if t[0] & 3 == 0 else (t[0] >> 2) + 1
        return _varint(n) + b"".join(tokens)

    cases = []
    for window in WINDOWS:
        reach = copy_reach(window)
        tokens = [snappy_literal(noise(reach + 300))]
        for dist in (reach - 1, reach, reach + 1):
            tokens += [snappy_literal(noise(1 + dist % 5)), snappy_copy(64, dist),
                       snappy_copy(40, dist), snappy_copy(7, 2)]
        cases.append((f"reach-{window}", block(tokens)))
    cases.append(("dist-65535", block([snappy_literal(noise(65535)), snappy_copy(1, 65535)])))
    cases.append(("dist1-dist3-runs", block(
        [snappy_literal(b"x")] + [snappy_copy(64, 1)] * 40 + [snappy_literal(b"abc")]
        + [snappy_copy(64, 3)] * 40 + [snappy_copy(5, 3)])))
    cases.append(("literal-slices", block(
        [snappy_literal(noise(5)), snappy_literal(noise(3000)), snappy_copy(64, 3000),
         snappy_literal(noise(CHUNK - 3069))])))
    return cases


def generated_corpus() -> list[bytes]:
    """256 distinct 64 KB chunks: runs, periods and a byte ramp, then mixed
    text at varied distances with an incompressible stretch."""
    from aircompressor_tpu_torch.ops.batch import _selfcheck_payload

    special = [bytes(CHUNK), b"\x01" * CHUNK, b"ab" * (CHUNK // 2),
               bytes(i & 0xFF for i in range(CHUNK))]
    return special + [_selfcheck_payload(seed=i)
                      for i in range(N_CHUNKS - len(special))]


def backward_cap_case(start: int = 900, source: int = 487) -> bytes:
    """2 KB of random bytes whose tail, from ``start``, repeats the stretch
    from ``source``: the skip has grown by then, so the first hit lies far
    into the repeat and backward extension stops at its 127-byte cap. The
    defaults reach the cap in the Snappy encoder, (1000, 200) in the LZ4
    encoder."""
    noise = np.random.default_rng(5).integers(0, 256, 2048, dtype=np.uint8).tobytes()
    return (noise[:start] + noise[source:])[:2048]


def lz4_malformed_cases(compress) -> list[bytes]:
    """Truncated, a literal run past the input, a zeroed offset, a literal
    run over 64 KB (the cases of tests/test_pallas_kernels.py, on generated
    text)."""
    text = (b"The quick brown fox jumps over the lazy dog. 0123456789 "
            * 600)[:30000]
    blob = compress(text)
    run = 67200
    fills, last = divmod(run - 15, 255)
    return [blob[: len(blob) // 2], blob[: len(blob) - 3], b"\xf0" + blob[1:],
            blob[:1] + b"\x00\x00" + blob[3:],
            b"\xf0" + b"\xff" * fills + bytes([last]) + b"A" * run]


# Blocks on which the JAX package's LZ4 decoders part (ROADMAP F6), with the
# ok flag and out_lens that lz4_pallas_w.decode gives them (interpret mode).
LZ4_EDGE_BLOCKS = [
    (bytes.fromhex("14610100"), False, 9), (bytes.fromhex("1061"), True, 1),
    (bytes.fromhex("00"), True, 0), (b"", False, 0),
    (bytes.fromhex("10610000"), False, 1), (bytes.fromhex("1f61010000"), False, 20),
    (bytes.fromhex("1461010000"), True, 9),
]


def lz4_length_edges_case() -> bytes:
    """2266 B whose LZ4 sequences have literal runs of 15, 270 and 525 and
    matches of 15 + 4, 270 + 4 and 525 + 4 bytes: lengths whose 255-extension
    ends in a 0 byte. Each repeat copies the stretch just before the literal
    run that precedes it."""
    noise = np.random.default_rng(0).integers(0, 256, 2000, dtype=np.uint8).tobytes()
    out, pos = b"", 0
    for lit, match in ((600, 19), (15, 274), (270, 529), (15, 19)):
        out += noise[pos:pos + lit]
        pos += lit
        out += out[max(0, len(out) - match - lit):][:match]
    return out + noise[pos:pos + 525]


def _lz4_ext(n: int) -> bytes:
    """The 255-extension of a length whose nibble is 15: n - 15 as 0xFF bytes
    worth 255 each, then the last byte (0 to 254)."""
    full, last = divmod(n - 15, 255)
    return b"\xff" * full + bytes([last])


class Lz4Block:
    """An LZ4 block built sequence by sequence, with random literals."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.parts: list[bytes] = []
        self.op = 0

    def seq(self, lit: int, dist: int, length: int) -> "Lz4Block":
        """lit literals, then a match of length >= 4 at dist (dist <= op
        after the literals, unless a malformed block is wanted)."""
        ml = length - 4
        token = bytes([(min(lit, 15) << 4) | min(ml, 15)])
        self.parts.append(token + (_lz4_ext(lit) if lit >= 15 else b"")
                          + self.rng.integers(0, 256, lit, dtype=np.uint8).tobytes()
                          + dist.to_bytes(2, "little") + (_lz4_ext(ml) if ml >= 15 else b""))
        self.op += lit + length
        return self

    def end(self, lit: int = 5) -> bytes:
        """The block, ended by a sequence of lit literals only."""
        last = (bytes([min(lit, 15) << 4]) + (_lz4_ext(lit) if lit >= 15 else b"")
                + self.rng.integers(0, 256, lit, dtype=np.uint8).tobytes())
        return b"".join(self.parts) + last


def lz4_window_cases() -> list[tuple[str, bytes]]:
    """Hand-built LZ4 blocks for the decode kernel's window and input ring:
    for each window, matches at dist reach - 1, reach and reach + 1 of 9,
    2 * step + 17 and step bytes after 0-3 literals; a match at dist 65,520
    that ends the output at 64 KB, and one at 65,535 past 64 KB (malformed:
    the literals before it count); a 64 KB literal-only block; literal and
    match 255-extensions that cross a 512-byte ring slice; overlapping
    matches at dist 1-63; matches that read their own sequence's literals,
    with the literals moved in the match's step and alone before it; a
    dist-1 match extended to end the output at 64 KB, and one a byte past
    (malformed)."""
    from aircompressor_tpu_torch.ops.lz4_decode import WINDOWS, copy_reach, step_bytes

    cases = []
    for window in WINDOWS:
        reach, step = copy_reach(window), step_bytes(window)
        blk = Lz4Block(window).seq(window + 300, 1, 4)
        for k, dist in enumerate((reach - 1, reach, reach + 1)):
            for j, length in enumerate((9, 2 * step + 17, step)):
                blk.seq((k + j) % 4, dist, length)
        cases.append((f"reach-{window}", blk.end()))
    cases.append(("far-65520", Lz4Block(1).seq(65520, 65520, 11).end(5)))
    cases.append(("offset-65535", Lz4Block(2).seq(65535, 65535, 4).end(5)))
    cases.append(("literal-64k", Lz4Block(3).end(65536)))
    # token 0, literal extension 1-2, literals 3-482, offset 483-484, match
    # extension 485-525 (over 512); then 470 literals to 998, offset to
    # 1000, and a literal extension at 1002-1032 (over 1024)
    blk = Lz4Block(4).seq(480, 1, 15 + 255 * 40 + 7 + 4).seq(470, 3000, 7)
    cases.append(("ext-slices", blk.seq(15 + 255 * 30 + 3, 18000, 300).end()))
    blk = Lz4Block(5).seq(64, 1, 4)
    for d in range(1, 64):
        blk.seq(d % 3 * 2, d, 4 + (37 * d) % 300)
    cases.append(("overlap-1-63", blk.end()))
    blk = Lz4Block(6).seq(40, 10, 100).seq(40, 40, 40).seq(40, 41, 90).seq(100, 60, 150)
    blk.seq(200, 150, 300).seq(600, 300, 1500).seq(1100, 1000, 3000).seq(5, 5, 64)
    cases.append(("own-literals", blk.end()))
    cases.append(("match-to-64k", Lz4Block(7).seq(1, 1, 65530).end(5)))
    cases.append(("match-past-64k", Lz4Block(8).seq(1, 1, 65536).end(5)))
    return cases


def encode_cases() -> list[bytes]:
    """The encode comparison batch: the synthetic cases, four canary windows
    across the text/random boundary, each cut to ENC_CUT bytes, and the
    backward-extension cap case."""
    from aircompressor_tpu_torch.ops.batch import _selfcheck_payload

    cases = [c[:ENC_CUT] for _, c in synthetic_cases()] + [backward_cap_case()]
    for seed in (0xA1C0, 1, 2, 3):
        payload = _selfcheck_payload(seed)
        cases.append(payload[-ENC_CUT - ENC_CUT // 2:-ENC_CUT // 2])
    return cases


def enc_margin(codec: str) -> int:
    """Probes run while ``ip < len - margin``."""
    return {"lz4": 12, "snappy": 15}[codec]


def enc_probes(codec: str, count: int) -> list[int]:
    """The first probe positions of a Snappy or LZ4 encode scan from 0 that
    finds no match: ``ip += skip >> shift``, ``skip`` from ``1 << shift``."""
    shift = 6 if codec == "lz4" else 5
    out, p, skip = [], 0, 1 << shift
    while len(out) < count:
        out.append(p)
        p += skip >> shift
        skip += 1
    return out


def enc_hash(codec: str, words: np.ndarray) -> np.ndarray:
    """The 14-bit table hash of 4-byte little-endian words."""
    mul = np.uint64(2654435761 if codec == "lz4" else 0x1E35A7BD)
    return ((words.astype(np.uint64) * mul) & np.uint64(0xFFFFFFFF)) >> np.uint64(18)


def _enc_colliding_words(codec: str, seed: int = 41) -> tuple[bytes, bytes]:
    """Two 4-byte words with one table hash, from a seeded birthday search."""
    w = np.random.default_rng(seed).integers(0, 2**32, 4096, dtype=np.uint64)
    h = enc_hash(codec, w)
    order = np.argsort(h, kind="stable")
    same = np.nonzero((h[order][1:] == h[order][:-1]) & (w[order][1:] != w[order][:-1]))[0]
    i, j = order[same[0]], order[same[0] + 1]
    return int(w[i]).to_bytes(4, "little"), int(w[j]).to_bytes(4, "little")


def encode_round_cases(codec: str) -> list[tuple[str, bytes]]:
    """Hand-built chunks for the rounds of 32 probes of the LZ4 (``codec``
    "lz4") or Snappy ("snappy") encode kernel, random bytes but for:

    - collision: probes 3 and 13 of round 20 hold words x and y with one
      hash and other bytes, and probe 7 of round 5 holds y; the later probe's
      candidate is the earlier lane (no match), the table's entry from
      before the round would match;
    - in_round: probe 24 of round 2 repeats the 8 bytes at probe 4;
    - commit: bytes 20-59 repeat at distance 16, so round 0 hits at lane 20
      (on lane 4) and its lanes 21-31 have the hashes of lanes 5-15; bytes
      200-207 repeat bytes 10-17, and that later probe's candidate is lane
      10's position, which lane 26 did not overwrite;
    - step_grows: the first round whose step is 2 (skip reaches 128 in LZ4,
      64 in Snappy) hits at its lane 5, on the bytes of probe 10 of round 0;
    - find_limit: the chunk ends so that the limit cuts a round after its
      lane 19, whose probe hits (on the bytes of probe 10) and runs to the
      chunk's end;
    - match_limit_0..3: 2000 random bytes then a repeat of them, at four
      lengths: forward extension runs to the match limit, which falls at
      each of the four bytes of a lane's window once.
    """
    rng = np.random.default_rng({"lz4": 43, "snappy": 47}[codec])
    cut, margin = ENC_CUT, enc_margin(codec)
    probes = enc_probes(codec, 32 * 64)
    first_step2 = 64 if codec == "lz4" else 32

    def noise(n=cut):
        return bytearray(rng.integers(0, 256, n, dtype=np.uint8).tobytes())

    x, y = _enc_colliding_words(codec)
    coll = noise()
    for pos, word in ((probes[32 * 5 + 7], y), (probes[32 * 20 + 3], x),
                      (probes[32 * 20 + 13], y)):
        coll[pos:pos + 4] = word
    in_round = noise()
    a, b = probes[64 + 4], probes[64 + 24]
    in_round[b:b + 8] = in_round[a:a + 8]
    commit = noise()
    for i in range(20, 60):
        commit[i] = commit[i - 16]
    commit[200:208] = commit[10:18]
    grows = noise()
    a, b = probes[10], probes[first_step2 + 5]
    grows[b:b + 8] = grows[a:a + 8]
    last = max(i for i in range(19, len(probes), 32) if probes[i] + 1 + margin <= cut)
    n = probes[last] + 1 + margin
    limit = noise(n)
    a, b = probes[10], probes[last]
    limit[b:] = limit[a:a + n - b]
    head = bytes(noise(2000))
    cases = [("collision", bytes(coll)), ("in_round", bytes(in_round)),
             ("commit", bytes(commit)), ("step_grows", bytes(grows)), ("find_limit", bytes(limit))]
    return cases + [(f"match_limit_{k}", (head + head)[:3001 + k]) for k in range(4)]


def full_cases(corpus: list[bytes]) -> list[bytes]:
    """The encode comparison at the compress path's width (64 KB rows): the
    zero chunk, text chunks (3-byte length headers, table positions and
    offsets past 8 KB), one cut to 40000 bytes, and 64 KB of random bytes."""
    noise = np.random.default_rng(11).integers(0, 256, CHUNK, dtype=np.uint8)
    return [corpus[0], corpus[4], corpus[100], corpus[255], corpus[37][:40000],
            noise.tobytes()]


def lz4_full_cases(corpus: list[bytes]) -> list[bytes]:
    """The LZ4 encode comparison at the compress path's width (64 KB rows):
    the zero chunk, three text chunks (one cut to 40000 bytes), 64 KB of
    random bytes, and a chunk of long runs: 5000 random bytes, 30000 x "a"
    and a repeat of the random start, whose literal and match lengths carry
    long 255-extension strings."""
    noise = np.random.default_rng(11).integers(0, 256, CHUNK, dtype=np.uint8).tobytes()
    runs = (noise[:5000] + b"a" * 30000 + noise)[:CHUNK]
    return [corpus[0], corpus[4], corpus[100], corpus[37][:40000], noise, runs]


def zstd_cases() -> list[bytes]:
    """The originals of the zstd comparison batch: the synthetic cases and
    two canary tails (text, then 8 KB of random bytes), each cut to
    ZSTD_CUT bytes."""
    from aircompressor_tpu_torch.ops.batch import _selfcheck_payload

    return [c[:ZSTD_CUT] for _, c in synthetic_cases()] + [
        _selfcheck_payload(seed)[-ZSTD_CUT - 2000:][:ZSTD_CUT] for seed in (0xA1C0, 1)]


def zstd_full_cases() -> list[bytes]:
    """The zstd comparison at the decode path's width: corpus chunks 0, 4,
    37, 38, 100 and 255 (the zero chunk, an RLE block, and text whose
    matches reach tens of KB back, each one block through the host encoder
    at level 3; chunk 38 is one of the five whose sequences use a repeat
    offset)."""
    from aircompressor_tpu_torch.ops.batch import _selfcheck_payload

    return [bytes(CHUNK)] + [_selfcheck_payload(seed) for seed in (0, 33, 34, 96, 251)]


def fse_short_match_chunk(n: int = CHUNK) -> bytes:
    """n bytes of 48 random tokens of 3 to 6 bytes in random order. The host
    encoder at level 3 makes one sequences section of short matches of it:
    at 64 KB 7,104 sequences over a 15.8 KB bitstream, some sixty slices of
    the FSE kernel's backward ring."""
    rng = np.random.default_rng(5)
    toks = [rng.integers(0, 256, int(rng.integers(3, 7)), dtype=np.uint8).tobytes()
            for _ in range(48)]
    return b"".join(toks[i] for i in rng.integers(0, 48, n // 3 + 1))[:n]


def fse_section_cases() -> tuple[list[str], dict]:
    """Hand-built sequences sections for the FSE kernel, packed as
    ``fse_sequences`` takes them (src, params, tabs, frames, seq_slots), one
    frame a case: random tables at the largest logs (9/8/9) over a
    bitstream of several ring slices; the predefined tables; RLE tables;
    one sequence; an OF code above 23 (err, 23 bits read); a repeat offset
    that resolves to 0 (err); a section that reads below its start (err);
    three sections whose repeat offsets carry across them; a frame with no
    section (blocks without sequences); and last a section whose top bytes
    lie past the input (read as 0). Bitstreams are random bytes at uneven
    offsets; initial states random below each table's size."""
    from aircompressor_tpu_torch.host.zstd import fse
    from aircompressor_tpu_torch.host.zstd.device_prep import _pack_fse, _predefined
    from aircompressor_tpu_torch.ops.zstd_decode import S_TABLE, S_WORDS

    rng = np.random.default_rng(14)
    src = bytearray()
    params, tabs, frames, names = [], [], [], []
    slots = 0

    def table(log: int, max_sym: int, low: int = 2):
        n = int(rng.integers(low + 1, min(max_sym + 1, 1 << log) + 1))
        syms = rng.choice(max_sym + 1, n, replace=False)
        counts = np.zeros(max_sym + 1, np.int64)
        counts[syms[:low]] = -1  # "less than one" probabilities
        counts[syms[low:]] = 1 + rng.multinomial((1 << log) - n, rng.dirichlet(np.ones(n - low)))
        return fse.build_decode_table(counts, log)

    def section(ll, of, ml, nseq: int, nbytes: int, fill=None, cut: int = 3) -> None:
        nonlocal slots
        src.extend(rng.integers(0, 256, int(rng.integers(1, 16)), dtype=np.uint8).tobytes())
        byte_lo = len(src)
        src.extend(bytes([fill]) * nbytes if fill is not None
                   else rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes())
        states = [int(rng.integers(0, 1 << t.log2_size)) for t in (ll, of, ml)]
        params.append([byte_lo, 8 * nbytes - cut, nseq, slots, *states,
                       ll.log2_size | of.log2_size << 8 | ml.log2_size << 16])
        tabs.append(np.concatenate([_pack_fse(ll, 512), _pack_fse(of, 256), _pack_fse(ml, 512)]))
        slots += -(-nseq // 128) * 128

    def frame(name: str, sections: list) -> None:
        frames.append([len(params), len(sections)])
        names.append(name)
        for args in sections:
            section(*args[:5], **(args[5] if len(args) > 5 else {}))

    ll_max, of_max, ml_max = 35, 23, 52  # codes past 23 only in "of-code-26"
    rle = fse.build_rle_table
    frame("max-logs", [(table(9, ll_max), table(8, of_max), table(9, ml_max), 700, 4000)])
    frame("predefined", [(_predefined("ll"), _predefined("of"), _predefined("ml"), 300, 1500)])
    frame("rle", [(rle(20), rle(10), rle(40), 60, 500)])
    frame("one-sequence", [(table(5, ll_max), table(5, of_max), table(5, ml_max), 1, 12)])
    frame("of-code-26", [(table(6, ll_max), rle(26), table(6, ml_max), 20, 120)])
    frame("repeat-offset-0", [(rle(0), rle(1), rle(0), 3, 8, {"fill": 0xFF})])
    frame("below-start", [(table(9, ll_max), table(8, of_max), table(9, ml_max), 40, 8)])
    frame("three-blocks", [(table(int(rng.integers(6, 10)), ll_max),
                            table(int(rng.integers(5, 9)), of_max),
                            table(int(rng.integers(6, 10)), ml_max), 120, 900) for _ in range(3)])
    frame("no-sequences", [])
    frame("past-the-input", [(table(7, ll_max), table(6, of_max), table(7, ml_max), 50, 400)])
    del src[-40:]  # the last section's top 40 bytes lie past the input
    return names, {
        "src": np.frombuffer(bytes(src), np.uint8).copy(),
        "params": np.array(params, np.int32).reshape(-1, S_WORDS),
        "tabs": np.array(tabs, np.int32).reshape(-1, S_TABLE),
        "frames": np.array(frames, np.int32).reshape(-1, 2), "seq_slots": slots}


def _huffman_table(weights: list[int]):
    """The canonical table of explicit Huffman weights (the last implicit)
    and its walk parameters: (table, rank_start[1..12], cum_syms, perm)."""
    from aircompressor_tpu_torch.host.zstd import device_prep, huffman

    table = huffman.build_table(np.array(weights, np.int64))
    rank_start, cum, perm = device_prep._walk_params(table)
    return table, rank_start[1:13], cum, perm


def _huffman_payload(table, syms) -> tuple[bytes, int]:
    """The backward bitstream that decodes to ``syms`` in order, and its
    payload bits: each code written least significant bit first, the last
    symbol's first, then the end-mark bit."""
    first = {}
    for i, s in enumerate(table.symbols.tolist()):
        first.setdefault(s, i)
    acc = nbits = 0
    for s in reversed(syms):
        nb = int(table.num_bits[first[s]])
        acc |= (first[s] >> (table.table_log - nb)) << nbits
        nbits += nb
    return (acc | 1 << nbits).to_bytes(nbits // 8 + 1, "little"), nbits


def huffman_lane_cases() -> list[tuple[str, dict]]:
    """Hand-made Huffman literal streams for the Huffman kernel's lanes:
    codes of one length (7 bits, which divides no sub-range of these
    streams, so a lane that starts off a code never meets one on its own),
    a table of log 11 (codes of 1 to 11 bits), a stream of fewer bits than
    32 lanes x its table log, one with bits left after nsym, one read past
    its start (nsym beyond its symbols), a table of log 12 (also read past
    its start) and a table whose walk finds no code below its first region
    (rank_start[1] raised, as no planner gives it): those take the kernel's
    one-lane walk; a stream of no payload bits with 6 symbols, one of
    100 codes and nsym 0, and two that the kernel's sub-ranges of up to
    1536 bits take in more than one segment of 32: 7,200 codes of one
    7-bit length (50,400 bits, two segments) and 10,000 codes of 9 to 11
    bits drawn alike from a table of log 11 (over 98,304 bits, three).
    Each case: its payload, rem, nsym, table_log, rank_start[1..12],
    cum_syms and perm."""
    rng = np.random.default_rng(23)
    chain = list(range(11, 0, -1))  # codes of 1..11 bits, two of 11

    def case(weights, n, extra=0, syms=None):
        table, rs, cum, perm = _huffman_table(weights)
        alphabet = sorted(set(table.symbols.tolist()))
        if syms is None:
            first = [int(np.argmax(table.symbols == s)) for s in alphabet]
            p = np.array([2.0 ** -int(table.num_bits[i]) for i in first])
            syms = rng.choice(alphabet, n, p=p / p.sum()).tolist()
        payload, bits = _huffman_payload(table, syms)
        return dict(payload=payload, rem=bits, nsym=len(syms) + extra,
                    table_log=table.table_log, rank_start=rs, cum=cum, perm=perm)

    zero = int(_huffman_table(chain)[0].symbols[0])  # its code: 11 zero bits
    syms = rng.choice([s for s in range(12) if s != zero], 400).tolist()
    syms[150] = zero  # where the broken walk sticks
    broken = case(chain, 0, syms=syms)
    broken["rank_start"] = broken["rank_start"].copy()
    broken["rank_start"][0] = 5
    empty = case(chain[4:], 0, syms=[])  # no payload bits: every symbol past the start
    empty["nsym"] = 6
    table = _huffman_table(chain)[0]
    long_codes = sorted({s for s, nb in zip(table.symbols.tolist(), table.num_bits.tolist())
                         if nb >= 9})
    return [
        ("one length", case([1] * 127, 1200)),
        ("log 11", case(chain, 3000)),
        ("short", case(chain[4:], 20)),
        ("bits left", case(chain[3:], 500, extra=-5)),
        ("read past start", case(chain[3:], 300, extra=9)),
        ("log 12", case(list(range(12, 0, -1)), 1000)),
        ("log 12 read past start", case(list(range(12, 0, -1)), 200, extra=7)),
        ("no code below rank_start[1]", broken),
        ("no payload bits", empty),
        ("no symbols", case(chain[4:], 100, extra=-100)),
        ("one length, two segments", case([1] * 127, 7200)),
        ("log 11, three segments", case(chain, 0, syms=rng.choice(long_codes, 10000).tolist())),
    ]


def one_sequence_case() -> bytes:
    """600 random bytes of 64 values and a repeat of their first 100: one
    sequence, with literals the emission codes."""
    head = np.random.default_rng(1).integers(0, 64, 600, dtype=np.uint8).tobytes()
    return head + head[:100]


def emit_edge_rows(packed: dict) -> tuple[dict, dict]:
    """Rows for the emission's edge cases from a batch of ``pack_plans``:
    its first row with nseq 0 (only the end mark in the sequences stream),
    and a row of random fields that reach every clamp (segments that start
    before the literals or run past them, codes outside the tables, widths
    below 0 and above 31, table entries out of range) without overflowing;
    and apart, a row whose streams overflow their capacities (16,384
    literals of 31-bit codes, 8,192 sequences of 31-bit states and extras)."""
    rng = np.random.default_rng(31)
    ints = lambda lo, hi, shape: rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)  # noqa: E731
    empty = {k: v[:1].copy() for k, v in packed.items()}
    empty["nseq"][:] = 0
    junk = {
        "lit": rng.integers(0, 256, (1, 65536), dtype=np.uint8),
        "lit_seg": np.array([[[-100, 3000], [60000, 9000], [100, 16384], [5, -5]]], np.int32),
        "huff": np.stack([ints(-2**31, 2**31, (1, 256)), ints(-2, 12, (1, 256))], 1),
        "seq": np.concatenate([ints(-3, 70, (1, 3, 8192)), ints(-2**31, 2**31, (1, 3, 8192)),
                               ints(-2, 40, (1, 3, 8192))], 1),
        "nseq": np.array([1500], np.int32),
        "fse_sym": np.stack([ints(-2**17, 2**17, (1, 3, 64)), ints(-600, 600, (1, 3, 64))], 2),
        "fse_ns": ints(0, 2**16, (1, 3, 512)),
        "flush_bits": np.array([[9, 40, -1]], np.int32),
    }
    edge = {k: np.concatenate([empty[k], junk[k]]) for k in packed}
    over = {k: np.zeros_like(v[:1]) for k, v in packed.items()}
    over["lit_seg"][0, 0] = [0, 16384]
    over["huff"][0, 0], over["huff"][0, 1] = ints(0, 2**31, 256), 31
    over["seq"][0, 3:6], over["seq"][0, 6:9] = ints(0, 2**31, (3, 8192)), 31
    over["fse_sym"][0, :, 0] = 31 << 16  # states of 31 bits
    over["nseq"][0] = 8192
    return edge, over


def huffman_lane_batch(cases, device, lead: int = 3):
    """The Huffman kernel's arguments for ``huffman_lane_cases``: the
    payloads in one flat input, each at an odd byte offset after ``lead``
    bytes of noise and 1 to 3 bytes between, each stream's slot 128-aligned
    and rounded up to 128; (src, params, perm, lit_size) on ``device``."""
    from aircompressor_tpu_torch.ops import zstd_decode

    rng = np.random.default_rng(29)
    src = bytearray(rng.integers(0, 256, lead, dtype=np.uint8).tobytes())
    params = np.zeros((len(cases), zstd_decode.H_WORDS), np.int32)
    perm = np.zeros((len(cases), 256), np.uint8)
    out = 0
    for h, (_, c) in enumerate(cases):
        params[h, :5] = [len(src), c["rem"], c["nsym"], out, c["table_log"]]
        params[h, zstd_decode.H_RANK_START:zstd_decode.H_RANK_START + 12] = c["rank_start"]
        params[h, zstd_decode.H_CUM_SYMS:zstd_decode.H_CUM_SYMS + 12] = c["cum"]
        perm[h] = c["perm"]
        src += c["payload"] + rng.integers(0, 256, 1 + h % 3, dtype=np.uint8).tobytes()
        out += -(-max(c["nsym"], 1) // 128) * 128
    src += bytes(zstd_decode.SRC_PAD)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(np.frombuffer(bytes(src), np.uint8).copy()), t(params), t(perm), out


def dfast_repeat_case() -> bytes:
    """8 KB of random bytes with two copies at distance REP_D: the first is
    found by the tables well inside the copy and extended back to REP_A;
    the second is taken by the repeat offset at ip + 1 (see
    tests/test_torch_zstd_dfast.py)."""
    x = bytearray(np.random.default_rng(17).integers(0, 256, DFAST_CUT,
                                                     dtype=np.uint8).tobytes())
    b = REP_A + REP_M + REP_G
    x[REP_A:REP_A + REP_M] = x[REP_A - REP_D:REP_A - REP_D + REP_M]
    x[b:b + REP_M2] = x[b - REP_D:b - REP_D + REP_M2]
    return bytes(x)


def dfast_cases() -> list[bytes]:
    """The DFAST matcher's edge cases (one grid step of the Pallas kernel):
    the four chunks of tests/test_zstd_dfast.py::test_edge_sizes cut to
    DFAST_CUT, two canary heads, stitched repeats of a random vocabulary (as
    in its test_structured_fuzz_sound) and the repeat case."""
    from aircompressor_tpu_torch.ops.batch import _selfcheck_payload

    rng = np.random.default_rng(5)
    edge = [b"A" * 64, (b"ab" * 32768)[:DFAST_CUT],
            bytes(rng.integers(0, 4, 64, dtype=np.uint8)), b"x" * 23]
    rng = np.random.default_rng(991)
    vocab = [rng.integers(0, 256, int(rng.integers(4, 900)), dtype=np.uint8).tobytes()
             for _ in range(6)]
    parts, total = [], 0
    while total < DFAST_CUT:
        w = vocab[int(rng.integers(0, len(vocab)))]
        if rng.random() < 0.3:
            w = w[: int(rng.integers(1, len(w) + 1))]
        parts.append(w)
        total += len(w)
    return (edge + [_selfcheck_payload(s)[:DFAST_CUT] for s in (1, 2)]
            + [b"".join(parts)[:DFAST_CUT], dfast_repeat_case()])


def _dfast_probes(count: int) -> list[int]:
    """The first probe positions of a chunk with no match (anchor 0)."""
    out, p = [], 0
    while len(out) < count:
        out.append(p)
        p += 1 + (p >> 8)
    return out


def _dfast_colliding_words(seed: int = 29) -> tuple[bytes, bytes]:
    """Two 8-byte words with equal long and equal short DFAST hashes but
    other first 4 bytes, from a seeded birthday search."""
    m32 = np.uint64(0xFFFFFFFF)
    w = np.random.default_rng(seed).integers(0, 2**63, 1 << 17, dtype=np.uint64)
    lo, b4, hi3 = w & m32, (w >> np.uint64(32)) & np.uint64(0xFF), w >> np.uint64(40)
    h_l = (((lo * np.uint64(0x1E35A7BD)) ^ (hi3 * np.uint64(0x9E3779B9))
            ^ (b4 * np.uint64(0x85EBCA77))) & m32) >> np.uint64(18)
    h_s = (((lo * np.uint64(0x9E3779B9)) ^ (b4 * np.uint64(0x1E35A7BD))) & m32) >> np.uint64(18)
    key = (h_l << np.uint64(14)) | h_s
    order = np.argsort(key, kind="stable")
    same = np.nonzero((key[order][1:] == key[order][:-1])
                      & (lo[order][1:] != lo[order][:-1]))[0]
    i, j = order[same[0]], order[same[0] + 1]
    return int(w[i]).to_bytes(8, "little"), int(w[j]).to_bytes(8, "little")


def dfast_collision_case() -> tuple[bytes, tuple[int, int, int]]:
    """DFAST_CUT random bytes where two probes of one round (lanes 3 and 13
    of round 20) hold words x and y with both hashes equal and other bytes,
    and an older probe holds y: the later probe's true candidate is the
    earlier lane (no match), the table's entry from before the round would
    match. Returns the chunk and (older, earlier, later)."""
    x, y = _dfast_colliding_words()
    probes = _dfast_probes(32 * 21)
    older, earlier, later = probes[32 * 5 + 7], probes[32 * 20 + 3], probes[32 * 20 + 13]
    buf = bytearray(np.random.default_rng(31).integers(0, 256, DFAST_CUT,
                                                       dtype=np.uint8).tobytes())
    for pos, word in ((older, y), (earlier, x), (later, y)):
        buf[pos:pos + 8] = word
    return bytes(buf), (older, earlier, later)


def dfast_in_round_case() -> tuple[bytes, tuple[int, int]]:
    """DFAST_CUT random bytes with one 8-byte word at positions 100 and 120,
    lanes 4 and 24 of the round from 96: the later lane matches through the
    earlier lane's position. Returns the chunk and the two positions."""
    buf = bytearray(np.random.default_rng(37).integers(0, 256, DFAST_CUT,
                                                       dtype=np.uint8).tobytes())
    buf[120:128] = buf[100:108]
    return bytes(buf), (100, 120)


class ExecBatch:
    """Hand-built inputs of the zstd execute kernel: frames of blocks whose
    (ll, ml, offset) triples read a literal buffer, an input buffer or RLE
    bytes through up to four pieces, as ``zstd_decode.execute`` takes them
    (``arrays``)."""

    HUFF, RAW, RLE = 0, 1, 2

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.lit = self.rng.integers(0, 256, 1 << 17, dtype=np.uint8)
        self.src = self.rng.integers(0, 256, 1 << 16, dtype=np.uint8)
        self.seq: list[list[int]] = []
        self.rows: list[list[int]] = []
        self.frames: list[list[int]] = []
        self.names: list[str] = []

    def block(self, triples, lit_total: int, pieces) -> list[int]:
        """One block row: its triples, lit_total and (kind, src, end) pieces."""
        pad = [0] * (4 - len(pieces))
        row = [len(triples), len(self.seq) if triples else -1, lit_total, 0,
               *[p[0] for p in pieces], *pad, *[p[1] for p in pieces], *pad,
               *[p[2] for p in pieces], *pad]
        self.seq += [list(t) for t in triples]
        return row

    def frame(self, name: str, rows) -> None:
        self.frames.append([len(self.rows), len(rows)])
        self.rows += rows
        self.names.append(name)

    def valid(self, n: int, op: int, lmax: int = 5, mmax: int = 20) -> tuple[list, int]:
        """n random sequences that are valid after op bytes of output: ll up to
        lmax, ml 3 to mmax, offsets up to the output before each match (1 at
        the start). Returns them and their literal count."""
        out, lits = [], 0
        for _ in range(n):
            ll = int(self.rng.integers(0 if op else 1, lmax + 1))
            ml = int(self.rng.integers(3, mmax + 1))
            of = int(self.rng.integers(1, op + ll + 1))
            out.append((ll, ml, of))
            op, lits = op + ll + ml, lits + ll
        return out, lits

    def arrays(self) -> dict:
        return dict(src=self.src, lit=self.lit,
                    seq3=np.array(self.seq or [[0, 0, 0]], np.int32).reshape(-1, 3),
                    frames=np.array(self.frames, np.int32).reshape(-1, 2),
                    blocks=np.array(self.rows, np.int32).reshape(-1, 16))


def execute_round_cases() -> tuple[list[str], dict]:
    """Hand-built frames for the zstd execute kernel's rounds and windows:
    overlapping matches (offsets 1, 3, 7, 31, 37, 63, 64; one longer than a
    round); offsets at each window's reach - 1, reach and reach + 1 (64
    bytes, a round and a little more, 5 bytes); blocks of 31, 32, 33, 64 and
    65 sequences (two literal pieces crossed inside a round) and a frame of
    blocks of 31 and 33; four Huffman pieces, a raw piece, an RLE piece, a
    raw block and an RLE block; frames not ok from a bad sequence in lane 0,
    in lane 31 and in the round after, ll = 2^31 - 1, ml = 2^31 - 1,
    literals past lit_total, past the pieces' cover by a sequence and by the
    trailing literals; and frames of exactly 4093 and 4094 bytes. Returns the
    frame names and the kernel's arrays (numpy)."""
    from aircompressor_tpu_torch.ops.zstd_decode import (
        EXECUTE_WINDOWS, execute_round, offset_reach)

    b = ExecBatch(21)
    H, RAW, RLE = b.HUFF, b.RAW, b.RLE
    seqs = [(40, 100, 1), (5, 300, 3), (0, 70, 31), (2, 200, 37), (10, 5000, 7), (3, 64, 64),
            (1, 2000, 63)]
    b.frame("overlap", [b.block(seqs, 81, [(H, 0, 81)])])
    for window in EXECUTE_WINDOWS:
        reach, rnd = offset_reach(window), execute_round(window)
        seqs = [(reach + 200, 0, 0)]
        for off in (reach - 1, reach, reach + 1):
            seqs += [(3, 64, off), (0, rnd + 100, off), (1, 5, off)]
        lits = sum(t[0] for t in seqs) + 10
        b.frame(f"reach-{window}", [b.block(seqs, lits, [(H, 1024, lits)])])
    for n in (31, 32, 33, 64, 65):
        seqs, lits = b.valid(n, 0)
        lits += 7
        b.frame(f"rounds-{n}", [b.block(seqs, lits, [(H, 4096, lits // 2), (H, 8192, lits)])])
    first, l1 = b.valid(31, 0)
    second, l2 = b.valid(33, l1 + 3 + sum(t[1] for t in first))
    b.frame("two-blocks", [b.block(first, l1 + 3, [(H, 12288, l1 + 3)]),
                           b.block(second, l2, [(RAW, 777, l2)])])
    seqs, lits = b.valid(40, 0, lmax=25)
    huff4 = [(H, 16384, lits // 4), (H, 16896, lits // 2), (H, 17408, lits // 2 + 1),
             (H, 17920, lits)]
    rows = [b.block(seqs, lits, huff4)]
    op = lits + sum(t[1] for t in seqs)
    seqs, lits = b.valid(20, op)
    rows.append(b.block(seqs, lits, [(RAW, 5000, lits)]))
    op += lits + sum(t[1] for t in seqs)
    seqs, lits = b.valid(20, op)
    rows.append(b.block(seqs, lits, [(RLE, 0x5A, lits)]))
    rows += [b.block([], 1000, [(RAW, 100, 1000)]), b.block([], 3000, [(RLE, 7, 3000)])]
    b.frame("pieces", rows)
    base, lits = b.valid(64, 0)
    lits += 5
    for name, i, field, value in (
            ("bad-lane0-ml", 0, 1, -1), ("bad-lane31-offset", 31, 2, 0),
            ("bad-next-round-offset", 32, 2, 1 << 20), ("ll-max", 3, 0, 2**31 - 1),
            ("ml-max", 40, 1, 2**31 - 1), ("past-lit-total", 50, 0, lits)):
        seqs = [list(t) for t in base]
        seqs[i][field] = value
        b.frame(name, [b.block(seqs, lits, [(H, 20480, lits)])])
    b.frame("past-cover-sequence", [b.block(base, lits, [(H, 20480, 20)])])
    b.frame("past-cover-trailing", [b.block(base, lits, [(H, 20480, lits - 3)])])
    for total in (4093, 4094):
        seqs = [(100, 3000, 90), (0, total - 3100 - 5, 2048)]
        b.frame(f"out-{total}", [b.block(seqs, 105, [(RAW, 333, 105)])])
    return b.names, b.arrays()


def zstd_malformed_cases() -> list[tuple[str, bytes, str]]:
    """zstd frames that pass the planner and that the decode must reject,
    each with its name and the reason the decode gives: a Huffman stream
    cut short (the jump table moves a byte from stream 1 to stream 2), a
    flipped bit in the sequences, an offset past the frame's start, a
    declared content size one more than the output, and a flipped checksum
    bit. The host decoders reject each as well."""
    from aircompressor_tpu_torch.host.zstd import device_prep, frame_enc, seq_enc
    from aircompressor_tpu_torch.ops.batch import _selfcheck_payload

    good = frame_enc.compress_bytes(_selfcheck_payload(9)[:6000])
    plan = device_prep.plan_batch([good], CHUNK)

    def edit(pos: int, new: bytes) -> bytes:
        return good[:pos] + new + good[pos + len(new):]

    jump = plan.huff_streams[0].byte_lo - 6
    s1, s2 = int.from_bytes(good[jump:jump + 2], "little"), int.from_bytes(
        good[jump + 2:jump + 4], "little")
    short = edit(jump, (s1 - 1).to_bytes(2, "little") + (s2 + 1).to_bytes(2, "little"))
    seq_at = plan.seq_streams[0].byte_lo + 9
    flipped = edit(seq_at, bytes([good[seq_at] ^ 1]))
    # 4 raw literals, then one sequence: 4 literals, offset 10, match of 4
    seqs, _ = seq_enc.compress_sequences(np.array([4]), np.array([13]), np.array([4]))
    body = bytes([4 << 3]) + b"abcd" + seqs
    far = (frame_enc.MAGIC.to_bytes(4, "little") + bytes([0, 0])  # 1 KB window
           + frame_enc._block_header(1, 2, len(body)) + body)
    size = edit(5, (int.from_bytes(good[5:7], "little") + 1).to_bytes(2, "little"))
    checksum = edit(len(good) - 1, bytes([good[-1] ^ 0x80]))
    bad_frame = "malformed zstd frame in device batch"
    return [("short Huffman stream", short, bad_frame),
            ("flipped sequences bit", flipped, bad_frame),
            ("offset past the frame start", far, bad_frame),
            ("content size mismatch", size, bad_frame),
            ("flipped checksum", checksum, "frame checksum mismatch (device decode)")]


# LZO1X blocks at the edges of the format, with the ok flag and out_lens that
# lzo_pallas_w.decode gives them at out_cap LZO_EDGE_CAP (interpret mode):
# the malformed blocks of tests/test_lzo_device.py, truncated M1 (state 1),
# M1' (state 4), M2, M3 and M4 commands, zero runs that end the input (a
# literal run's and an M3 length's), M2 and M1' matches before the start,
# output one byte over out_cap, exactly out_cap and past 64 KB (an M3 match
# of 4093, 4092 and 65533 bytes after 4 literals), data after the stop
# command, a first literal run past the input, the stop command alone, and
# a trailing literal missing at the end. The host decoder rejects exactly
# the blocks that are not ok here.
LZO_EDGE_CAP = 4096
LZO_EDGE_BLOCKS = [
    (bytes.fromhex("00"), False, 0),
    (bytes.fromhex("1100"), False, 0),
    (bytes.fromhex("0004736f6d652064"), False, 0),
    (bytes.fromhex("40ff0000000000000000"), False, 0),
    (bytes.fromhex("126100"), False, 1),
    (bytes.fromhex("156162636401"), False, 4),
    (bytes.fromhex("156162636440"), False, 4),
    (bytes.fromhex("15616263642100"), False, 4),
    (bytes.fromhex("15616263641900"), False, 4),
    (bytes.fromhex("000000"), False, 0),
    (bytes.fromhex("1561626364200000"), False, 4),
    (bytes.fromhex("15616263644001110000"), False, 4),
    (bytes.fromhex("15616263640100110000"), False, 4),
    (bytes.fromhex("156162636420") + bytes(15) + bytes.fromhex("eb0000110000"), False, 4097),
    (bytes.fromhex("156162636420") + bytes(15) + bytes.fromhex("ea0000110000"), True, 4096),
    (bytes.fromhex("156162636420") + bytes(256) + bytes.fromhex("dc0000110000"), False, 4),
    (bytes.fromhex("0004736f6d65206461746120746f20636f6d7072657373202000775400086f20636f"
                   "6d707265737320110000747261696c696e672064617461"), True, 440),
    (bytes.fromhex("166162"), False, 0),
    (bytes.fromhex("110000"), True, 0),
    (bytes.fromhex("15616263644100"), False, 7),
]


def lzo_cases() -> list[bytes]:
    """The LZO comparison's originals: the synthetic cases cut to 64 KB."""
    return [c[:CHUNK] for _, c in synthetic_cases()]


def _lzo_ext(n: int) -> bytes:
    """A zero-extended length field of n >= 1: zeros worth 255 each, then the
    last byte (1 to 255)."""
    zeros, last = divmod(n - 1, 255)
    return bytes(zeros) + bytes([last + 1])


class LzoBlock:
    """An LZO1X block built command by command, with the state each command
    needs: a literal run after a match with no trailing literals (or at the
    start), M1 after 1-3 trailing literals, M1' after a literal run."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.parts: list[bytes] = []
        self.op = 0
        self.state = 0

    def noise(self, n: int) -> bytes:
        return self.rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def first(self, n: int) -> "LzoBlock":  # a first-byte literal run, 1 to 238
        assert not self.parts and 1 <= n <= 238
        self.parts.append(bytes([17 + n]) + self.noise(n))
        self.op, self.state = n, min(n, 4)
        return self

    def literals(self, n: int) -> "LzoBlock":  # a literal-run command, n >= 4
        assert self.state == 0 and n >= 4
        head = bytes([n - 3]) if n <= 18 else b"\0" + _lzo_ext(n - 18)
        self.parts.append(head + self.noise(n))
        self.op, self.state = self.op + n, 4
        return self

    def match(self, family: str, length: int, dist: int, trailing: int = 0) -> "LzoBlock":
        assert 1 <= dist <= self.op
        if family == "M1":  # 2 bytes after 1-3 literals, 3 after a run
            assert length == (2 if self.state < 4 else 3) and self.state > 0
            d = dist - (1 if self.state < 4 else 2049)
            assert 0 <= d < 1024
            head = bytes([((d & 3) << 2) | trailing, d >> 2])
        elif family == "M2":  # 3 to 8 bytes, dist up to 2048
            d = dist - 1
            assert 3 <= length <= 8 and d < 2048
            head = bytes([((length - 1) << 5) | ((d & 7) << 2) | trailing, d >> 3])
        elif family == "M3":  # dist up to 16384
            d = dist - 1
            assert length >= 3 and d < 16384
            head = (bytes([32 | (length - 2)]) if length <= 33 else b"\x20" + _lzo_ext(length - 33)
                    ) + ((d << 2) | trailing).to_bytes(2, "little")
        else:  # M4: dist 16385 to 49151
            d = dist - 16384
            assert family == "M4" and length >= 3 and 0 < d < 32768
            hi = (d >> 14) << 3
            head = (bytes([16 | hi | (length - 2)]) if length <= 9 else bytes([16 | hi])
                    + _lzo_ext(length - 9)) + (((d & 0x3FFF) << 2) | trailing).to_bytes(2, "little")
        self.parts.append(head + self.noise(trailing))
        self.op, self.state = self.op + length + trailing, trailing
        return self

    def stop(self, zero_run: int = 0) -> bytes:
        """The block ended by the stop command (an M4 at dist 16384), its
        length zero-extended over ``zero_run`` zeros where that is not 0."""
        stop = b"\x11\0\0" if not zero_run else b"\x10" + bytes(zero_run) + b"\x01\0\0"
        return b"".join(self.parts) + stop


def lzo_window_cases() -> list[tuple[str, bytes]]:
    """Hand-built LZO1X blocks for the decode kernel's window and input ring:
    for each window, M3 or M4 matches (the families that reach that far) at
    dist reach - 1, reach and reach + 1, of 9 or 33 bytes and zero-extended
    lengths of several steps, with 0-3 trailing literals; an M4 of dist
    49,151; every command family with 0-3 trailing literals, M2 at dist 1
    and 2048 among them; overlapping zero-extended matches at dist 1, 31 and
    37; a 64 KB literal run; and zero-extended lengths over a 300-byte zero
    run, as the stop command (ok), a literal run and an M3 (both past 64 KB,
    malformed)."""
    from aircompressor_tpu_torch.ops.lzo_decode import WINDOWS, copy_reach, step_bytes

    cases = []
    for window in WINDOWS:
        reach, step = copy_reach(window), step_bytes(window)
        blk = LzoBlock(window).literals(window + 300)
        for k, dist in enumerate((reach - 1, reach, reach + 1)):
            family = "M3" if dist <= 16384 else "M4"
            for j, length in enumerate((9, 2 * step + 17, step)):
                blk.match(family, length, dist, (k + j) % 4)
                if blk.state == 0:
                    blk.literals(5 + k)
        cases.append((f"reach-{window}", blk.stop()))
    blk = LzoBlock(1).literals(49151 + 100)
    blk.match("M4", 300, 49151, 2).match("M4", 9, 49151).literals(7).match("M4", 40, 49150, 3)
    cases.append(("m4-49151", blk.stop()))
    blk = LzoBlock(2).literals(20000)
    blk.match("M1", 3, 2049, 1).match("M1", 2, 1, 2).match("M1", 2, 1024, 3).match("M1", 2, 5, 0)
    for tr in range(4):
        if blk.state:
            blk.match("M1", 2, 7, 0)
        blk.literals(4 + tr).match("M1", 3, 3072 - tr, tr)
        blk.match("M2", 3 + tr, 1 + 600 * tr, tr).match("M2", 8, 2048, tr)
        blk.match("M3", 5 + tr, 1000 + tr, tr).match("M4", 4 + tr, 16385 + 999 * tr, tr)
    blk.match("M3", 3000, 1, 1).match("M3", 2000, 37, 2).match("M3", 50, 31, 3)
    blk.match("M4", 700, 16385, 0)
    cases.append(("families", blk.stop()))
    cases.append(("literal-64k", LzoBlock(3).literals(65536).stop()))
    cases.append(("stop-zero-run-300", LzoBlock(4).first(17).stop(300)))
    cases.append(("literal-zero-run-300", b"\0" + bytes(300) + b"\x05" + bytes(50)))
    cases.append(("m3-zero-run-300", LzoBlock(5).first(9).stop()[:-3] + b"\x20" + bytes(300)
                  + b"\x05\x04\0\x11\0\0"))
    return cases


def corpus_full_cases() -> list[bytes]:
    """Six 64 KB corpus chunks, as the LZO and deflate paths give them: the
    zero chunk, the byte ramp and four text chunks."""
    from aircompressor_tpu_torch.ops.batch import _selfcheck_payload

    ramp = bytes(i & 0xFF for i in range(CHUNK))
    return [bytes(CHUNK), ramp] + [_selfcheck_payload(seed) for seed in (0, 33, 96, 251)]


def deflate_full_flush(data: bytes, every: int = 2048, level: int = 6) -> bytes:
    """A raw-deflate stream of data with a zlib full flush every ``every``
    bytes: two blocks a flush, more than the JAX planner's 16."""
    import zlib

    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    parts = [co.compress(data[i:i + every]) + co.flush(zlib.Z_FULL_FLUSH)
             for i in range(0, len(data), every)]
    return b"".join(parts) + co.flush()


DEFLATE_LBASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                 67, 83, 99, 115, 131, 163, 195, 227, 258)
DEFLATE_DBASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513,
                 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577)


def _deflate_extra(i: int, dist: bool) -> int:
    """The extra bits of length code 257 + i or distance code i."""
    return max(0, i // 2 - 1) if dist else (0 if i < 8 or i == 28 else i // 4 - 1)


class DeflateBits:
    """An RFC 1951 bit writer: fields LSB first, Huffman codes MSB first."""

    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, width: int) -> None:
        self.bits.extend((value >> i) & 1 for i in range(width))

    def huff(self, code: int, width: int) -> None:
        self.bits.extend((code >> i) & 1 for i in reversed(range(width)))

    def align(self) -> None:
        self.bits.extend([0] * (-len(self.bits) % 8))

    def fixed_symbol(self, sym: int) -> None:
        if sym < 144:
            self.huff(0x30 + sym, 8)
        elif sym < 256:
            self.huff(0x190 + sym - 144, 9)
        elif sym < 280:
            self.huff(sym - 256, 7)
        else:
            self.huff(0xC0 + sym - 280, 8)

    def fixed_block(self, tokens, final: bool) -> None:
        """A fixed-Huffman block of tokens: a literal byte (int) or a copy
        (length, dist), then the end of block."""
        import bisect

        self.put(int(final), 1)
        self.put(1, 2)
        for t in tokens:
            if isinstance(t, int):
                self.fixed_symbol(t)
                continue
            length, dist = t
            i = bisect.bisect_right(DEFLATE_LBASE, length) - 1
            self.fixed_symbol(257 + i)
            self.put(length - DEFLATE_LBASE[i], _deflate_extra(i, False))
            j = bisect.bisect_right(DEFLATE_DBASE, dist) - 1
            self.huff(j, 5)
            self.put(dist - DEFLATE_DBASE[j], _deflate_extra(j, True))
        self.fixed_symbol(256)

    def stored_block(self, data: bytes, final: bool) -> None:
        self.put(int(final), 1)
        self.put(0, 2)
        self.align()
        self.put(len(data), 16)
        self.put(len(data) ^ 0xFFFF, 16)
        for b in data:
            self.put(b, 8)

    def getvalue(self) -> bytes:
        self.align()
        return np.packbits(np.array(self.bits, np.uint8), bitorder="little").tobytes()


def _canonical_codes(lengths: dict) -> dict:
    """RFC 1951 canonical Huffman codes {symbol: (code, length)}."""
    codes, code, prev = {}, 0, 0
    for sym, n in sorted(lengths.items(), key=lambda kv: (kv[1], kv[0])):
        code <<= n - prev
        codes[sym], code, prev = (code, n), code + 1, n
    return codes


def deflate_dynamic_block(ll_lens: dict, d_lens: dict, symbols,
                          cl_symbols: int = 16) -> bytes:
    """One final dynamic-Huffman block with these literal/length and
    distance code lengths ({symbol: length}, whatever their Kraft sums),
    sent with a code-length code of 4 bits for each of the symbols 0 to
    ``cl_symbols`` - 1 (complete for 16), and then ``symbols``: (alphabet
    "ll" or "d", symbol, extra value, extra bits) in order."""
    acc, n = 0, 0

    def put(value: int, width: int) -> None:
        nonlocal acc, n
        acc |= value << n
        n += width

    def huff(code: int, width: int) -> None:  # Huffman codes go MSB first
        put(int(format(code, f"0{width}b")[::-1], 2), width)

    hlit = max(257, max(ll_lens) + 1)
    hdist = max(1, max(d_lens) + 1) if d_lens else 1
    put(1, 1)
    put(2, 2)
    put(hlit - 257, 5)
    put(hdist - 1, 5)
    put(19 - 4, 4)
    order = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
    for sym in order:
        put(4 if sym < cl_symbols else 0, 3)
    for i in range(hlit):
        huff(ll_lens.get(i, 0), 4)
    for i in range(hdist):
        huff(d_lens.get(i, 0), 4)
    codes = {"ll": _canonical_codes(ll_lens), "d": _canonical_codes(d_lens)}
    for alphabet, sym, extra, extra_bits in symbols:
        huff(*codes[alphabet][sym])
        put(extra, extra_bits)
    return acc.to_bytes((n + 7) // 8, "little")


def deflate_f3_stream() -> bytes:
    """"aaa" in a dynamic block whose literal/length code is incomplete: two
    codes of length 2 ('a' and end of block). The JAX planner takes it (ROADMAP
    F3); zlib rejects it ("invalid literal/lengths set"), and so does the
    port's planner."""
    return deflate_dynamic_block({97: 2, 256: 2}, {},
                                 [("ll", 97, 0, 0)] * 3 + [("ll", 256, 0, 0)])


def deflate_window_cases() -> list[tuple[str, bytes]]:
    """Hand-built raw-deflate streams for the deflate kernel's windows:
    copies at each window's reach (kWindow - 258) and one either side, with
    lengths 258 and 3, overlapping copies and the farthest distance; a
    64 KB all-literal fixed-Huffman block; a stored block between Huffman
    blocks whose copies reach into it and across it."""
    from aircompressor_tpu_torch.ops import deflate_decode

    rng = np.random.default_rng(41)
    lits = rng.integers(0, 256, 33000).tolist()
    copies = [(258, 1), (258, 3), (100, 7)]
    for reach in map(deflate_decode.copy_reach, deflate_decode.WINDOWS):
        copies += [(n, d) for d in (reach - 1, reach, reach + 1) for n in (258, 3)]
    copies.append((258, 32768))
    w = DeflateBits()
    w.fixed_block(lits + copies, final=True)
    reach = w.getvalue()
    w = DeflateBits()
    w.fixed_block(rng.integers(0, 256, CHUNK).tolist(), final=True)
    literal = w.getvalue()
    w = DeflateBits()
    w.fixed_block(rng.integers(0, 256, 5000).tolist() + [(258, 4999), (40, 1)], final=False)
    w.stored_block(rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(), final=False)
    w.fixed_block([(258, 1500), (258, 7000), 7, (3, 3300)], final=True)
    return [("reach", reach), ("literal-64k", literal), ("stored-between", w.getvalue())]


def deflate_slot_cases() -> list[tuple[str, bytes]]:
    """Dynamic blocks whose tables overflow the deflate kernel's table slot
    (SLOT entries from the lower root): "roots-apart", literal/length
    subtables of 320 entries, so the distance root lies past the slot; and
    "sub-outside", subtables of 256, so both roots fit and the distance
    subtable lies just past the slot. Both complete codes, symbols through
    the subtables."""
    deep = (10, 11, 12, 13, 14, 15, 15)  # one root prefix with a 64-entry subtable
    ll = {97: 1, 98: 2, 99: 3, 100: 4, 256: 5, 257: 6, 101: 8, 102: 9}
    ll.update(zip(range(103, 110), deep))
    ll.update((s, 15) for s in (*range(97), *range(110, 256), *range(258, 271)))
    apart = deflate_dynamic_block(ll, {0: 1}, [
        ("ll", 97, 0, 0), ("ll", 103, 0, 0), ("ll", 0, 0, 0), ("ll", 200, 0, 0),
        ("ll", 257, 0, 0), ("d", 0, 0, 0), ("ll", 98, 0, 0), ("ll", 256, 0, 0)])
    ll = {97: 1, 98: 2, 99: 3, 100: 4, 101: 5, 256: 6, 257: 7}
    ll.update(zip(range(103, 110), deep))
    ll.update((s, 15) for s in (*range(97), *range(110, 205)))
    dist = {d: d + 1 for d in range(9)}
    dist.update(zip(range(9, 16), deep))
    text = [("ll", 97 + i % 5, 0, 0) for i in range(60)]
    outside = deflate_dynamic_block(ll, dist, text + [
        ("ll", 103, 0, 0), ("ll", 257, 0, 0), ("d", 9, 2, 3), ("ll", 50, 0, 0),
        ("ll", 257, 0, 0), ("d", 12, 0, 5), ("ll", 256, 0, 0)])
    return [("roots-apart", apart), ("sub-outside", outside)]


def deflate_malformed_cases() -> list[tuple[str, bytes]]:
    """Raw-deflate streams that zlib and the planner reject, each with its
    name."""
    from aircompressor_tpu_torch.ops.batch import _selfcheck_payload, deflate_raw

    good = deflate_raw(_selfcheck_payload(5)[:20000])
    lit = [("ll", 97, 0, 0)]
    return [
        ("truncated", good[: len(good) // 2]),
        ("bad len/nlen", b"\x01\x05\x00\x00\x00hello"),
        ("btype 3", b"\x07"),
        ("over-subscribed code", deflate_dynamic_block(
            {97: 1, 98: 1, 256: 1}, {}, lit + [("ll", 256, 0, 0)])),
        ("distance too far back", deflate_dynamic_block(  # length 3, distance 2
            {97: 1, 256: 2, 257: 2}, {1: 1}, lit + [("ll", 257, 0, 0), ("d", 1, 0, 0),
                                                   ("ll", 256, 0, 0)])),
        ("incomplete code (F3)", deflate_f3_stream()),
        ("incomplete code-length code (F3)", deflate_dynamic_block(
            {97: 1, 256: 1}, {}, lit + [("ll", 256, 0, 0)], cl_symbols=15)),
    ]


def deflate_cases() -> tuple[list[bytes], list[bytes]]:
    """The deflate comparison's streams and their originals: the synthetic
    cases cut to 64 KB at levels 1, 6 and 9 (short ones in fixed-Huffman
    blocks, the random chunk in stored blocks), and a 64 KB corpus chunk
    with a full flush every 2 KB (65 blocks)."""
    from aircompressor_tpu_torch.ops.batch import _selfcheck_payload, deflate_raw

    raws = [c[:CHUNK] for _, c in synthetic_cases()]
    blobs = [deflate_raw(r, level) for level in (1, 6, 9) for r in raws]
    flushed = _selfcheck_payload(3)
    return blobs + [deflate_full_flush(flushed)], raws * 3 + [flushed]


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps calls, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel, plain, reps_kernel: int, reps_plain: int):
    """Kernel and plain times taken in turns: plain, kernel, kernel, plain."""
    p1 = time_ms(plain, reps_plain)
    k1 = time_ms(kernel, reps_kernel)
    k2 = time_ms(kernel, reps_kernel)
    p2 = time_ms(plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def steps_against_plain(name: str, kernel, plain, *args, **kw) -> int:
    """Hold a kernel's ``with_steps`` results to its plain version's, all
    four, and its first three to the kernel's own without steps; return the
    largest count."""
    k = kernel(*args, with_steps=True, **kw)
    p = plain(*args, with_steps=True, **kw)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(k, p)):
        require(torch.equal(a, b), f"{name} with_steps result {i} equals plain")
    for i, (a, b) in enumerate(zip(k[:3], kernel(*args, **kw))):
        require(torch.equal(a, b), f"{name} result {i} the same with and without steps")
    return int(k[3].max())


ENC_OUTPUTS = ("comp", "comp_lens", "ok", "steps")
# Shared-memory carveouts timed for the encode kernels, percent of an SM's
# most: 228, 196, 164, 132 and 100 KB, 6, 5, 4, 4 and 3 chunks (32 KB
# tables) an SM beside 28, 60, 92, 124 and 156 KB of L1.
ENC_CARVEOUTS = (100, 85, 71, 57, 43)
ENC_REDESIGN = ("PR 10: rounds of 32 probes over the shared-memory table, 128-byte "
                "extension, literal copies with loads in flight")


def _enc_modules():
    from aircompressor_tpu_torch.ops import lz4_encode, snappy_encode

    return (("snappy", snappy_encode), ("lz4", lz4_encode))


def encode_rounds_against_plain(dev) -> dict:
    """Hold the Snappy and LZ4 encode kernels to their plain versions on their
    round chunks (``encode_round_cases``) at width ENC_CUT + 1, tiled to 3
    and to 793 rows (past the 792 chunks a wave holds at 6 an SM), with
    ``with_steps`` (all four outputs) and without (the first three). Return
    each kernel's max_abs_err by name."""
    from aircompressor_tpu_torch.ops.batch import _pack, to_device_batch

    errs = {}
    for codec, mod in _enc_modules():
        chunks = [c for _, c in encode_round_cases(codec)]
        data, lens = to_device_batch(*_pack(chunks, ENC_CUT + 1), dev)
        want = mod.encode_plain(data, lens, with_steps=True)
        err = 0
        for rows in (3, 793):
            idx = torch.arange(rows, device=dev) % len(chunks)
            args = data[idx].contiguous(), lens[idx]
            tiled = [t[idx] for t in want]
            for got in (mod.encode(*args, with_steps=True), mod.encode(*args)):
                for name, a, b in zip(ENC_OUTPUTS, got, tiled):
                    require(torch.equal(a, b), f"{codec} encode {name} equal plain on the "
                            f"round chunks at {rows} rows, with_steps={len(got) == 4}")
                err = max(err, int((got[0].int() - tiled[0].int()).abs().max()))
        errs[f"{codec}_encode"] = err
        print(f"{codec} encode: the {len(chunks)} round chunks at width {ENC_CUT + 1}, tiled to "
              f"3 and 793 rows, with and without steps: kernel == plain (comp, comp_lens, ok, "
              f"steps), max_abs_err {err}; steps {want[3].tolist()}")
    return errs


def encoded_matches(codec: str, blob: bytes) -> int:
    """The matches in a block as these encoders write it: LZ4's sequences
    with an offset; Snappy's copies, the pieces of one match (one offset, no
    literal between them) counted once."""
    i, count = 0, 0
    if codec == "lz4":
        while True:
            token = blob[i]
            i += 1
            lit = token >> 4
            if lit == 15:  # the 255-extension ends at its first byte under 255
                while blob[i] == 255:
                    lit += 255
                    i += 1
                lit += blob[i]
                i += 1
            i += lit
            if i >= len(blob):
                return count
            count += 1
            i += 2
            if token & 15 == 15:
                while blob[i] == 255:
                    i += 1
                i += 1
    while blob[i] & 128:  # the varint length
        i += 1
    i += 1
    last = None
    while i < len(blob):
        tag, kind = blob[i], blob[i] & 3
        if kind == 0:
            n1 = tag >> 2
            size = {60: 1, 61: 2}.get(n1, 0)
            n1 = int.from_bytes(blob[i + 1:i + 1 + size], "little") if size else n1
            i += 1 + size + n1 + 1
            last = None
            continue
        dist = (((tag >> 5) << 8) | blob[i + 1]) if kind == 1 else blob[i + 1] | blob[i + 2] << 8
        count += dist != last
        last = dist
        i += 2 if kind == 1 else 3
    return count


def encode_chains_against_plain(raw, raw_lens) -> dict:
    """Hold both encode kernels with ``with_steps`` to their plain versions on
    the corpus (all four outputs), and return for each its longest chain:
    chunk, probes and matches, and the probes of all chunks."""
    chains = {}
    for codec, mod in _enc_modules():
        got = mod.encode(raw, raw_lens, with_steps=True)
        t0 = time.perf_counter()
        want = mod.encode_plain(raw, raw_lens, with_steps=True)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        for name, a, b in zip(ENC_OUTPUTS, got, want):
            require(torch.equal(a, b), f"{codec} encode {name} equal plain on the corpus")
        steps = got[3]
        top = int(steps.argmax())
        blob = got[0][top, :int(got[1][top])].cpu().numpy().tobytes()
        chain = dict(chunk=top, probes=int(steps[top]), matches=encoded_matches(codec, blob),
                     total=int(steps.sum()),
                     err=int((got[0].int() - want[0].int()).abs().max()))
        chains[codec] = chain
        print(f"{codec} encode on the corpus: kernel == plain with steps (comp, comp_lens, ok, "
              f"steps; plain {t_plain:.1f} s, host clock); longest chain chunk {top}: "
              f"{chain['probes']} probes, {chain['matches']} matches; {chain['total']} "
              f"probes in all")
    return chains


def snappy_window_against_plain(dev, blobs: list[bytes]) -> int:
    """Hold both windows of the Snappy decode kernel to the plain version
    with steps: the given blobs and the hand-built window cases tiled to 257
    rows (the 32 KB window) and to SMALL_BATCH + 1 rows (the 4 KB window) of
    an odd width, at out_cap 64 KB and 4093, and each distinct row alone;
    return the max_abs_err."""
    from aircompressor_tpu_torch.ops import snappy_decode
    from aircompressor_tpu_torch.ops.batch import _pack, to_device_batch

    blobs = blobs + [b for _, b in snappy_window_cases()]
    n, err = len(snappy_window_cases()), 0
    for rows in (257, snappy_decode.SMALL_BATCH + 1):
        batch = (blobs * (rows // len(blobs) + 1))[:rows]
        comp, lens = to_device_batch(*_pack(batch, max(map(len, batch)) | 1), dev)
        for out_cap in (CHUNK, 4093):
            p = snappy_decode.decode_plain(comp, lens, out_cap=out_cap, with_steps=True)
            k = snappy_decode.decode(comp, lens, out_cap=out_cap, with_steps=True)
            torch.cuda.synchronize()
            require(out_cap < CHUNK or bool(p[2][len(blobs) - n:len(blobs)].all()),
                    "the window cases decode ok")
            for name, a, b in zip(("out", "out_lens", "ok", "steps"), k, p):
                require(torch.equal(a, b), f"decode {name} equal plain at out_cap "
                                           f"{out_cap}, {rows} rows")
            err = max(err, int((k[0].int() - p[0].int()).abs().max()))
            if rows == 257:
                for i in range(len(blobs)):
                    one = snappy_decode.decode(comp[i:i + 1], lens[i:i + 1], out_cap=out_cap,
                                               with_steps=True)
                    require(all(torch.equal(a[0], b[i]) for a, b in zip(one, p)),
                            f"decode row {i} alone equals plain at out_cap {out_cap}")
    print(f"snappy decode windows {snappy_decode.WINDOWS}: 257 and "
          f"{snappy_decode.SMALL_BATCH + 1} rows of an odd width ({n} window cases: 64 KB "
          f"dist-1 run, 64 KB literal, copies at each reach +- 1, mixed) and each of the "
          f"{len(blobs)} rows alone, out_cap {CHUNK} and 4093, kernel == plain (out, "
          f"out_lens, ok, steps), max_abs_err {err}")
    return err


def xxh64_batches_against_plain(dev) -> int:
    """Hold the xxh64 kernel to its plain version at 1, 7 and 257 rows (1,
    1 and 2 streams a warp) of 64 KB and 65,531 B, lengths -1, 0, 31, 32,
    past the row and random, at every seed of the seed check; the first 7
    rows to the host too. Return the max_abs_err."""
    from aircompressor_tpu_torch.host.xxhash import xxh64 as host_xxh64
    from aircompressor_tpu_torch.ops import xxhash

    rng = np.random.default_rng(44)
    err = 0
    for width in (CHUNK, CHUNK - 5):
        for b in (1, 7, 257):
            host = rng.integers(0, 256, (b, width), dtype=np.uint8)
            lens_list = ([-1, 0, 31, 32, width + 9, width, 65]
                         + rng.integers(0, width, b, dtype=np.int64).tolist())[:b]
            data = torch.from_numpy(host).to(dev)
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            for seed in (*XXH_SEEDS, (1 << 64) - 1):
                k = [v & (2**64 - 1) for v in xxhash.xxh64(data, lens, seed).tolist()]
                p = [v & (2**64 - 1) for v in xxhash.xxh64_plain(data, lens, seed).tolist()]
                s = [host_xxh64(host[i, :min(max(n, 0), width)], seed)
                     for i, n in enumerate(lens_list[:7])]
                require(k == p and k[:7] == s, f"xxh64 kernel == plain == host at "
                                               f"{b} rows of {width} B, seed {seed:#x}")
                err = max([err] + [abs(x - y) for x, y in zip(k, p)])
    print(f"xxh64: 1, 7 and 257 rows of {CHUNK} and {CHUNK - 5} B, lengths -1, 0, 31, 32, "
          f"past the row and random, seeds {[hex(x) for x in XXH_SEEDS]} and 2^64-1: "
          f"kernel == plain (== host on the first 7 rows), max_abs_err {err}")
    return err


def xxh32_batches_against_plain(dev) -> int:
    """Hold the xxh32 kernel to its plain version and the host at 1, 7, 257,
    529, 1,057 and 2,113 rows (1, 1, 1, 2, 4 and 8 streams a warp) of 64 KB
    (the staged variant) and 65,533 B (the plain variant), lengths -1, 0, 15, 16,
    past the row and random, at every seed of the seed check; the first 7
    rows and the last to the host too. Return the max_abs_err."""
    from aircompressor_tpu_torch.host.xxhash import xxh32 as host_xxh32
    from aircompressor_tpu_torch.ops import xxhash

    rng = np.random.default_rng(45)
    err = 0
    for width in (CHUNK, CHUNK - 3):
        for b in (1, 7, 257, 529, 1057, 2113):
            host = rng.integers(0, 256, (b, width), dtype=np.uint8)
            lens_list = ([-1, 0, 15, 16, width + 9, width, 65]
                         + rng.integers(0, width, b, dtype=np.int64).tolist())[:b]
            data = torch.from_numpy(host).to(dev)
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            for seed in (*XXH_SEEDS, (1 << 32) - 1):
                k = xxhash.xxh32(data, lens, seed).tolist()
                p = xxhash.xxh32_plain(data, lens, seed).tolist()
                some = sorted({*range(min(b, 7)), b - 1})
                s = [host_xxh32(host[i, :min(max(lens_list[i], 0), width)], seed)
                     for i in some]
                require(k == p and [k[i] for i in some] == s,
                        f"xxh32 kernel == plain == host at {b} rows of {width} B, seed "
                        f"{seed:#x}")
                err = max([err] + [abs(x - y) for x, y in zip(k, p)])
    print(f"xxh32: 1, 7, 257, 529, 1057 and 2113 rows of {CHUNK} and {CHUNK - 3} B, lengths -1, "
          f"0, 15, 16, past the row and random, seeds {[hex(x) for x in XXH_SEEDS]} and "
          f"2^32-1: kernel == plain (== host on the first 7 rows and the last), "
          f"max_abs_err {err}")
    return err


def lz4_windows_against_plain(dev, blobs: list[bytes]) -> int:
    """Hold both windows of the LZ4 decode kernel to the plain version with
    steps: the given blobs and the hand-built window cases tiled to 257 rows
    (the 32 KB window) and to SMALL_BATCH + 1 rows (the 4 KB window) of an
    odd width, at out_cap 64 KB, 4096 and 4093; the flags and bytes against
    the host decoder. Return the max_abs_err."""
    from aircompressor_tpu_torch.errors import MalformedInputException
    from aircompressor_tpu_torch.host import lz4 as host_lz4
    from aircompressor_tpu_torch.ops import lz4_decode
    from aircompressor_tpu_torch.ops.batch import _pack, to_device_batch

    cases = lz4_window_cases()
    blobs = blobs + [b for _, b in cases]
    want = []
    for b in blobs:
        try:
            want.append(host_lz4.decompress(b, CHUNK))
        except MalformedInputException:
            want.append(None)
    err = 0
    for rows in (257, lz4_decode.SMALL_BATCH + 1):
        batch = (blobs * (rows // len(blobs) + 1))[:rows]
        comp, lens = to_device_batch(*_pack(batch, max(map(len, batch)) | 1), dev)
        for out_cap in (CHUNK, 4096, 4093):
            p = lz4_decode.decode_plain(comp, lens, out_cap=out_cap, with_steps=True)
            k = lz4_decode.decode(comp, lens, out_cap=out_cap, with_steps=True)
            torch.cuda.synchronize()
            for name, a, b in zip(("out", "out_lens", "ok", "steps"), k, p):
                require(torch.equal(a, b), f"lz4 decode {name} equal plain at out_cap "
                                           f"{out_cap}, {rows} rows")
            err = max(err, int((k[0].int() - p[0].int()).abs().max()))
            got = k[2].tolist()
            for i, w in enumerate(want):
                require(got[i] == (w is not None and len(w) <= out_cap),
                        f"lz4 window case {i} ok as the host at out_cap {out_cap}")
                if w is not None:
                    require(k[0][i, :min(len(w), out_cap)].cpu().numpy().tobytes()
                            == w[:out_cap], f"lz4 window case {i} equals the host's bytes")
    print(f"lz4 decode windows {lz4_decode.WINDOWS}: 257 and {lz4_decode.SMALL_BATCH + 1} "
          f"rows of an odd width ({len(blobs) - len(cases)} blobs and {len(cases)} window "
          f"cases: {', '.join(n for n, _ in cases)}), out_cap {CHUNK}, 4096 and 4093, "
          f"kernel == plain (out, out_lens, ok, steps), cases == host decoder, max_abs_err "
          f"{err}")
    return err


def bound_ms(read_bytes: int, write_bytes: int) -> float:
    """The least time for the card to move these bytes once each."""
    return (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3


def zstd_bound_ms(plan, kernel: str) -> float:
    """The bytes bound of one zstd kernel on a batch plan: each stream,
    section, table entry, triple and literal that it needs read once, each
    output written once."""
    if kernel == "zstd_huffman":  # the streams, the walk's 29 words and the
        # permutation in; the literals and final bit counts out
        return bound_ms(sum((h.rem_init + 8) // 8 + 4 * 29 + 256 for h in plan.huff_streams),
                        sum(h.nsym + 4 for h in plan.huff_streams))
    if kernel == "zstd_fse":  # the sections, 7 words and the FSE entries of
        # their table sizes in; the triples, bit counts and flags out
        return bound_ms(sum((s.rem_init + s.ll_log + s.of_log + s.ml_log + 8) // 8 + 4 * 7
                            + 4 * ((1 << s.ll_log) + (1 << s.of_log) + (1 << s.ml_log))
                            for s in plan.seq_streams),
                        sum(12 * s.nseq + 8 for s in plan.seq_streams))
    blocks = [bp for fp in plan.frames for bp in fp.blocks]  # zstd_execute: the
    # triples, the literals (not RLE ones), the block rows in; the rows out
    lits = sum(bp.lit_total for bp in blocks if bp.piece_kind[0] != 2)
    return bound_ms(sum(12 * bp.n_seq + 64 for bp in blocks) + lits + 8 * len(plan.frames),
                    len(plan.frames) * (plan.out_cap + 5))


def gbps(nbytes, ms):
    return nbytes / ms / 1e6


def zstd_plain_check(pk) -> tuple[dict, float, int]:
    """Hold each zstd kernel to its plain version on one packed batch, the
    execute kernel on the plain literals and triples. Returns each kernel's
    max_abs_err, the plain versions' time (host clock) and the largest match
    offset of the batch."""
    from aircompressor_tpu_torch.ops import zstd_decode

    h_args, s_args, _ = zstd_args(pk)
    k_h = zstd_decode.huffman_decode(*h_args)
    k_s = zstd_decode.fse_sequences(*s_args)
    t0 = time.perf_counter()
    p_h = zstd_decode.huffman_decode_plain(*h_args)
    p_s = zstd_decode.fse_sequences_plain(*s_args[:5])
    x_args = (pk.src, p_h[0], p_s[0], pk.b_frames, pk.blocks)
    p_x = zstd_decode.execute_plain(*x_args)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    k_x = zstd_decode.execute(*x_args)
    torch.cuda.synchronize()
    errs = {}
    for name, ks, ps in (("zstd_huffman", k_h, p_h), ("zstd_fse", k_s, p_s),
                         ("zstd_execute", k_x, p_x)):
        for k, p in zip(ks, ps):
            require(torch.equal(k, p), f"{name} kernel == plain")
        errs[name] = max(int((k.long() - p.long()).abs().max()) if k.numel() else 0
                         for k, p in zip(ks, ps))
    return errs, t_plain, int(p_s[0][:, 2].max()) if p_s[0].numel() else 0


def zstd_kernels_against_plain(dev) -> dict:
    """Hold the three zstd kernels to their plain versions on two batches:
    the zstd cases through the host encoder, the libzstd fixture and the
    malformed cases; then 64 KB chunks through the host encoder at level 3,
    as the decode path gives them. Then decode each batch through all three
    and check every frame: the good ones give their originals, the
    malformed ones are rejected as their cases say."""
    from aircompressor_tpu_torch.data import libzstd_frames, zstandard_version
    from aircompressor_tpu_torch.host.zstd import device_prep, frame_enc
    from aircompressor_tpu_torch.ops import zstd_decode

    print("== zstd kernels against plain on the card", flush=True)
    raws, fixture, bad = zstd_cases(), libzstd_frames(), zstd_malformed_cases()
    items = ([frame_enc.compress_bytes(r) for r in raws]
             + [f["frame"] for f in fixture] + [b for _, b, _ in bad])
    want = raws + [f["original"] for f in fixture]
    full = zstd_full_cases()
    full_items = [frame_enc.compress_bytes(c, 3) for c in full]
    plan = device_prep.plan_batch(items, CHUNK)
    full_plan = device_prep.plan_batch(full_items, CHUNK)
    pk, full_pk = zstd_decode.pack(plan, dev), zstd_decode.pack(full_plan, dev)
    errs, t_plain, _ = zstd_plain_check(pk)
    full_errs, t_full_plain, full_offset = zstd_plain_check(full_pk)
    errs = {k: max(v, full_errs[k]) for k, v in errs.items()}

    errs["zstd_huffman"] = max(errs["zstd_huffman"],
                               huffman_lanes_against_plain(dev, (pk, full_pk)))
    errs["zstd_execute"] = max(errs["zstd_execute"], execute_rounds_against_plain(dev))
    errs["zstd_fse"] = max(errs["zstd_fse"], fse_sections_against_plain(dev))

    res, full_res = zstd_decode.decode_plan(pk), zstd_decode.decode_plan(full_pk)
    ok, checksum_ok = res["ok"].tolist(), res["checksum_ok"].tolist()
    lens = res["out_len"].tolist()
    n_good = len(want)
    require(all(ok[:n_good]) and all(checksum_ok[:n_good]), "every good zstd frame ok")
    for i, w in enumerate(want):
        require(lens[i] == len(w) and res["out"][i, :len(w)].cpu().numpy().tobytes() == w,
                f"zstd frame {i} decodes to its original")
    for (name, _, reason), ok_i, cks_i in zip(bad, ok[n_good:], checksum_ok[n_good:]):
        by_checksum = reason.startswith("frame checksum")
        require(ok_i and not cks_i if by_checksum else not ok_i,
                f"zstd malformed case '{name}' rejected: ok {ok_i}, checksum_ok {cks_i}")
    require(bool(full_res["ok"].all()) and bool(full_res["checksum_ok"].all()),
            "every 64 KB zstd frame of the comparison ok")
    for i, c in enumerate(full):
        require(int(full_res["out_len"][i]) == len(c)
                and full_res["out"][i, :len(c)].cpu().numpy().tobytes() == c,
                f"64 KB zstd frame {i} decodes to its original")
    later = sum(bp.n_seq > 0 for f, fp in zip(fixture, plan.frames[len(raws):])
                if f["flush"] for bp in fp.blocks[1:])
    print(f"zstd: {len(items)} frames ({len(raws)} from the host encoder, {len(fixture)} "
          f"from libzstd {zstandard_version()}, {len(bad)} malformed); "
          f"{len(plan.huff_streams)} Huffman streams, {len(plan.seq_streams)} sequences "
          f"sections, {later} of them after the first block of a multi-block libzstd "
          f"frame; kernel == plain; plain versions {t_plain:.2f} s (host clock)")
    print(f"zstd: {len(full_items)} frames of 64 KB chunks at level 3: "
          f"{len(full_plan.huff_streams)} Huffman streams of up to "
          f"{max(h.nsym for h in full_plan.huff_streams)} symbols, "
          f"{sum(s.nseq for s in full_plan.seq_streams)} sequences, offsets up to "
          f"{full_offset}; kernel == plain; "
          f"plain versions {t_full_plain:.2f} s (host clock); max_abs_err over both "
          f"batches {errs}")
    return dict(n_frames=len(items), plan=plan, pk=pk, errs=errs)


def execute_rounds_against_plain(dev) -> int:
    """Hold both windows of the zstd execute kernel to its plain version on
    the hand-built round cases (``execute_round_cases``), their frames tiled
    to 257 rows (the 32 KB window; out_cap 64 KB and 4093) and
    EXECUTE_SMALL_BATCH + 1 rows (the 4 KB window; out_cap 64 KB); return
    the max_abs_err."""
    from aircompressor_tpu_torch.ops import zstd_decode

    names, arrays = execute_round_cases()
    a = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    err = 0
    for rows in (257, zstd_decode.EXECUTE_SMALL_BATCH + 1):
        frames = a["frames"].repeat(rows // len(names) + 1, 1)[:rows].contiguous()
        args = (a["src"], a["lit"], a["seq3"], frames, a["blocks"])
        for out_cap in (CHUNK, 4093) if rows == 257 else (CHUNK,):
            p = zstd_decode.execute_plain(*args, out_cap=out_cap)
            k = zstd_decode.execute(*args, out_cap=out_cap)
            torch.cuda.synchronize()
            for name, x, y in zip(("out", "out_len", "ok"), k, p):
                require(torch.equal(x, y), f"zstd_execute {name} equal plain on the round "
                                           f"cases at out_cap {out_cap}, {rows} rows")
            err = max(err, int((k[0].int() - p[0].int()).abs().max()))
            good = [n for n, ok in zip(names, k[2].tolist()) if ok]
            require(out_cap < CHUNK or good == [n for n in names if not n.startswith(
                ("bad", "ll-", "ml-", "past"))], f"the round cases ok as named: {good[:30]}")
    print(f"zstd_execute windows {zstd_decode.EXECUTE_WINDOWS}: the {len(names)} round cases "
          f"({', '.join(names)}) tiled to 257 and {zstd_decode.EXECUTE_SMALL_BATCH + 1} "
          f"frames, out_cap {CHUNK} (and 4093 at 257), kernel == plain (out, out_len, ok), "
          f"max_abs_err {err}")
    return err


def tile_sections(a: dict, n: int) -> dict:
    """``n`` copies of a packed batch of sequences sections (one frame each
    per copy), each copy's triples in slots of its own."""
    S, slots = a["params"].shape[0], a["seq_slots"]
    return dict(src=a["src"],
                params=np.concatenate([a["params"] + np.array([0, 0, 0, k * slots, 0, 0, 0, 0],
                                                              np.int32) for k in range(n)]),
                tabs=np.tile(a["tabs"], (n, 1)),
                frames=np.concatenate([a["frames"] + np.array([k * S, 0], np.int32)
                                       for k in range(n)]),
                seq_slots=n * slots)


def fse_sections_against_plain(dev) -> int:
    """Hold the FSE kernel to its plain version on all three outputs: on
    the hand-built sections
    (``fse_section_cases``, three copies: 30 frames) and on a batch of the
    64 KB short-match chunk through the host encoder (one section of
    thousands of sequences over many ring slices) and the libzstd fixture's
    frames (multi-block, repeat offsets carried across blocks: F7), whose
    frames then decode to their originals. Return the max_abs_err."""
    from aircompressor_tpu_torch.data import libzstd_frames
    from aircompressor_tpu_torch.host.zstd import device_prep, frame_enc
    from aircompressor_tpu_torch.ops import zstd_decode

    names, a = fse_section_cases()
    t = tile_sections(a, 3)
    hand = tuple(torch.from_numpy(t[k]).to(dev) for k in ("src", "params", "tabs", "frames"))
    hand += (t["seq_slots"],)
    fixture = libzstd_frames()
    chunk = fse_short_match_chunk()
    frames = [frame_enc.compress_bytes(chunk, 3)] + [f["frame"] for f in fixture]
    want = [chunk] + [f["original"] for f in fixture]
    plan = device_prep.plan_batch(frames, CHUNK)
    pk = zstd_decode.pack(plan, dev)
    real = (pk.src, pk.s_params, pk.s_tabs, pk.s_frames, pk.seq_slots)
    err = 0
    for what, args in (("hand-built", hand), ("short-match and libzstd", real)):
        p = zstd_decode.fse_sequences_plain(*args)
        k = zstd_decode.fse_sequences(*args)
        torch.cuda.synchronize()
        for name, x, y in zip(("seq3", "rem", "err"), k, p):
            require(torch.equal(x, y), f"zstd_fse {name} equal plain on the {what} sections")
        err = max(err, max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
                           for x, y in zip(k, p)))
    res = zstd_decode.decode_plan(pk)
    require(bool(res["ok"].all()) and bool(res["checksum_ok"].all()),
            "the short-match and libzstd frames decode ok")
    for i, w in enumerate(want):
        require(int(res["out_len"][i]) == len(w)
                and res["out"][i, :len(w)].cpu().numpy().tobytes() == w,
                f"short-match batch frame {i} decodes to its original")
    flags = zstd_decode.fse_sequences_plain(*hand)[2].tolist()[:a["params"].shape[0]]
    big = max(plan.seq_streams, key=lambda s: s.nseq)
    print(f"zstd_fse: the hand-built sections "
          f"({', '.join(names)}; err {flags}) tiled to {len(t['frames'])} frames, and the "
          f"64 KB short-match frame ({big.nseq} sequences, "
          f"{big.rem_init // 8} B of bitstream) with the {len(fixture)} libzstd frames: kernel == "
          f"plain (seq3, rem, err), frames == originals, max_abs_err {err}")
    return err


def huffman_lanes_against_plain(dev, packed) -> int:
    """Hold the Huffman kernel to its plain version, ``lit`` and ``rem``, on
    the hand-made lane streams (``huffman_lane_cases``, two of them of
    three segments) and on the ``packed`` batches; return the
    max_abs_err."""
    from aircompressor_tpu_torch.ops import zstd_decode

    cases = huffman_lane_cases()
    batches = [huffman_lane_batch(cases, dev)] + [
        (pk.src, pk.h_params, pk.h_perm, pk.lit_size) for pk in packed]
    err = 0
    for b, args in enumerate(batches):
        want = zstd_decode.huffman_decode_plain(*args)
        got = zstd_decode.huffman_decode(*args)
        torch.cuda.synchronize()
        for name, a, w in zip(("lit", "rem"), got, want):
            require(torch.equal(a, w), f"zstd_huffman {name} equal plain on batch {b}")
            err = max(err, int((a.long() - w.long()).abs().max()) if a.numel() else 0)
    print(f"zstd_huffman: the lane cases ({', '.join(n for n, _ in cases)}; rem "
          f"{zstd_decode.huffman_decode_plain(*batches[0])[1].tolist()}) and both batches: "
          f"kernel == plain on lit and rem, max_abs_err {err}")
    return err


def zstd_args(pk) -> tuple:
    """The three zstd kernels' arguments on a packed batch; the execute
    kernel's literals and triples come from the other two kernels."""
    from aircompressor_tpu_torch.ops import zstd_decode

    h_args = (pk.src, pk.h_params, pk.h_perm, pk.lit_size)
    s_args = (pk.src, pk.s_params, pk.s_tabs, pk.s_frames, pk.seq_slots)
    lit, _ = zstd_decode.huffman_decode(*h_args)
    seq3, _, _ = zstd_decode.fse_sequences(*s_args)
    return h_args, s_args, (pk.src, lit, seq3, pk.b_frames, pk.blocks)


def packed_equal(a, b) -> bool:
    """Two ``zstd_decode.Packed`` batches are the same, tensor for tensor:
    dtype, shape and values, and the three sizes."""
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in (
        (getattr(a, k), getattr(b, k)) for k in ZSTD_PACKED_TENSORS)) and (
        (a.lit_size, a.seq_slots, a.out_cap) == (b.lit_size, b.seq_slots, b.out_cap))


ZSTD_PACKED_TENSORS = ("src", "h_params", "h_perm", "s_params", "s_tabs", "s_frames", "blocks",
                       "b_frames", "h_frame", "s_frame", "content_size", "checksum")


def zstd_decode_path(dev, corpus: list[bytes], sustain: int = SUSTAIN) -> dict:
    """The zstd decode path: the corpus through the host encoder at level 3,
    ``ZstdBatchCodec.decompress_chunks`` on its frames, then the frames tiled
    ``sustain`` times, planned once by the C++ planner and run through the
    three kernels and the xxh64 kernel, with the launch counts set to 0 just
    before and read just after. Every byte and every XXH64 is checked. Then
    the Python planner (``device_prep.plan_batch`` and ``pack``) on the same
    batches, timed beside the C++ planner, whose plans must equal its."""
    from aircompressor_tpu_torch.host.xxhash import xxh64 as host_xxh64
    from aircompressor_tpu_torch.host.zstd import device_prep, frame_enc
    from aircompressor_tpu_torch.ops import xxhash, zstd_decode
    from aircompressor_tpu_torch.ops.batch import ZstdBatchCodec, _pack, to_device_batch

    print("== zstd decode path at real size (generated corpus)", flush=True)
    n = len(corpus)
    t0 = time.perf_counter()
    frames = [frame_enc.compress_bytes(c, 3) for c in corpus]
    t_encode = time.perf_counter() - t0
    raw, raw_lens = to_device_batch(*_pack(corpus, CHUNK), dev)
    big_raw, big_lens = raw.repeat(sustain, 1), raw_lens.repeat(sustain)
    want_hash = [host_xxh64(c) for c in corpus] * sustain
    tiled = frames * sustain

    codec = ZstdBatchCodec(device=dev)  # its canary runs on the path
    zstd_decode.huffman_launches = zstd_decode.fse_launches = 0
    zstd_decode.execute_launches = zstd_decode.execute_frames = xxhash.launches = 0
    t0 = time.perf_counter()
    decoded = codec.decompress_chunks(frames)
    t_codec = time.perf_counter() - t0
    t0 = time.perf_counter()
    big_pk = zstd_decode.plan(tiled, CHUNK, dev)
    torch.cuda.synchronize()
    t_plan_big = time.perf_counter() - t0
    t0 = time.perf_counter()
    big = zstd_decode.decode_plan(big_pk)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t0
    counts = {"zstd_huffman": zstd_decode.huffman_launches,
              "zstd_fse": zstd_decode.fse_launches,
              "zstd_execute": zstd_decode.execute_launches, "xxh64": xxhash.launches}
    exec_frames = zstd_decode.execute_frames

    n_all = 1 + n + n * sustain  # the canary, then the two batches
    require(all(c > 0 for c in counts.values()), f"the zstd kernels launched: {counts}")
    require(exec_frames == n_all,
            f"every zstd frame went through the kernels: {exec_frames}/{n_all}")
    require(decoded == corpus, "ZstdBatchCodec.decompress_chunks returns the corpus")
    require(bool(big["ok"].all()) and bool(big["checksum_ok"].all()),
            "every tiled zstd frame decodes ok with its checksum")
    require(torch.equal(big["out_len"], big_lens) and torch.equal(big["out"], big_raw),
            "every tiled zstd frame decodes to its original")
    require([v & (2**64 - 1) for v in big["digest"].tolist()] == want_hash,
            "every xxh64 of a decoded zstd frame equals the host's of its original")

    # The two planners on the same batches, each to host tensors: the C++
    # planner (plan and layout) against the Python planner and pack.
    t = {}
    for name, items in (("corpus", frames), ("tiled", tiled)):
        t0 = time.perf_counter()
        cc = zstd_decode.plan(items, CHUNK, "cpu")
        t[f"cc_{name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        py_plan = device_prep.plan_batch(items, CHUNK, item_errors=True)
        t[f"py_{name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = zstd_decode.pack(py_plan, "cpu")
        t[f"py_pack_{name}"] = time.perf_counter() - t0
        require(packed_equal(cc, py), f"the C++ plan of the {name} frames equals the "
                                      f"Python planner's, tensor for tensor")
        if name == "corpus":
            plan = py_plan
        else:
            big_plan = py_plan
    pk = zstd_decode.plan(frames, CHUNK, dev)
    print(f"host zstd encoder: {n} frames, {sum(map(len, corpus))} B -> "
          f"{sum(map(len, frames))} B in {t_encode:.2f} s (host clock)")
    print(f"ZstdBatchCodec.decompress_chunks: {n} frames in {t_codec:.3f} s (host clock, "
          f"canary, C++ planner, staging and copies included)")
    print(f"tiled x{sustain}: {len(big_plan.frames)} frames: C++ planner and upload "
          f"{t_plan_big:.4f} s, kernels and xxh64 {t_big:.3f} s (host clock, first call); "
          f"{len(big_plan.huff_streams)} Huffman streams, {len(big_plan.seq_streams)} "
          f"sequences sections")
    print(f"zstd decode planners (host clock, to host tensors, plans equal): {n} frames: "
          f"C++ {t['cc_corpus']:.4f} s, Python {t['py_corpus']:.4f} s + pack "
          f"{t['py_pack_corpus']:.4f} s; {len(tiled)} frames: C++ {t['cc_tiled']:.4f} s, "
          f"Python {t['py_tiled']:.4f} s + pack {t['py_pack_tiled']:.4f} s")
    print(f"zstd path launches {counts}, {exec_frames} of {n_all} frames through the "
          f"execute kernel")
    fse_err = 0  # the FSE kernel against its plain version on both batches
    for what, p in (("the corpus's", pk), ("the tiled", big_pk)):
        args = (p.src, p.s_params, p.s_tabs, p.s_frames, p.seq_slots)
        k = zstd_decode.fse_sequences(*args)
        w = zstd_decode.fse_sequences_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("seq3", "rem", "err"), k, w):
            require(torch.equal(a, b), f"zstd_fse {name} equal plain on {what} frames")
        fse_err = max(fse_err, max(int((a.long() - b.long()).abs().max()) for a, b in zip(k, w)))
    print(f"zstd_fse on the corpus's {len(plan.frames)} frames and the {len(big_plan.frames)} "
          f"tiled: kernel == plain (seq3, rem, err), max_abs_err {fse_err}")
    return dict(plan=plan, pk=pk, big_plan=big_plan, fse_err=fse_err,
                big_pk=big_pk, counts=counts, t_plan_big=t_plan_big, planner_times=t,
                decoded_bytes=int(big_lens.sum()), frames=frames, t_encode=t_encode)


def alone_ms(fn, kernel: str, batches):
    """The kernel alone at each of three batches (device time from a
    profiler trace, without the wrapper's allocations, copies and host
    time): the kernels JSON's kernel_ms, chunks_kernel_ms and
    tiled_kernel_ms."""
    from aircompressor_tpu_torch import _build
    from aircompressor_tpu_torch.ops import profiling

    out = _build.BUILD_DIR.parent / "profile" / kernel
    times = [profiling.kernel_ms(lambda: fn(*args), kernel, 5, str(out)) for args in batches]
    print(f"{kernel} alone (profiler device time): " + ", ".join(f"{t:.4f}" for t in times)
          + " ms at the three batches")
    return dict(zip(("kernel_ms", "chunks_kernel_ms", "tiled_kernel_ms"), times))


def fse_times(zp: dict, fn, batches) -> dict:
    """The FSE kernel alone (profiler device time: at 256 frames its
    wrapper's host time passes the kernel's) at the three batches; its
    waves, ns a sequence of the longest frame and of an SM, and that frame
    alone (the chain by itself). Returns the kernels JSON's extra keys."""
    from aircompressor_tpu_torch import _build
    from aircompressor_tpu_torch.host.zstd import device_prep
    from aircompressor_tpu_torch.ops import profiling, zstd_decode

    _, mid, big = batches
    plan, big_plan = zp["plan"], zp["big_plan"]
    per_frame = [sum(bp.n_seq for bp in fp.blocks) for fp in plan.frames]
    longest = max(per_frame)
    total = sum(s.nseq for s in big_plan.seq_streams)
    n_mid, n_big = len(plan.frames), len(big_plan.frames)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = str(_build.BUILD_DIR.parent / "profile" / "fse")
    alone = alone_ms(fn, "fse_kernel", batches)
    waves = {n: zstd_decode.fse_waves(n) for n in (n_mid, n_big)}
    one = zstd_decode.pack(device_prep.plan_batch([zp["frames"][per_frame.index(longest)]],
                                                  CHUNK), mid[0].device)
    one_args = (one.src, one.s_params, one.s_tabs, one.s_frames, one.seq_slots)
    one_ms = profiling.kernel_ms(lambda: fn(*one_args), "fse_kernel", 5, out)
    print(f"zstd_fse alone: {alone['chunks_kernel_ms'] * 1e6 / longest:.1f} ns a sequence of "
          f"the longest frame ({longest} sequences) at {n_mid} frames; "
          f"{alone['tiled_kernel_ms'] * 1e6 * sms / total:.2f} ns a sequence of an SM (all "
          f"{total} sequences over {sms} SMs) at {n_big}; that frame alone {one_ms:.4f} ms "
          f"({one_ms * 1e6 / longest:.1f} ns a sequence); waves {waves}")
    return {"redesigned": "PR 14", "longest_chain_steps": longest,
            "chain_alone_ms": one_ms, **alone,
            "waves": {str(k): v for k, v in waves.items()}}


def zstd_kernel_times(zk: dict, zp: dict) -> list[dict]:
    """Time each zstd kernel by CUDA events on the comparison batch (beside
    its plain version, in turns), on the corpus's frames and on the tiled
    frames, each beside its bytes bound; return their lines of the kernels
    JSON."""
    from aircompressor_tpu_torch.ops import zstd_decode

    fns = {"zstd_huffman": (zstd_decode.huffman_decode, zstd_decode.huffman_decode_plain, 103),
           "zstd_fse": (zstd_decode.fse_sequences,
                        lambda *a: zstd_decode.fse_sequences_plain(*a[:5]), 277),
           "zstd_execute": (zstd_decode.execute, zstd_decode.execute_plain, 543)}
    plans = (zk["plan"], zp["plan"], zp["big_plan"])
    args = [zstd_args(pk) for pk in (zk["pk"], zp["pk"], zp["big_pk"])]
    entries, total_big = [], 0.0
    for k, (name, (fn, plain, line)) in enumerate(fns.items()):
        small, mid, big = (a[k] for a in args)
        ms, plain_ms = paired_ms(lambda: fn(*small), lambda: plain(*small), 10, 1)
        ms_mid, ms_big = time_ms(lambda: fn(*mid), 10), time_ms(lambda: fn(*big), 3)
        b_small, b_mid, b_big = (zstd_bound_ms(plan, name) for plan in plans)
        total_big += ms_big
        n_small, n_mid, n_big = (len(plan.frames) for plan in plans)
        print(f"{name}: {n_small} frames (the comparison batch): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b_small:.5f} ms; {n_mid} frames: kernel "
              f"{ms_mid:.4f} ms, bound {b_mid:.5f} ms; {n_big} frames: kernel "
              f"{ms_big:.4f} ms, bound {b_big:.5f} ms")
        extra = {}
        if name == "zstd_execute":
            shares = zstd_decode.offset_shares(*mid[2:])
            longest = max(sum(bp.n_seq for bp in fp.blocks) for fp in zp["plan"].frames)
            total = sum(bp.n_seq for fp in zp["big_plan"].frames for bp in fp.blocks)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            extra = {"redesigned": "PR 12", "longest_chain_steps": longest}
            print("zstd match offsets of the corpus (share of matches and of their bytes "
                  "within each window's reach): " + json.dumps(shares))
            print(f"zstd_execute: {ms_mid * 1e6 / longest:.1f} ns a sequence of the longest "
                  f"frame ({longest} sequences) at {n_mid} frames; "
                  f"{ms_big * 1e6 * sms / total:.2f} ns a sequence of an SM (all {total} "
                  f"sequences over {sms} SMs) at {n_big}")
        if name == "zstd_fse":
            extra = fse_times(zp, fn, (small, mid, big))
        if name == "zstd_huffman":
            extra = {"redesigned": "PR 11", **alone_ms(fn, "huffman_kernel", (small, mid, big))}
            longest = max(h.nsym for h in zp["plan"].huff_streams)
            total = sum(h.nsym for h in zp["big_plan"].huff_streams)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            print(f"zstd_huffman: {ms_mid * 1e6 / longest:.1f} ns a symbol of the longest "
                  f"stream ({longest} symbols) at {n_mid} frames; "
                  f"{ms_big * 1e6 * sms / total:.3f} ns a symbol of an SM (all {total} "
                  f"symbols over {sms} SMs) at {n_big}")
        entries.append({
            "name": name, "route": "cuda", "source": f"aircompressor_tpu_torch/csrc/{name}.cu",
            "replaces": f"aircompressor_tpu/ops/zstd_pallas.py:{line}",
            "launches": zp["counts"][name],
            "max_abs_err": max(zk["errs"][name], zp["fse_err"] if name == "zstd_fse" else 0),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_small, "bound_by": "bytes",
            "library_ms": None, "batch": f"{n_small} frames of <= 16 KB",
            "chunks": n_mid, "chunks_ms": ms_mid, "chunks_bound_ms": b_mid,
            "tiled_chunks": n_big, "tiled_ms": ms_big, "tiled_bound_ms": b_big, **extra})
    print(f"zstd huffman + fse + execute, {len(zp['big_plan'].frames)} frames: "
          f"{gbps(zp['decoded_bytes'], total_big):.3f} GB/s decoded (kernels alone; the "
          f"C++ planner and upload took {zp['t_plan_big']:.4f} s)")
    return entries


def xxhash_seeds_against_plain(dev) -> dict:
    """Hold the xxh64 and xxh32 kernels to their plain versions and the host
    tier at seeds 0, 1, 0x9E3779B1 and the largest seed, on 8-byte aligned
    and unaligned rows; return each kernel's max_abs_err."""
    from aircompressor_tpu_torch.host.xxhash import xxh32 as host_xxh32
    from aircompressor_tpu_torch.host.xxhash import xxh64 as host_xxh64
    from aircompressor_tpu_torch.ops import xxhash

    print("== xxHash kernels at nonzero seeds", flush=True)
    errs = {"xxh64": 0, "xxh32": 0}
    rng = np.random.default_rng(43)
    lens_list = list(XXH_SEED_LENGTHS)
    for width in (1024, 1021):
        host = rng.integers(0, 256, (len(lens_list), width), dtype=np.uint8)
        data = torch.from_numpy(host).to(dev)
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        for name, bits, kernel, plain, scalar in (
                ("xxh64", 64, xxhash.xxh64, xxhash.xxh64_plain, host_xxh64),
                ("xxh32", 32, xxhash.xxh32, xxhash.xxh32_plain, host_xxh32)):
            mask = (1 << bits) - 1
            for seed in (*XXH_SEEDS, mask):
                k = [v & mask for v in kernel(data, lens, seed).tolist()]
                p = [v & mask for v in plain(data, lens, seed).tolist()]
                s = [scalar(host[i, :n], seed) for i, n in enumerate(lens_list)]
                require(k == p == s, f"{name} kernel == plain == host at seed {seed:#x}, "
                                     f"L={width}")
                errs[name] = max([errs[name]] + [abs(a - b) for a, b in zip(k, p)])
    print(f"xxh64 and xxh32: seeds {[hex(x) for x in XXH_SEEDS]} and 2^64-1 / 2^32-1, "
          f"lengths {lens_list}, rows of 1024 and 1021 B: kernel == plain == host, "
          f"max_abs_err {errs}")
    return errs


def zstd_encode_kernels_against_plain(dev) -> dict:
    """Hold the DFAST matcher kernel to its plain version on the DFAST edge
    cases and six 64 KB corpus chunks (``zstd_full_cases``) at the compress
    path's width, on every output; and the emission kernel on the plans of
    those chunks, from the matcher kernel's proposals (level 3) and from the
    host matcher (level 1). Tolerance 0."""
    from aircompressor_tpu_torch.ops import zstd_dfast, zstd_encode

    print("== zstd compress kernels against plain on the card", flush=True)
    edge = dfast_cases() + [dfast_collision_case()[0], dfast_in_round_case()[0]]
    chunks, data, lens = zstd_encode.stage(edge + zstd_full_cases(), dev)
    k = zstd_dfast.find_sequences(data, lens, with_steps=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = zstd_dfast.find_sequences_plain(data, lens, with_steps=True)
    torch.cuda.synchronize()
    t_dfast_plain = time.perf_counter() - t0
    for name, a, b in zip(DFAST_OUTPUTS, k, p):
        require(torch.equal(a, b), f"zstd_dfast {name} equal plain")
    require(bool(k[5].all()), "every chunk ok in the matcher")
    require(all(torch.equal(a, b) for a, b in zip(k[:6], zstd_dfast.find_sequences(data, lens))),
            "zstd_dfast the same with and without steps")
    dfast_err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(k, p))
    dfast_err = max(dfast_err, dfast_rounds_against_plain(dev, edge, p, len(edge)))
    pres = zstd_encode.match(chunks, data, lens)  # the host check of every proposal
    plans3 = zstd_encode.plan(chunks, 3, pres)
    one = zstd_encode.plan([one_sequence_case()], 3, [None])
    require(one.device[0], "the one-sequence chunk reaches the emission")
    packs = [q.pack() for q in (plans3, zstd_encode.plan(chunks, 1, [None] * len(chunks)), one)]
    packed = {k: np.concatenate([q[k] for q in packs]) for k in packs[0]}
    edge_rows, over = emit_edge_rows(packed)
    packed_all = {k: np.concatenate([v, edge_rows[k]]) for k, v in packed.items()}
    args = [torch.from_numpy(packed_all[name]).to(dev) for name, _, _ in zstd_encode.EMIT_INPUTS]
    ke = zstd_encode.emit(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pe = zstd_encode.emit_plain(*args)
    torch.cuda.synchronize()
    t_emit_plain = time.perf_counter() - t0
    for name, a, b in zip(EMIT_OUTPUTS, ke, pe):
        require(torch.equal(a, b), f"zstd_emit {name} equal plain")
    emit_err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(ke, pe))
    emit_err = max(emit_err, emit_overflow_against_plain(dev, over))
    nseq = k[3].tolist()
    print(f"zstd_dfast: {len(chunks)} chunks ({len(edge)} of <= {DFAST_CUT} B, "
          f"{len(chunks) - len(edge)} of 64 KB) at width {data.shape[1]}: sequences "
          f"{nseq}, steps {k[6].tolist()}; kernel == plain on all six outputs and steps, "
          f"max_abs_err {dfast_err}; every proposal passes the host check; plain "
          f"{t_dfast_plain:.2f} s (host clock)")
    print(f"zstd_emit: {len(packed['nseq'])} planned blocks (level 3 from the kernel's proposals "
          f"and level 1 from the host matcher, and the one-sequence chunk), sequences "
          f"{sorted(packed['nseq'].tolist())} and up to "
          f"{int(packed['lit_seg'][:, :, 1].sum(1).max())} literals, a row with nseq 0 and "
          f"one of random fields: kernel == plain on all four outputs, max_abs_err "
          f"{emit_err}; plain {t_emit_plain:.2f} s (host clock)")
    # The six 64 KB chunks alone, for the kernels' times at that shape.
    full = slice(len(edge), None)
    full_packed = zstd_encode.plan(chunks[full], 3, pres[full]).pack()
    return dict(dfast_err=dfast_err, emit_err=emit_err,
                dfast_args=(data[full].contiguous(), lens[full].contiguous()),
                emit_args=[torch.from_numpy(full_packed[name]).to(dev)
                           for name, _, _ in zstd_encode.EMIT_INPUTS],
                emit_packed=full_packed)


DFAST_OUTPUTS = ("ll", "ml", "of", "nseq", "last_lit", "ok", "steps")
EMIT_OUTPUTS = ("lit_bytes", "lit_tot", "seq_bytes", "seq_tot")


def emit_overflow_against_plain(dev, over: dict) -> int:
    """The overflowing row: the emission and its plain version both raise,
    and with the overflow check off they agree on all four outputs (the
    stores past each capacity dropped, the bits counted); return the
    max_abs_err."""
    from aircompressor_tpu_torch.ops import zstd_encode

    args = [torch.from_numpy(over[name]).to(dev) for name, _, _ in zstd_encode.EMIT_INPUTS]
    for fn in (zstd_encode.emit, zstd_encode.emit_plain):
        try:
            fn(*args)
        except RuntimeError as e:
            require("overflowed a stream of row 0" in str(e), f"overflow raises: {e}")
        else:
            require(False, f"{fn.__name__} raises on the overflowing row")
    check, zstd_encode._check_totals = zstd_encode._check_totals, lambda *a: None
    try:
        k, p = zstd_encode.emit(*args), zstd_encode.emit_plain(*args)
        torch.cuda.synchronize()
    finally:
        zstd_encode._check_totals = check
    for name, a, b in zip(EMIT_OUTPUTS, k, p):
        require(torch.equal(a, b), f"zstd_emit {name} equal plain on the overflowing row")
    require(int(k[1][0, 0]) > 8 * zstd_encode.LSTREAM_CAP
            and int(k[3][0]) > 8 * zstd_encode.SSTREAM_CAP, "both streams overflow")
    print(f"zstd_emit: the overflowing row raises in both; with the check off kernel == "
          f"plain (bit totals {k[1][0].tolist()}, {int(k[3][0])})")
    return max(int((a.long() - b.long()).abs().max()) for a, b in zip(k, p))


def dfast_rounds_against_plain(dev, edge: list[bytes], plain, n_edge: int) -> int:
    """Hold the DFAST kernel to its plain version on the edge chunks at an
    odd width (DFAST_CUT + 1), on the two round chunks (the in-round hash
    collision and the in-round match) tiled to 3 and to 397 rows (more than
    the 396 a wave holds), and on each row of ``plain``'s batch alone; all
    seven outputs. Return the max_abs_err."""
    from aircompressor_tpu_torch.ops import zstd_dfast
    from aircompressor_tpu_torch.ops.batch import _pack, to_device_batch

    err = 0

    def same(got, want, what):
        nonlocal err
        for name, a, b in zip(DFAST_OUTPUTS, got, want):
            require(torch.equal(a, b), f"zstd_dfast {name} equal plain: {what}")
            err = max(err, int((a.long() - b.long()).abs().max()) if a.numel() else 0)

    data, lens = to_device_batch(*_pack(edge, DFAST_CUT + 1), dev)
    same(zstd_dfast.find_sequences(data, lens, with_steps=True),
         [t[:n_edge] for t in plain], f"edge chunks at width {DFAST_CUT + 1}")
    pair = [t[n_edge - 2:n_edge] for t in plain]
    for rows in (3, 397):
        tiled = (edge[-2:] * rows)[:rows]
        data, lens = to_device_batch(*_pack(tiled, DFAST_CUT + 1), dev)
        want = [torch.cat([t] * (rows // 2 + 1))[:rows] for t in pair]
        same(zstd_dfast.find_sequences(data, lens, with_steps=True), want,
             f"the round chunks tiled to {rows} rows")
    full = edge + zstd_full_cases()
    data, lens = to_device_batch(*_pack(full, CHUNK), dev)
    for i in range(len(full)):
        same(zstd_dfast.find_sequences(data[i:i + 1], lens[i:i + 1], with_steps=True),
             [t[i:i + 1] for t in plain], f"row {i} alone")
    print(f"zstd_dfast: the edge chunks at width {DFAST_CUT + 1}, the two round chunks "
          f"tiled to 3 and 397 rows, each of the {len(full)} rows alone: kernel == plain "
          f"(all six outputs and steps), max_abs_err {err}")
    return err


def dfast_bound_ms(lens: torch.Tensor) -> float:
    """Each chunk's bytes and length read once; the three (B, 16384) int32
    sequence fields, nseq, last_lit and ok written once."""
    B = lens.shape[0]
    return bound_ms(int(lens.sum()) + 4 * B, B * (3 * 16384 * 4 + 9))


def emit_bound_ms(packed: dict) -> float:
    """The literals, the nine fields of each sequence and each row's tables
    read once; the four Huffman streams, the sequences stream and their
    totals written once (the zero tails included)."""
    B = packed["nseq"].shape[0]
    read = (int(packed["lit_seg"][:, :, 1].sum()) + 36 * int(packed["nseq"].sum())
            + B * (4 * (8 + 512 + 1 + 384 + 1536 + 3)))
    return bound_ms(read, B * (4 * 24576 + 16 + 98304 + 4))


def zstd_compress_path(dev, corpus: list[bytes], host_frames: list[bytes],
                       sustain: int = SUSTAIN) -> dict:
    """The zstd compress path: ``ZstdBatchCodec(level=3).compress_chunks`` on
    the corpus (its canary included), with the launch counts and route
    counters set to 0 just before and read just after; every frame decoded
    through the port's zstd decode kernels with its checksum; the size
    against the host encoder's frames (``host_frames``). Then the same batch
    again stage by stage, timed on the host clock, with equal frames, and
    the Python planner on its proposals beside the C++ planner, with equal
    plans, rows and frames; then the matcher over the corpus tiled
    ``sustain`` times and the emission over its packed plans tiled, each
    equal to the tiled 256-chunk outputs."""
    from aircompressor_tpu_torch.ops import xxhash, zstd_decode, zstd_dfast, zstd_encode
    from aircompressor_tpu_torch.ops.batch import ZstdBatchCodec

    print("== zstd compress path at real size (generated corpus)", flush=True)
    n = len(corpus)
    codec = ZstdBatchCodec(level=3, device=dev)  # its canary runs on the path
    zstd_dfast.launches = zstd_dfast.rows = zstd_encode.launches = zstd_encode.rows = 0
    zstd_encode.host_matcher_rows = zstd_encode.host_frame_rows = xxhash.launches = 0
    t0 = time.perf_counter()
    frames = codec.compress_chunks(corpus)
    t_codec = time.perf_counter() - t0
    counts = {"zstd_dfast": zstd_dfast.launches, "zstd_emit": zstd_encode.launches,
              "xxh64": xxhash.launches}
    routes = {"dfast_rows": zstd_dfast.rows, "host_matcher_rows": zstd_encode.host_matcher_rows,
              "emit_rows": zstd_encode.rows, "host_frame_rows": zstd_encode.host_frame_rows}
    require(all(c > 0 for c in counts.values()), f"the zstd compress kernels launched: "
            f"{counts}")
    require(routes["dfast_rows"] == n + 2, f"every chunk and both canary chunks went "
            f"through the matcher kernel: {routes}")
    t0 = time.perf_counter()
    decoded = zstd_decode.decode_batch(frames, device=dev)
    t_decode = time.perf_counter() - t0
    require(decoded == corpus, "every compressed frame decodes to its chunk through the "
                               "zstd decode kernels, checksums verified")
    size, host_size = sum(map(len, frames)), sum(map(len, host_frames))
    require(size <= ZSTD_RATIO_LIMIT * host_size,
            f"zstd compressed size {size} <= {ZSTD_RATIO_LIMIT} x the host encoder's "
            f"{host_size}")

    # The same batch, stage by stage.
    zstd_encode.host_matcher_rows = zstd_encode.host_frame_rows = 0
    times = {}
    t0 = time.perf_counter()
    chunks, raw, raw_lens = zstd_encode.stage(corpus, dev)
    torch.cuda.synchronize()
    times["stage"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pres = zstd_encode.match(chunks, raw, raw_lens)
    times["match"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plans = zstd_encode.plan(chunks, 3, pres)
    times["plan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = plans.pack()
    times["pack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    emitted = zstd_encode.emit_plans(plans, dev)
    times["emit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged = zstd_encode.assemble(chunks, plans, emitted, raw, raw_lens, 3)
    times["assemble"] = time.perf_counter() - t0
    require(staged == frames, "the staged run writes compress_chunks' frames")
    text = range(4, n)  # the special chunks are runs, periods and a ramp
    require(all(pres[i] is not None and plans.device[i] for i in text),
            "every text chunk takes the matcher kernel's proposals and the emission")
    require(zstd_encode.host_frame_rows == int((~plans.device).sum()),
            "every emitted block gains; only unplanned chunks take the host encoder")
    reasons = {}
    for r in plans.reason:
        reasons[r or "device"] = reasons.get(r or "device", 0) + 1
    py_times = python_compress_planner(chunks, pres, plans, packed, emitted, raw, raw_lens)

    # The corpus tiled on the device, through both kernels.
    k256 = zstd_dfast.find_sequences(raw, raw_lens, with_steps=True)
    big_raw, big_lens = raw.repeat(sustain, 1), raw_lens.repeat(sustain)
    t0 = time.perf_counter()
    k_big = zstd_dfast.find_sequences(big_raw, big_lens)
    torch.cuda.synchronize()
    t_dfast_big = time.perf_counter() - t0
    for name, a, b in zip(DFAST_OUTPUTS, k_big, k256):
        require(torch.equal(a, b.repeat(sustain, *[1] * (b.dim() - 1))),
                f"tiled zstd_dfast {name} equals the 256-chunk output tiled")
    args = [torch.from_numpy(packed[name]).to(dev) for name, _, _ in zstd_encode.EMIT_INPUTS]
    big_args = [a.repeat(sustain, *[1] * (a.dim() - 1)) for a in args]
    e256 = zstd_encode.emit(*args)
    t0 = time.perf_counter()
    e_big = zstd_encode.emit(*big_args)
    torch.cuda.synchronize()
    t_emit_big = time.perf_counter() - t0
    for name, a, b in zip(EMIT_OUTPUTS, e_big, e256):
        require(torch.equal(a, b.repeat(sustain, *[1] * (b.dim() - 1))),
                f"tiled zstd_emit {name} equals the 256-row output tiled")
    for name, a in zip(EMIT_OUTPUTS, e256):
        require(np.array_equal(a.cpu().numpy(), emitted[name]), f"emission {name} repeats")

    print(f"ZstdBatchCodec(level=3).compress_chunks: {n} chunks, {sum(map(len, corpus))} B "
          f"-> {size} B in {t_codec:.3f} s (host clock, canary included); the host "
          f"encoder's frames {host_size} B, ratio {size / host_size:.6f} (limit "
          f"{ZSTD_RATIO_LIMIT}); decoded through the zstd decode kernels in "
          f"{t_decode:.3f} s")
    print(f"zstd compress launches {counts}, routes {routes}; plans {reasons}")
    print(f"zstd compress stages, {n} chunks (host clock): " + ", ".join(
        f"{k} {v:.4f} s" for k, v in times.items())
          + f"; total {sum(times.values()):.4f} s (pack is inside emit too)")
    print(f"zstd compress planners, {n} chunks (host clock, plans, rows and frames equal): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in py_times.items()))
    steps = k256[6]
    top = int(steps.argmax())
    chain = dict(steps=int(steps[top]), matches=int(k256[3][top]), chunk=top,
                 total=int(steps.sum()))
    digest = hashlib.sha256(b"".join(frames)).hexdigest()
    print(f"tiled x{sustain}: {big_raw.shape[0]} chunks through zstd_dfast in "
          f"{t_dfast_big:.3f} s, {big_args[0].shape[0]} planned blocks through zstd_emit "
          f"in {t_emit_big:.3f} s (host clock, first call)")
    print(f"zstd_dfast steps on the corpus: longest chain chunk {top}, {chain['steps']} "
          f"steps ({chain['steps'] - chain['matches']} probes, {chain['matches']} matches); "
          f"{chain['total']} in all; compress_chunks frames sha256 {digest}")
    return dict(counts=counts, routes=routes, times=times, py_times=py_times, raw=raw,
                raw_lens=raw_lens, chain=chain,
                big_raw=big_raw, big_lens=big_lens, args=args, big_args=big_args,
                packed=packed, size=size, host_size=host_size, t_codec=t_codec)


def python_compress_planner(chunks, pres, plans, packed, emitted, raw, raw_lens) -> dict:
    """The Python planner on the compress path's batch, from the same
    proposals (``device_enc._plan_chunk``, ``pack_plans`` and ``_assemble``),
    required equal to the C++ planner's plans, rows and frames; its times
    beside the C++ planner's (each on the host clock; the host matcher runs
    inside both plans for chunks without proposals)."""
    from aircompressor_tpu_torch.host.zstd import device_enc, huff_enc
    from aircompressor_tpu_torch.ops import xxhash

    times = {}
    t0 = time.perf_counter()
    py = []
    for c, pre in zip(chunks, pres):
        if pre is not None:
            data = np.frombuffer(c, np.uint8)
            ll, of, ml = pre
            pre = (ll, of, ml, device_enc._extract_literals(
                data, ll, ml, len(c) - int(ll.sum() + ml.sum())))
        py.append(device_enc._plan_chunk(c, 3, pre))
    times["python plan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_packed = device_enc.pack_plans([q for q in py if q.device])
    times["python pack"] = time.perf_counter() - t0
    require([q.reason for q in py] == plans.reason and [q.device for q in py] ==
            plans.device.tolist(), "the C++ plans' device flags and reasons equal Python's")
    require(all(np.array_equal(packed[k], py_packed[k]) and packed[k].dtype ==
                py_packed[k].dtype for k in packed),
            "the C++ planner's emission rows equal pack_plans'")
    for i in plans.rows:
        table, modes, descs = plans.detail(i)
        require(table == huff_enc.write_table(py[i].ct)
                and modes == tuple(f.mode for f in py[i].fields)
                and descs == tuple(f.desc for f in py[i].fields),
                f"chunk {i}: the C++ Huffman table and field modes equal Python's")
    rows = emitted["rows"]
    digest = xxhash.xxh64(raw, raw_lens).cpu().numpy()[rows]
    args = [emitted[k] for k in ("lit_bytes", "lit_tot", "seq_bytes", "seq_tot")]
    t0 = time.perf_counter()
    cc_frames = plans.assemble(*args, digest)
    times["C++ assemble"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_frames = [device_enc._assemble(py[i], args[0][r], args[1][r], args[2][r],
                                      int(args[3][r]), int(digest[r]))
                 for r, i in enumerate(rows)]
    times["python assemble"] = time.perf_counter() - t0
    require(cc_frames == py_frames, "the C++ assembly's frames equal _assemble's")
    return times


def zstd_encode_times(zek: dict, zc: dict) -> list[dict]:
    """Time the DFAST and emission kernels by CUDA events on the six 64 KB
    chunks (beside their plain versions, in turns), on the corpus and on the
    corpus tiled, each beside its bytes bound; return their lines of the
    kernels JSON. The emission wrapper reads two totals back to check for an
    overflow, so its times include that copy."""
    from aircompressor_tpu_torch.ops import zstd_dfast, zstd_encode

    entries = []
    d_small, d_mid, d_big = zek["dfast_args"], (zc["raw"], zc["raw_lens"]), (
        zc["big_raw"], zc["big_lens"])
    e_small, e_mid, e_big = zek["emit_args"], zc["args"], zc["big_args"]
    big_packed = {k: np.concatenate([v] * SUSTAIN) for k, v in zc["packed"].items()
                  if k in ("lit_seg", "nseq")}
    for name, fn, plain, small, mid, big, bounds, line, src in (
            ("zstd_dfast", zstd_dfast.find_sequences, zstd_dfast.find_sequences_plain,
             d_small, d_mid, d_big, [dfast_bound_ms(a[1]) for a in (d_small, d_mid, d_big)],
             "aircompressor_tpu/ops/zstd_dfast_pallas.py:58", "zstd_dfast"),
            ("zstd_emit", zstd_encode.emit, zstd_encode.emit_plain, e_small, e_mid, e_big,
             [emit_bound_ms(p) for p in (zek["emit_packed"], zc["packed"], big_packed)],
             "aircompressor_tpu/ops/zstd_encode_jax.py:159", "zstd_emit")):
        ms, plain_ms = paired_ms(lambda: fn(*small), lambda: plain(*small), 10, 1)
        ms_mid, ms_big = time_ms(lambda: fn(*mid), 5), time_ms(lambda: fn(*big), 3)
        rows = [small[0].shape[0], mid[0].shape[0], big[0].shape[0]]
        print(f"{name}: {rows[0]} rows (of the six 64 KB chunks): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bounds[0]:.5f} ms; {rows[1]} rows: kernel "
              f"{ms_mid:.4f} ms, bound {bounds[1]:.5f} ms; {rows[2]} rows: kernel "
              f"{ms_big:.4f} ms, bound {bounds[2]:.5f} ms")
        if name == "zstd_dfast":
            chain = zc["chain"]
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            print(f"zstd_dfast: {ms_mid * 1e6 / chain['steps']:.1f} ns a step of the longest "
                  f"chain ({chain['steps']} steps) at {rows[1]} chunks; "
                  f"{ms_big * 1e6 * sms / (chain['total'] * SUSTAIN):.2f} ns a step of an SM "
                  f"(all {chain['total'] * SUSTAIN} steps over {sms} SMs) at {rows[2]}")
        if name == "zstd_emit":
            segs = zc["packed"]["lit_seg"][:, :, 1]
            longest, total = int(segs.max()), int(segs.sum()) * SUSTAIN
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            print(f"zstd_emit: {ms_mid * 1e6 / longest:.1f} ns a symbol of the longest Huffman "
                  f"segment ({longest} symbols; up to {int(zc['packed']['nseq'].max())} "
                  f"sequences a row) at {rows[1]} rows; "
                  f"{ms_big * 1e6 * sms / total:.3f} ns a Huffman symbol of an SM (all {total} "
                  f"over {sms} SMs) at {rows[2]}")
        entry = {
            "name": name, "route": "cuda", "source": f"aircompressor_tpu_torch/csrc/{src}.cu",
            "replaces": line, "launches": zc["counts"][name],
            "max_abs_err": zek["dfast_err" if name == "zstd_dfast" else "emit_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[0], "bound_by": "bytes",
            "library_ms": None, "batch": f"{rows[0]} rows of the six 64 KB chunks",
            "chunks": rows[1], "chunks_ms": ms_mid, "chunks_bound_ms": bounds[1],
            "tiled_chunks": rows[2], "tiled_ms": ms_big, "tiled_bound_ms": bounds[2]}
        if name == "zstd_emit":
            entry["note"] = "the JAX package's emission is XLA, not a Pallas kernel"
            entry["redesigned"] = "PR 11"
            entry.update(alone_ms(fn, "zstd_emit_kernel", (small, mid, big)))
        else:
            entry["redesigned"] = "rounds of 32 probes over the shared-memory tables"
            entry["longest_chain_steps"] = zc["chain"]["steps"]
        entries.append(entry)
    return entries


def lzo_kernel_against_plain(dev) -> dict:
    """Hold the LZO kernel to its plain version on the LZO cases, six 64 KB
    corpus chunks and the edge blocks, at out_cap 64 KB and LZO_EDGE_CAP;
    check the flags against the host decoder, the bytes against the
    originals and the edge blocks against the Pallas kernel's values."""
    from aircompressor_tpu_torch.errors import MalformedInputException
    from aircompressor_tpu_torch.host import lzo as host_lzo
    from aircompressor_tpu_torch.ops import lzo_decode
    from aircompressor_tpu_torch.ops.batch import _pack, _round_up, to_device_batch

    print("== LZO kernel against plain on the card", flush=True)
    raws = lzo_cases() + corpus_full_cases()
    blobs = [host_lzo.compress(r) for r in raws] + [b for b, _, _ in LZO_EDGE_BLOCKS]
    want = []
    for b in blobs:
        try:
            want.append(host_lzo.decompress(b, CHUNK))
        except MalformedInputException:
            want.append(None)
    require(want[:len(raws)] == raws, "the host LZO codec round-trips the cases")
    comp, lens = to_device_batch(*_pack(blobs, _round_up(max(map(len, blobs)), 16)), dev)
    err, t_plain = 0, 0.0
    for out_cap in (CHUNK, LZO_EDGE_CAP):
        k = lzo_decode.decode(comp, lens, out_cap=out_cap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = lzo_decode.decode_plain(comp, lens, out_cap=out_cap)
        torch.cuda.synchronize()
        t_plain += time.perf_counter() - t0
        for name, a, b in zip(("out", "out_lens", "ok"), k, p):
            require(torch.equal(a, b), f"lzo decode {name} equal plain at out_cap {out_cap}")
        err = max(err, int((k[0].int() - p[0].int()).abs().max()))
        got_ok = k[2].tolist()
        require(got_ok == [w is not None and len(w) <= out_cap for w in want],
                f"lzo decode flags exactly what the host decoder rejects at {out_cap}")
        for i, w in enumerate(want):
            if w is not None:
                require(k[0][i, :min(len(w), out_cap)].cpu().numpy().tobytes()
                        == w[:out_cap], f"lzo decode case {i} equals its original")
        if out_cap == LZO_EDGE_CAP:
            edge = list(zip(got_ok, k[1].tolist()))[-len(LZO_EDGE_BLOCKS):]
            require(edge == [(ok, n) for _, ok, n in LZO_EDGE_BLOCKS],
                    f"lzo decode gives the Pallas kernel's ok and out_lens on the edge "
                    f"blocks: {edge}")
    n_full = len(corpus_full_cases())
    full = blobs[len(raws) - n_full:len(raws)]
    top = steps_against_plain("lzo decode", lzo_decode.decode, lzo_decode.decode_plain,
                              comp, lens, out_cap=LZO_EDGE_CAP)
    err = max(err, lzo_windows_against_plain(dev, full))
    print(f"lzo decode: {len(blobs)} chunks ({want.count(None)} malformed; "
          f"{n_full} of 64 KB corpus chunks) at out_cap {CHUNK} and {LZO_EDGE_CAP}, "
          f"kernel == plain, max_abs_err {err}; edge blocks as the Pallas kernel; "
          f"plain {t_plain:.2f} s (host clock, both caps); with_steps == plain "
          f"(largest {top} commands)")
    return dict(err=err, full=full)


def lzo_windows_against_plain(dev, blobs: list[bytes]) -> int:
    """Hold both windows of the LZO decode kernel to the plain version with
    steps: the given blobs and the hand-built window cases tiled to 257 rows
    (the 32 KB window; out_cap 64 KB, 4096 and 4093) and to SMALL_BATCH + 1
    rows (the 4 KB window; out_cap 64 KB) of an odd width; the cases against
    the host decoder. Return the max_abs_err."""
    from aircompressor_tpu_torch.errors import MalformedInputException
    from aircompressor_tpu_torch.host import lzo as host_lzo
    from aircompressor_tpu_torch.ops import lzo_decode
    from aircompressor_tpu_torch.ops.batch import _pack, to_device_batch

    cases = lzo_window_cases()
    blobs = blobs + [b for _, b in cases]
    want = []
    for b in blobs:
        try:
            want.append(host_lzo.decompress(b, CHUNK))
        except MalformedInputException:
            want.append(None)
    err = 0
    for rows in (257, lzo_decode.SMALL_BATCH + 1):
        batch = (blobs * (rows // len(blobs) + 1))[:rows]
        comp, lens = to_device_batch(*_pack(batch, max(map(len, batch)) | 1), dev)
        for out_cap in (CHUNK, 4096, 4093) if rows == 257 else (CHUNK,):
            p = lzo_decode.decode_plain(comp, lens, out_cap=out_cap, with_steps=True)
            k = lzo_decode.decode(comp, lens, out_cap=out_cap, with_steps=True)
            torch.cuda.synchronize()
            for name, a, b in zip(("out", "out_lens", "ok", "steps"), k, p):
                require(torch.equal(a, b), f"lzo decode {name} equal plain at out_cap "
                                           f"{out_cap}, {rows} rows")
            err = max(err, int((k[0].int() - p[0].int()).abs().max()))
            if out_cap == CHUNK:
                got = k[2].tolist()
                for i, w in enumerate(want):
                    require(got[i] == (w is not None), f"lzo window case {i} ok as the host")
                    if w is not None:
                        require(k[0][i, :len(w)].cpu().numpy().tobytes() == w,
                                f"lzo window case {i} equals the host decoder's bytes")
    print(f"lzo decode windows {lzo_decode.WINDOWS}: 257 and {lzo_decode.SMALL_BATCH + 1} "
          f"rows of an odd width (six 64 KB corpus chunks and {len(cases)} window cases: "
          f"{', '.join(n for n, _ in cases)}), out_cap {CHUNK} (and 4096 and 4093 at 257 "
          f"rows), kernel == "
          f"plain (out, out_lens, ok, steps), cases == host decoder, max_abs_err {err}")
    return err


def deflate_kernel_against_plain(dev) -> dict:
    """Hold the deflate kernel to its plain version on the deflate cases, six
    64 KB corpus chunks, the malformed streams, and two chunks whose bytes
    were changed after planning (cut to half its length, one flipped bit),
    at out_cap 64 KB and 4096; check the planner's status of each, the
    flags and the bytes; and that DeflateBatchCodec names each malformed
    stream with zlib's reason."""
    from aircompressor_tpu_torch.errors import MalformedInputException
    from aircompressor_tpu_torch.host.deflate import plan as deflate_plan
    from aircompressor_tpu_torch.ops import deflate_decode
    from aircompressor_tpu_torch.ops.batch import (
        DeflateBatchCodec, _pack, _round_up, deflate_raw, to_device_batch)

    print("== deflate kernel against plain on the card", flush=True)
    blobs, raws = deflate_cases()
    full = [deflate_raw(c) for c in corpus_full_cases()]
    staged = [b for _, b in deflate_window_cases() + deflate_slot_cases()]
    blobs, raws = blobs + full + staged, raws + corpus_full_cases() + [
        zlib.decompress(b, -15) for b in staged]
    bad = deflate_malformed_cases()
    edited = [full[3], full[2]]  # planned whole, then changed
    items = blobs + [b for _, b in bad] + edited
    buf, lens = _pack(items, _round_up(max(map(len, items)), 16))
    t0 = time.perf_counter()
    plan = deflate_plan.plan(buf, lens)
    t_plan = time.perf_counter() - t0
    status = plan.info[:, 3].tolist()
    n_good, n_bad = len(blobs), len(bad)
    require(status[:n_good] == [deflate_plan.ST_OK] * n_good and
            status[n_good + n_bad:] == [deflate_plan.ST_OK] * 2, "every good stream plans")
    require(status[n_good:n_good + n_bad] == [deflate_plan.ST_MALFORMED] * n_bad,
            f"the planner rejects every malformed stream: {status[n_good:n_good + n_bad]}")
    flushed = n_good - len(staged) - len(full) - 1
    require(int(plan.info[flushed, 1]) > 16, "the full-flush chunk has more than 16 blocks")
    lens[-2] //= 2  # the last two rows keep their plan: a cut length ...
    buf[-1, len(edited[1]) // 2] ^= 0x10  # ... and a flipped bit
    comp, comp_lens = to_device_batch(buf, lens, dev)
    dplan = deflate_decode.upload(plan, dev)
    err, t_plain = 0, 0.0
    for out_cap in (CHUNK, 4096):
        k = deflate_decode.decode(comp, comp_lens, dplan, out_cap=out_cap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = deflate_decode.decode_plain(comp, comp_lens, dplan, out_cap=out_cap)
        torch.cuda.synchronize()
        t_plain += time.perf_counter() - t0
        for name, a, b in zip(("out", "out_lens", "ok"), k, p):
            require(torch.equal(a, b), f"deflate decode {name} equal plain at out_cap {out_cap}")
        err = max(err, int((k[0].int() - p[0].int()).abs().max()))
        got_ok = k[2].tolist()
        require(got_ok[:n_good] == [len(r) <= out_cap for r in raws],
                f"every good deflate stream decodes ok at out_cap {out_cap}")
        require(not any(got_ok[n_good:-1]), "the malformed and cut streams fail")
        for i, r in enumerate(raws):
            require(k[0][i, :min(len(r), out_cap)].cpu().numpy().tobytes() == r[:out_cap],
                    f"deflate case {i} equals its original")
    top = steps_against_plain("deflate decode", deflate_decode.decode,
                              deflate_decode.decode_plain, comp, comp_lens, dplan,
                              out_cap=4096)
    print(f"deflate decode: with_steps == plain (largest {top} symbols)")
    err = max(err, deflate_windows_against_plain(dev, items, buf, lens, plan))
    codec = DeflateBatchCodec(device=dev)
    good_blobs = blobs[:3]
    for name, b in bad:
        try:
            codec.decompress_chunks(good_blobs + [b])
            raise RuntimeError(f"check failed: the deflate codec rejects '{name}'")
        except MalformedInputException as e:
            require(e.offset == 3, f"'{name}' is named as chunk 3, got {e.offset}")
            print(f"deflate codec: '{name}' -> MalformedInputException(3, {e.reason!r})")
    print(f"deflate decode: {len(items)} chunks ({n_good} good, levels 1/6/9, fixed, "
          f"stored, a {int(plan.info[flushed, 1])}-block full-flush chunk and "
          f"{len(full)} of 64 KB corpus chunks; {n_bad} malformed; 2 changed after "
          f"planning) at out_cap {CHUNK} and 4096, kernel == plain, max_abs_err {err}; "
          f"planner {t_plan:.4f} s, plain {t_plain:.2f} s (host clock, both caps)")
    return dict(err=err, full=full)


def deflate_windows_against_plain(dev, items: list[bytes], buf, lens, plan) -> int:
    """Hold both instantiations of the deflate kernel to the plain version
    with steps: the batch (every deflate case, the window and slot cases,
    the malformed and changed streams) at an odd width, tiled to 257 rows
    (32 KB window) and to SMALL_BATCH + 1 rows (1 KB window), at out_cap
    64 KB and 4093, and each distinct row alone. The plain version runs on
    the distinct rows once a cap and is tiled. Return the max_abs_err."""
    from aircompressor_tpu_torch.ops import deflate_decode
    from aircompressor_tpu_torch.ops.batch import to_device_batch

    n, width = len(items), buf.shape[1] | 1
    odd = np.zeros((n, width), np.uint8)
    odd[:, :buf.shape[1]] = buf
    comp, comp_lens = to_device_batch(odd, lens, dev)
    err = 0
    for out_cap in (CHUNK, 4093):
        dplan = deflate_decode.upload(plan, dev)
        want = deflate_decode.decode_plain(comp, comp_lens, dplan, out_cap=out_cap,
                                           with_steps=True)
        for rows in (257, deflate_decode.SMALL_BATCH + 1):
            reps = rows // n + 1
            tplan = deflate_decode.upload(tile_plan(plan, reps), dev)
            tiled = (comp.repeat(reps, 1), comp_lens.repeat(reps))
            got = deflate_decode.decode(*tiled, tplan, out_cap=out_cap, with_steps=True)
            torch.cuda.synchronize()
            for name, a, b in zip(("out", "out_lens", "ok", "steps"), got, want):
                require(torch.equal(a[:rows], b.repeat(reps, *[1] * (b.dim() - 1))[:rows]),
                        f"deflate decode {name} equal plain at out_cap {out_cap}, {rows} rows")
            err = max(err, int((got[0][:n].int() - want[0].int()).abs().max()))
        for i in range(n):
            one = deflate_decode.decode(comp[i:i + 1], comp_lens[i:i + 1],
                                        deflate_decode.DevicePlan(dplan.desc, dplan.tabs,
                                                                  dplan.index[i:i + 1]),
                                        out_cap=out_cap, with_steps=True)
            require(all(torch.equal(a[0], b[i]) for a, b in zip(one, want)),
                    f"deflate decode row {i} alone equals plain at out_cap {out_cap}")
    print(f"deflate decode windows {deflate_decode.WINDOWS}: {n} rows at width {width} "
          f"tiled to 257 and {deflate_decode.SMALL_BATCH + 1} rows and each row alone, "
          f"out_cap {CHUNK} and 4093 (window cases: reach +- 1 of each window, 64 KB "
          f"literal block, stored between Huffman blocks; slot cases: roots apart, a "
          f"subtable past the slot), kernel == plain (out, out_lens, ok, steps), "
          f"max_abs_err {err}")
    return err


def tile_plan(plan, n: int):
    """A packed deflate plan repeated n times, for a batch tiled n times."""
    from aircompressor_tpu_torch.host.deflate.plan import Plan

    nb, nt = plan.desc.shape[0], plan.tabs.shape[0]
    shift = np.array([nb, 0, nt, 0], np.int64)
    index = np.concatenate([plan.index + k * shift for k in range(n)]).astype(np.int32)
    return Plan(np.tile(plan.desc, (n, 1)), np.tile(plan.tabs, n), index,
                np.tile(plan.info, (n, 1)))


def lzo_path(dev, corpus: list[bytes], sustain: int = SUSTAIN) -> dict:
    """The LZO path: the corpus through the host encoder
    (``LzoBatchCodec.compress_chunks``), ``decompress_chunks`` on its blocks,
    then the blocks tiled ``sustain`` times through the LZO decode kernel
    and the xxh64 kernel, with the launch counts set to 0 just before and
    read just after. Every byte and every XXH64 is checked."""
    from aircompressor_tpu_torch.host.xxhash import xxh64 as host_xxh64
    from aircompressor_tpu_torch.ops import lzo_decode, xxhash
    from aircompressor_tpu_torch.ops.batch import (
        LzoBatchCodec, _pack, _round_up, to_device_batch)

    print("== LZO path at real size (generated corpus)", flush=True)
    n = len(corpus)
    codec = LzoBatchCodec()  # the card by default
    t0 = time.perf_counter()
    blobs = codec.compress_chunks(corpus)
    t_compress = time.perf_counter() - t0
    raw, raw_lens = to_device_batch(*_pack(corpus, CHUNK), dev)
    comp, comp_lens = to_device_batch(*_pack(blobs, _round_up(max(map(len, blobs)), 16)), dev)
    big, big_lens = comp.repeat(sustain, 1), comp_lens.repeat(sustain)
    want_hash = [host_xxh64(c) for c in corpus] * sustain
    lzo_decode.launches = lzo_decode.rows = xxhash.launches = 0
    t0 = time.perf_counter()
    decoded = codec.decompress_chunks(blobs)  # its canary runs here
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = codec.decompress_chunks(blobs)
    t_codec = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, out_lens, ok = lzo_decode.decode(big, big_lens)
    digest = xxhash.xxh64(out, out_lens)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t0
    counts = {"lzo_decode": lzo_decode.launches, "xxh64": xxhash.launches}
    rows = lzo_decode.rows

    n_all = 1 + 2 * n + n * sustain  # the canary, two codec batches, the tiles
    require(all(c > 0 for c in counts.values()), f"the LZO path's kernels launched: {counts}")
    require(rows == n_all, f"every LZO chunk went through the kernel: {rows}/{n_all}")
    require(decoded == corpus and again == corpus,
            "LzoBatchCodec.decompress_chunks returns the corpus")
    require(bool(ok.all()), "every tiled LZO chunk decodes ok")
    require(torch.equal(out_lens, raw_lens.repeat(sustain)) and
            torch.equal(out, raw.repeat(sustain, 1)), "every tiled LZO chunk decodes to its original")
    require([v & (2**64 - 1) for v in digest.tolist()] == want_hash,
            "every xxh64 of a decoded LZO chunk equals the host's of its original")
    comp_bytes = sum(map(len, blobs))
    steps = lzo_decode.decode(comp, comp_lens, with_steps=True)[3]
    top = int(steps.argmax())
    chain = dict(steps=int(steps[top]), chunk=top, total=int(steps.sum()))
    shares = lzo_decode.distance_shares(comp, comp_lens)
    print(f"lzo steps on the corpus: longest chain chunk {top}, {chain['steps']} commands; "
          f"{chain['total']} in all")
    print("lzo match distances of the corpus (share of matches and of their bytes within "
          "each window's reach): " + json.dumps(shares))
    print(f"LzoBatchCodec.compress_chunks (host encoder): {n} chunks, "
          f"{sum(map(len, corpus))} B -> {comp_bytes} B in {t_compress:.2f} s (host clock)")
    print(f"LzoBatchCodec.decompress_chunks: {n} chunks in {t_codec:.4f} s (host clock, "
          f"staging and copies included; first call with its canary {t_first:.4f} s)")
    print(f"tiled x{sustain}: {big.shape[0]} chunks decoded and xxh64-hashed in "
          f"{t_big:.3f} s (host clock, first call); launches {counts}, {rows} of {n_all} "
          f"chunks through the LZO kernel")
    return dict(comp=comp, comp_lens=comp_lens, big=big, big_lens=big_lens,
                counts=counts, comp_bytes=comp_bytes, decoded_bytes=int(out_lens.sum()),
                t_codec=t_codec, chain=chain)


def deflate_path(dev, corpus: list[bytes], sustain: int = SUSTAIN) -> dict:
    """The deflate path: the corpus through zlib at level 6
    (``DeflateBatchCodec.compress_chunks``), ``decompress_chunks`` on its
    streams, then the streams planned once, the plan and the streams tiled
    ``sustain`` times, through the deflate decode kernel and the xxh64
    kernel, with the launch counts set to 0 just before and read just
    after. Every byte and every XXH64 is checked, and every chunk went
    through the kernel."""
    from aircompressor_tpu_torch.host.deflate import plan as deflate_plan
    from aircompressor_tpu_torch.host.xxhash import xxh64 as host_xxh64
    from aircompressor_tpu_torch.ops import deflate_decode, xxhash
    from aircompressor_tpu_torch.ops.batch import (
        DeflateBatchCodec, _pack, _round_up, to_device_batch)

    print("== deflate path at real size (generated corpus)", flush=True)
    n = len(corpus)
    codec = DeflateBatchCodec()  # the card by default, level 6
    t0 = time.perf_counter()
    blobs = codec.compress_chunks(corpus)
    t_compress = time.perf_counter() - t0
    raw, raw_lens = to_device_batch(*_pack(corpus, CHUNK), dev)
    buf, lens = _pack(blobs, _round_up(max(map(len, blobs)), 16))
    want_hash = [host_xxh64(c) for c in corpus] * sustain
    deflate_decode.launches = deflate_decode.rows = xxhash.launches = 0
    t0 = time.perf_counter()
    decoded = codec.decompress_chunks(blobs)  # its canary runs here
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = codec.decompress_chunks(blobs)
    t_codec = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = deflate_plan.plan(buf, lens)
    t_plan = time.perf_counter() - t0
    comp, comp_lens = to_device_batch(buf, lens, dev)
    big, big_lens = comp.repeat(sustain, 1), comp_lens.repeat(sustain)
    t0 = time.perf_counter()
    big_plan = deflate_decode.upload(tile_plan(plan, sustain), dev)
    out, out_lens, ok = deflate_decode.decode(big, big_lens, big_plan)
    digest = xxhash.xxh64(out, out_lens)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t0
    counts = {"deflate_decode": deflate_decode.launches, "xxh64": xxhash.launches}
    rows = deflate_decode.rows

    n_all = 1 + 2 * n + n * sustain  # the canary, two codec batches, the tiles
    require(all(c > 0 for c in counts.values()), f"the deflate path's kernels launched: {counts}")
    require(rows == n_all, f"every deflate chunk went through the kernel: {rows}/{n_all}")
    require(decoded == corpus and again == corpus,
            "DeflateBatchCodec.decompress_chunks returns the corpus")
    require(bool((plan.info[:, 3] == deflate_plan.ST_OK).all()), "every corpus stream plans")
    require(bool(ok.all()), "every tiled deflate chunk decodes ok")
    require(torch.equal(out_lens, raw_lens.repeat(sustain)) and
            torch.equal(out, raw.repeat(sustain, 1)),
            "every tiled deflate chunk decodes to its original")
    require([v & (2**64 - 1) for v in digest.tolist()] == want_hash,
            "every xxh64 of a decoded deflate chunk equals the host's of its original")
    comp_bytes = int(lens.sum())
    plan_bytes = 4 * (plan.desc.size + plan.tabs.size + plan.index.size)
    small_plan = deflate_decode.upload(plan, dev)
    steps = deflate_decode.decode(comp, comp_lens, small_plan, with_steps=True)[3]
    top = int(steps.argmax())
    chain = dict(steps=int(steps[top]), chunk=top, total=int(steps.sum()))
    shares = deflate_decode.distance_shares(comp, comp_lens, small_plan)
    print(f"deflate steps on the corpus: longest chain chunk {top}, {chain['steps']} "
          f"symbols; {chain['total']} in all")
    print("deflate copy distances of the corpus (share of copies and of their bytes "
          "within each window's reach): " + json.dumps(shares))
    print(f"DeflateBatchCodec.compress_chunks (zlib level 6): {n} chunks, "
          f"{sum(map(len, corpus))} B -> {comp_bytes} B in {t_compress:.3f} s (host clock)")
    print(f"DeflateBatchCodec.decompress_chunks: {n} chunks in {t_codec:.4f} s (host "
          f"clock, planner, staging and copies included; first call with its canary "
          f"{t_first:.4f} s); planner alone {t_plan:.4f} s for {n} chunks, "
          f"{int(plan.info[:, 1].sum())} blocks, {plan_bytes} B of plan")
    print(f"tiled x{sustain}: {big.shape[0]} chunks (plan tiled, not replanned) decoded "
          f"and xxh64-hashed in {t_big:.3f} s (host clock, first call, upload included); "
          f"launches {counts}, {rows} of {n_all} chunks through the deflate kernel")
    return dict(comp=comp, comp_lens=comp_lens, plan=small_plan, chain=chain,
                big=big, big_lens=big_lens, big_plan=big_plan, counts=counts,
                comp_bytes=comp_bytes, plan_bytes=plan_bytes,
                decoded_bytes=int(out_lens.sum()), t_plan=t_plan, t_codec=t_codec)


def lzo_deflate_times(dev, lk: dict, lp: dict, dk: dict, dp: dict) -> list[dict]:
    """Time the LZO and deflate kernels by CUDA events on the six 64 KB
    corpus chunks (beside their plain versions, in turns), on the corpus's
    256 chunks and on the 4096 tiled chunks, each beside its bytes bound:
    the blocks, their lengths and (deflate) the plan in, every row's bytes,
    length and flag out. Return their lines of the kernels JSON."""
    from aircompressor_tpu_torch.host.deflate import plan as deflate_plan
    from aircompressor_tpu_torch.ops import deflate_decode, lzo_decode
    from aircompressor_tpu_torch.ops.batch import _pack, _round_up, to_device_batch

    def staged(blobs):
        buf, lens = _pack(blobs, _round_up(max(map(len, blobs)), 16))
        return buf, lens, to_device_batch(buf, lens, dev)

    _, _, lzo_full = staged(lk["full"])
    buf, lens, dfull = staged(dk["full"])
    full_plan = deflate_plan.plan(buf, lens)
    runs = [  # name, module, (six chunks, 256, 4096) arguments, their plan bytes
        ("lzo_decode", lzo_decode, lk, lp, 52,
         (lzo_full, (lp["comp"], lp["comp_lens"]), (lp["big"], lp["big_lens"])), (0, 0, 0)),
        ("deflate_decode", deflate_decode, dk, dp, 61,
         ((*dfull, deflate_decode.upload(full_plan, dev)),
          (dp["comp"], dp["comp_lens"], dp["plan"]),
          (dp["big"], dp["big_lens"], dp["big_plan"])),
         (4 * (full_plan.desc.size + full_plan.tabs.size + full_plan.index.size),
          dp["plan_bytes"], dp["plan_bytes"] * SUSTAIN))]
    entries = []
    for name, mod, check, path, line, (full, mid, big), plan_bytes in runs:
        ms, plain_ms = paired_ms(lambda: mod.decode(*full), lambda: mod.decode_plain(*full),
                                 10, 1)
        ms_mid, ms_big = time_ms(lambda: mod.decode(*mid), 10), time_ms(lambda: mod.decode(*big), 3)
        b_full, b_mid, b_big = (
            bound_ms(comp_bytes + 4 * b + pb, b * CHUNK + 5 * b) for comp_bytes, b, pb in (
                (sum(map(len, check["full"])), len(check["full"]), plan_bytes[0]),
                (path["comp_bytes"], N_CHUNKS, plan_bytes[1]),
                (path["comp_bytes"] * SUSTAIN, N_CHUNKS * SUSTAIN, plan_bytes[2])))
        print(f"{name}: 6 chunks of 64 KB: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_full:.5f} ms; {N_CHUNKS} chunks: kernel {ms_mid:.4f} ms "
              f"({gbps(path['decoded_bytes'] / SUSTAIN, ms_mid):.3f} GB/s), bound "
              f"{b_mid:.5f} ms; {N_CHUNKS * SUSTAIN} chunks: kernel {ms_big:.4f} ms "
              f"({gbps(path['decoded_bytes'], ms_big):.3f} GB/s decoded), bound {b_big:.5f} ms")
        entries.append({
            "name": name, "route": "cuda", "source": f"aircompressor_tpu_torch/csrc/{name}.cu",
            "replaces": f"aircompressor_tpu/ops/{name.split('_')[0]}_pallas_w.py:{line}",
            "launches": path["counts"][name], "max_abs_err": check["err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_full, "bound_by": "bytes",
            "library_ms": None, "batch": "6 corpus chunks of 64 KB",
            "chunks": N_CHUNKS, "chunks_ms": ms_mid, "chunks_bound_ms": b_mid,
            "tiled_chunks": N_CHUNKS * SUSTAIN, "tiled_ms": ms_big, "tiled_bound_ms": b_big})
        if name == "lzo_decode":
            chain, sms = path["chain"], torch.cuda.get_device_properties(0).multi_processor_count
            entries[-1].update(redesigned="PR 12", longest_chain_steps=chain["steps"])
            print(f"lzo_decode: {ms_mid * 1e6 / chain['steps']:.1f} ns a command of the "
                  f"longest chain ({chain['steps']} commands) at {N_CHUNKS} chunks; "
                  f"{ms_big * 1e6 * sms / (chain['total'] * SUSTAIN):.2f} ns a command of an "
                  f"SM (all {chain['total'] * SUSTAIN} commands over {sms} SMs) at "
                  f"{N_CHUNKS * SUSTAIN}")
        if name == "deflate_decode":
            chain, sms = path["chain"], torch.cuda.get_device_properties(0).multi_processor_count
            entries[-1].update(redesigned="table slot, input ring and output window in "
                               "shared memory", longest_chain_steps=chain["steps"])
            print(f"deflate_decode: {ms_mid * 1e6 / chain['steps']:.1f} ns a symbol of the "
                  f"longest chain ({chain['steps']} symbols) at {N_CHUNKS} chunks; "
                  f"{ms_big * 1e6 * sms / (chain['total'] * SUSTAIN):.2f} ns a symbol of an "
                  f"SM (all {chain['total'] * SUSTAIN} symbols over {sms} SMs) at "
                  f"{N_CHUNKS * SUSTAIN}")
    print(f"deflate planner on the host: {N_CHUNKS} chunks in {dp['t_plan']:.4f} s (host "
          f"clock) beside the kernel's {entries[1]['chunks_ms']:.4f} ms")
    return entries


def snappy_r2_against_plain(dev, corpus: list[bytes]) -> dict:
    """Hold the r2 kernel (kernel #12) to its plain version on all four
    outputs, steps included, at out_cap 65536 and 4096, on 45 rows in two
    groups of 32: the synthetic cases, the malformed blocks, the r2
    malformed rows and 24 corpus blocks of 64 KB. Bytes, lengths and ok also
    equal kernel #1's; each row alone (one launch a row) gives its own count.
    Returns the max_abs_err."""
    from aircompressor_tpu_torch.host import snappy as host_snappy
    from aircompressor_tpu_torch.ops import snappy_decode, snappy_decode_r2
    from aircompressor_tpu_torch.ops.batch import _pack, _round_up, to_device_batch

    compress = host_snappy.compress
    blobs = ([compress(c) for _, c in synthetic_cases()] + malformed_cases(compress)
             + R2_MALFORMED + [compress(corpus[i]) for i in R2_CORPUS_ROWS])
    require(len(blobs) == 45, "45 rows for the r2 comparison")
    comp, comp_lens = to_device_batch(
        *_pack(blobs, _round_up(max(map(len, blobs)), 16)), dev)
    err = 0
    for out_cap in (CHUNK, 4096):
        k = snappy_decode_r2.decode(comp, comp_lens, out_cap=out_cap, with_steps=True)
        p = snappy_decode_r2.decode_plain(comp, comp_lens, out_cap=out_cap, with_steps=True)
        k1 = snappy_decode.decode(comp, comp_lens, out_cap=out_cap)
        torch.cuda.synchronize()
        for name, a, b in zip(("out", "out_lens", "ok", "steps"), k, p):
            require(torch.equal(a, b), f"r2 decode {name} equal plain at out_cap {out_cap}")
        for name, a, b in zip(("out", "out_lens", "ok"), k, k1):
            require(torch.equal(a, b), f"r2 decode {name} equal kernel #1's at {out_cap}")
        err = max(err, int((k[0].int() - p[0].int()).abs().max()))
        steps = k[3].tolist()
        require(len(set(steps[:32])) == 1 and len(set(steps[32:])) == 1
                and steps[0] != steps[32], f"two groups with different maxima: {steps}")
        require(not any(k[2][13:21].tolist()), "every r2 malformed row fails")
    table = snappy_decode.token_table(comp, comp_lens)
    own = snappy_decode_r2.chunk_steps(table, comp_lens).tolist()
    alone = [int(snappy_decode_r2.decode(comp[i:i + 1], comp_lens[i:i + 1],
                                         with_steps=True)[3][0]) for i in range(len(blobs))]
    require(alone == own, "each row alone gives its own count")
    print(f"snappy r2 decode: {len(blobs)} chunks ({len(blobs) - 32} in the second "
          f"group) at out_cap {CHUNK} and 4096, kernel == plain on out, out_lens, ok "
          f"and steps (group maxima {steps[0]} and {steps[32]}), == kernel #1 on out, "
          f"out_lens and ok, max_abs_err {err}; each of the {len(blobs)} rows alone "
          f"== its own count (largest {max(own)})")
    return max(err, r2_windows_against_plain(dev, blobs))


def r2_windows_against_plain(dev, blobs: list[bytes]) -> int:
    """Hold both windows of the r2 decode kernel to its plain version on all
    four outputs, and to kernel #1 on out, out_lens and ok: the given blobs
    and the hand-built window cases (``r2_window_cases``) tiled to 257 rows
    (the 32 KB window) and to SMALL_BATCH + 1 rows (the 4 KB window) of an
    odd width, at out_cap 65536, 4096 and 4093; the window cases' bytes also
    against the host decoder. Return the max_abs_err."""
    from aircompressor_tpu_torch.host import snappy as host_snappy
    from aircompressor_tpu_torch.ops import snappy_decode, snappy_decode_r2
    from aircompressor_tpu_torch.ops.batch import _pack, to_device_batch

    cases = r2_window_cases()
    first = len(blobs)
    blobs = blobs + [b for _, b in cases]
    want = [host_snappy.decompress(b, CHUNK) for _, b in cases]
    err = 0
    for rows in (257, snappy_decode_r2.SMALL_BATCH + 1):
        batch = (blobs * (rows // len(blobs) + 1))[:rows]
        comp, lens = to_device_batch(*_pack(batch, max(map(len, batch)) | 1), dev)
        for out_cap in (CHUNK, 4096, 4093):
            k = snappy_decode_r2.decode(comp, lens, out_cap=out_cap, with_steps=True)
            p = snappy_decode_r2.decode_plain(comp, lens, out_cap=out_cap, with_steps=True)
            k1 = snappy_decode.decode(comp, lens, out_cap=out_cap)
            torch.cuda.synchronize()
            for name, a, b in zip(("out", "out_lens", "ok", "steps"), k, p):
                require(torch.equal(a, b), f"r2 decode {name} equal plain at out_cap "
                                           f"{out_cap}, {rows} rows")
            for name, a, b in zip(("out", "out_lens", "ok"), k, k1):
                require(torch.equal(a, b), f"r2 decode {name} equal kernel #1's at out_cap "
                                           f"{out_cap}, {rows} rows")
            err = max(err, int((k[0].int() - p[0].int()).abs().max()))
            for i, w in enumerate(want):
                require(bool(k[2][first + i]) == (len(w) <= out_cap)
                        and k[0][first + i, :min(len(w), out_cap)].cpu().numpy().tobytes()
                        == w[:out_cap], f"r2 window case {cases[i][0]} equals the host's bytes")
    print(f"snappy r2 decode windows {snappy_decode_r2.WINDOWS}: 257 and "
          f"{snappy_decode_r2.SMALL_BATCH + 1} rows of an odd width ({first} comparison rows "
          f"and {len(cases)} window cases: {', '.join(n for n, _ in cases)}), out_cap {CHUNK}, "
          f"4096 and 4093, kernel == plain (out, out_lens, ok, steps) and == kernel #1 (out, "
          f"out_lens, ok), cases == host decoder, max_abs_err {err}")
    return err


CRC_GRID = list(range(36)) + [63, 64, 65, 4095, 4096, 4097, CHUNK]
RANK_TIMEOUT = 300  # seconds for each gloo rank of the two-rank run
RANK_CODE = "import sys, chip_smoke; chip_smoke.rank_worker(*sys.argv[1:])"


def crc32c_against_plain(dev) -> int:
    """Hold the CRC32-C kernel to ``crc32c_plain`` and the host's
    ``crc32c_raw`` on the length grid: rows of width CHUNK (16-byte
    aligned: the kernel's aligned variant), of CHUNK - 5 and at a base one
    byte past 16-byte alignment (its byte variant), and lengths past the
    row or below 0 (clamped). Returns the max_abs_err."""
    from aircompressor_tpu_torch.host.crc32c import crc32c_raw
    from aircompressor_tpu_torch.ops import checksum

    rng = np.random.default_rng(32)
    err = 0
    for width, shift in ((CHUNK, 0), (CHUNK - 5, 0), (4096, 1)):
        rows = len(CRC_GRID) + 2
        buf = torch.from_numpy(rng.integers(0, 256, rows * width + shift, dtype=np.uint8)).to(dev)
        data = buf[shift:].view(rows, width)
        require(data.is_contiguous() and (data.data_ptr() % 16 == 0) == (shift == 0),
                "the batch's alignment")
        lens = torch.tensor([min(n, width) for n in CRC_GRID] + [-7, width + 9],
                            dtype=torch.int32, device=dev)
        k = checksum.crc32c(data, lens).tolist()
        p = checksum.crc32c_plain(data, lens).tolist()
        host = data.cpu().numpy()
        h = [crc32c_raw(host[i, :min(max(n, 0), width)]) for i, n in enumerate(lens.tolist())]
        err = max([err] + [abs(a - b) for a, b in zip(k, p)])
        require(k == p == h, f"crc32c kernel == plain == host at L={width}, base +{shift}")
    print(f"crc32c: {3 * (len(CRC_GRID) + 2)} rows (lengths 0-35, 63-65, 4095-4097, "
          f"{CHUNK}, -7 and past the row; widths {CHUNK}, {CHUNK - 5} and 4096 at a base "
          f"+1), kernel == plain == host, max_abs_err {err}")
    return err


def _counts() -> dict:
    """The launch counts of the kernels that the mesh phases run."""
    from aircompressor_tpu_torch.ops import checksum, snappy_decode, snappy_encode, xxhash

    return {"snappy_encode": snappy_encode.launches, "snappy_decode": snappy_decode.launches,
            "xxh64": xxhash.launches, "xxh32": xxhash.xxh32_launches,
            "crc32c": checksum.launches}


def _zero_counts() -> None:
    from aircompressor_tpu_torch.ops import checksum, snappy_decode, snappy_encode, xxhash

    snappy_encode.launches = snappy_decode.launches = xxhash.launches = 0
    xxhash.xxh32_launches = checksum.launches = 0


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


MESH_KEYS = ("xxh64", "xxh32", "crc32c")


def mesh_path(dev, raw: torch.Tensor, raw_lens: torch.Tensor) -> dict:
    """The one-process mesh over every card (``dev`` alone on a machine of
    one): ``sharded_checksum_step``,
    ``sharded_compress`` then ``sharded_decompress`` on the tiled corpus,
    every output, length, flag and total equal to the unsharded calls;
    then ``dryrun_multichip`` over every card. Returns the mesh's results,
    launches and times."""
    from aircompressor_tpu_torch.entry import _sample_batch, decode_and_hash, dryrun_multichip
    from aircompressor_tpu_torch.ops import checksum, pipeline, snappy_decode, snappy_encode
    from aircompressor_tpu_torch.ops.batch import to_device_batch

    print("== one-process mesh over every card (the tiled corpus)", flush=True)
    mesh = pipeline.make_mesh()
    _zero_counts()
    t0 = time.perf_counter()
    ck = pipeline.sharded_checksum_step(mesh)(raw, raw_lens)
    comp, comp_lens, c_total = pipeline.sharded_compress(mesh)(raw, raw_lens)
    out, out_lens, ok, d_total = pipeline.sharded_decompress(mesh)(comp, comp_lens)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    counts = _counts()
    require(all(n > 0 for n in counts.values()), f"the mesh launched every kernel: {counts}")

    want = pipeline.checksum_step(raw, raw_lens)
    for key in MESH_KEYS:
        require(torch.equal(ck[key], want[key]), f"mesh {key} equals the unsharded step's")
    u_comp, u_lens, u_ok = snappy_encode.encode(raw, raw_lens)
    u_out, u_out_lens, u_dok = snappy_decode.decode(u_comp, u_lens)
    require(bool(u_ok.all()) and torch.equal(comp, u_comp) and torch.equal(comp_lens, u_lens),
            "mesh compress equals the unsharded encode")
    require(torch.equal(out, u_out) and torch.equal(out_lens, u_out_lens)
            and torch.equal(ok, u_dok) and bool(ok.all()),
            "mesh decompress equals the unsharded decode")
    require(torch.equal(out_lens, raw_lens) and torch.equal(out, raw),
            "mesh decompress gives back the tiled corpus")
    n_bytes = int(raw_lens.to(torch.int64).sum())
    require(int(ck["bytes"]) == int(d_total) == n_bytes and
            int(c_total) == int(comp_lens.to(torch.int64).sum()), "mesh totals")
    plain = checksum.mask_crc(checksum.crc32c_plain(raw[:N_CHUNKS], raw_lens[:N_CHUNKS]))
    require(torch.equal(ck["crc32c"], plain.repeat(SUSTAIN)), "mesh CRC32-C equals plain")
    print(f"mesh of {mesh.size} ({', '.join(map(str, mesh.devices))}): {raw.shape[0]} chunks, {n_bytes} B, checksum + "
          f"compress ({int(c_total)} B) + decompress in {t_mesh:.3f} s (host clock, first "
          f"calls); == unsharded on every output; launches {counts}")

    print("== dryrun_multichip", flush=True)
    n_cards = torch.cuda.device_count()
    _zero_counts()
    dry = dryrun_multichip(n_cards)
    dry_counts = _counts()
    buf, lens, chunk = _sample_batch(4 * n_cards)
    single = decode_and_hash(*to_device_batch(buf, lens, dev), out_cap=chunk)
    for key in single:
        require(torch.equal(dry[key], single[key]), f"dryrun {key} equals the unsharded step")
    require(dry_counts["snappy_decode"] > 0 and dry_counts["xxh64"] > 0,
            f"the dryrun launched kernels #1 and #2: {dry_counts}")
    print(f"dryrun_multichip({n_cards}): {4 * n_cards} chunks, {int(dry['bytes'])} B, "
          f"== unsharded decode_and_hash; launches {dry_counts}")
    return {"ck": ck, "comp": comp, "comp_lens": comp_lens, "c_total": int(c_total),
            "out": out, "out_lens": out_lens, "d_total": int(d_total), "bytes": n_bytes,
            "counts": counts, "mesh": mesh}


def nccl_rank(dev, raw: torch.Tensor, raw_lens: torch.Tensor, mp: dict) -> None:
    """A world of one NCCL rank in this process: the distributed steps on
    the tiled corpus, equal to the mesh's, and the scaling report of one
    card (not a scaling figure)."""
    import tempfile

    from aircompressor_tpu_torch import _build
    from aircompressor_tpu_torch.ops import multihost

    print("== one NCCL rank in this process", flush=True)
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        multihost.initialize(f"file://{tmp}/rendezvous", 1, 0)
        report, counts = _nccl_steps(dev, raw, raw_lens, mp)
    print(f"one NCCL rank: == the mesh on every output and total; launches {counts}")
    print("scaling_report on ONE card, a mesh of one device against the unsharded decode "
          "(the wrapper's overhead, not a scaling figure): " + json.dumps(report))


def _nccl_steps(dev, raw, raw_lens, mp: dict):
    import torch.distributed as dist

    from aircompressor_tpu_torch.ops import multihost, pipeline, snappy_decode

    try:
        multihost.initialize("file:///nonexistent/store", 1, 0)  # a no-op
        require(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "one NCCL rank")
        mesh = multihost.global_mesh()
        require(mesh.devices == (dev,), f"the rank's mesh is {dev}: {mesh}")
        data, lens = multihost.make_global_batch(mesh, raw.cpu().numpy(), raw_lens.cpu().numpy())
        _zero_counts()
        ck = multihost.distributed_checksum(mesh)(data, lens)
        comp, comp_lens, c_total = multihost.distributed_compress(mesh)(data, lens)
        out, out_lens, ok, d_total = multihost.distributed_decompress(mesh)(comp, comp_lens)
        torch.cuda.synchronize()
        counts = _counts()
        for key in MESH_KEYS:
            require(torch.equal(ck[key].local, mp["ck"][key]), f"NCCL rank {key} == the mesh's")
        require(torch.equal(comp.local, mp["comp"]) and torch.equal(comp_lens.local, mp["comp_lens"])
                and torch.equal(out.local, mp["out"]) and torch.equal(out_lens.local, mp["out_lens"])
                and bool(ok.local.all()), "NCCL rank outputs == the mesh's")
        require(int(ck["bytes"]) == int(d_total) == mp["bytes"] and int(c_total) == mp["c_total"]
                and ck["bytes"].device == dev, "NCCL rank totals (reduced on the card)")
        require(all(n > 0 for n in counts.values()), f"the rank launched every kernel: {counts}")
        decode = pipeline.sharded_decompress(mesh)
        t_one = time_ms(lambda: snappy_decode.decode(mp["comp"], mp["comp_lens"]), 3)
        t_mesh = time_ms(lambda: decode(mp["comp"], mp["comp_lens"]), 3)
        report = multihost.scaling_report(mesh, t_one / 1e3, t_mesh / 1e3, mp["bytes"])
    finally:
        dist.destroy_process_group()
    return report, counts


def rank_worker(rank: str, world: str, store: str) -> None:
    """One gloo rank of the two-rank run, on cuda:0: half of the tiled
    corpus's chunks through the distributed steps; every local row decoded
    on the host. Prints one JSON line of its totals and digests."""
    import sys

    for name in ("jax", "aircompressor_tpu"):
        sys.modules[name] = None
    import torch.distributed as dist

    from aircompressor_tpu_torch.host import snappy as host_snappy
    from aircompressor_tpu_torch.ops import multihost
    from aircompressor_tpu_torch.ops.batch import _pack

    rank, world = int(rank), int(world)
    corpus = generated_corpus()
    buf, lens = _pack(corpus * SUSTAIN, CHUNK)
    per = buf.shape[0] // world
    mine = slice(rank * per, (rank + 1) * per)
    multihost.initialize(store, world, rank, device="cuda:0", backend="gloo")
    try:
        mesh = multihost.global_mesh()
        data, lengths = multihost.make_global_batch(mesh, buf[mine], lens[mine])
        _zero_counts()
        ck = multihost.distributed_checksum(mesh)(data, lengths)
        comp, comp_lens, c_total = multihost.distributed_compress(mesh)(data, lengths)
        out, out_lens, ok, d_total = multihost.distributed_decompress(mesh)(comp, comp_lens)
        counts = _counts()
        rows, blens = multihost.local_rows(comp), multihost.local_rows(comp_lens)
        raws = corpus * SUSTAIN
        for i in range(per):
            require(host_snappy.decompress(rows[i, :blens[i]].tobytes(), CHUNK)
                    == raws[rank * per + i], f"rank {rank}: local row {i} decodes on the host")
        require(bool(ok.local.all()) and np.array_equal(multihost.local_rows(out), buf[mine]),
                f"rank {rank}: local rows of out equal its chunks")
        result = {"rank": rank, "offset": data.offset, "rows": data.rows,
                  "bytes": int(ck["bytes"]), "c_total": int(c_total), "d_total": int(d_total),
                  "total_device": str(ck["bytes"].device), "counts": counts,
                  "digests": {key: _digest(ck[key].local) for key in MESH_KEYS}
                  | {"comp": _digest(comp.local), "comp_lens": _digest(comp_lens.local),
                     "out": _digest(out.local), "out_lens": _digest(out_lens.local)}}
    finally:
        dist.destroy_process_group()
    print(json.dumps(result))


def gloo_ranks(mp: dict) -> list[dict]:
    """Two gloo ranks on the one card, as subprocesses with a file:// store,
    each with half of the tiled corpus: their global totals equal the
    mesh's, their local results the mesh's rows of their half."""
    import subprocess
    import sys
    import tempfile

    from aircompressor_tpu_torch import _build

    print("== two gloo ranks on the one card (subprocesses)", flush=True)
    here = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_CODE, str(r), "2", f"file://{tmp}/rendezvous"],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=RANK_TIMEOUT))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    t_ranks = time.perf_counter() - t0
    for r, (proc, (out, err)) in enumerate(zip(procs, outs)):
        require(proc.returncode == 0, f"gloo rank {r} exits 0:\n{err[-4000:]}")
    reports = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    per = mp["out"].shape[0] // 2
    for r, rep in enumerate(reports):
        rows = slice(r * per, (r + 1) * per)
        want = {key: _digest(mp["ck"][key][rows]) for key in MESH_KEYS} | {
            "comp": _digest(mp["comp"][rows]), "comp_lens": _digest(mp["comp_lens"][rows]),
            "out": _digest(mp["out"][rows]), "out_lens": _digest(mp["out_lens"][rows])}
        require(rep["rank"] == r and rep["offset"] == r * per and rep["rows"] == 2 * per,
                f"gloo rank {r}'s rows")
        require(rep["digests"] == want, f"gloo rank {r}'s local results == the mesh's rows")
        require(all(n > 0 for n in rep["counts"].values()),
                f"gloo rank {r} launched every kernel: {rep['counts']}")
        require(rep["bytes"] == rep["d_total"] == mp["bytes"] and rep["c_total"] == mp["c_total"]
                and rep["total_device"] == "cpu", f"gloo rank {r} holds the global totals")
    print(f"two gloo ranks on cuda:0: {per} chunks each, global totals {mp['bytes']} B and "
          f"{mp['c_total']} B compressed on both, local results == the mesh's rows, every "
          f"local row decoded on the host; launches {[rep['counts'] for rep in reports]}; "
          f"{t_ranks:.1f} s (host clock, both processes from their start)")
    return reports


def families_phase(dev, corpus: list[bytes], card: str) -> dict:
    """The codec families on the host, held to the card's batch decoders.

    (a) Builds the host library with g++ and requires the native tier; (b)
    round-trips the corpus's first 32 chunks through each family's native
    tier (LZO has only its numpy tier, zstd's own tier is numpy) and 2 text
    chunks of them through the Snappy and LZ4 numpy tiers, each tier
    decoding the other's output; (c) sends the block API's
    LZ4 blocks, LZO blocks and zstd frames (the own encoder's, and
    libzstd's where the machine has it) to ``Lz4BatchCodec``,
    ``LzoBatchCodec`` and ``ZstdBatchCodec`` on the card, whose bytes must
    equal the originals and the host decoders' (the zstd frames'
    ``zstd.frame_dec`` among them); (d) writes the 2 MB as one
    ``SnappyFramedOutputStream`` and decodes it with
    ``snappy_framed_decompress_device`` and ``SnappyFramedInputStream``.
    The LZ4 frame, lzop and zstd stream formats, which have no device path,
    round-trip on the host. Returns the launches of each card kernel in
    (c) and (d), each required to be nonzero, and the phase's numbers."""
    import ctypes.util
    import io

    from aircompressor_tpu_torch import _build, lz4, lzo, native, snappy, zstd
    from aircompressor_tpu_torch.lz4 import frame_codec
    from aircompressor_tpu_torch.lz4 import streams as lz4_streams
    from aircompressor_tpu_torch.lzo import lzop
    from aircompressor_tpu_torch.native import zstd_binding
    from aircompressor_tpu_torch.ops import (
        checksum, lz4_decode, lzo_decode, snappy_decode, xxhash, zstd_decode)
    from aircompressor_tpu_torch.ops.batch import (
        Lz4BatchCodec, LzoBatchCodec, ZstdBatchCodec, snappy_framed_decompress_device)
    from aircompressor_tpu_torch.snappy import framed as snappy_framed
    from aircompressor_tpu_torch.zstd import frame_dec
    from aircompressor_tpu_torch.zstd import streams as zstd_streams

    print("== families: block API, native tier and stream formats, held to the "
          "card's batch decoders", flush=True)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    lib = _build.build_host()
    t_build = time.perf_counter() - t0
    require(native.is_enabled(), f"the native tier is enabled ({native.load_error()})")
    picks = {f.__qualname__.split(".")[0]: type(f()).__name__ for f in (
        snappy.SnappyCompressor.create, snappy.SnappyDecompressor.create,
        lz4.Lz4Compressor.create, lz4.Lz4Decompressor.create,
        lzo.LzoCompressor.create, lzo.LzoDecompressor.create,
        zstd.ZstdCompressor.create, zstd.ZstdDecompressor.create)}
    require(picks["SnappyCompressor"] == "SnappyNativeCompressor"
            and picks["Lz4Decompressor"] == "Lz4NativeDecompressor",
            "create() picks the native tier")
    has_libzstd = zstd_binding.is_enabled()
    print(f"host library {lib.name} ready in {t_build:.2f} s; create() picks "
          f"{json.dumps(picks)}; libzstd found: {has_libzstd} "
          f"({ctypes.util.find_library('zstd')})")

    chunks = corpus[:32]
    data = b"".join(chunks)
    rates = {}

    def round_trip(name, comp, dec, raws):
        t0 = time.perf_counter()
        blobs = [comp.compress(r) for r in raws]
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = [dec.decompress(b, CHUNK) for b in blobs]
        t_d = time.perf_counter() - t0
        require(outs == raws, f"{name} round-trips {len(raws)} chunks")
        n = sum(map(len, raws)) / 1e6
        rates[name] = {"chunks": len(raws), "compress_MBps": n / t_c,
                       "decompress_MBps": n / t_d,
                       "ratio": sum(map(len, blobs)) / sum(map(len, raws))}
        return blobs

    snappy_n = round_trip("snappy native", snappy.SnappyNativeCompressor(),
                          snappy.SnappyNativeDecompressor(), chunks)
    lz4_n = round_trip("lz4 native", lz4.Lz4NativeCompressor(),
                       lz4.Lz4NativeDecompressor(), chunks)
    lzo_blobs = round_trip("lzo numpy", lzo.LzoCompressor(), lzo.LzoDecompressor(), chunks)
    zstd_ref = round_trip("zstd own (numpy)", zstd.ZstdRefCompressor(),
                          zstd.ZstdRefDecompressor(), chunks)
    zstd_n = (round_trip("zstd libzstd", zstd.ZstdNativeCompressor(),
                         zstd.ZstdNativeDecompressor(), chunks) if has_libzstd else [])
    two = chunks[4:6]  # text chunks: 0-3 are a zero, a run, a period-2 and a ramp
    snappy_r = round_trip("snappy numpy", snappy.SnappyRefCompressor(),
                          snappy.SnappyRefDecompressor(), two)
    lz4_r = round_trip("lz4 numpy", lz4.Lz4RefCompressor(), lz4.Lz4RefDecompressor(), two)
    for name, dec, blobs in [
            ("snappy numpy on native blocks", snappy.SnappyRefDecompressor(), snappy_n[4:6]),
            ("snappy native on numpy blocks", snappy.SnappyNativeDecompressor(), snappy_r),
            ("lz4 numpy on native blocks", lz4.Lz4RefDecompressor(), lz4_n[4:6]),
            ("lz4 native on numpy blocks", lz4.Lz4NativeDecompressor(), lz4_r)]:
        require([dec.decompress(b, CHUNK) for b in blobs] == two, name)
    if has_libzstd:
        require([zstd.ZstdNativeDecompressor().decompress(f, CHUNK) for f in zstd_ref[4:6]]
                == two, "libzstd decodes the own encoder's frames")
    zstd_host = {}
    for name, frames in (("own", zstd_ref), ("libzstd", zstd_n)):
        outs = []
        for f in frames:
            dst = np.empty(CHUNK, np.uint8)
            outs.append(dst[:frame_dec.decompress(np.frombuffer(f, np.uint8), dst)].tobytes())
        require(outs == chunks[:len(frames)], f"frame_dec decodes the {name} frames")
        zstd_host[name] = outs

    print("-- block API output to the card", flush=True)
    snappy_decode.launches = checksum.launches = lz4_decode.launches = 0
    lzo_decode.launches = xxhash.launches = 0
    zstd_decode.huffman_launches = zstd_decode.fse_launches = zstd_decode.execute_launches = 0
    t0 = time.perf_counter()
    got = Lz4BatchCodec(device=dev).decompress_chunks(lz4_n)
    require(got == chunks, "the card decodes Lz4NativeCompressor's blocks to the originals")
    require(got == [lz4.Lz4NativeDecompressor().decompress(b, CHUNK) for b in lz4_n],
            "the card's LZ4 bytes equal the host decoder's")
    got = LzoBatchCodec(device=dev).decompress_chunks(lzo_blobs)
    require(got == chunks == [lzo.LzoDecompressor().decompress(b, CHUNK) for b in lzo_blobs],
            "the card decodes LzoCompressor's blocks as the host does")
    zc = ZstdBatchCodec(device=dev)
    for name, frames in (("own", zstd_ref), ("libzstd", zstd_n)):
        if frames:
            got = zc.decompress_chunks(frames)
            require(got == zstd_host[name] == chunks,
                    f"the card decodes the {name} zstd frames as frame_dec does")

    print("-- a framed stream to the card", flush=True)
    sink = io.BytesIO()
    out = snappy_framed.SnappyFramedOutputStream(sink)
    out.write(data)
    out.close()
    stream = sink.getvalue()
    got = snappy_framed_decompress_device(stream, device=dev)
    require(got == data, "the card decodes the SnappyFramedOutputStream to the 2 MB")
    require(snappy_framed.SnappyFramedInputStream(io.BytesIO(stream)).read() == data,
            "SnappyFramedInputStream decodes it to the 2 MB")
    t_card = time.perf_counter() - t0
    counts = {"snappy_decode": snappy_decode.launches, "crc32c": checksum.launches,
              "lz4_decode": lz4_decode.launches, "lzo_decode": lzo_decode.launches,
              "zstd_huffman": zstd_decode.huffman_launches,
              "zstd_fse": zstd_decode.fse_launches,
              "zstd_execute": zstd_decode.execute_launches}
    require(all(n > 0 for n in counts.values()), f"the phase launched each kernel: {counts}")
    counts_xxh64 = xxhash.launches

    print("-- frame and stream formats on the host", flush=True)
    formats = {}

    def host_format(name, encode, decode, raw=data):
        t0 = time.perf_counter()
        blob = encode(raw)
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        require(decode(blob) == raw, f"{name} round-trips {len(raw)} B")
        formats[name] = {"in_bytes": len(raw), "out_bytes": len(blob),
                         "compress_MBps": len(raw) / 1e6 / t_c,
                         "decompress_MBps": len(raw) / 1e6 / (time.perf_counter() - t0)}

    fc = frame_codec.Lz4FrameCompressor.create(block_checksums=True, content_checksum=True,
                                               content_size=True)
    host_format("lz4 frame (native blocks)", fc.compress,
                lambda b: frame_codec.Lz4FrameDecompressor.create().decompress(b, len(data)))
    host_format("lz4 frame stream", lambda d: lz4_streams.compress_stream(d, block_max_id=4),
                lz4_streams.decompress_stream)
    host_format("x-snappy-framed stream", snappy_framed.compress_framed,
                snappy_framed.decompress_framed)
    host_format("lzop", lambda d: lzop.compress_file(d, lzop.F_ADLER32_D | lzop.F_ADLER32_C),
                lzop.decompress_file)
    # the stream encoder matches each 128 KB block against its whole window
    # in Python, so its time grows faster than its input: 4 blocks, not 16
    host_format("zstd stream (own encoder)", zstd_streams.compress_stream,
                zstd_streams.decompress_stream, data[:4 * 131072])
    t_total = time.perf_counter() - t_phase
    print(f"families: {len(chunks)} chunks, {len(data)} B; card decodes (LZ4, LZO, zstd "
          f"{'own and libzstd' if has_libzstd else 'own'} frames, the framed stream) "
          f"{t_card:.3f} s; launches {json.dumps(counts)} (xxh64 {counts_xxh64}); "
          f"phase {t_total:.2f} s (host clock)")
    print(f"host tiers on the card machine's host CPU ({card}), MB/s of "
          "uncompressed bytes: " + json.dumps({"blocks": rates, "formats": formats}))
    return {"counts": counts, "seconds": t_total, "card_seconds": t_card}


def gzip_member_parts(member: bytes) -> tuple[bytes, int, int]:
    """One gzip member's raw-deflate body, CRC-32 and ISIZE. The header is
    read by RFC 1952 §2.3: ID1 ID2 CM FLG MTIME XFL OS, then FEXTRA (a
    little-endian length and that many bytes), FNAME and FCOMMENT (each
    ended by a zero byte) and FHCRC (two bytes) where FLG sets them."""
    require(member[:3] == b"\x1f\x8b\x08", "a gzip member starts 1f 8b 08 (deflate)")
    flg = member[3]
    require(flg & 0xE0 == 0, f"gzip FLG reserved bits are zero: {flg:#x}")
    pos = 10
    if flg & 0x04:  # FEXTRA
        pos += 2 + int.from_bytes(member[pos:pos + 2], "little")
    for bit in (0x08, 0x10):  # FNAME, FCOMMENT
        if flg & bit:
            pos = member.index(b"\x00", pos) + 1
    if flg & 0x02:  # FHCRC
        require(int.from_bytes(member[pos:pos + 2], "little")
                == zlib.crc32(member[:pos]) & 0xFFFF, "gzip header CRC16")
        pos += 2
    return (member[pos:-8], int.from_bytes(member[-8:-4], "little"),
            int.from_bytes(member[-4:], "little"))


def zlib_stream_parts(stream: bytes) -> tuple[bytes, int]:
    """A zlib stream's (RFC 1950) raw-deflate body and Adler-32: a 2-byte
    header of CM 8, no preset dictionary and a check that CMF.FLG is a
    multiple of 31, then the body, then the big-endian Adler-32."""
    cmf, flg = stream[0], stream[1]
    require(cmf & 0x0F == 8 and cmf >> 4 <= 7 and not flg & 0x20
            and (cmf * 256 + flg) % 31 == 0, f"a zlib header: {stream[:2].hex()}")
    return stream[2:-4], int.from_bytes(stream[-4:], "big")


def hadoop_block_chunks(blob: bytes) -> tuple[list[int], list[bytes]]:
    """The Hadoop block stream's ([BE32 uncompressed block length] then
    ([BE32 chunk length] [chunk]) pairs) blocks, as written by
    ``hadoop.BlockHadoopOutputStream``: one chunk a block. Returns the
    blocks' uncompressed lengths and their chunks; a decode whose length
    differs from its block's shows a block of more chunks."""
    lens, chunks, pos = [], [], 0
    while pos < len(blob):
        require(pos + 8 <= len(blob), "a whole block header")
        lens.append(int.from_bytes(blob[pos:pos + 4], "big"))
        n = int.from_bytes(blob[pos + 4:pos + 8], "big")
        chunks.append(blob[pos + 8:pos + 8 + n])
        pos += 8 + n
    require(pos == len(blob), "the block stream ends at a chunk's end")
    return lens, chunks


HADOOP_BUFFER = 65536  # the block streams' buffer: the batch decoders' cap
HADOOP_CHUNKS = 32  # the corpus's first 32 chunks: 2,093,470 B
SLOW_CUT = 512 * 1024  # the own zstd stream encoder and the own bzip2 engine


def compat_phase(dev, corpus: list[bytes], card: str) -> dict:
    """The rest of the user surface on the host (deflate with libdeflate,
    gzip, bzip2, XXH3, the Hadoop layer), held to the card's batch decoders.

    (a) Prints the tiers ``create()`` picks and what ``find_library`` finds
    for deflate, xxhash and bz2: without libdeflate the zlib tier runs (the
    JAX package's own pick), without libxxhash XXH3 is not run. (b)
    Compresses the 256 corpus chunks with ``DeflateRefCompressor()`` (zlib
    level 4) and with ``DeflateNativeCompressor`` at levels 1, 4 and 12
    where libdeflate is found, and decodes each set with
    ``DeflateBatchCodec`` on the card, then the libdeflate fixture's
    streams (``data/libdeflate_streams.npz``), which bring libdeflate's
    output to the card where the machine lacks the library. (c) Writes each chunk as one gzip
    member (``gzip.compress_stream``), reads the concatenation back with
    ``GzipInputStream``, parses each member's header and trailer, decodes
    the bodies on the card and checks each CRC-32 and ISIZE against the
    card's bytes. (d) Round-trips the corpus's first 32 chunks through
    every ``CODEC_REGISTRY`` entry (zstd and the own bzip2 engine on the
    first 512 KB), sends the Snappy, LZ4 and LZO block streams' chunks
    (``buffer_size`` 65536) to ``SnappyBatchCodec``, ``Lz4BatchCodec`` and
    ``LzoBatchCodec`` and DefaultCodec's bodies (a stream a chunk) to
    ``DeflateBatchCodec``, checking each Adler-32; hashes the chunks with
    XXH3 64 and 128, one-shot and in 4 KB pieces. The block streams cut
    the 2 MB into 64 KB blocks, a chunk each, whatever the corpus chunks'
    lengths. Every card decode must
    equal the originals and the host readers; none has a fall back. Returns
    the launches of #10, #1, #4 and #6, each required nonzero."""
    import ctypes.util
    import io

    from aircompressor_tpu_torch import bzip2, deflate, gzip, hadoop, xxhash
    from aircompressor_tpu_torch.data import libdeflate_library, libdeflate_streams
    from aircompressor_tpu_torch.native import deflate_binding
    from aircompressor_tpu_torch.ops import deflate_decode, lz4_decode, lzo_decode, snappy_decode
    from aircompressor_tpu_torch.ops.batch import (
        DeflateBatchCodec, Lz4BatchCodec, LzoBatchCodec, SnappyBatchCodec)

    print("== compat: deflate, gzip, bzip2, XXH3 and the Hadoop layer, held to the "
          "card's batch decoders", flush=True)
    t_phase = time.perf_counter()
    libs = {n: ctypes.util.find_library(n) for n in ("deflate", "xxhash", "bz2")}
    picks = {"DeflateCompressor": type(deflate.DeflateCompressor.create()).__name__,
             "DeflateDecompressor": type(deflate.DeflateDecompressor.create()).__name__,
             "bzip2.create_compressor": type(bzip2.create_compressor()).__name__,
             "xxh3_is_enabled": xxhash.xxh3_is_enabled()}
    has_libdeflate = deflate_binding.is_enabled()
    print(f"find_library: {json.dumps(libs)}; picks {json.dumps(picks)}")
    if not has_libdeflate:
        print("libdeflate not found: the deflate family runs its zlib tier, as the JAX "
              "package's create() does; the libdeflate sets are not run, the fixture's "
              "libdeflate streams are")
    if not picks["xxh3_is_enabled"]:
        print("libxxhash not found: XXH3 is not run")

    rates, card_s = {}, {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    def rate(name, n, t_c, t_d, out_bytes=None):
        rates[name] = {"MB": n / 1e6, "compress_MBps": n / 1e6 / t_c,
                       "decompress_MBps": n / 1e6 / t_d}
        if out_bytes is not None:
            rates[name]["ratio"] = out_bytes / n

    deflate_decode.launches = snappy_decode.launches = 0
    lz4_decode.launches = lzo_decode.launches = 0
    card_deflate = DeflateBatchCodec(device=dev)
    host_inflate = deflate.DeflateDecompressor.create()
    total = sum(map(len, corpus))

    print(f"-- (b) deflate, {len(corpus)} chunks", flush=True)
    tiers = [("zlib 4", deflate.DeflateRefCompressor())]
    if has_libdeflate:
        tiers += [(f"libdeflate {lv}", deflate.DeflateNativeCompressor(lv)) for lv in (1, 4, 12)]
    for name, comp in tiers:
        blobs, t_c = timed(lambda: [comp.compress(c) for c in corpus])
        host, t_d = timed(lambda: [host_inflate.decompress(b, CHUNK) for b in blobs])
        got, card_s[f"deflate {name}"] = timed(card_deflate.decompress_chunks, blobs)
        require(got == corpus, f"the card decodes the {name} streams to the originals")
        require(got == host, f"the card's bytes equal {type(host_inflate).__name__}'s ({name})")
        rate(f"deflate {name}", total, t_c, t_d, sum(map(len, blobs)))
    fixture = libdeflate_streams()  # libdeflate's output, on any machine
    blobs = [f["stream"] for f in fixture]
    got, card_s["libdeflate fixture"] = timed(card_deflate.decompress_chunks, blobs)
    require(got == [f["original"] for f in fixture]
            == [host_inflate.decompress(b, CHUNK) for b in blobs],
            f"the card decodes the {len(blobs)} streams of the libdeflate fixture "
            f"({libdeflate_library()}) as the host does")

    print("-- (c) gzip, a member a chunk", flush=True)
    members, t_c = timed(lambda: [gzip.compress_stream(c) for c in corpus])
    stream = b"".join(members)
    back, t_d = timed(lambda: gzip.GzipInputStream(io.BytesIO(stream)).read())
    require(back == b"".join(corpus), f"GzipInputStream reads the {len(members)} members back")
    rate("gzip (zlib 4)", total, t_c, t_d, len(stream))
    parts = [gzip_member_parts(m) for m in members]
    got, card_s["gzip bodies"] = timed(card_deflate.decompress_chunks, [p[0] for p in parts])
    require(got == corpus, "the card decodes every gzip member's body")
    require(all(zlib.crc32(g) == crc and len(g) & 0xFFFFFFFF == isize
                for g, (_, crc, isize) in zip(got, parts)),
            "every member's CRC-32 and ISIZE hold for the card's bytes")

    print(f"-- (d) Hadoop, the first {HADOOP_CHUNKS} chunks", flush=True)
    chunks = corpus[:HADOOP_CHUNKS]
    data = b"".join(chunks)

    def write(streams, raw, piece=CHUNK):
        sink = io.BytesIO()
        out = streams.create_output_stream(sink)
        for i in range(0, len(raw), piece):
            out.write(raw[i:i + piece])
        out.finish()
        return sink.getvalue()

    def read(streams, blob):
        return streams.create_input_stream(io.BytesIO(blob)).read()

    for name in sorted(hadoop.CODEC_REGISTRY):
        streams = hadoop.get_codec(name)
        raw = data[:SLOW_CUT] if "ZStandard" in name else data
        blob, t_c = timed(write, streams, raw)
        back, t_d = timed(read, streams, blob)
        require(back == raw, f"{name} round-trips {len(raw)} B")
        rate(f"hadoop {name.rsplit('.', 1)[1]} ({type(streams).__name__})",
             len(raw), t_c, t_d, len(blob))
    segments = [data[i:i + HADOOP_BUFFER] for i in range(0, len(data), HADOOP_BUFFER)]
    for cls, batch in ((hadoop.SnappyHadoopStreams, SnappyBatchCodec),
                       (hadoop.Lz4HadoopStreams, Lz4BatchCodec),
                       (hadoop.LzoHadoopStreams, LzoBatchCodec)):
        streams = cls(buffer_size=HADOOP_BUFFER)
        blob = write(streams, data)
        lens, blocks = hadoop_block_chunks(blob)
        require(lens == list(map(len, segments)), f"{cls.__name__}: a block a 64 KB segment")
        got, card_s[cls.__name__] = timed(batch(device=dev).decompress_chunks, blocks)
        require(got == segments, f"the card decodes the {cls.__name__} chunks to the originals")
        require(b"".join(got) == read(streams, blob),
                f"the card's bytes equal the {cls.__name__} reader's")
    default = hadoop.get_codec("org.apache.hadoop.io.compress.DefaultCodec")
    zparts = [zlib_stream_parts(write(default, c)) for c in chunks]
    got, card_s["DefaultCodec bodies"] = timed(card_deflate.decompress_chunks,
                                               [b for b, _ in zparts])
    require(got == chunks, "the card decodes every DefaultCodec body")
    require(all(zlib.adler32(g) == a for g, (_, a) in zip(got, zparts)),
            "every DefaultCodec Adler-32 holds for the card's bytes")
    counts = {"deflate_decode": deflate_decode.launches,
              "snappy_decode": snappy_decode.launches,
              "lz4_decode": lz4_decode.launches, "lzo_decode": lzo_decode.launches}

    print("-- bzip2 tiers and XXH3 on the host", flush=True)
    blob, t_c = timed(bzip2.BZip2NativeCompressor().compress, data)
    back, t_d = timed(bzip2.BZip2NativeDecompressor().decompress, blob)
    require(back == data, "libbz2 round-trips the 2 MB")
    rate("bzip2 libbz2 (9)", len(data), t_c, t_d, len(blob))
    own = data[:SLOW_CUT]
    blob, t_c = timed(bzip2.BZip2RefCompressor().compress, own)
    back, t_d = timed(bzip2.BZip2RefDecompressor().decompress, blob)
    require(back == own and bzip2.BZip2NativeDecompressor().decompress(blob) == own,
            "the own engine's stream decodes in both tiers")
    require(bzip2.BZip2RefDecompressor().decompress(bzip2.BZip2NativeCompressor().compress(own))
            == own, "the own engine decodes libbz2's stream")
    rate("bzip2 own engine (9)", len(own), t_c, t_d, len(blob))
    if picks["xxh3_is_enabled"]:
        for bits, one_shot, hasher in ((64, xxhash.xxh3_64, xxhash.XxHash3Hasher),
                                       (128, xxhash.xxh3_128, xxhash.XxHash3Hasher128)):
            want, t_one = timed(lambda: [one_shot(c) for c in chunks])
            streamed = []
            for c in chunks:
                with hasher() as h:
                    for i in range(0, len(c), 4096):
                        h.update(c[i:i + 4096])
                    streamed.append(h.digest())
            require(streamed == want, f"XXH3-{bits} streamed in 4 KB pieces == one-shot")
            rates[f"xxh3_{bits}"] = {"MB": len(data) / 1e6, "hash_MBps": len(data) / 1e6 / t_one}
    t_total = time.perf_counter() - t_phase
    print(f"compat: card decodes (s, canaries included) {json.dumps(card_s)}; "
          f"launches {json.dumps(counts)}; phase {t_total:.2f} s (host clock)")
    print(f"host tiers on the card machine's host CPU ({card}), MB of uncompressed bytes "
          "and MB/s: " + json.dumps(rates))
    require(all(n > 0 for n in counts.values()), f"the phase launched each kernel: {counts}")
    return {"counts": counts, "seconds": t_total, "card_seconds": card_s}


def main() -> None:
    print("== device", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on a GPU")
    from aircompressor_tpu_torch.ops import profiling

    card = profiling.card()
    print(card)
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from aircompressor_tpu_torch import _build
    from aircompressor_tpu_torch.entry import _sample_batch, decode_and_hash, entry
    from aircompressor_tpu_torch.errors import MalformedInputException
    from aircompressor_tpu_torch.host import framed
    from aircompressor_tpu_torch.host import lz4 as host_lz4
    from aircompressor_tpu_torch.host import snappy as host_snappy
    from aircompressor_tpu_torch.host.xxhash import xxh32 as host_xxh32
    from aircompressor_tpu_torch.host.xxhash import xxh64 as host_xxh64
    from aircompressor_tpu_torch.ops import (
        checksum, lz4_decode, lz4_encode, snappy_decode, snappy_decode_r2,
        snappy_encode, xxhash)
    from aircompressor_tpu_torch.ops._rows import encode_carveout
    from aircompressor_tpu_torch.ops.batch import (
        Lz4BatchCodec, SnappyBatchCodec, _pack, _round_up, _selfcheck_payload,
        snappy_framed_decompress_device, to_device_batch)

    print("== build", flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"built {lib_path.relative_to(_build.BUILD_DIR.parent.parent)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())

    print("== kernels against plain on the card", flush=True)
    compress = host_snappy.compress
    cases = [c for _, c in synthetic_cases()]
    cases += [c[:CHUNK] for c in cases if len(c) > CHUNK]
    cases += [_selfcheck_payload(seed) for seed in (0xA1C0, 1, 2, 3)]
    blobs = [compress(c) for c in cases] + malformed_cases(compress)
    comp, comp_lens = to_device_batch(
        *_pack(blobs, _round_up(max(len(b) for b in blobs), 16)), dev)
    k_out, k_lens, k_ok = snappy_decode.decode(comp, comp_lens)
    p_out, p_lens, p_ok = snappy_decode.decode_plain(comp, comp_lens)
    torch.cuda.synchronize()
    require(torch.equal(k_ok, p_ok), "decode ok flags equal plain")
    require(torch.equal(k_lens, p_lens), "decode out_lens equal plain")
    decode_err = int((k_out.int() - p_out.int()).abs().max())
    require(decode_err == 0, "decode bytes equal plain")
    want_ok = [len(c) <= CHUNK for c in cases] + [False] * 3
    require(k_ok.tolist() == want_ok, "decode flags exactly the bad chunks")
    for i, c in enumerate(cases):
        if want_ok[i]:
            require(k_out[i, :len(c)].cpu().numpy().tobytes() == c,
                    f"decode case {i} equals its original")
    blobs_steps = blobs + R2_MALFORMED
    st_comp, st_lens = to_device_batch(
        *_pack(blobs_steps, _round_up(max(map(len, blobs_steps)), 16)), dev)
    k_st = snappy_decode.decode(st_comp, st_lens, with_steps=True)
    p_st = snappy_decode.decode_plain(st_comp, st_lens, with_steps=True)
    torch.cuda.synchronize()
    for name, k, p in zip(("out", "out_lens", "ok", "steps"), k_st, p_st):
        require(torch.equal(k, p), f"decode with_steps {name} equal plain")
    for name, k, p in zip(("out", "out_lens", "ok"), k_st[:3],
                          snappy_decode.decode(st_comp, st_lens)):
        require(torch.equal(k, p), f"decode {name} the same with and without steps")
    print(f"snappy decode: {len(blobs)} chunks, {want_ok.count(False)} "
          f"malformed, kernel == plain, max_abs_err {decode_err}; with_steps on "
          f"{len(blobs_steps)} chunks == plain (out, out_lens, ok, steps; largest "
          f"{int(k_st[3].max())} tokens)")
    decode_err = max(decode_err, snappy_window_against_plain(dev, blobs_steps))

    grid = list(range(36)) + [47, 48, 63, 64, 65, 100, 255, 256, 257, CHUNK]
    rng = np.random.default_rng(42)
    xxh_err = 0
    for width in (CHUNK, CHUNK - 5):  # 8-byte aligned rows, then unaligned
        data = torch.from_numpy(
            rng.integers(0, 256, (len(grid), width), dtype=np.uint8)).to(dev)
        lens = torch.tensor([min(n, width) for n in grid], dtype=torch.int32,
                            device=dev)
        k_h = [v & (2**64 - 1) for v in xxhash.xxh64(data, lens).tolist()]
        p_h = [v & (2**64 - 1) for v in xxhash.xxh64_plain(data, lens).tolist()]
        host = data.cpu().numpy()
        s_h = [host_xxh64(host[i, :n]) for i, n in enumerate(lens.tolist())]
        xxh_err = max([xxh_err] + [abs(a - b) for a, b in zip(k_h, p_h)])
        require(k_h == p_h == s_h, f"xxh64 kernel == plain == scalar at L={width}")
    print(f"xxh64: {2 * len(grid)} streams, kernel == plain == scalar, "
          f"max_abs_err {xxh_err}")
    xxh_err = max(xxh_err, xxh64_batches_against_plain(dev))

    enc_cases = encode_cases()
    enc_buf, enc_lens = _pack(enc_cases, ENC_CUT)
    enc_in = to_device_batch(enc_buf, enc_lens, dev)
    k_comp, k_clens, k_eok = snappy_encode.encode(*enc_in)
    p_comp, p_clens, p_eok = snappy_encode.encode_plain(*enc_in)
    torch.cuda.synchronize()
    require(torch.equal(k_eok, p_eok) and bool(k_eok.all()), "encode ok flags equal plain")
    require(torch.equal(k_clens, p_clens), "encode comp_lens equal plain")
    encode_err = int((k_comp.int() - p_comp.int()).abs().max())
    require(encode_err == 0, "encode bytes equal plain")
    for i, c in enumerate(enc_cases):
        blob = k_comp[i, :int(k_clens[i])].cpu().numpy().tobytes()
        require(host_snappy.decompress(blob, len(c)) == c,
                f"encode case {i} decodes to its original on the host")
    noisy = enc_buf.copy()
    for i, n in enumerate(enc_lens):
        noisy[i, n:] = rng.integers(0, 256, ENC_CUT - n, dtype=np.uint8)
    n_comp, n_clens, _ = snappy_encode.encode(*to_device_batch(noisy, enc_lens, dev))
    require(torch.equal(n_comp, k_comp) and torch.equal(n_clens, k_clens),
            "bytes past each length do not change the encode")
    top = steps_against_plain("snappy encode", snappy_encode.encode,
                              snappy_encode.encode_plain, *enc_in)
    print(f"snappy encode: {len(enc_cases)} chunks of <= {ENC_CUT} B, kernel == "
          f"plain, max_abs_err {encode_err}, host decoder round trip ok; with_steps == "
          f"plain (largest {top} probes)")

    corpus = generated_corpus()
    full = full_cases(corpus)
    full_in = to_device_batch(*_pack(full, CHUNK), dev)
    k_full = snappy_encode.encode(*full_in)
    t0 = time.perf_counter()
    p_full = snappy_encode.encode_plain(*full_in, with_steps=True)
    torch.cuda.synchronize()
    t_full_plain = time.perf_counter() - t0
    for got in (k_full, snappy_encode.encode(*full_in, with_steps=True)):
        for name, k, p in zip(ENC_OUTPUTS, got, p_full):
            require(torch.equal(k, p), f"encode {name} equal plain on 64 KB rows")
    require(bool(k_full[2].all()), "every 64 KB row encodes ok")
    encode_err = max(encode_err, int((k_full[0].int() - p_full[0].int()).abs().max()))
    for i, c in enumerate(full):
        blob = k_full[0][i, :int(k_full[1][i])].cpu().numpy().tobytes()
        require(host_snappy.decompress(blob, CHUNK) == c,
                f"64 KB encode case {i} decodes to its original on the host")
    print(f"snappy encode: {len(full)} chunks of <= {CHUNK} B at width {CHUNK}, "
          f"kernel == plain (comp, comp_lens, ok; with_steps also steps, largest "
          f"{int(p_full[3].max())} probes), max_abs_err {encode_err}; "
          f"plain {t_full_plain:.2f} s (host clock)")

    print("== LZ4 and xxh32 kernels against plain on the card", flush=True)
    lz4_full = lz4_full_cases(corpus)
    lz4_full_buf, lz4_full_lens = _pack(lz4_full, CHUNK)
    lz4_full_in = to_device_batch(lz4_full_buf, lz4_full_lens, dev)
    k_lz = lz4_encode.encode(*lz4_full_in)
    t0 = time.perf_counter()
    p_lz = lz4_encode.encode_plain(*lz4_full_in, with_steps=True)
    torch.cuda.synchronize()
    t_lz_plain = time.perf_counter() - t0
    for got in (k_lz, lz4_encode.encode(*lz4_full_in, with_steps=True)):
        for name, k, p in zip(ENC_OUTPUTS, got, p_lz):
            require(torch.equal(k, p), f"lz4 encode {name} equal plain on 64 KB rows")
    require(bool(k_lz[2].all()), "every 64 KB row encodes ok in LZ4")
    lz4_encode_err = int((k_lz[0].int() - p_lz[0].int()).abs().max())
    lz4_full_blobs = [k_lz[0][i, :int(k_lz[1][i])].cpu().numpy().tobytes()
                      for i in range(len(lz4_full))]
    for i, c in enumerate(lz4_full):
        require(host_lz4.decompress(lz4_full_blobs[i], CHUNK) == c,
                f"LZ4 64 KB encode case {i} decodes to its original on the host")
    noisy = lz4_full_buf.copy()
    for i, n in enumerate(lz4_full_lens):
        noisy[i, n:] = rng.integers(0, 256, CHUNK - n, dtype=np.uint8)
    n_lz = lz4_encode.encode(*to_device_batch(noisy, lz4_full_lens, dev))
    require(all(torch.equal(a, b) for a, b in zip(n_lz, k_lz)),
            "bytes past each length do not change the LZ4 encode")
    top = steps_against_plain("lz4 encode", lz4_encode.encode, lz4_encode.encode_plain,
                              *enc_in)
    print(f"lz4 encode: {len(lz4_full)} chunks of <= {CHUNK} B at width {CHUNK}, "
          f"kernel == plain (comp, comp_lens, ok; with_steps also steps, largest "
          f"{int(p_lz[3].max())} probes), max_abs_err {lz4_encode_err}; "
          f"host decoder round trip ok; plain {t_lz_plain:.2f} s (host clock); "
          f"with_steps == plain on the {len(enc_cases)} chunks of <= {ENC_CUT} B "
          f"(largest {top} probes)")
    enc_round_errs = encode_rounds_against_plain(dev)
    encode_err = max(encode_err, enc_round_errs["snappy_encode"])
    lz4_encode_err = max(lz4_encode_err, enc_round_errs["lz4_encode"])

    lz4_raws = ([c for _, c in synthetic_cases()] + [lz4_length_edges_case()]
                + [_selfcheck_payload(seed) for seed in (0xA1C0, 1)])
    lz4_blobs_in = ([host_lz4.compress(c) for c in lz4_raws] + lz4_full_blobs
                    + lz4_malformed_cases(host_lz4.compress)
                    + [b for b, _, _ in LZ4_EDGE_BLOCKS])
    want_lz4 = []
    for b in lz4_blobs_in:
        try:
            want_lz4.append(host_lz4.decompress(b, CHUNK))
        except MalformedInputException:
            want_lz4.append(None)
    lz_comp, lz_comp_lens = to_device_batch(
        *_pack(lz4_blobs_in, _round_up(max(map(len, lz4_blobs_in)), 16)), dev)
    lz4_decode_err = 0
    for out_cap in (CHUNK, 4096):
        k_d = lz4_decode.decode(lz_comp, lz_comp_lens, out_cap=out_cap)
        p_d = lz4_decode.decode_plain(lz_comp, lz_comp_lens, out_cap=out_cap)
        torch.cuda.synchronize()
        for name, k, p in zip(("out", "out_lens", "ok"), k_d, p_d):
            require(torch.equal(k, p), f"lz4 decode {name} equal plain at out_cap {out_cap}")
        k_st = lz4_decode.decode(lz_comp, lz_comp_lens, out_cap=out_cap, with_steps=True)
        p_st = lz4_decode.decode_plain(lz_comp, lz_comp_lens, out_cap=out_cap, with_steps=True)
        for name, k, p in zip(("out", "out_lens", "ok", "steps"), k_st, p_st):
            require(torch.equal(k, p), f"lz4 decode with_steps {name} equal plain at {out_cap}")
        require(all(torch.equal(k, p) for k, p in zip(k_st[:3], k_d)),
                f"lz4 decode the same with and without steps at {out_cap}")
        lz4_decode_err = max(lz4_decode_err, int((k_d[0].int() - p_d[0].int()).abs().max()))
        got_ok = k_d[2].tolist()
        require(got_ok == [w is not None and len(w) <= out_cap for w in want_lz4],
                f"lz4 decode flags exactly what the host decoder rejects at {out_cap}")
        lens = k_d[1].tolist()
        for i, w in enumerate(want_lz4):
            if w is not None:
                require(k_d[0][i, :min(len(w), out_cap)].cpu().numpy().tobytes()
                        == w[:out_cap], f"lz4 decode case {i} equals its original")
        edge = list(zip(got_ok, lens))[-len(LZ4_EDGE_BLOCKS):]
        require(edge == [(ok, n) for _, ok, n in LZ4_EDGE_BLOCKS],
                f"lz4 decode gives the Pallas kernel's ok and out_lens on the F6 "
                f"blocks: {edge}")
    print(f"lz4 decode: {len(lz4_blobs_in)} chunks ({want_lz4.count(None)} "
          f"malformed) at out_cap {CHUNK} and 4096, kernel == plain, "
          f"max_abs_err {lz4_decode_err}; F6 blocks as the Pallas kernel; with_steps "
          f"== plain (largest {int(k_st[3].max())} sequences)")
    lz4_decode_err = max(lz4_decode_err, lz4_windows_against_plain(dev, lz4_blobs_in))

    xxh32_err = 0
    grid32 = list(range(101)) + [CHUNK - 1, CHUNK]
    for width in (CHUNK, CHUNK - 3):  # 4-byte aligned rows, then unaligned
        data = torch.from_numpy(
            rng.integers(0, 256, (len(grid32), width), dtype=np.uint8)).to(dev)
        lens = torch.tensor([min(n, width) for n in grid32], dtype=torch.int32,
                            device=dev)
        k_h, p_h = xxhash.xxh32(data, lens).tolist(), xxhash.xxh32_plain(data, lens).tolist()
        host = data.cpu().numpy()
        s_h = [host_xxh32(host[i, :n]) for i, n in enumerate(lens.tolist())]
        xxh32_err = max([xxh32_err] + [abs(a - b) for a, b in zip(k_h, p_h)])
        require(k_h == p_h == s_h, f"xxh32 kernel == plain == scalar at L={width}")
    print(f"xxh32: {2 * len(grid32)} streams, kernel == plain == scalar, "
          f"max_abs_err {xxh32_err}")
    xxh32_err = max(xxh32_err, xxh32_batches_against_plain(dev))
    crc_err = crc32c_against_plain(dev)

    zk = zstd_kernels_against_plain(dev)
    lk = lzo_kernel_against_plain(dev)
    dk = deflate_kernel_against_plain(dev)
    seed_errs = xxhash_seeds_against_plain(dev)
    zek = zstd_encode_kernels_against_plain(dev)
    r2_err = snappy_r2_against_plain(dev, corpus)

    codec = SnappyBatchCodec()  # the card by default; its canaries run here
    short = [c for c in cases if len(c) <= CHUNK]
    require(codec.decompress_chunks([compress(c) for c in short]) == short,
            "SnappyBatchCodec decode round trip of the cases")
    require(codec.decompress_chunks(codec.compress_chunks(short)) == short,
            "SnappyBatchCodec compress round trip of the cases")
    e_step, e_inputs = entry()
    c_step, c_inputs = entry("cpu")
    require(e_inputs[0].device.type == "cuda", "entry() runs on the card by default")
    e_res, c_res = e_step(*e_inputs), c_step(*c_inputs)
    for key in ("out", "out_lens", "ok", "xxh64"):
        require(torch.equal(e_res[key].cpu(), c_res[key]), f"entry {key} on card == CPU")
    print("SnappyBatchCodec self-checks and round trips ok; entry() on card == CPU")

    print("== compress path at real size (generated corpus)", flush=True)
    raw, raw_lens = to_device_batch(*_pack(corpus, CHUNK), dev)
    big_raw, big_raw_lens = raw.repeat(SUSTAIN, 1), raw_lens.repeat(SUSTAIN)
    snappy_encode.launches = snappy_encode.rows = 0
    t0 = time.perf_counter()
    blobs = codec.compress_chunks(corpus)
    t_compress = time.perf_counter() - t0
    t0 = time.perf_counter()
    big_comp, big_comp_lens, big_ok = snappy_encode.encode(big_raw, big_raw_lens)
    torch.cuda.synchronize()
    t_big_enc = time.perf_counter() - t0
    enc_launches, enc_rows = snappy_encode.launches, snappy_encode.rows

    n_enc = len(corpus) + big_raw.shape[0]
    require(enc_rows == n_enc, f"every chunk went through the encode kernel: "
            f"{enc_rows}/{n_enc}")
    require(bool(big_ok.all()), "every tiled chunk encodes ok")
    require(big_comp_lens.tolist() == [len(b) for b in blobs] * SUSTAIN,
            "tiled comp_lens equal compress_chunks' lengths")
    require(torch.equal(big_comp, big_comp[:N_CHUNKS].repeat(SUSTAIN, 1)),
            "every tile encodes to the same bytes")
    width = max(map(len, blobs))
    require(big_comp[:N_CHUNKS, :width].cpu().numpy().tobytes() ==
            b"".join(b.ljust(width, b"\0") for b in blobs),
            "the first tile equals compress_chunks' blocks")
    for i in range(0, N_CHUNKS, N_CHUNKS // 8):
        require(host_snappy.decompress(blobs[i], CHUNK) == corpus[i],
                f"corpus block {i} decodes to its original on the host")
    t0 = time.perf_counter()
    host_size = sum(len(compress(c)) for c in corpus[:16])
    t_host16 = time.perf_counter() - t0
    ratio = sum(map(len, blobs[:16])) / host_size
    require(ratio <= RATIO_LIMIT, f"encode size / host reference size {ratio} "
            f"<= {RATIO_LIMIT}")
    comp_bytes = sum(map(len, blobs))
    print(f"compress_chunks: {len(corpus)} chunks, {sum(map(len, corpus))} B -> "
          f"{comp_bytes} B in {t_compress:.3f} s (host clock, staging and copies "
          f"included)")
    print(f"tiled x{SUSTAIN}: {big_raw.shape[0]} chunks encoded in {t_big_enc:.3f} s "
          f"(host clock, first call)")
    print(f"size against the host reference compressor on 16 chunks: {ratio:.6f} "
          f"(limit {RATIO_LIMIT}; host compressor {t_host16:.2f} s)")
    print(f"encode launches {enc_launches}, {enc_rows} of {n_enc} chunks through "
          f"the encode kernel")

    print("== decode path at real size (the encoded corpus)", flush=True)
    want_hash = [host_xxh64(c) for c in corpus]
    sample_buf, sample_lens, _ = _sample_batch(8)
    sample_raw = [host_snappy.decompress(sample_buf[i, :n].tobytes(), CHUNK)
                  for i, n in enumerate(sample_lens)]
    snappy_decode.launches = snappy_decode.rows = xxhash.launches = 0
    t0 = time.perf_counter()
    decoded = codec.decompress_chunks(blobs)
    t_codec = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = decode_and_hash(big_comp, big_comp_lens)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t0
    e_res = e_step(*e_inputs)
    torch.cuda.synchronize()
    counts = {"snappy_decode": snappy_decode.launches, "xxh64": xxhash.launches}
    rows = snappy_decode.rows
    n_in = len(blobs) + big_comp.shape[0] + e_inputs[0].shape[0]

    require(decoded == corpus, "decompress_chunks returns every original")
    require(bool(res["ok"].all()), "every tiled chunk decodes ok")
    require(res["out_lens"].tolist() == [len(c) for c in corpus] * SUSTAIN,
            "tiled out_lens equal the originals' lengths")
    require(torch.equal(res["out"], res["out"][:N_CHUNKS].repeat(SUSTAIN, 1)),
            "every tile decodes to the same bytes")
    require(res["out"][:N_CHUNKS].cpu().numpy().tobytes() ==
            b"".join(c.ljust(CHUNK, b"\0") for c in corpus),
            "the first tile equals the corpus")
    got_hash = [v & (2**64 - 1) for v in res["xxh64"].tolist()]
    require(got_hash == want_hash * SUSTAIN, "every xxh64 equals the host's")
    require(bool(e_res["ok"].all()) and
            [v & (2**64 - 1) for v in e_res["xxh64"].tolist()] ==
            [host_xxh64(r) for r in sample_raw], "entry() hashes equal the host's")
    require(all(n > 0 for n in counts.values()), f"both kernels launched: {counts}")
    device_fraction = rows / n_in
    require(device_fraction == 1.0, f"every chunk decoded on the device: {rows}/{n_in}")
    decoded_bytes = int(res["out_lens"].sum())
    print(f"decompress_chunks: {len(blobs)} chunks in {t_codec:.3f} s (host clock, "
          f"staging and copies included)")
    print(f"tiled x{SUSTAIN}: {big_comp.shape[0]} chunks, {decoded_bytes} B decoded "
          f"and hashed in {t_big:.3f} s (host clock, first call)")
    print(f"device_fraction {device_fraction} ({rows} of {n_in} chunks through the "
          f"decode kernel, {n_in - rows} on the host); launches {counts}")
    shares = snappy_decode.distance_shares(*to_device_batch(
        *_pack(blobs, _round_up(max(map(len, blobs)), 16)), dev))
    print(f"copy dists of the encoded corpus ({shares['copies']} copies, "
          f"{shares['copy_bytes']} B): " + "; ".join(
              f"within {reach}: {100 * v['copies']:.2f}% of copies, "
              f"{100 * v['bytes']:.2f}% of their bytes" for reach, v in shares["within"].items()))

    print("== r2 decode path at real size (kernel #12 on the encoded corpus)", flush=True)
    r2_comp, r2_comp_lens = to_device_batch(
        *_pack(blobs, _round_up(max(map(len, blobs)), 16)), dev)
    snappy_decode_r2.launches = snappy_decode_r2.rows = 0
    t0 = time.perf_counter()
    r2_small = snappy_decode_r2.decode(r2_comp, r2_comp_lens, with_steps=True)
    r2_big = snappy_decode_r2.decode(big_comp, big_comp_lens, with_steps=True)
    torch.cuda.synchronize()
    t_r2 = time.perf_counter() - t0
    r2_launches, r2_rows = snappy_decode_r2.launches, snappy_decode_r2.rows

    n_r2 = N_CHUNKS + big_comp.shape[0]
    require(r2_launches > 0 and r2_rows == n_r2,
            f"every chunk went through the r2 kernel: {r2_launches} launches, "
            f"{r2_rows}/{n_r2} chunks")
    require(bool(r2_small[2].all()) and bool(r2_big[2].all()),
            "every chunk decodes ok through the r2 kernel")
    require(r2_small[0].cpu().numpy().tobytes() ==
            b"".join(c.ljust(CHUNK, b"\0") for c in corpus),
            "the r2 kernel's 256 chunks equal the corpus")
    require(torch.equal(r2_small[0], res["out"][:N_CHUNKS])
            and torch.equal(r2_small[1], res["out_lens"][:N_CHUNKS]),
            "the r2 kernel's 256 chunks equal kernel #1's")
    require(torch.equal(r2_big[0], res["out"]) and torch.equal(r2_big[1], res["out_lens"]),
            "the r2 kernel's 4096 chunks equal kernel #1's")
    require(torch.equal(r2_big[3], r2_small[3].repeat(SUSTAIN)),
            "the 4096-chunk steps equal the 256-chunk steps tiled")
    for what, (c, n), got in (("256", (r2_comp, r2_comp_lens), r2_small),
                              ("4096", (big_comp, big_comp_lens), r2_big)):
        for r in range(0, c.shape[0], 512):  # slices of whole groups of 32: plain's memory
            want = snappy_decode_r2.decode_plain(c[r:r + 512], n[r:r + 512], with_steps=True)
            for name, a, b in zip(("out", "out_lens", "ok", "steps"), got, want):
                require(torch.equal(a[r:r + 512], b),
                        f"the r2 kernel's {what} chunks: {name} equal plain")
            r2_err = max(r2_err, int((got[0][r:r + 512].int() - want[0].int()).abs().max()))
    del want
    r2_steps = r2_small[3].view(-1, 32)[:, 0].tolist()
    print(f"r2 decode: {N_CHUNKS} chunks, then {big_comp.shape[0]} tiled, in {t_r2:.3f} s "
          f"(host clock, first calls); launches {r2_launches}, {r2_rows} of {n_r2} "
          f"chunks through the r2 kernel; every byte == the corpus and kernel #1's, all "
          f"four outputs == plain; "
          f"steps of the {len(r2_steps)} groups {r2_steps}")

    print("== framed path (x-snappy-framed stream of the corpus)", flush=True)
    noise = np.random.default_rng(7).integers(0, 256, CHUNK, dtype=np.uint8).tobytes()
    data = b"".join(corpus[:4]) + noise + b"".join(corpus[4:])
    stream = framed.compress_framed(data, codec.compress_chunks)
    head = len(framed.HEADER)
    stream = (stream[:head] + framed.chunk(framed.PADDING_CHUNK, bytes(100))
              + stream[head:])
    spans = framed.chunk_spans(stream)
    kinds = [k for k, _ in spans]
    require(kinds.count(framed.UNCOMPRESSED_CHUNK) == 1 and
            kinds.count(framed.PADDING_CHUNK) == 1 and
            kinds.index(framed.UNCOMPRESSED_CHUNK) == 5,
            "the stream holds one padding chunk and one stored chunk (block 4)")
    snappy_decode.launches = checksum.launches = 0
    t0 = time.perf_counter()
    got = snappy_framed_decompress_device(stream, device=dev)
    t_framed_first = time.perf_counter() - t0
    framed_launches, crc_launches = snappy_decode.launches, checksum.launches
    require(got == data, "the framed stream decodes to the corpus")
    require(framed_launches > 0, "the framed decode launched the decode kernel")
    require(crc_launches > 0, "the framed decode launched the CRC32-C kernel")
    pos = spans[1 + BAD_CRC_BLOCK][1] + 4  # +1: the padding chunk comes first
    bad = stream[:pos] + bytes([stream[pos] ^ 1]) + stream[pos + 1:]
    try:
        snappy_framed_decompress_device(bad, device=dev)
        raise RuntimeError("check failed: a flipped CRC raises")
    except MalformedInputException as e:
        require(e.offset == BAD_CRC_INDEX,
                f"a flipped CRC reports compressed chunk {BAD_CRC_INDEX}, got {e.offset}")
    t0 = time.perf_counter()
    for _ in range(3):
        snappy_framed_decompress_device(stream, device=dev)
    t_framed = (time.perf_counter() - t0) / 3
    t0 = time.perf_counter()  # the host part alone: frame walk and packing
    payloads = [p for kind, p, _ in framed.iter_frames(stream) if kind == "compressed"]
    _pack(payloads, _round_up(max(map(len, payloads)), 16))
    t_walk = time.perf_counter() - t0
    print(f"framed: {len(stream)} B stream, {len(data)} B out, decode launches "
          f"{framed_launches}, crc32c launches {crc_launches}; flipped CRC -> MalformedInputException at "
          f"{BAD_CRC_INDEX}; first call {t_framed_first:.3f} s, then "
          f"{t_framed:.4f} s a call (host clock, mean of 3; "
          f"{gbps(len(data), t_framed * 1e3):.3f} GB/s); of which frame walk "
          f"and packing {t_walk:.4f} s")

    families = families_phase(dev, corpus, card)
    compat = compat_phase(dev, corpus, card)

    print("== LZ4 path at real size (generated corpus)", flush=True)
    want_hash32 = [host_xxh32(c) for c in corpus]
    lz4_codec = Lz4BatchCodec()  # the card by default; its canaries run here
    lz4_encode.launches = lz4_encode.rows = lz4_decode.launches = lz4_decode.rows = 0
    xxhash.xxh32_launches = xxhash.xxh32_rows = 0
    t0 = time.perf_counter()
    lz4_blobs = lz4_codec.compress_chunks(corpus)
    t_lz4_compress = time.perf_counter() - t0
    t0 = time.perf_counter()
    lz4_decoded = lz4_codec.decompress_chunks(lz4_blobs)
    t_lz4_decompress = time.perf_counter() - t0
    t0 = time.perf_counter()
    lzb_comp, lzb_comp_lens, lzb_eok = lz4_encode.encode(big_raw, big_raw_lens)
    lzb_out, lzb_out_lens, lzb_ok = lz4_decode.decode(lzb_comp, lzb_comp_lens)
    lzb_hash = xxhash.xxh32(lzb_out, lzb_out_lens)
    torch.cuda.synchronize()
    t_lz4_big = time.perf_counter() - t0
    lz4_counts = {"lz4_encode": lz4_encode.launches, "lz4_decode": lz4_decode.launches,
                  "xxh32": xxhash.xxh32_launches}
    lz4_rows = {"lz4_encode": lz4_encode.rows, "lz4_decode": lz4_decode.rows,
                "xxh32": xxhash.xxh32_rows}

    n_lz4 = len(corpus) + big_raw.shape[0]
    require(all(n > 0 for n in lz4_counts.values()), f"the LZ4 kernels launched: "
            f"{lz4_counts}")
    require(lz4_rows["lz4_encode"] >= n_lz4 and lz4_rows["lz4_decode"] >= n_lz4
            and lz4_rows["xxh32"] >= big_raw.shape[0],
            f"every chunk went through each LZ4 kernel: {lz4_rows}")
    require(lz4_decoded == corpus, "Lz4BatchCodec.decompress_chunks returns the corpus")
    require(bool(lzb_eok.all()) and bool(lzb_ok.all()),
            "every tiled chunk encodes and decodes ok in LZ4")
    require(lzb_comp_lens.tolist() == [len(b) for b in lz4_blobs] * SUSTAIN,
            "tiled LZ4 comp_lens equal compress_chunks' lengths")
    require(torch.equal(lzb_comp, lzb_comp[:N_CHUNKS].repeat(SUSTAIN, 1)),
            "every tile LZ4-encodes to the same bytes")
    width = max(map(len, lz4_blobs))
    require(lzb_comp[:N_CHUNKS, :width].cpu().numpy().tobytes() ==
            b"".join(b.ljust(width, b"\0") for b in lz4_blobs),
            "the first tile equals Lz4BatchCodec.compress_chunks' blocks")
    require(torch.equal(lzb_out_lens, big_raw_lens) and torch.equal(lzb_out, big_raw),
            "every tiled chunk LZ4-decodes to its original")
    require(lzb_hash.tolist() == want_hash32 * SUSTAIN,
            "every xxh32 of a decoded chunk equals the host's of its original")
    for i in range(0, N_CHUNKS, N_CHUNKS // 8):
        require(host_lz4.decompress(lz4_blobs[i], CHUNK) == corpus[i],
                f"LZ4 corpus block {i} decodes to its original on the host")
    t0 = time.perf_counter()
    lz4_host_size = sum(len(host_lz4.compress(c)) for c in corpus[:16])
    t_lz4_host16 = time.perf_counter() - t0
    lz4_ratio = sum(map(len, lz4_blobs[:16])) / lz4_host_size
    require(lz4_ratio <= LZ4_RATIO_LIMIT, f"LZ4 encode size / host LZ4 size "
            f"{lz4_ratio} <= {LZ4_RATIO_LIMIT}")
    lz4_comp_bytes = sum(map(len, lz4_blobs))
    lz_comp256, lz_comp_lens256 = to_device_batch(
        *_pack(lz4_blobs, _round_up(max(map(len, lz4_blobs)), 16)), dev)
    lz4_steps = lz4_decode.decode(lz_comp256, lz_comp_lens256, with_steps=True)[3]
    lz4_top = int(lz4_steps.argmax())
    lz4_chain = dict(steps=int(lz4_steps[lz4_top]), chunk=lz4_top, total=int(lz4_steps.sum()))
    lz4_shares = lz4_decode.distance_shares(lz_comp256, lz_comp_lens256)
    print(f"lz4 steps on the corpus: longest chain chunk {lz4_top}, {lz4_chain['steps']} "
          f"sequences; {lz4_chain['total']} in all")
    print("lz4 match distances of the corpus (share of matches and of their bytes within "
          "each window's reach): " + json.dumps(lz4_shares))
    print(f"Lz4BatchCodec: compress_chunks {len(corpus)} chunks, "
          f"{sum(map(len, corpus))} B -> "
          f"{lz4_comp_bytes} B in {t_lz4_compress:.3f} s, decompress_chunks "
          f"{t_lz4_decompress:.3f} s (host clock, canaries, staging and copies "
          f"included)")
    print(f"tiled x{SUSTAIN}: {big_raw.shape[0]} chunks LZ4-encoded, decoded and "
          f"xxh32-hashed in {t_lz4_big:.3f} s (host clock, first call)")
    print(f"size against the host LZ4 compressor on 16 chunks: {lz4_ratio:.6f} "
          f"(limit {LZ4_RATIO_LIMIT}; host compressor {t_lz4_host16:.2f} s)")
    print(f"LZ4 path launches {lz4_counts}, rows {lz4_rows} ({n_lz4} chunks)")

    print("== encode kernels with steps on the corpus, against plain", flush=True)
    chains = encode_chains_against_plain(raw, raw_lens)
    encode_err = max(encode_err, chains["snappy"]["err"])
    lz4_encode_err = max(lz4_encode_err, chains["lz4"]["err"])

    zp = zstd_decode_path(dev, corpus)
    lp = lzo_path(dev, corpus)
    dp = deflate_path(dev, corpus)
    zc = zstd_compress_path(dev, corpus, zp["frames"])
    mp = mesh_path(dev, big_raw, big_raw_lens)
    nccl_rank(dev, big_raw, big_raw_lens, mp)
    gloo_ranks(mp)

    print("== times (CUDA events)", flush=True)
    comp, comp_lens = to_device_batch(
        *_pack(blobs, _round_up(max(map(len, blobs)), 16)), dev)
    out256, lens256 = res["out"][:N_CHUNKS].contiguous(), res["out_lens"][:N_CHUNKS]
    dec_ms, dec_plain_ms = paired_ms(
        lambda: snappy_decode.decode(comp, comp_lens),
        lambda: snappy_decode.decode_plain(comp, comp_lens), 20, 3)
    xxh_ms, xxh_plain_ms = paired_ms(
        lambda: xxhash.xxh64(out256, lens256),
        lambda: xxhash.xxh64_plain(out256, lens256), 20, 2)
    enc_ms, enc_plain_ms = paired_ms(
        lambda: snappy_encode.encode(*full_in),
        lambda: snappy_encode.encode_plain(*full_in), 20, 1)
    big_out, big_out_lens = res["out"], res["out_lens"]
    dec_big_ms = time_ms(lambda: snappy_decode.decode(big_comp, big_comp_lens), 5)
    r2_ms, r2_plain_ms = paired_ms(
        lambda: snappy_decode_r2.decode(comp, comp_lens),
        lambda: snappy_decode_r2.decode_plain(comp, comp_lens), 20, 3)
    r2_big_ms = time_ms(lambda: snappy_decode_r2.decode(big_comp, big_comp_lens), 5)
    xxh_big_ms = time_ms(lambda: xxhash.xxh64(big_out, big_out_lens), 10)
    crc_big_ms, crc_big_plain_ms = paired_ms(
        lambda: checksum.crc32c(big_out, big_out_lens),
        lambda: checksum.crc32c_plain(big_out, big_out_lens), 10, 1)
    enc256_ms = time_ms(lambda: snappy_encode.encode(raw, raw_lens), 5)
    enc_big_ms = time_ms(lambda: snappy_encode.encode(big_raw, big_raw_lens), 3)
    crc_ms, crc_plain_ms = paired_ms(
        lambda: checksum.crc32c(out256, lens256),
        lambda: checksum.crc32c_plain(out256, lens256), 20, 2)
    lz_out256, lz_lens256 = lzb_out[:N_CHUNKS].contiguous(), lzb_out_lens[:N_CHUNKS]
    lzd_ms, lzd_plain_ms = paired_ms(
        lambda: lz4_decode.decode(lz_comp256, lz_comp_lens256),
        lambda: lz4_decode.decode_plain(lz_comp256, lz_comp_lens256), 20, 3)
    x32_ms, x32_plain_ms = paired_ms(
        lambda: xxhash.xxh32(lz_out256, lz_lens256),
        lambda: xxhash.xxh32_plain(lz_out256, lz_lens256), 20, 2)
    lze_ms, lze_plain_ms = paired_ms(
        lambda: lz4_encode.encode(*lz4_full_in),
        lambda: lz4_encode.encode_plain(*lz4_full_in), 20, 1)
    lzd_big_ms = time_ms(lambda: lz4_decode.decode(lzb_comp, lzb_comp_lens), 5)
    x32_big_ms = time_ms(lambda: xxhash.xxh32(lzb_out, lzb_out_lens), 10)
    lze256_ms = time_ms(lambda: lz4_encode.encode(raw, raw_lens), 5)
    lze_big_ms = time_ms(lambda: lz4_encode.encode(big_raw, big_raw_lens), 3)
    raw256 = sum(map(len, corpus))  # the canary chunks fall short of 64 KB
    raw_big = raw256 * SUSTAIN
    full_bytes = sum(map(len, full))
    lz4_full_bytes = sum(map(len, lz4_full))
    comp_big_bytes = int(big_comp_lens.sum())
    lz_comp_big_bytes = int(lzb_comp_lens.sum())

    # Bounds: each input byte the function needs read once, each output
    # byte written once (the zero tails of out and comp included), at the
    # card's memory rate. These codecs do no floating-point work.
    def enc_bound(in_bytes, b, out_cap=snappy_encode.OUT_CAP):
        return bound_ms(in_bytes + 4 * b, b * out_cap + 5 * b)

    def lz4_enc_bound(in_bytes, b):
        return enc_bound(in_bytes, b, lz4_encode.OUT_CAP)

    dec_bound = profiling.decode_bound_ms

    def xxh_bound(in_bytes, b):
        return bound_ms(in_bytes + 4 * b, 8 * b)

    print(f"card: {card}")
    print(f"snappy encode, {len(full)} chunks at width {CHUNK} ({full_bytes} B in): "
          f"kernel {enc_ms:.4f} ms, plain {enc_plain_ms:.4f} ms")
    print(f"snappy encode, {N_CHUNKS} chunks ({raw256} B in): kernel {enc256_ms:.4f} ms "
          f"({gbps(raw256, enc256_ms):.3f} GB/s in)")
    print(f"snappy encode, {big_raw.shape[0]} chunks ({raw_big} B in): kernel "
          f"{enc_big_ms:.4f} ms ({gbps(raw_big, enc_big_ms):.3f} GB/s in)")
    print(f"snappy decode, {N_CHUNKS} chunks ({raw256} B out): kernel {dec_ms:.4f} ms "
          f"({gbps(raw256, dec_ms):.3f} GB/s), plain {dec_plain_ms:.4f} ms "
          f"({gbps(raw256, dec_plain_ms):.3f} GB/s)")
    print(f"snappy r2 decode, {N_CHUNKS} chunks: kernel {r2_ms:.4f} ms "
          f"({gbps(raw256, r2_ms):.3f} GB/s), plain {r2_plain_ms:.4f} ms, bound "
          f"{dec_bound(int(comp_lens.sum()), N_CHUNKS):.5f} ms")
    print(f"snappy r2 decode, {big_comp.shape[0]} chunks: kernel {r2_big_ms:.4f} ms "
          f"({gbps(decoded_bytes, r2_big_ms):.3f} GB/s decoded), bound "
          f"{dec_bound(comp_big_bytes, big_comp.shape[0]):.5f} ms")
    r2_chunk_steps = snappy_decode_r2.chunk_steps(snappy_decode.token_table(comp, comp_lens),
                                                  comp_lens)
    r2_windows = int(r2_chunk_steps.max())  # the longest group's windows: its longest chunk's
    r2_one = int(r2_chunk_steps.argmax())
    print(f"snappy r2 decode: {r2_ms * 1e6 / r2_windows:.1f} ns a window of the longest group "
          f"({r2_windows} windows, chunk {r2_one}) at {N_CHUNKS} chunks, "
          f"{r2_big_ms * 1e6 / r2_windows:.1f} at {big_comp.shape[0]}")
    print(f"xxh64, {N_CHUNKS} chunks: kernel {xxh_ms:.4f} ms "
          f"({gbps(raw256, xxh_ms):.3f} GB/s), plain {xxh_plain_ms:.4f} ms "
          f"({gbps(raw256, xxh_plain_ms):.3f} GB/s)")
    print(f"snappy decode, {big_comp.shape[0]} chunks ({decoded_bytes} B out): kernel "
          f"{dec_big_ms:.4f} ms ({gbps(decoded_bytes, dec_big_ms):.3f} GB/s decoded)")
    print(f"xxh64, {big_comp.shape[0]} chunks: kernel {xxh_big_ms:.4f} ms "
          f"({gbps(decoded_bytes, xxh_big_ms):.3f} GB/s hashed)")
    print(f"decode + xxh64, {big_comp.shape[0]} chunks: "
          f"{gbps(decoded_bytes, dec_big_ms + xxh_big_ms):.3f} GB/s")
    for b, ms, plain_ms, nbytes in ((N_CHUNKS, crc_ms, crc_plain_ms, raw256),
                                    (big_comp.shape[0], crc_big_ms, crc_big_plain_ms,
                                     decoded_bytes)):
        print(f"crc32c, {b} chunks ({nbytes} B): kernel {ms:.4f} ms "
              f"({gbps(nbytes, ms):.3f} GB/s), plain {plain_ms:.4f} ms, bound "
              f"{xxh_bound(nbytes, b):.5f} ms")
    print(f"lz4 encode, {len(lz4_full)} chunks at width {CHUNK} ({lz4_full_bytes} B "
          f"in): kernel {lze_ms:.4f} ms, plain {lze_plain_ms:.4f} ms")
    for b, ms, nbytes, bnd in (
            (N_CHUNKS, lze256_ms, raw256, lz4_enc_bound(raw256, N_CHUNKS)),
            (big_raw.shape[0], lze_big_ms, raw_big, lz4_enc_bound(raw_big, big_raw.shape[0]))):
        print(f"lz4 encode, {b} chunks ({nbytes} B in): kernel {ms:.4f} ms "
              f"({gbps(nbytes, ms):.3f} GB/s in), bound {bnd:.5f} ms")
    carveouts = {}
    for codec, mod in _enc_modules():  # fixed carveouts, then the wrapper's choice again
        by_batch, carveouts[codec] = mod.encode_carveout, {}
        for pct in ENC_CARVEOUTS:
            mod.encode_carveout = lambda batch, device, pct=pct: pct
            carveouts[codec][pct] = (time_ms(lambda: mod.encode(raw, raw_lens), 5),
                                     time_ms(lambda: mod.encode(big_raw, big_raw_lens), 3))
        mod.encode_carveout = by_batch
        print(f"{codec} encode by carveout (percent: ms at {N_CHUNKS}, ms at "
              f"{big_raw.shape[0]} chunks; the wrapper's by the batch: "
              f"{encode_carveout(N_CHUNKS, dev)}, {encode_carveout(big_raw.shape[0], dev)}): "
              + "; ".join(f"{pct}%: {a:.4f}, {b:.4f}" for pct, (a, b) in carveouts[codec].items()))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for codec, ms256, ms_big in (("snappy", enc256_ms, enc_big_ms),
                                 ("lz4", lze256_ms, lze_big_ms)):
        ch = chains[codec]
        print(f"{codec} encode: {ms256 * 1e6 / ch['probes']:.1f} ns a probe of the longest "
              f"chain (chunk {ch['chunk']}, {ch['probes']} probes, {ch['matches']} matches) "
              f"at {N_CHUNKS} chunks; {ms_big * 1e6 * sms / (ch['total'] * SUSTAIN):.2f} ns a "
              f"probe of an SM (all {ch['total'] * SUSTAIN} probes over {sms} SMs) at "
              f"{big_raw.shape[0]}")
    print(f"lz4 decode, {N_CHUNKS} chunks ({raw256} B out): kernel {lzd_ms:.4f} ms "
          f"({gbps(raw256, lzd_ms):.3f} GB/s), plain {lzd_plain_ms:.4f} ms, bound "
          f"{dec_bound(lz4_comp_bytes, N_CHUNKS):.5f} ms")
    print(f"lz4 decode, {big_raw.shape[0]} chunks ({raw_big} B out): kernel "
          f"{lzd_big_ms:.4f} ms ({gbps(raw_big, lzd_big_ms):.3f} GB/s decoded), bound "
          f"{dec_bound(lz_comp_big_bytes, big_raw.shape[0]):.5f} ms")
    print(f"xxh32, {N_CHUNKS} chunks: kernel {x32_ms:.4f} ms "
          f"({gbps(raw256, x32_ms):.3f} GB/s), plain {x32_plain_ms:.4f} ms, bound "
          f"{xxh_bound(raw256, N_CHUNKS):.5f} ms")
    print(f"xxh32, {big_raw.shape[0]} chunks: kernel {x32_big_ms:.4f} ms "
          f"({gbps(raw_big, x32_big_ms):.3f} GB/s hashed), bound "
          f"{xxh_bound(raw_big, big_raw.shape[0]):.5f} ms")
    print(f"lz4 decode: {lzd_ms * 1e6 / lz4_chain['steps']:.1f} ns a sequence of the longest "
          f"chain ({lz4_chain['steps']} sequences) at {N_CHUNKS} chunks; "
          f"{lzd_big_ms * 1e6 * sms / (lz4_chain['total'] * SUSTAIN):.2f} ns a sequence of an "
          f"SM (all {lz4_chain['total'] * SUSTAIN} sequences over {sms} SMs) at "
          f"{big_raw.shape[0]}")
    print(f"lz4 encode + decode + xxh32, {big_raw.shape[0]} chunks: "
          f"{gbps(raw_big, lze_big_ms + lzd_big_ms + x32_big_ms):.3f} GB/s")

    print("== profiling: kernel_rows and a trace of both Snappy decode kernels", flush=True)
    prof_rows = profiling.kernel_rows()
    print(json.dumps({"kernel_rows": prof_rows}))
    require([r["kernel"] for r in prof_rows] == ["snappy_decode", "lz4_decode", "xxh64"]
            and all(r["GBps"] > 0 for r in prof_rows)
            and all(r["loop_iterations"] > 0 for r in prof_rows[:2]),
            "kernel_rows gives the three kernels' rows")
    with profiling.trace(str(_build.BUILD_DIR.parent / "profile")) as trace_path:
        snappy_decode_r2.decode(comp, comp_lens)
        snappy_decode.decode(comp, comp_lens)
    with open(trace_path) as f:
        trace_text = f.read()
    for symbol in ("snappy_decode_r2_kernel", "snappy_decode_kernel"):
        require(symbol in trace_text, f"the trace names {symbol}")
    print(f"trace {trace_path}: {len(trace_text)} B, names snappy_decode_r2_kernel "
          f"and snappy_decode_kernel")

    # xxh32 alone (profiler device time): one 64 KB stream, the accumulator
    # chain with the card otherwise idle, then the two batches (a call of
    # one stream takes the wrapper about as long on the host); after the
    # trace above, which three profiler runs before it left without the
    # r2 kernel
    x32_alone = [profiling.kernel_ms(lambda: xxhash.xxh32(*args), "xxh32_kernel", 5,
                                     str(_build.BUILD_DIR.parent / "profile" / "xxh32"))
                 for args in ((lzb_out[:1], lzb_out_lens[:1]), (lz_out256, lz_lens256),
                              (lzb_out, lzb_out_lens))]
    print(f"xxh32 alone (profiler device time): one stream of {int(lzb_out_lens[0])} B (the "
          f"accumulator chain with the card otherwise idle) {x32_alone[0]:.4f} ms, "
          f"{x32_alone[0] * 1e6 / (int(lzb_out_lens[0]) // 16):.2f} ns a round; {N_CHUNKS} "
          f"chunks {x32_alone[1]:.4f} ms; {big_raw.shape[0]} chunks {x32_alone[2]:.4f} ms")
    # the r2 decode's longest chunk alone (profiler device time), after the
    # trace for the same reason
    r2_alone = profiling.kernel_ms(
        lambda: snappy_decode_r2.decode(comp[r2_one:r2_one + 1], comp_lens[r2_one:r2_one + 1]),
        "snappy_decode_r2", 5, str(_build.BUILD_DIR.parent / "profile" / "r2"))
    print(f"snappy r2 decode: chunk {r2_one} alone (profiler device time) {r2_alone:.4f} ms, "
          f"{r2_alone * 1e6 / r2_windows:.1f} ns a window")
    z_entries = zstd_kernel_times(zk, zp)
    ld_entries = lzo_deflate_times(dev, lk, lp, dk, dp)
    zc_entries = zstd_encode_times(zek, zc)

    kernels = [
        {"name": "snappy_decode", "route": "cuda",
         "source": "aircompressor_tpu_torch/csrc/snappy_decode.cu",
         "replaces": "aircompressor_tpu/ops/snappy_pallas_w.py:70", "redesigned": "PR 8",
         "launches": counts["snappy_decode"], "max_abs_err": decode_err,
         "ms": dec_ms, "plain_ms": dec_plain_ms,
         "bound_ms": dec_bound(int(comp_lens.sum()), N_CHUNKS), "bound_by": "bytes",
         "library_ms": None, "batch": f"{N_CHUNKS} chunks",
         "tiled_chunks": big_comp.shape[0], "tiled_ms": dec_big_ms,
         "tiled_bound_ms": dec_bound(comp_big_bytes, big_comp.shape[0])},
        {"name": "snappy_decode_r2", "route": "cuda",
         "source": "aircompressor_tpu_torch/csrc/snappy_decode_r2.cu",
         "replaces": "aircompressor_tpu/ops/snappy_pallas8.py:60",
         "redesigned": "PR 14", "longest_chain_steps": r2_windows,
         "chain_alone_ms": r2_alone,
         "launches": r2_launches, "max_abs_err": r2_err,
         "ms": r2_ms, "plain_ms": r2_plain_ms,
         "bound_ms": dec_bound(int(comp_lens.sum()), N_CHUNKS), "bound_by": "bytes",
         "library_ms": None, "batch": f"{N_CHUNKS} chunks",
         "tiled_chunks": big_comp.shape[0], "tiled_ms": r2_big_ms,
         "tiled_bound_ms": dec_bound(comp_big_bytes, big_comp.shape[0])},
        {"name": "xxh64", "route": "cuda",
         "source": "aircompressor_tpu_torch/csrc/xxh64.cu",
         "replaces": "aircompressor_tpu/ops/xxhash_pallas.py:40", "redesigned": "PR 8",
         "launches": counts["xxh64"], "max_abs_err": xxh_err,
         "ms": xxh_ms, "plain_ms": xxh_plain_ms,
         "bound_ms": xxh_bound(raw256, N_CHUNKS), "bound_by": "bytes",
         "library_ms": None, "batch": f"{N_CHUNKS} chunks",
         "tiled_chunks": big_comp.shape[0], "tiled_ms": xxh_big_ms,
         "tiled_bound_ms": xxh_bound(decoded_bytes, big_comp.shape[0])},
        {"name": "snappy_encode", "route": "cuda",
         "source": "aircompressor_tpu_torch/csrc/snappy_encode.cu",
         "replaces": "aircompressor_tpu/ops/snappy_encode_pallas.py:74",
         "launches": enc_launches, "max_abs_err": encode_err,
         "ms": enc_ms, "plain_ms": enc_plain_ms,
         "bound_ms": enc_bound(full_bytes, len(full)), "bound_by": "bytes",
         "library_ms": None, "batch": f"{len(full)} chunks of <= {CHUNK} B",
         "redesigned": ENC_REDESIGN, "longest_chain_steps": chains["snappy"]["probes"],
         "carveout_ms": carveouts["snappy"],
         "chunks_ms": enc256_ms, "chunks_bound_ms": enc_bound(raw256, N_CHUNKS),
         "tiled_chunks": big_raw.shape[0], "tiled_ms": enc_big_ms,
         "tiled_bound_ms": enc_bound(raw_big, big_raw.shape[0])},
        {"name": "lz4_decode", "route": "cuda",
         "source": "aircompressor_tpu_torch/csrc/lz4_decode.cu",
         "replaces": "aircompressor_tpu/ops/lz4_pallas_w.py:53",
         "redesigned": "input ring and output window in shared memory, one step a sequence",
         "longest_chain_steps": lz4_chain["steps"], "distance_shares": lz4_shares,
         "launches": lz4_counts["lz4_decode"], "max_abs_err": lz4_decode_err,
         "ms": lzd_ms, "plain_ms": lzd_plain_ms,
         "bound_ms": dec_bound(lz4_comp_bytes, N_CHUNKS), "bound_by": "bytes",
         "library_ms": None, "batch": f"{N_CHUNKS} chunks",
         "tiled_chunks": big_raw.shape[0], "tiled_ms": lzd_big_ms,
         "tiled_bound_ms": dec_bound(lz_comp_big_bytes, big_raw.shape[0])},
        {"name": "lz4_encode", "route": "cuda",
         "source": "aircompressor_tpu_torch/csrc/lz4_encode.cu",
         "replaces": "aircompressor_tpu/ops/lz4_encode_pallas.py:64",
         "launches": lz4_counts["lz4_encode"], "max_abs_err": lz4_encode_err,
         "ms": lze_ms, "plain_ms": lze_plain_ms,
         "bound_ms": lz4_enc_bound(lz4_full_bytes, len(lz4_full)), "bound_by": "bytes",
         "library_ms": None, "batch": f"{len(lz4_full)} chunks of <= {CHUNK} B",
         "redesigned": ENC_REDESIGN, "longest_chain_steps": chains["lz4"]["probes"],
         "carveout_ms": carveouts["lz4"],
         "chunks_ms": lze256_ms, "chunks_bound_ms": lz4_enc_bound(raw256, N_CHUNKS),
         "tiled_chunks": big_raw.shape[0], "tiled_ms": lze_big_ms,
         "tiled_bound_ms": lz4_enc_bound(raw_big, big_raw.shape[0])},
        {"name": "xxh32", "route": "cuda",
         "source": "aircompressor_tpu_torch/csrc/xxh32.cu",
         "replaces": "aircompressor_tpu/ops/xxhash_jax.py:176",
         "note": "the JAX package's xxh32 is XLA, not a Pallas kernel",
         "redesigned": "one lane per accumulator over staged loads",
         "chain_floor_ms": x32_alone[0], "kernel_ms": x32_alone[1],
         "tiled_kernel_ms": x32_alone[2],
         "launches": lz4_counts["xxh32"], "max_abs_err": xxh32_err,
         "ms": x32_ms, "plain_ms": x32_plain_ms,
         "bound_ms": xxh_bound(raw256, N_CHUNKS), "bound_by": "bytes",
         "library_ms": None, "batch": f"{N_CHUNKS} chunks",
         "tiled_chunks": big_raw.shape[0], "tiled_ms": x32_big_ms,
         "tiled_bound_ms": xxh_bound(raw_big, big_raw.shape[0])},
        {"name": "crc32c", "route": "cuda",
         "source": "aircompressor_tpu_torch/csrc/crc32c.cu",
         "replaces": "aircompressor_tpu/ops/checksum_jax.py:34",
         "note": "the JAX package's crc32c is XLA, not a Pallas kernel",
         "launches": crc_launches, "mesh_launches": mp["counts"]["crc32c"],
         "max_abs_err": crc_err, "ms": crc_ms, "plain_ms": crc_plain_ms,
         "bound_ms": xxh_bound(raw256, N_CHUNKS), "bound_by": "bytes",
         "library_ms": None, "batch": f"{N_CHUNKS} chunks",
         "tiled_chunks": big_comp.shape[0], "tiled_ms": crc_big_ms,
         "tiled_plain_ms": crc_big_plain_ms,
         "tiled_bound_ms": xxh_bound(decoded_bytes, big_comp.shape[0])},
    ]
    kernels += z_entries + ld_entries + zc_entries
    require(len(kernels) == 15, f"15 kernels in the line, got {len(kernels)}")
    for e in kernels:  # the families phase drives seven of them again
        if e["name"] in families["counts"]:
            e["families_launches"] = families["counts"][e["name"]]
    require(sum("families_launches" in e for e in kernels) == len(families["counts"]),
            "every kernel of the families phase is in the line")
    for e in kernels:  # the compat phase drives four of them again
        if e["name"] in compat["counts"]:
            e["compat_launches"] = compat["counts"][e["name"]]
    require(sum("compat_launches" in e for e in kernels) == len(compat["counts"]),
            "every kernel of the compat phase is in the line")
    for e in kernels:  # the seeded checks hold the xxHash kernels too
        if e["name"] in seed_errs:
            e["max_abs_err"] = max(e["max_abs_err"], seed_errs[e["name"]])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
