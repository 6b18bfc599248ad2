"""Huffman encoding — zstd literals (RFC 8878 §4.2).

The port's copy of ``aircompressor_tpu.zstd.huff_enc``.

Own implementation. Parity targets (behavior only): reference
zstd/HuffmanCompressionTable.java (tree build + depth limit + serialization)
and zstd/HuffmanCompressor.java (single/4-stream emitters).

Design notes:
- Code lengths come from the package-merge algorithm (optimal length-limited
  prefix code) instead of the reference's repay heuristic — simpler and never
  worse in table cost.
- Canonical code assignment mirrors huffman.build_table EXACTLY: symbols
  grouped by weight ascending (weight w ⇒ nbBits = table_log+1-w), within a
  weight by symbol index; code = state_start >> (w-1).
- Weight serialization: FSE-compressed (2-state interleaved, log ≤ 6) when
  that is smaller and representable, else raw 4-bit nibbles.
"""

from __future__ import annotations

import numpy as np

from . import fse_enc
from .bits import BackwardBitWriter, pack_backward

MAX_SYMBOL = 255
MAX_CODE_LENGTH = 11  # zstd encoder limit for literals (decode table log ≤ 12)


class HuffmanCTable:
    __slots__ = ("table_log", "nbits", "codes", "n_symbols")

    def __init__(self, table_log, nbits, codes, n_symbols):
        self.table_log = table_log
        self.nbits = nbits  # (256,) int64, 0 = absent
        self.codes = codes  # (256,) int64
        self.n_symbols = n_symbols

    def weights(self) -> np.ndarray:
        """Per-symbol zstd weights for symbols 0..last_present (inclusive)."""
        present = np.nonzero(self.nbits)[0]
        last = int(present[-1])
        w = np.zeros(last + 1, dtype=np.int64)
        nz = self.nbits[: last + 1] > 0
        w[nz] = self.table_log + 1 - self.nbits[: last + 1][nz]
        return w


def package_merge_lengths(counts: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal length-limited code lengths (package-merge / coin collector).

    counts: (n,) histogram; returns (n,) code lengths (0 for absent symbols).
    Requires ≥ 2 present symbols.
    """
    present = np.nonzero(counts)[0]
    k = present.size
    assert k >= 2
    if k > (1 << max_len):
        raise ValueError("too many symbols for depth limit")
    # items: (weight, set of leaf indices) — package-merge over max_len levels
    leaves = sorted((int(counts[s]), int(s)) for s in present)
    lengths = np.zeros(counts.size, dtype=np.int64)
    # packages[l] = list of (weight, [leaf symbols...]) at level l
    prev: list[tuple[int, list[int]]] = []
    for _ in range(max_len):
        items = [(w, [s]) for (w, s) in leaves] + prev
        items.sort(key=lambda t: t[0])
        # pair up
        nxt = []
        for i in range(0, len(items) - 1, 2):
            a, b = items[i], items[i + 1]
            nxt.append((a[0] + b[0], a[1] + b[1]))
        prev = nxt
    # take the first 2(k-1) items of the final merged list
    items = [(w, [s]) for (w, s) in leaves] + prev
    items.sort(key=lambda t: t[0])
    for w, syms in items[: 2 * (k - 1)]:
        for s in syms:
            lengths[s] += 1
    return lengths


def build_ctable(counts: np.ndarray, max_len: int = MAX_CODE_LENGTH) -> HuffmanCTable:
    """Build canonical encode table from a literal histogram (≥2 symbols)."""
    nbits = package_merge_lengths(counts, max_len)
    table_log = int(nbits.max())
    # canonical codes, mirroring huffman.build_table's state layout
    codes = np.zeros(counts.size, dtype=np.int64)
    weights = np.where(nbits > 0, table_log + 1 - nbits, 0)
    pos = 0
    for w in range(1, table_log + 1):
        for s in np.nonzero(weights == w)[0]:
            codes[s] = pos >> (w - 1)
            pos += 1 << (w - 1)
    assert pos == 1 << table_log, (pos, table_log)
    full = np.zeros(256, dtype=np.int64)
    fullc = np.zeros(256, dtype=np.int64)
    full[: nbits.size] = nbits
    fullc[: codes.size] = codes
    return HuffmanCTable(table_log, full, fullc, int(np.count_nonzero(nbits)))


def write_table(ct: HuffmanCTable) -> bytes:
    """Serialize the table: header byte + FSE-compressed or raw 4-bit weights.

    The LAST present symbol's weight is implicit (reconstructed from the
    power-of-2 remainder) and therefore not serialized.
    """
    w_all = ct.weights()
    w = w_all[:-1]  # last weight implicit
    n = w.size
    raw_size = (n + 1) // 2
    fse_payload = None
    if n >= 2 and np.count_nonzero(np.bincount(w, minlength=2)) >= 2:
        counts = np.bincount(w, minlength=int(w.max()) + 1)
        if np.count_nonzero(counts) >= 2:
            total = int(counts.sum())
            log = fse_enc.optimal_table_log(6, total, counts.size - 1)
            try:
                norm = fse_enc.normalize_counts(counts, log, total)
                fct = fse_enc.build_ctable(norm, log)
                desc = fse_enc.write_normalized_counts(norm, log)
                payload = fse_enc.compress_interleaved2(w, fct)
                if len(desc) + len(payload) < min(raw_size, 128):
                    fse_payload = desc + payload
            except ValueError:
                fse_payload = None
    if fse_payload is not None:
        return bytes([len(fse_payload)]) + fse_payload
    if n > 128:
        raise ValueError("cannot serialize >128 weights raw")  # needs FSE path
    out = bytearray([127 + n])
    for i in range(0, n - 1, 2):
        out.append((int(w[i]) << 4) | int(w[i + 1]))
    if n % 2:
        out.append(int(w[n - 1]) << 4)
    return bytes(out)


def encode_single_stream(data: np.ndarray, ct: HuffmanCTable) -> bytes:
    """Encode one backward Huffman stream: symbols written in reverse order so
    the decoder reads them forward from the stream top."""
    rev = data[::-1].astype(np.int64)
    return pack_backward(ct.codes[rev], ct.nbits[rev])


def encode_4_streams(data: np.ndarray, ct: HuffmanCTable) -> bytes:
    """4-stream layout: 6-byte jump table + 4 independent backward streams;
    segment size = ceil(n/4) for the first three (RFC 8878 §3.1.1.2.4)."""
    n = data.size
    assert n >= 4
    seg = (n + 3) // 4
    parts = [
        encode_single_stream(data[i * seg : min((i + 1) * seg, n)], ct)
        for i in range(4)
    ]
    for p in parts[:3]:
        if len(p) > 0xFFFF:
            raise ValueError("stream too large for jump table")
    head = bytearray()
    for p in parts[:3]:
        head += len(p).to_bytes(2, "little")
    return bytes(head) + b"".join(parts)


def estimate_compressed_bits(counts: np.ndarray, ct: HuffmanCTable) -> int:
    return int(np.sum(counts * ct.nbits[: counts.size]))
