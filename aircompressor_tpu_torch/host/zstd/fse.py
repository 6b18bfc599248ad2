"""Finite State Entropy (tANS) — decode side (RFC 8878 §4.1).

The port's copy of ``aircompressor_tpu.zstd.fse``.

Parity targets: reference zstd/FseTableReader.java:27-168 (normalized-count
parsing with the extra-accuracy trick and 2-bit zero-repeat flags, symbol
spreading) and zstd/FiniteStateEntropy.java:38-151 (2-state interleaved
stream decode used for Huffman weights).
"""

from __future__ import annotations

import numpy as np

from ...errors import MalformedInputException
from .bits import BackwardBitReader, ForwardBitReader


class FseTable:
    """Decode table: per-state (symbol, number_of_bits, new_state_base)."""

    __slots__ = ("log2_size", "symbol", "num_bits", "new_state")

    def __init__(self, log2_size: int, symbol, num_bits, new_state):
        self.log2_size = log2_size
        self.symbol = symbol
        self.num_bits = num_bits
        self.new_state = new_state


def read_normalized_counts(src: np.ndarray, start: int, end: int,
                           max_symbol: int, max_table_log: int) -> tuple[np.ndarray, int, int]:
    """Parse an FSE table description. Returns (counts, table_log,
    bytes_consumed). Counts use -1 for 'less-than-one' probabilities."""
    br = ForwardBitReader(src, start, end)
    table_log = br.read(4) + 5
    if table_log > max_table_log:
        raise MalformedInputException(start, f"FSE table log {table_log} too large")
    table_size = 1 << table_log
    remaining = table_size + 1
    threshold = table_size
    nb_bits = table_log + 1
    counts = np.zeros(max_symbol + 1, dtype=np.int64)
    symbol = 0
    previous_zero = False
    while remaining > 1:
        if symbol > max_symbol:
            raise MalformedInputException(start, "too many FSE symbols")
        if previous_zero:
            # 2-bit zero-repeat flags (value 3 chains)
            n = symbol
            while br.peek(16) == 0xFFFF:
                br.skip(16)
                n += 24
            while br.peek(2) == 3:
                br.skip(2)
                n += 3
            n += br.read(2)
            if n > max_symbol + 1:
                raise MalformedInputException(start, "zero-repeat overruns symbol range")
            symbol = n  # counts already zero-initialized
            if br.overflowed():
                raise MalformedInputException(start, "FSE description overruns input")
            previous_zero = False
            if remaining <= 1:
                break
            continue
        maxv = 2 * threshold - 1 - remaining
        value = br.peek(nb_bits)
        low = value & (threshold - 1)
        if low < maxv:
            count = low
            br.skip(nb_bits - 1)
        else:
            count = value & (2 * threshold - 1)
            if count >= threshold:
                count -= maxv
            br.skip(nb_bits)
        count -= 1  # extra-accuracy: stored values are count+1; -1 => "less than one"
        remaining -= -count if count < 0 else count
        counts[symbol] = count
        symbol += 1
        previous_zero = count == 0
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
        if br.overflowed():
            raise MalformedInputException(start, "FSE description overruns input")
    if remaining != 1:
        raise MalformedInputException(start, "FSE normalized counts do not sum to table size")
    return counts[: symbol if symbol > 0 else 1], table_log, br.bytes_consumed()


def build_decode_table(counts: np.ndarray, table_log: int) -> FseTable:
    """Build the FSE decode table (symbol spread + per-state transitions).

    Vectorized: the spread walk ``pos += step (mod size)`` with
    skip-while-above-high is one full cycle of a permutation coprime to the
    table size, so the visited cells are a closed form (filter the cycle by
    ``<= high``); the transition numbering (each symbol's occurrences get
    ``count..2*count-1`` in state order) is a stable argsort + group rank."""
    table_size = 1 << table_log
    n_symbols = counts.size
    if table_size < 8:
        return _build_decode_table_scalar(counts, table_log)
    counts = counts.astype(np.int64)
    symbol_arr = np.zeros(table_size, dtype=np.int64)

    # low-probability (-1) symbols occupy the highest cells
    low = np.nonzero(counts == -1)[0]
    n_low = low.size
    high = table_size - 1 - n_low
    if n_low:
        # explicit indices: a stop of -1 in a reversed slice would mean
        # "until the last element" when every symbol is low-probability
        symbol_arr[table_size - 1 - np.arange(n_low)] = low
    init = np.where(counts == -1, 1, counts)  # first transition index

    # spread symbols over the kept cells of the step cycle
    step = (table_size >> 1) + (table_size >> 3) + 3
    mask = table_size - 1
    walk = (np.arange(table_size, dtype=np.int64) * step) & mask
    kept = walk[walk <= high]
    pos_counts = np.maximum(counts, 0)
    total = int(pos_counts.sum())
    if total != kept.size:
        raise MalformedInputException(0, "FSE spread did not return to zero")
    symbol_arr[kept] = np.repeat(np.arange(n_symbols, dtype=np.int64), pos_counts)

    # per-state transition: occurrence rank within each symbol, state order
    order = np.argsort(symbol_arr, kind="stable")
    sym_sorted = symbol_arr[order]
    idx = np.arange(table_size, dtype=np.int64)
    grp_start = np.zeros(table_size, dtype=np.int64)
    first = np.nonzero(np.r_[True, sym_sorted[1:] != sym_sorted[:-1]])[0]
    grp_start[first] = first
    grp_start = np.maximum.accumulate(grp_start)
    nxt = init[sym_sorted] + (idx - grp_start)
    # bit_length(nxt) via float exponent (exact: nxt <= 2*table_size < 2^53)
    bitlen = np.frexp(nxt.astype(np.float64))[1].astype(np.int64)
    nb_sorted = table_log - (bitlen - 1)
    ns_sorted = (nxt << nb_sorted) - table_size
    num_bits = np.zeros(table_size, dtype=np.int64)
    new_state = np.zeros(table_size, dtype=np.int64)
    num_bits[order] = nb_sorted
    new_state[order] = ns_sorted
    return FseTable(table_log, symbol_arr, num_bits, new_state)


def _build_decode_table_scalar(counts: np.ndarray, table_log: int) -> FseTable:
    """Reference scalar build, kept for tiny tables (step not coprime)."""
    table_size = 1 << table_log
    symbol_arr = np.zeros(table_size, dtype=np.int64)
    num_bits = np.zeros(table_size, dtype=np.int64)
    new_state = np.zeros(table_size, dtype=np.int64)
    n_symbols = counts.size

    high = table_size - 1
    symbol_next = np.zeros(n_symbols, dtype=np.int64)
    for s in range(n_symbols):
        c = int(counts[s])
        if c == -1:
            symbol_arr[high] = s
            high -= 1
            symbol_next[s] = 1
        else:
            symbol_next[s] = c

    step = (table_size >> 1) + (table_size >> 3) + 3
    mask = table_size - 1
    pos = 0
    for s in range(n_symbols):
        c = int(counts[s])
        for _ in range(max(c, 0)):
            symbol_arr[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise MalformedInputException(0, "FSE spread did not return to zero")

    for u in range(table_size):
        s = int(symbol_arr[u])
        nxt = int(symbol_next[s])
        symbol_next[s] += 1
        nb = table_log - (nxt.bit_length() - 1)
        num_bits[u] = nb
        new_state[u] = (nxt << nb) - table_size
    return FseTable(table_log, symbol_arr, num_bits, new_state)


def build_rle_table(symbol: int) -> FseTable:
    """Single-state table always yielding ``symbol`` with 0-bit transitions
    (reference: FseTableReader.initializeRleTable)."""
    return FseTable(
        0,
        np.array([symbol], dtype=np.int64),
        np.array([0], dtype=np.int64),
        np.array([0], dtype=np.int64),
    )


def decompress_interleaved2(table: FseTable, reader: BackwardBitReader,
                            max_output: int) -> np.ndarray:
    """2-state interleaved FSE stream decode (Huffman weights).

    Emits symbols until the bitstream overflows, then flushes final states
    (reference: FiniteStateEntropy.java:38-151)."""
    out = np.zeros(max_output, dtype=np.int64)
    n = 0
    log = table.log2_size
    sym, bits, nxt = table.symbol, table.num_bits, table.new_state
    s1 = reader.read(log)
    s2 = reader.read(log)
    if reader.is_overflowed():
        raise MalformedInputException(0, "FSE stream too short for initial states")
    while True:
        if n >= max_output:
            raise MalformedInputException(0, "FSE output exceeds limit")
        out[n] = sym[s1]
        n += 1
        s1 = int(nxt[s1]) + reader.read(int(bits[s1]))
        if reader.is_overflowed():
            if n >= max_output:
                raise MalformedInputException(0, "FSE output exceeds limit")
            out[n] = sym[s2]
            n += 1
            break
        if n >= max_output:
            raise MalformedInputException(0, "FSE output exceeds limit")
        out[n] = sym[s2]
        n += 1
        s2 = int(nxt[s2]) + reader.read(int(bits[s2]))
        if reader.is_overflowed():
            if n >= max_output:
                raise MalformedInputException(0, "FSE output exceeds limit")
            out[n] = sym[s1]
            n += 1
            break
    return out[:n]
