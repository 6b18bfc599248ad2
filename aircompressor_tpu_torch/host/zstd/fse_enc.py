"""Finite State Entropy (tANS) — encode side (RFC 8878 §4.1).

The port's copy of ``aircompressor_tpu.zstd.fse_enc``.

Own implementation of the standard FSE construction. Parity targets (behavior
only): reference zstd/FiniteStateEntropy.java:153-521 (compress, optimal
table log, count normalization, normalized-count serialization) and
zstd/FseCompressionTable.java (encode-table build).

The encode table maps a running state c ∈ [tableSize, 2·tableSize) through
    nbBits = (c + delta_nb_bits[s]) >> 16
    emit low nbBits of c
    c      = next_state[(c >> nbBits) + delta_find_state[s]]
which is exactly the inverse of fse.build_decode_table's transition — the
spread function must match bit-for-bit (same step = 5/8·size + 3, same
low-probability placement from the table top).
"""

from __future__ import annotations

import numpy as np

from .bits import BackwardBitWriter


class FseCTable:
    __slots__ = ("table_log", "next_state", "delta_nb_bits", "delta_find_state")

    def __init__(self, table_log, next_state, delta_nb_bits, delta_find_state):
        self.table_log = table_log
        self.next_state = next_state
        self.delta_nb_bits = delta_nb_bits
        self.delta_find_state = delta_find_state


def optimal_table_log(max_log: int, total: int, max_symbol: int) -> int:
    """Pick a table log ≤ max_log adequate for ``total`` inputs over
    ``max_symbol+1`` symbols (behavioral parity: FSE_optimalTableLog)."""
    total, max_symbol = int(total), int(max_symbol)
    log = (total - 1).bit_length() - 2 if total > 1 else 5
    min_bits = max_symbol.bit_length() + 1 if max_symbol > 0 else 5
    log = max(log, min_bits - 1)
    log = max(5, min(max_log, log))
    return log


def normalize_counts(counts: np.ndarray, table_log: int, total: int) -> np.ndarray:
    """Scale histogram ``counts`` (sum=total) to normalized counts summing to
    2^table_log. Symbols with tiny probability get -1 (cost: one table cell).
    """
    table_size = 1 << table_log
    counts = counts.astype(np.int64)
    norm = np.zeros_like(counts)
    if total <= 0:
        raise ValueError("empty input")
    # low-probability threshold: count such that scaled value < 1
    lowprob = np.logical_and(counts > 0, counts * table_size < total)
    norm[lowprob] = -1
    big = counts * table_size >= total
    scaled = (counts[big].astype(np.float64) * table_size / total).round().astype(np.int64)
    norm[big] = np.maximum(scaled, 1)
    used = int(np.sum(np.where(norm == -1, 1, norm)))
    delta = table_size - used
    if delta != 0:
        # absorb the difference into the largest symbols, keeping every
        # normalized count ≥ 1
        order = np.argsort(-norm)
        i = 0
        while delta != 0:
            s = int(order[i % order.size])
            if norm[s] < 1:
                i += 1
                if i > 4 * order.size:
                    raise ValueError("cannot normalize counts")
                continue
            if delta > 0:
                norm[s] += delta
                delta = 0
            else:
                take = min(-delta, int(norm[s]) - 1)
                norm[s] -= take
                delta += take
                i += 1
                if take == 0 and i > 4 * order.size:
                    raise ValueError("cannot normalize counts")
    return norm


def build_ctable(norm: np.ndarray, table_log: int) -> FseCTable:
    """Build the encode table from normalized counts (sum = 2^table_log)."""
    table_size = 1 << table_log
    n_symbols = norm.size
    # symbol spread — must match fse.build_decode_table exactly
    spread = np.zeros(table_size, dtype=np.int64)
    high = table_size - 1
    for s in range(n_symbols):
        if norm[s] == -1:
            spread[high] = s
            high -= 1
    step = (table_size >> 1) + (table_size >> 3) + 3
    mask = table_size - 1
    pos = 0
    for s in range(n_symbols):
        for _ in range(max(int(norm[s]), 0)):
            spread[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    assert pos == 0, "FSE spread did not return to zero"

    # cumulative symbol start positions (−1 counts as one cell)
    occ = np.where(norm == -1, 1, np.maximum(norm, 0)).astype(np.int64)
    cumul = np.zeros(n_symbols + 1, dtype=np.int64)
    np.cumsum(occ, out=cumul[1:])

    # next_state: for each table cell u (in spread order), the encoder state
    # value tableSize+u, grouped per symbol in increasing u
    next_state = np.zeros(table_size, dtype=np.int64)
    fill = cumul[:-1].copy()
    for u in range(table_size):
        s = int(spread[u])
        next_state[fill[s]] = table_size + u
        fill[s] += 1

    # per-symbol deltas
    delta_nb = np.zeros(n_symbols, dtype=np.int64)
    delta_find = np.zeros(n_symbols, dtype=np.int64)
    total = 0
    for s in range(n_symbols):
        c = int(norm[s])
        if c == 0:
            # unused symbol; keep a safe value
            delta_nb[s] = ((table_log + 1) << 16) - table_size
            delta_find[s] = total
        elif c == -1 or c == 1:
            delta_nb[s] = (table_log << 16) - table_size
            delta_find[s] = total - 1
            total += 1
        else:
            max_bits_out = table_log - ((c - 1).bit_length() - 1)
            min_state_plus = c << max_bits_out
            delta_nb[s] = (max_bits_out << 16) - min_state_plus
            delta_find[s] = total - c
            total += c
    return FseCTable(table_log, next_state, delta_nb, delta_find)


class FseEncoder:
    """Running encode state over a CTable (reverse-order symbol feed)."""

    __slots__ = ("ct", "state", "started")

    def __init__(self, ct: FseCTable):
        self.ct = ct
        self.state = 0
        self.started = False

    def init_state(self, symbol: int) -> None:
        ct = self.ct
        nb = (int(ct.delta_nb_bits[symbol]) + (1 << 15)) >> 16
        sub = ((nb << 16) - int(ct.delta_nb_bits[symbol])) >> nb
        self.state = int(ct.next_state[sub + int(ct.delta_find_state[symbol])])
        self.started = True

    def encode(self, writer: BackwardBitWriter, symbol: int) -> None:
        ct = self.ct
        nb = (self.state + int(ct.delta_nb_bits[symbol])) >> 16
        writer.add(self.state, nb)
        self.state = int(ct.next_state[(self.state >> nb) + int(ct.delta_find_state[symbol])])

    def flush(self, writer: BackwardBitWriter) -> None:
        writer.add(self.state, self.ct.table_log)


def write_normalized_counts(norm: np.ndarray, table_log: int) -> bytes:
    """Serialize normalized counts as the forward-bitstream FSE table
    description (inverse of fse.read_normalized_counts)."""
    table_size = 1 << table_log
    out = _ForwardBitWriter()
    out.add(table_log - 5, 4)
    remaining = table_size + 1
    threshold = table_size
    nb_bits = table_log + 1
    s = 0
    n = norm.size
    previous_zero = False
    while remaining > 1 and s < n:
        if previous_zero:
            # zero-run: 2-bit repeat counts, 3 chains, 0xFFFF jumps by 24
            start = s
            while s < n and norm[s] == 0:
                s += 1
            run = s - start
            while run >= 24:
                out.add(0xFFFF, 16)
                run -= 24
            while run >= 3:
                out.add(3, 2)
                run -= 3
            out.add(run, 2)
            previous_zero = False
            continue
        c = int(norm[s])
        s += 1
        max_v = 2 * threshold - 1 - remaining
        remaining -= 1 if c < 0 else c
        v = c + 1  # -1 → 0
        if v >= threshold:
            v += max_v
        if v < max_v:
            out.add(v, nb_bits - 1)
        else:
            out.add(v, nb_bits)
        previous_zero = c == 0
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ValueError("normalized counts do not sum to table size")
    return out.close()


class _ForwardBitWriter:
    __slots__ = ("acc", "nbits", "out")

    def __init__(self):
        self.acc = 0
        self.nbits = 0
        self.out = bytearray()

    def add(self, value: int, n: int) -> None:
        self.acc |= (value & ((1 << n) - 1)) << self.nbits
        self.nbits += n
        while self.nbits >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.nbits -= 8

    def close(self) -> bytes:
        if self.nbits:
            self.out.append(self.acc & 0xFF)
        return bytes(self.out)


def compress_interleaved2(symbols: np.ndarray, ct: FseCTable) -> bytes:
    """2-state interleaved FSE encode (Huffman weights stream) — exact
    inverse of fse.decompress_interleaved2: stream A carries even indices,
    stream B odd; init with each stream's last symbol, encode the rest in
    reverse index order, flush B then A (so A's init is read first)."""
    n = symbols.size
    assert n >= 2
    w = BackwardBitWriter()
    a = FseEncoder(ct)
    b = FseEncoder(ct)
    if n % 2 == 0:
        b.init_state(int(symbols[n - 1]))
        a.init_state(int(symbols[n - 2]))
        i = n - 3
    else:
        a.init_state(int(symbols[n - 1]))
        b.init_state(int(symbols[n - 2]))
        i = n - 3
    while i >= 0:
        enc = a if (i % 2 == 0) else b
        enc.encode(w, int(symbols[i]))
        i -= 1
    b.flush(w)
    a.flush(w)
    return w.close()
