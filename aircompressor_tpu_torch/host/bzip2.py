"""Own bzip2 engine: RLE1 + Burrows–Wheeler + MTF + RLE2 + multi-table
canonical Huffman, and the full inverse.

The port's copy of ``aircompressor_tpu.bzip2.block_ref``, the from-scratch
counterpart of the reference's bzip2/CBZip2OutputStream.java
(RLE1/BWT/MTF/RLE2/Huffman writer) and bzip2/CBZip2InputStream.java
(recvDecodingTables/hbCreateDecodeTables/getAndMoveToFrontDecode),
redesigned around numpy:

- the block sort is prefix-doubling over ROTATIONS (np.lexsort rounds on
  (rank, rank rotated by k)), not the reference's fallback-aware pointer
  sort;
- the inverse BWT builds the successor vector with a counting sort
  (vectorized) and walks it by doubling;
- Huffman code lengths come from the shared package-merge
  (``host/zstd/huff_enc.py``), not the reference's two-queue + repair
  algorithm;
- group/table assignment is a small expectation-minimization loop like
  libbz2's sendMTFValues, scored vectorized.

Output is standard .bz2 wire format: stdlib ``bz2`` (libbz2) decodes these
streams and this engine decodes its streams bit-exactly
(tests/test_torch_bzip2.py).
"""

from __future__ import annotations

import numpy as np

from ..errors import MalformedInputException
from .zstd.huff_enc import package_merge_lengths

BLOCK_MAGIC = 0x314159265359
EOS_MAGIC = 0x177245385090
MAX_CODE_LEN = 17  # encoder cap (decoder accepts up to 23)
GROUP_SIZE = 50
MAX_GROUPS = 6
RUNA, RUNB = 0, 1

# ---------------------------------------------------------------- bzip2 CRC32
# MSB-first CRC-32 (poly 0x04C11DB7), init/final 0xFFFFFFFF — derived
# programmatically (the reference ships the table: bzip2/Crc32.java)
def _crc_table() -> np.ndarray:
    t = np.zeros(256, np.uint32)
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7) if c & 0x80000000 else (c << 1)
            c &= 0xFFFFFFFF
        t[i] = c
    return t


_CRC_TAB = _crc_table()


def block_crc(data: np.ndarray) -> int:
    """The block CRC, a table lookup a byte over Python ints (the JAX
    engine's ``_block_crc_fast``)."""
    crc = 0xFFFFFFFF
    tab = _CRC_TAB
    for b in memoryview(data.tobytes()):
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(tab[(crc >> 24) ^ b])
    return crc ^ 0xFFFFFFFF


# ------------------------------------------------------------------ bit I/O
class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, nbits: int, value: int):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nbits += nbits
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_bits_array(self, nbits: np.ndarray, values: np.ndarray):
        """Append many (nbits, value) pairs — vectorized packing."""
        nbits = nbits.astype(np.int64)
        values = values.astype(np.int64)
        ends = np.cumsum(nbits) + self.nbits  # bit offset AFTER each value
        total = int(ends[-1]) if len(ends) else self.nbits
        nbytes = (total + 7) // 8
        # spread each value's bits into a byte array via per-bit scatter on
        # (value, position) — bzip2 codes are ≤ 23 bits so loop bit planes
        buf = np.zeros(nbytes, np.uint8)
        # carry in the partial accumulator
        if self.nbits:
            buf[0] = (self.acc << (8 - self.nbits)) & 0xFF
        maxb = int(nbits.max()) if len(nbits) else 0
        starts = ends - nbits
        for k in range(maxb):
            # bit k of each code, counted from the MSB of that code
            live = nbits > k
            pos = starts[live] + k
            bit = (values[live] >> (nbits[live] - 1 - k)) & 1
            byte_idx = (pos >> 3).astype(np.int64)
            shift = (7 - (pos & 7)).astype(np.int64)
            np.bitwise_or.at(buf, byte_idx, (bit << shift).astype(np.uint8))
        rem = total & 7
        if rem:
            self.acc = int(buf[-1]) >> (8 - rem)
            self.out += bytes(buf[:-1])
        else:
            self.acc = 0
            self.out += bytes(buf)
        self.nbits = rem

    def finish(self) -> bytes:
        if self.nbits:
            self.out.append((self.acc << (8 - self.nbits)) & 0xFF)
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)


class BitReader:
    def __init__(self, data: bytes, byte_pos: int = 0):
        self.data = data
        self.pos = byte_pos * 8

    def read(self, nbits: int) -> int:
        v = 0
        p = self.pos
        data = self.data
        end = p + nbits
        if end > len(data) * 8:
            raise MalformedInputException(p // 8, "bzip2: truncated stream")
        while nbits > 0:
            byte = data[p >> 3]
            avail = 8 - (p & 7)
            take = min(avail, nbits)
            v = (v << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            p += take
            nbits -= take
        self.pos = p
        return v


# ------------------------------------------------------------------- RLE1
def rle1_encode(data: np.ndarray) -> np.ndarray:
    """Initial run-length pass: 4 equal bytes then a count byte (0-251)."""
    if len(data) == 0:
        return data
    out = bytearray()
    n = len(data)
    # run boundaries, vectorized
    change = np.nonzero(np.diff(data))[0] + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [n]))
    for s, e in zip(starts.tolist(), ends.tolist()):
        run = e - s
        b = data[s]
        while run >= 4:
            k = min(run - 4, 251)
            out += bytes([b, b, b, b, k])
            run -= 4 + k
        out += bytes([b]) * run
    return np.frombuffer(bytes(out), np.uint8)


def rle1_decode(data: np.ndarray) -> np.ndarray:
    out = bytearray()
    i = 0
    n = len(data)
    run = 0
    last = -1
    while i < n:
        b = int(data[i])
        out.append(b)
        i += 1
        if b == last:
            run += 1
            if run == 4:
                if i >= n:
                    raise MalformedInputException(i, "bzip2: truncated RLE run")
                out += bytes([b]) * int(data[i])
                i += 1
                run = 0
                last = -1
                continue
        else:
            run = 1
        last = b
    return np.frombuffer(bytes(out), np.uint8)


# -------------------------------------------------------------------- BWT
def bwt_forward(block: np.ndarray):
    """Sorted-rotations BWT. Returns (last column, origPtr)."""
    n = len(block)
    if n == 0:
        return block, 0
    if n == 1:
        return block.copy(), 0
    rank = block.astype(np.int64)
    idx = np.arange(n)
    k = 1
    while k < n:
        key2 = np.roll(rank, -k)
        order = np.lexsort((key2, rank))
        # recompute ranks
        r_s = rank[order]
        k_s = key2[order]
        new = np.empty(n, np.int64)
        neq = np.concatenate(
            ([False], (r_s[1:] != r_s[:-1]) | (k_s[1:] != k_s[:-1])))
        new[order] = np.cumsum(neq)
        if new[order[-1]] == n - 1:
            rank = new
            break
        rank = new
        k <<= 1
    # Exactly periodic blocks leave equal rotations tied (doubling can never
    # separate them); equal rotations have equal last-column bytes, so ANY
    # consistent tie-break yields a valid BWT — break by position.
    sa = np.lexsort((np.arange(n), rank))
    inv = np.empty(n, np.int64)
    inv[sa] = np.arange(n)
    last = block[(sa - 1) % n]
    orig_ptr = int(inv[0])
    return last, orig_ptr


def bwt_inverse(last: np.ndarray, orig_ptr: int) -> np.ndarray:
    """The inverse BWT: the successor walk from ``orig_ptr``, resolved by
    successive squaring of the permutation on power-of-two hops (the JAX
    engine's ``_bwt_inverse_fast``)."""
    n = len(last)
    if n == 0:
        return last
    if not 0 <= orig_ptr < n:
        raise MalformedInputException(0, "bzip2: origPtr out of range")
    order = np.argsort(last, kind="stable").astype(np.int64)
    # positions visited: p_0 = order[orig_ptr], p_{i+1} = order[p_i]
    # build the full visit sequence by repeated doubling of the chain
    seq = np.empty(n, np.int64)
    seq[0] = order[orig_ptr]
    filled = 1
    hop = order  # hop[i] = 2^k-step successor
    while filled < n:
        take = min(filled, n - filled)
        seq[filled : filled + take] = hop[seq[:take]]
        filled += take
        if filled < n:
            hop = hop[hop]
    return last[seq]


# --------------------------------------------------------------- MTF + RLE2
def mtf_rle2_encode(bwt: np.ndarray, used: np.ndarray):
    """MTF over the used-symbol alphabet then RUNA/RUNB zero-run coding.
    Returns int32 symbols (RUNA=0, RUNB=1, value j→j+1, EOB=alpha-1)."""
    syms = np.nonzero(used)[0].astype(np.uint8)
    alpha = len(syms) + 2
    eob = alpha - 1
    # map bytes to their index in the used alphabet
    to_idx = np.zeros(256, np.int32)
    to_idx[syms] = np.arange(len(syms), dtype=np.int32)
    seq = to_idx[bwt]
    out = []
    stack = list(range(len(syms)))
    posmap = {v: i for i, v in enumerate(stack)}
    run = 0

    def flush_run(run):
        # zero-run length in bijective base 2: RUNA digit = 1, RUNB digit = 2
        while run > 0:
            if run & 1:
                out.append(RUNA)
                run = (run - 1) >> 1
            else:
                out.append(RUNB)
                run = (run - 2) >> 1
        return 0

    # python loop over MTF — the stack mutation is inherently serial; keep
    # the block sizes bounded by callers (tests ≤ 900KB)
    lst = stack
    for v in seq.tolist():
        j = lst.index(v)
        if j == 0:
            run += 1
            continue
        run = flush_run(run)
        out.append(j + 1)
        lst.pop(j)
        lst.insert(0, v)
    run = flush_run(run)
    out.append(eob)
    return np.asarray(out, np.int32), alpha


def mtf_rle2_decode(symbols, used: np.ndarray, max_out: int) -> np.ndarray:
    """Inverse of mtf_rle2_encode; ``symbols`` is an iterator of decoded
    Huffman symbols ending with EOB."""
    syms = np.nonzero(used)[0].astype(np.uint8).tolist()
    out = bytearray()
    lst = list(syms)
    run = 0
    runbit = 0
    for s in symbols:
        if s <= 1:  # RUNA/RUNB
            run += (s + 1) << runbit
            runbit += 1
            continue
        if run:
            out += bytes([lst[0]]) * run
            run = 0
            runbit = 0
        # s in [2, alpha-2] → mtf index s-1
        j = s - 1
        v = lst.pop(j)
        lst.insert(0, v)
        out.append(v)
        if len(out) > max_out:
            raise MalformedInputException(0, "bzip2: block overruns its size")
    if run:
        out += bytes([lst[0]]) * run
    if len(out) > max_out:
        raise MalformedInputException(0, "bzip2: block overruns its size")
    return np.frombuffer(bytes(out), np.uint8)


# ------------------------------------------------------------------ Huffman
def _assign_codes(lengths: np.ndarray):
    """bzip2 canonical codes: increasing code values by length, symbols in
    natural order within a length (reference: hbAssignCodes)."""
    alpha = len(lengths)
    codes = np.zeros(alpha, np.int64)
    code = 0
    for ln in range(int(lengths.min()), int(lengths.max()) + 1):
        for s in range(alpha):
            if lengths[s] == ln:
                codes[s] = code
                code += 1
        code <<= 1
    return codes


def _build_tables(mtf: np.ndarray, alpha: int, n_groups: int):
    """libbz2-style sendMTFValues: initial frequency-band split then a few
    refinement iterations of assign-groups-to-cheapest-table."""
    n = len(mtf)
    n_sel = (n + GROUP_SIZE - 1) // GROUP_SIZE
    # per-group symbol histograms, vectorized
    gidx = np.arange(n) // GROUP_SIZE
    hist = np.zeros((n_sel, alpha), np.int64)
    np.add.at(hist, (gidx, mtf), 1)

    # initial split: cumulative-frequency bands (like libbz2's first guess)
    total_counts = hist.sum(axis=0)
    lengths = np.zeros((n_groups, alpha), np.int64)
    order = np.argsort(-total_counts, kind="stable")
    # seed: table t favors band t of the frequency-sorted alphabet
    for t in range(n_groups):
        fake = np.ones(alpha, np.int64)
        band = order[(np.arange(alpha) * n_groups) // alpha == t]
        fake[band] = np.maximum(total_counts[band], 1) * 8 + 1
        lengths[t] = package_merge_lengths(fake, MAX_CODE_LEN)
        lengths[t] = np.maximum(lengths[t], 1)

    selectors = np.zeros(n_sel, np.int64)
    for _ in range(4):
        # assign each 50-group to its cheapest table
        cost = hist @ lengths.T  # (n_sel, n_groups)
        selectors = np.argmin(cost, axis=1)
        # rebuild each table from its assigned groups
        for t in range(n_groups):
            counts = hist[selectors == t].sum(axis=0)
            counts = np.maximum(counts, 1)
            lengths[t] = np.maximum(
                package_merge_lengths(counts, MAX_CODE_LEN), 1)
    return lengths, selectors


# ------------------------------------------------------------ block encode
def _encode_block(bw: BitWriter, pre_rle: np.ndarray, crc: int):
    rle = rle1_encode(pre_rle)
    bwt, orig_ptr = bwt_forward(rle)
    if len(rle) == 0:
        raise ValueError("empty block")
    used = np.zeros(256, bool)
    used[rle] = True
    mtf, alpha = mtf_rle2_encode(bwt, used)
    n_groups = (2 if len(mtf) < 200 else
                3 if len(mtf) < 600 else
                4 if len(mtf) < 1200 else
                5 if len(mtf) < 2400 else 6)
    lengths, selectors = _build_tables(mtf, alpha, n_groups)
    n_sel = len(selectors)

    bw.write(24, BLOCK_MAGIC >> 24)
    bw.write(24, BLOCK_MAGIC & 0xFFFFFF)
    bw.write(32, crc)
    bw.write(1, 0)  # not randomized
    bw.write(24, orig_ptr)
    # symbol map
    groups16 = used.reshape(16, 16)
    gmask = groups16.any(axis=1)
    bw.write(16, int("".join("1" if g else "0" for g in gmask), 2))
    for g in range(16):
        if gmask[g]:
            bw.write(16, int("".join("1" if u else "0" for u in groups16[g]), 2))
    bw.write(3, n_groups)
    bw.write(15, n_sel)
    # selector MTF + unary
    lst = list(range(n_groups))
    for s in selectors.tolist():
        j = lst.index(s)
        lst.pop(j)
        lst.insert(0, s)
        bw.write(j + 1, (((1 << j) - 1) << 1))  # j ones then a zero
    # delta-coded lengths
    for t in range(n_groups):
        cur = int(lengths[t, 0])
        bw.write(5, cur)
        for s in range(alpha):
            target = int(lengths[t, s])
            while cur != target:
                bw.write(2, 0b10 if cur < target else 0b11)
                cur += 1 if cur < target else -1
            bw.write(1, 0)
    # symbol stream, vectorized per selector run
    codes = np.zeros((n_groups, alpha), np.int64)
    for t in range(n_groups):
        codes[t] = _assign_codes(lengths[t])
    sel_of_sym = selectors[np.arange(len(mtf)) // GROUP_SIZE]
    bw.write_bits_array(lengths[sel_of_sym, mtf], codes[sel_of_sym, mtf])


def compress(data: bytes | np.ndarray, block_size_100k: int = 9) -> bytes:
    """Full .bz2 stream with our own engine (oracle: stdlib bz2 decodes)."""
    if not 1 <= block_size_100k <= 9:
        raise ValueError("block size must be in [1, 9]")
    data = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(data, np.uint8)
    bw = BitWriter()
    bw.write(8, ord("B"))
    bw.write(8, ord("Z"))
    bw.write(8, ord("h"))
    bw.write(8, ord("0") + block_size_100k)
    limit = block_size_100k * 100000 - 19
    combined = 0
    pos = 0
    n = len(data)
    while pos < n:
        # greedily take input whose RLE1 image fits the block limit; RLE1
        # never expands by more than 1.25x, so a safe slice then trim
        take = min(n - pos, limit)
        chunk = data[pos : pos + take]
        while len(rle1_encode(chunk)) > limit:
            take = int(take * 0.9)
            chunk = data[pos : pos + take]
        crc = block_crc(chunk)
        combined = (((combined << 1) | (combined >> 31)) ^ crc) & 0xFFFFFFFF
        _encode_block(bw, chunk, crc)
        pos += take
    bw.write(24, EOS_MAGIC >> 24)
    bw.write(24, EOS_MAGIC & 0xFFFFFF)
    bw.write(32, combined)
    return bw.finish()


# ------------------------------------------------------------ block decode
def _read_huff_tables(br: BitReader, alpha: int, n_groups: int):
    lengths = np.zeros((n_groups, alpha), np.int64)
    for t in range(n_groups):
        cur = br.read(5)
        for s in range(alpha):
            while br.read(1):
                cur += -1 if br.read(1) else 1
            if not 1 <= cur <= 23:
                raise MalformedInputException(
                    br.pos // 8, "bzip2: invalid code length")
            lengths[t, s] = cur
    return lengths


class _Decoder:
    """Canonical decode tables per group: limit/base/perm arrays (same
    construction as the reference's hbCreateDecodeTables)."""

    def __init__(self, lengths: np.ndarray):
        self.n_groups, alpha = lengths.shape
        self.min_len = lengths.min(axis=1)
        self.max_len = lengths.max(axis=1)
        self.limit = np.zeros((self.n_groups, 25), np.int64)
        self.base = np.zeros((self.n_groups, 25), np.int64)
        self.perm = np.zeros((self.n_groups, alpha), np.int64)
        for t in range(self.n_groups):
            pp = 0
            for ln in range(int(self.min_len[t]), int(self.max_len[t]) + 1):
                for s in range(alpha):
                    if lengths[t, s] == ln:
                        self.perm[t, pp] = s
                        pp += 1
            count = np.zeros(25, np.int64)
            for s in range(alpha):
                count[lengths[t, s] + 1] += 1
            base = np.cumsum(count)
            vec = 0
            for ln in range(int(self.min_len[t]), int(self.max_len[t]) + 1):
                vec += int(base[ln + 1]) - int(base[ln])
                self.limit[t, ln] = vec - 1
                vec <<= 1
            for ln in range(int(self.min_len[t]) + 1, int(self.max_len[t]) + 1):
                self.base[t, ln] = (
                    (int(self.limit[t, ln - 1]) + 1) << 1) - int(base[ln])

    def decode_symbols(self, br: BitReader, selectors: np.ndarray, eob: int):
        out = []
        g = -1
        in_group = 0
        t = 0
        while True:
            if in_group == 0:
                g += 1
                if g >= len(selectors):
                    raise MalformedInputException(
                        br.pos // 8, "bzip2: ran out of selectors")
                t = int(selectors[g])
                in_group = GROUP_SIZE
            in_group -= 1
            ln = int(self.min_len[t])
            v = br.read(ln)
            while v > self.limit[t, ln]:
                ln += 1
                if ln > 23:
                    raise MalformedInputException(
                        br.pos // 8, "bzip2: invalid Huffman code")
                v = (v << 1) | br.read(1)
            s = int(self.perm[t, v - int(self.base[t, ln])])
            if s == eob:
                return out
            out.append(s)


def decompress(data: bytes) -> bytes:
    """Decode a complete .bz2 stream (possibly multi-stream concatenated)."""
    out_all = bytearray()
    pos = 0
    data = bytes(data)
    while pos < len(data):
        if data[pos : pos + 2] != b"BZ":
            if pos and not data[pos:].strip(b"\x00"):
                break  # trailing padding
            raise MalformedInputException(pos, "bzip2: bad stream magic")
        if data[pos + 2 : pos + 3] != b"h":
            raise MalformedInputException(pos + 2, "bzip2: unsupported version")
        level = data[pos + 3] - ord("0")
        if not 1 <= level <= 9:
            raise MalformedInputException(pos + 3, "bzip2: bad block size")
        br = BitReader(data, pos + 4)
        combined = 0
        while True:
            magic = (br.read(24) << 24) | br.read(24)
            if magic == EOS_MAGIC:
                stored = br.read(32)
                if stored != combined:
                    raise MalformedInputException(
                        br.pos // 8, "bzip2: combined CRC mismatch")
                break
            if magic != BLOCK_MAGIC:
                raise MalformedInputException(br.pos // 8, "bzip2: bad block magic")
            crc = br.read(32)
            if br.read(1):
                raise MalformedInputException(
                    br.pos // 8, "bzip2: randomized blocks unsupported "
                    "(deprecated since bzip2 0.9.5; never emitted)")
            orig_ptr = br.read(24)
            gmask = br.read(16)
            used = np.zeros(256, bool)
            for g in range(16):
                if (gmask >> (15 - g)) & 1:
                    bits = br.read(16)
                    for k in range(16):
                        if (bits >> (15 - k)) & 1:
                            used[16 * g + k] = True
            n_used = int(used.sum())
            if n_used == 0:
                raise MalformedInputException(br.pos // 8, "bzip2: empty alphabet")
            alpha = n_used + 2
            n_groups = br.read(3)
            if not 2 <= n_groups <= 6:
                raise MalformedInputException(br.pos // 8, "bzip2: bad group count")
            n_sel = br.read(15)
            # selector MTF decode
            lst = list(range(n_groups))
            selectors = np.zeros(n_sel, np.int64)
            for i in range(n_sel):
                j = 0
                while br.read(1):
                    j += 1
                    if j >= n_groups:
                        raise MalformedInputException(
                            br.pos // 8, "bzip2: bad selector")
                v = lst.pop(j)
                lst.insert(0, v)
                selectors[i] = v
            lengths = _read_huff_tables(br, alpha, n_groups)
            dec = _Decoder(lengths)
            syms = dec.decode_symbols(br, selectors, alpha - 1)
            max_block = level * 100000
            bwt = mtf_rle2_decode(syms, used, max_block)
            rle = bwt_inverse(bwt, orig_ptr)
            block = rle1_decode(rle)
            if block_crc(block) != crc:
                raise MalformedInputException(br.pos // 8, "bzip2: block CRC mismatch")
            combined = (((combined << 1) | (combined >> 31)) ^ crc) & 0xFFFFFFFF
            out_all += block.tobytes()
        pos = (br.pos + 7) // 8
    return bytes(out_all)
