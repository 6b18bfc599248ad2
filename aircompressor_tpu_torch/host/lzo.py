"""LZO1X block codec, reference tier: scalar control flow over numpy.

A copy of ``aircompressor_tpu.lzo.block_ref`` (format: the public LZO1X
stream; parity: the reference's LzoRawDecompressor and LzoRawCompressor),
with bytes-in, bytes-out ``compress`` and ``decompress`` over its
``compress_into`` and ``decompress_into``. The reference has no native LZO,
so ``LzoBatchCodec.compress_chunks`` runs this encoder on the host; its
match lengths come from the port's copy of the zstd block encoder's
helpers.

Command families (first byte t, "state" = trailing literals of the previous
command in 0..3, or ≥4 after a standalone literal run):
- t < 16, state 0:   literal run of t+3 (t==0 → zero-extended +15)
- t < 16, state 1-3: M1 copy, len 2, dist = (t>>2) + (next<<2) + 1
- t < 16, state ≥4:  M1' copy, len 3, dist = (t>>2) + (next<<2) + 2049
- t in 16..31 (M4):  len = (t&7)+2 (0 → zero-extended +7), le16 follows:
                     dist = 16384 + ((t&8)<<11) + (le16>>2); dist==16384 → STOP
- t in 32..63 (M3):  len = (t&31)+2 (0 → zero-extended +31), le16 follows:
                     dist = (le16>>2) + 1
- t ≥ 64      (M2):  len = (t>>5)+1, dist = ((t>>2)&7) + (next<<3) + 1
After every copy command, state = (trailing 2 bits) literals follow verbatim.
First byte special: if the stream starts with t > 17, it is a literal run of
t-17 bytes (state semantics as usual).
"""

from __future__ import annotations

import numpy as np

from ..errors import MalformedInputException

MAX_DISTANCE = 0xBFFF  # 49151 — M4 ceiling
M2_MAX_DISTANCE = 0x0800  # 2048
M3_MAX_DISTANCE = 0x4000  # 16384
MIN_MATCH = 3


def max_compressed_length(n: int) -> int:
    """Worst case: incompressible data costs n + n/255 + literal headers + stop."""
    return n + (n >> 8) + 64 + 3


def compress(data: bytes) -> bytes:
    """One LZO1X block of ``data``, ended by the stop command."""
    src = np.frombuffer(memoryview(data), np.uint8)
    dst = np.empty(max_compressed_length(src.size), np.uint8)
    return dst[:compress_into(src, dst)].tobytes()


def decompress(blob: bytes, max_len: int) -> bytes:
    """The bytes of one LZO1X block of at most ``max_len`` decoded bytes;
    raises MalformedInputException on a malformed block."""
    dst = np.empty(int(max_len), np.uint8)
    return dst[:decompress_into(np.frombuffer(memoryview(blob), np.uint8), dst)].tobytes()


# ------------------------------------------------------------------- decoder
def decompress_into(src: np.ndarray, dst: np.ndarray) -> int:
    s = src.tobytes()
    n = len(s)
    out = dst
    cap = out.size
    ip = 0
    op = 0

    def fail(msg, at=None):
        raise MalformedInputException(ip if at is None else at, msg)

    def read_len(base, t):
        """zero-extension: while zero bytes, +255; then + last byte + base."""
        nonlocal ip
        length = 0
        while True:
            if ip >= n:
                fail("truncated length extension")
            b = s[ip]
            ip += 1
            if b == 0:
                length += 255
            else:
                return length + base + b

    def copy_literals(count):
        nonlocal ip, op
        if ip + count > n:
            fail("literal run exceeds input")
        if op + count > cap:
            fail("output buffer too small")
        out[op : op + count] = np.frombuffer(s, np.uint8, count, ip)
        ip += count
        op += count

    def copy_match(dist, length):
        nonlocal op
        if dist > op:
            fail("match offset before start")
        if op + length > cap:
            fail("output buffer too small")
        start = op - dist
        if dist >= length:
            out[op : op + length] = out[start : start + length]
        else:
            idx = start + (np.arange(length) % dist)
            out[op : op + length] = out[idx]
        op += length

    if n == 0:
        fail("empty input")

    state = 0
    # first-byte special
    t = s[ip]
    if t > 17:
        ip += 1
        count = t - 17
        copy_literals(count)
        state = 4 if count >= 4 else count

    while True:
        if ip >= n:
            fail("missing stop command")
        t = s[ip]
        ip += 1
        if t < 16:
            if state == 0:
                length = (read_len(15, t) if t == 0 else t) + 3
                copy_literals(length)
                state = 4
                continue
            if state < 4:
                # M1: len 2
                if ip >= n:
                    fail("truncated M1 command")
                dist = (t >> 2) + (s[ip] << 2) + 1
                ip += 1
                copy_match(dist, 2)
            else:
                # M1': len 3
                if ip >= n:
                    fail("truncated M1' command")
                dist = (t >> 2) + (s[ip] << 2) + 2049
                ip += 1
                copy_match(dist, 3)
            trailing = t & 3
        elif t < 32:
            length = (read_len(7, 0) if (t & 7) == 0 else (t & 7)) + 2
            if ip + 2 > n:
                fail("truncated M4 command")
            le16 = s[ip] | (s[ip + 1] << 8)
            ip += 2
            dist = 16384 + ((t & 8) << 11) + (le16 >> 2)
            if dist == 16384:
                return op  # stop command
            copy_match(dist, length)
            trailing = le16 & 3
        elif t < 64:
            length = (read_len(31, 0) if (t & 31) == 0 else (t & 31)) + 2
            if ip + 2 > n:
                fail("truncated M3 command")
            le16 = s[ip] | (s[ip + 1] << 8)
            ip += 2
            dist = (le16 >> 2) + 1
            copy_match(dist, length)
            trailing = le16 & 3
        else:
            length = (t >> 5) + 1
            if ip >= n:
                fail("truncated M2 command")
            dist = ((t >> 2) & 7) + (s[ip] << 3) + 1
            ip += 1
            copy_match(dist, length)
            trailing = t & 3
        if trailing:
            copy_literals(trailing)
        state = trailing


# ------------------------------------------------------------------- encoder
HASH_LOG = 13


def _hash_positions(w4: np.ndarray) -> np.ndarray:
    return ((w4 * np.uint32(2654435761)) >> np.uint32(32 - HASH_LOG)).astype(np.int64)


def _emit_extended(out: bytearray, rem: int) -> None:
    """Zero-extension bytes: zeros add 255 each, final nonzero byte ends."""
    while rem > 255:
        out.append(0)
        rem -= 255
    out.append(rem)


def _emit_run(out: bytearray, lits: np.ndarray) -> None:
    """Standalone literal-run command (state must be 0); run ≥ 4."""
    count = lits.size
    assert count >= 4
    body = count - 3
    if body <= 15:
        out.append(body)
    else:
        out.append(0)
        _emit_extended(out, body - 15)
    out += lits.tobytes()


def _emit_match(out: bytearray, dist: int, length: int, trailing: int) -> None:
    if length <= 8 and dist <= M2_MAX_DISTANCE:
        d = dist - 1
        out.append(((length - 1) << 5) | ((d & 7) << 2) | trailing)
        out.append(d >> 3)
    elif dist <= M3_MAX_DISTANCE:
        body = length - 2
        if body <= 31:
            out.append(32 | body)
        else:
            out.append(32)
            _emit_extended(out, body - 31)
        le16 = ((dist - 1) << 2) | trailing
        out.append(le16 & 0xFF)
        out.append(le16 >> 8)
    else:
        assert dist <= MAX_DISTANCE
        d = dist - 16384
        body = length - 2
        if body <= 7:
            out.append(16 | ((d >> 14) << 3) | body)
        else:
            out.append(16 | ((d >> 14) << 3))
            _emit_extended(out, body - 7)
        le16 = ((d & 0x3FFF) << 2) | trailing
        out.append(le16 & 0xFF)
        out.append(le16 >> 8)


def _find_matches(src: np.ndarray):
    """Vectorized candidate discovery (same 4-phase shape as
    zstd/block_enc.py). Returns list of (pos, dist, length), increasing pos,
    non-overlapping."""
    n = src.size
    seqs = []
    if n < 16:
        return seqs
    limit = n - 11  # keep a literal tail like the reference margins
    if limit <= 4:
        return seqs
    a = src.astype(np.uint32)
    w4 = a[:limit] | (a[1 : limit + 1] << 8) | (a[2 : limit + 2] << 16) | (
        a[3 : limit + 3] << 24
    )
    h = _hash_positions(w4)
    order = np.argsort(h, kind="stable")
    prev = np.full(limit, -1, dtype=np.int64)
    same = h[order[1:]] == h[order[:-1]]
    prev[order[1:][same]] = order[:-1][same]
    pos = np.nonzero(prev >= 0)[0]
    cand = prev[pos]
    keep = ((pos - cand) <= MAX_DISTANCE) & (w4[pos] == w4[cand])
    pos, cand = pos[keep], cand[keep]
    if pos.size == 0:
        return seqs
    # common-prefix lengths via the shared zstd machinery (8-byte word
    # rounds + closed-form long-match resolution, zstd/block_enc.py) —
    # byte-at-a-time extension is O(run²) on repetitive inputs
    from .zstd import block_enc as _zb

    hard_cap = np.minimum(np.int64(limit) - pos, 1 << 14)
    w8 = _zb._u64_windows(src)
    mlen = _zb._match_lengths(w8, pos, cand, n, _zb._PeriodBreaks(src),
                              hard_cap=hard_cap)
    # w4 equality guarantees 4 matching bytes (pos+3 <= limit+2 < n), so a
    # near-tail cap below 4 must not drop the match — emit it at 4 like the
    # byte-extension loop always did
    mlen = np.maximum(mlen, 4)
    cur = 0
    k = pos.size
    while True:
        i = int(np.searchsorted(pos, cur))
        if i >= k:
            break
        p = int(pos[i])
        seqs.append((p, int(p - cand[i]), int(mlen[i])))
        cur = p + int(mlen[i])
    return seqs


def compress_into(src: np.ndarray, dst: np.ndarray) -> int:
    """Greedy LZO1X encoder.

    Literal-run rules: runs of 1-3 bytes ride the previous copy command's
    2 trailing-state bits (or the first-byte special 18/19/20 at stream
    start); runs ≥ 4 are standalone commands (only legal in state 0/4, which
    holds because embedded trailing runs are ≤ 3)."""
    n = src.size
    out = bytearray()
    seqs = _find_matches(src)

    def emit_leading_run(lits: np.ndarray) -> None:
        # stream start, state 0
        count = lits.size
        if count == 0:
            return
        if count <= 3:
            out.append(17 + count)
            out.extend(lits.tobytes())
        else:
            _emit_run(out, lits)

    prev = None  # deferred (dist, length) awaiting trailing-run decision
    anchor = 0
    for (p, dist, length) in seqs:
        run = p - anchor
        lits = src[p - run : p]
        if prev is None:
            emit_leading_run(lits)
        else:
            t = run if run <= 3 else 0
            _emit_match(out, prev[0], prev[1], t)
            if t:
                out += lits[:t].tobytes()
            else:
                if run:
                    _emit_run(out, lits)
        prev = (dist, length)
        anchor = p + length
    final = src[anchor:]
    if prev is None:
        emit_leading_run(final)
    else:
        t = final.size if final.size <= 3 else 0
        _emit_match(out, prev[0], prev[1], t)
        if t:
            out += final.tobytes()
        elif final.size:
            _emit_run(out, final)
    out += b"\x11\x00\x00"  # stop command
    if dst.size < len(out):
        raise ValueError("output buffer too small")
    dst[: len(out)] = np.frombuffer(bytes(out), np.uint8)
    return len(out)
