"""A model of the CRC32-C kernel's lane split and GF(2) combine.

``csrc/crc32c.cu`` checksums a row with one warp: lane k takes a contiguous
segment of ceil(n / 32) bytes rounded up to 32 (kSegAlign), computes the
CRC register over it from 0 by slicing by 8 (32 bytes an iteration, then
byte by byte), and shifts the register across the bytes after its segment
by GF(2) products with the constants x^(8 * 2^j) mod P (kX8Pow); lane 0
adds the initial value's term, the 32 terms are XOR-reduced and inverted.
That cannot run here, so this file models it in numpy, in the kernel's
order, with the constants, polynomial and rounding read from the CUDA
source, and checks:

- the constants are the powers of x that the combine needs;
- the segments are disjoint, cover the row, start at multiples of 32 (the
  aligned variant's 16-byte loads) and do not wrap 32 bits below 2^31;
- the model equals ``crc32c_plain`` (what the port runs for CPU tensors
  and what the kernel is held to on the card), ``checksum_jax.crc32c`` and
  the host ``crc32c_raw`` exactly (integer checksum: tolerance 0) over the
  length grid that ``chip_smoke.py`` gives the kernel, at a 16-aligned
  width and at 65,531;
- a wrong shift constant, and a segment boundary one byte off, each break
  that equality.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aircompressor_tpu.ops import checksum_jax  # noqa: E402
from aircompressor_tpu_torch.host import crc32c as host_crc  # noqa: E402
from aircompressor_tpu_torch.ops import checksum  # noqa: E402

SOURCE = (Path(__file__).resolve().parent.parent / "aircompressor_tpu_torch" / "csrc"
          / "crc32c.cu").read_text()
POLY = int(re.search(r"kPoly = (0x[0-9A-Fa-f]+)u", SOURCE).group(1), 16)
SEG_ALIGN = int(re.search(r"kSegAlign = (\d+);", SOURCE).group(1))
X8POW = [int(v, 16) for v in re.findall(
    r"(0x[0-9A-F]{8})u", SOURCE[SOURCE.index("kX8Pow[32]"):SOURCE.index("};")])]
M32 = 0xFFFFFFFF
# the kernel's length grid in chip_smoke.py
GRID = list(range(36)) + [63, 64, 65, 4095, 4096, 4097, 65536]


def mul_mod_p(a: int, b: int) -> int:
    """a * b mod P, reflected (bit 31 is x^0), as ``mul_mod_p`` does it."""
    p = 0
    for _ in range(32):
        if a >> 31:
            p ^= b
        a = (a << 1) & M32
        b = (b >> 1) ^ (POLY if b & 1 else 0)
    return p


def shift_bytes(c: int, m: int, x8pow=X8POW) -> int:
    """The register c advanced across m zero bytes, as ``shift_bytes``."""
    x, j = 0x80000000, 0
    while m:
        if m & 1:
            x = mul_mod_p(x8pow[j], x)
        m >>= 1
        j += 1
    return mul_mod_p(x, c)


def slicing_tables() -> np.ndarray:
    """t[k][b]: the register after byte b and then k zero bytes, from 0, as
    the block builds them."""
    t = np.zeros((8, 256), np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        t[0, i] = c
    for i in range(256):
        c = int(t[0, i])
        for k in range(1, 8):
            c = (c >> 8) ^ int(t[0, c & 0xFF])
            t[k, i] = c
    return t


T = slicing_tables().tolist()


def segments(n: int, align: int = SEG_ALIGN) -> list[tuple[int, int]]:
    """Each lane's [begin, end), as the kernel computes them."""
    per = n // 32 + (n % 32 != 0)
    seg = -(-per // align) * align
    out = []
    for lane in range(32):
        begin = min(lane * seg, n)
        out.append((begin, min(begin + seg, n)))
    return out


def raw_register(row: np.ndarray, begin: int, end: int) -> int:
    """The register over row[begin:end] from 0: 32 bytes an iteration by
    slicing by 8, then byte by byte."""
    c, pos = 0, begin
    while end - pos >= 32:
        for k in range(pos, pos + 32, 8):
            lo = int.from_bytes(row[k:k + 4].tobytes(), "little") ^ c
            hi = int.from_bytes(row[k + 4:k + 8].tobytes(), "little")
            c = (T[7][lo & 0xFF] ^ T[6][(lo >> 8) & 0xFF] ^ T[5][(lo >> 16) & 0xFF]
                 ^ T[4][lo >> 24] ^ T[3][hi & 0xFF] ^ T[2][(hi >> 8) & 0xFF]
                 ^ T[1][(hi >> 16) & 0xFF] ^ T[0][hi >> 24])
        pos += 32
    for pos in range(pos, end):
        c = T[0][(c ^ int(row[pos])) & 0xFF] ^ (c >> 8)
    return c


def model_crc32c(data: np.ndarray, lengths: np.ndarray, x8pow=X8POW,
                 boundary_slip: int = 0) -> list[int]:
    """The kernel's CRC32-C of each row. ``boundary_slip`` moves every lane's
    segment end by that many bytes while the shift still counts from the
    true end (a mutation)."""
    L = data.shape[1]
    out = []
    for row, n in zip(data, lengths):
        n = min(max(int(n), 0), L)
        v = shift_bytes(M32, n, x8pow)  # lane 0's term of the initial value
        for begin, end in segments(n):
            c = raw_register(row, begin, min(max(end + boundary_slip, begin), n))
            if c:
                v ^= shift_bytes(c, n - end, x8pow)
        out.append(~v & M32)
    return out


def _batch(width: int, seed: int = 11):
    lengths = np.array([min(n, width) for n in GRID], np.int32)
    data = np.random.default_rng(seed).integers(0, 256, (len(GRID), width), dtype=np.uint8)
    return data, lengths


def test_source_constants_are_the_powers_of_x():
    assert POLY == host_crc.POLY_REFLECTED
    assert SEG_ALIGN % 16 == 0
    x = 1 << 30  # x^1
    powers = [x]
    for _ in range(40):
        powers.append(mul_mod_p(powers[-1], powers[-1]))  # x^(2^i)
    assert X8POW == powers[3:35]


def test_slicing_tables_extend_the_byte_table():
    t = slicing_tables()
    np.testing.assert_array_equal(t[0], host_crc.byte_table())
    for k in range(1, 8):  # t[k][b] is byte b's term shifted by k bytes
        for b in (1, 0x80, 0xFF):
            assert int(t[k, b]) == shift_bytes(int(t[0, b]), k)


def test_segments_cover_the_row():
    for n in list(range(0, 1100)) + [4095, 65531, 65536, 2**31 - 1]:
        segs = segments(n)
        assert segs[0][0] == 0 and segs[-1][1] == n, n
        for (b0, e0), (b1, _) in zip(segs, segs[1:]):
            assert b0 <= e0 == b1, n  # disjoint and contiguous, in lane order
        assert all(b % SEG_ALIGN == 0 or b == n for b, _ in segs), n
        seg = segs[0][1] - segs[0][0]
        assert seg == 0 or seg >= -(-n // 32), n
        assert 31 * seg < n + 1024 and seg < 2**26 + 32, n  # the kernel's 32-bit math


@pytest.mark.parametrize("width", [65536, 65531])
def test_model_equals_plain_jax_and_host(width):
    data, lengths = _batch(width)
    got = model_crc32c(data, lengths)
    plain = checksum.crc32c_plain(torch.from_numpy(data), torch.from_numpy(lengths))
    assert got == plain.tolist()
    want = np.asarray(jax.jit(checksum_jax.crc32c)(jnp.asarray(data), jnp.asarray(lengths)))
    assert got == want.astype(np.int64).tolist()
    assert got == [host_crc.crc32c_raw(data[i, :n]) for i, n in enumerate(lengths)]


def test_model_clamps_lengths_as_plain():
    data, _ = _batch(300)
    lengths = np.array([-5, 0, 299, 300, 301, 10**6] + [7] * (len(GRID) - 6), np.int32)
    plain = checksum.crc32c_plain(torch.from_numpy(data), torch.from_numpy(lengths))
    assert model_crc32c(data, lengths) == plain.tolist()
    assert checksum.crc32c(torch.from_numpy(data), torch.from_numpy(lengths)).tolist() == (
        plain.tolist())


@pytest.mark.parametrize("mutation", ["constant", "boundary+1", "boundary-1"])
def test_mutations_break_the_model(mutation):
    data, lengths = _batch(4100, seed=3)
    plain = checksum.crc32c_plain(torch.from_numpy(data), torch.from_numpy(lengths)).tolist()
    assert model_crc32c(data, lengths) == plain
    if mutation == "constant":  # x^(8 * 2^5), used by every shift across >= 32 bytes
        x8pow = list(X8POW)
        x8pow[5] ^= 1 << 7
        got = model_crc32c(data, lengths, x8pow=x8pow)
    else:
        got = model_crc32c(data, lengths, boundary_slip=1 if mutation == "boundary+1" else -1)
    assert got != plain
