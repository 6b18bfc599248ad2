"""The port's XXH64 and XXH32 against the JAX package and the scalar host tier.

``xxh64_plain`` (what the port runs for CPU tensors, and what the CUDA
kernel is held to on the card) must equal ``(hi << 32) | lo`` of
``xxhash_jax.xxh64`` and of the Pallas stripe kernel ``xxhash_pallas.xxh64``
(interpret mode here), and ``_scalar.xxh64``, exactly, over every tail class.
``xxh32_plain`` must equal ``xxhash_jax.xxh32`` (XLA; the JAX package has no
Pallas XXH32) and ``_scalar.xxh32`` the same way.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aircompressor_tpu.ops import xxhash_jax, xxhash_pallas  # noqa: E402
from aircompressor_tpu.xxhash import _scalar  # noqa: E402
from aircompressor_tpu_torch.host import xxhash as host_xxhash  # noqa: E402
from aircompressor_tpu_torch.ops import xxhash  # noqa: E402

M64 = (1 << 64) - 1


def _batch(L: int, lens: list[int], seed: int):
    rng = np.random.default_rng(seed)
    lengths = np.array([min(L, v) for v in lens], dtype=np.int32)
    data = rng.integers(0, 256, (lengths.size, L), dtype=np.uint8)
    for i, n in enumerate(lengths):
        data[i, n:] = 0
    return data, lengths


def _u64(t: torch.Tensor) -> list[int]:
    return [int(v) & M64 for v in t]


def _jax_u64(hi, lo) -> list[int]:
    return [(int(h) << 32) | int(l) for h, l in zip(np.asarray(hi), np.asarray(lo))]


@pytest.mark.parametrize("seed", [0, 0x9E3779B185EBCA87])
def test_xxh64_plain_matches_xxhash_jax_and_scalar(seed):
    # the length grid of tests/test_ops_jax.py
    data, lengths = _batch(256, list(range(36)) + [47, 48, 63, 64, 65, 100, 256], 42)
    got = _u64(xxhash.xxh64_plain(torch.from_numpy(data),
                                  torch.from_numpy(lengths), seed=seed))
    want = _jax_u64(*xxhash_jax.xxh64(jnp.asarray(data), jnp.asarray(lengths),
                                      seed=seed))
    assert got == want
    assert got == [_scalar.xxh64(data[i, :n].tobytes(), seed=seed)
                   for i, n in enumerate(lengths)]


def test_xxh64_plain_matches_pallas_stripe_kernel():
    L = 512
    lens = (list(range(48)) + [63, 64, 65, 100, 255, 256, 257, L]) * 4
    data, lengths = _batch(L, lens[:128], 7)
    got = _u64(xxhash.xxh64(torch.from_numpy(data), torch.from_numpy(lengths)))
    assert got == _jax_u64(*xxhash_pallas.xxh64(jnp.asarray(data),
                                                jnp.asarray(lengths)))


@pytest.mark.parametrize("L", [0, 1, 77, 100])
def test_xxh64_any_width_and_clamped_lengths(L):
    """Any L (the JAX contract needs L % 256 == 0); lengths clamp to [0, L]."""
    rng = np.random.default_rng(L)
    data = rng.integers(0, 256, (6, L), dtype=np.uint8)
    lengths = np.array([0, L // 2, L, L + 9, -3, max(L - 1, 0)], np.int32)
    got = _u64(xxhash.xxh64(torch.from_numpy(data), torch.from_numpy(lengths)))
    assert got == [_scalar.xxh64(data[i, :min(max(n, 0), L)].tobytes())
                   for i, n in enumerate(lengths)]


def test_xxh64_rejects_bad_arguments():
    with pytest.raises(TypeError):
        xxhash.xxh64(torch.zeros((2, 8), dtype=torch.int32),
                     torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        xxhash.xxh64(torch.zeros((2, 8), dtype=torch.uint8),
                     torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("seed", [0, 0x9E3779B1])
def test_xxh32_plain_matches_xxhash_jax_and_scalar(seed):
    lens = list(range(101)) + [127, 128, 255, 256]
    data, lengths = _batch(256, lens, 43)
    got = xxhash.xxh32_plain(torch.from_numpy(data), torch.from_numpy(lengths),
                             seed=seed).tolist()
    want = np.asarray(xxhash_jax.xxh32(jnp.asarray(data), jnp.asarray(lengths),
                                       seed=seed)).tolist()
    assert got == want
    assert got == [_scalar.xxh32(data[i, :n].tobytes(), seed=seed)
                   for i, n in enumerate(lengths)]


@pytest.mark.parametrize("L", [0, 1, 77, 100])
def test_xxh32_any_width_and_clamped_lengths(L):
    """Any L (the JAX contract needs L % 128 == 0); lengths clamp to [0, L]."""
    rng = np.random.default_rng(L + 1)
    data = rng.integers(0, 256, (6, L), dtype=np.uint8)
    lengths = np.array([0, L // 2, L, L + 9, -3, max(L - 1, 0)], np.int32)
    got = xxhash.xxh32(torch.from_numpy(data), torch.from_numpy(lengths)).tolist()
    assert got == [_scalar.xxh32(data[i, :min(max(n, 0), L)].tobytes())
                   for i, n in enumerate(lengths)]


def test_xxh32_rejects_bad_arguments():
    with pytest.raises(TypeError):
        xxhash.xxh32(torch.zeros((2, 8), dtype=torch.int32),
                     torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        xxhash.xxh32(torch.zeros((2, 8), dtype=torch.uint8),
                     torch.zeros(3, dtype=torch.int32))


SEED_LENGTHS = [0, 3, 31, 32, 33, 1000]


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B1, (1 << 64) - 1])
def test_xxh64_takes_a_seed(seed):
    """The wrapper (the plain version, for CPU tensors) at a seed equals
    ``xxhash_jax.xxh64`` and the host tier at that seed."""
    data, lengths = _batch(1024, SEED_LENGTHS, 44)
    got = _u64(xxhash.xxh64(torch.from_numpy(data), torch.from_numpy(lengths), seed))
    want = _jax_u64(*xxhash_jax.xxh64(jnp.asarray(data), jnp.asarray(lengths),
                                      seed=seed))
    assert got == want
    assert got == [host_xxhash.xxh64(data[i, :n], seed) for i, n in enumerate(lengths)]


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B1, (1 << 32) - 1])
def test_xxh32_takes_a_seed(seed):
    data, lengths = _batch(1024, SEED_LENGTHS, 45)
    got = xxhash.xxh32(torch.from_numpy(data), torch.from_numpy(lengths), seed).tolist()
    want = np.asarray(xxhash_jax.xxh32(jnp.asarray(data), jnp.asarray(lengths),
                                       seed=seed)).tolist()
    assert got == want
    assert got == [host_xxhash.xxh32(data[i, :n], seed) for i, n in enumerate(lengths)]


def _lanes_then_merge(row: bytes, seed: int) -> int:
    """XXH64 as the kernel computes it: four accumulators, each over its own
    8 bytes of every stripe and computed apart from the others (one lane
    each), then one lane's merge, tail and avalanche in the reference's
    order."""
    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M64

    def rnd(acc, lane):
        return rotl((acc + lane * xxhash.P64_2) & M64, 31) * xxhash.P64_1 & M64

    def le(at, n):
        return int.from_bytes(row[at:at + n], "little")

    p1, p2 = xxhash.P64_1 & M64, xxhash.P64_2 & M64
    n, stripes = len(row), len(row) // 32
    inits = [seed + p1 + p2, seed + p2, seed, seed - p1]
    v = []
    for j in range(4):  # one lane's accumulator, alone
        acc = inits[j] & M64
        for s in range(stripes):
            acc = rnd(acc, le(32 * s + 8 * j, 8))
        v.append(acc)
    if n >= 32:
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & M64
        for acc in v:
            h = ((h ^ rnd(0, acc)) * p1 + (xxhash.P64_4 & M64)) & M64
    else:
        h = (seed + (xxhash.P64_5 & M64)) & M64
    h = (h + n) & M64
    off = 32 * stripes
    while off + 8 <= n:
        h = (rotl(h ^ rnd(0, le(off, 8)), 27) * p1 + (xxhash.P64_4 & M64)) & M64
        off += 8
    if off + 4 <= n:
        h = (rotl(h ^ (le(off, 4) * p1 & M64), 23) * p2 + (xxhash.P64_3 & M64)) & M64
        off += 4
    while off < n:
        h = rotl(h ^ (row[off] * (xxhash.P64_5 & M64) & M64), 11) * p1 & M64
        off += 1
    h ^= h >> 33
    h = h * p2 & M64
    h ^= h >> 29
    h = h * (xxhash.P64_3 & M64) & M64
    return h ^ (h >> 32)


@pytest.mark.parametrize("seed", [0, 0x9E3779B1])
def test_four_accumulators_merged_as_the_kernel_merges_them(seed):
    """Lengths 0-65 and 65,536: the kernel's split of the stripe loop over
    four lanes, merged by one, equals ``xxh64_plain``."""
    lens = list(range(66)) + [65536]
    data, lengths = _batch(65536, lens, 46)
    plain = _u64(xxhash.xxh64_plain(torch.from_numpy(data), torch.from_numpy(lengths), seed))
    assert [_lanes_then_merge(data[i, :n].tobytes(), seed)
            for i, n in enumerate(lengths)] == plain


M32 = (1 << 32) - 1


def _xxh32_lanes_then_merge(row: bytes, seed: int) -> int:
    """XXH32 as the kernel computes it: four accumulators, each over its own
    4 bytes of every 16-byte stripe and computed apart from the others (one
    lane each), then one lane's rotate-sum, length add, tail of <= 3 words
    and <= 3 bytes, and avalanche in the reference's order."""
    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M32

    def le(at, n):
        return int.from_bytes(row[at:at + n], "little")

    n, stripes = len(row), len(row) // 16
    inits = [seed + xxhash.P32_1 + xxhash.P32_2, seed + xxhash.P32_2, seed,
             seed - xxhash.P32_1]
    v = []
    for j in range(4):  # one lane's accumulator, alone
        acc = inits[j] & M32
        for s in range(stripes):
            acc = rotl((acc + le(16 * s + 4 * j, 4) * xxhash.P32_2) & M32, 13) * xxhash.P32_1 & M32
        v.append(acc)
    if n >= 16:
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & M32
    else:
        h = (seed + xxhash.P32_5) & M32
    h = (h + n) & M32
    off = 16 * stripes
    while off + 4 <= n:
        h = rotl((h + le(off, 4) * xxhash.P32_3) & M32, 17) * xxhash.P32_4 & M32
        off += 4
    while off < n:
        h = rotl((h + row[off] * xxhash.P32_5) & M32, 11) * xxhash.P32_1 & M32
        off += 1
    h = (h ^ (h >> 15)) * xxhash.P32_2 & M32
    h = (h ^ (h >> 13)) * xxhash.P32_3 & M32
    return h ^ (h >> 16)


@pytest.mark.parametrize("seed", [0, 0x9E3779B1])
def test_xxh32_four_accumulators_merged_as_the_kernel_merges_them(seed):
    """Lengths 0-65 and 65,536 in rows of 65,536 bytes (a multiple of 16 *
    UNROLL, as ``xxhash_jax.xxh32`` asserts): the kernel's split of the
    stripe loop over four lanes, merged by one, equals ``xxh32_plain`` and
    ``xxhash_jax.xxh32``."""
    lens = list(range(66)) + [65536]
    data, lengths = _batch(65536, lens, 47)
    plain = xxhash.xxh32_plain(torch.from_numpy(data), torch.from_numpy(lengths), seed).tolist()
    want = np.asarray(xxhash_jax.xxh32(jnp.asarray(data), jnp.asarray(lengths),
                                       seed=seed)).tolist()
    got = [_xxh32_lanes_then_merge(data[i, :n].tobytes(), seed) for i, n in enumerate(lengths)]
    assert got == plain == want
