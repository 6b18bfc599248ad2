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
