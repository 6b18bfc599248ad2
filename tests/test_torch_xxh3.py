"""The port's XXH3 binding (``xxhash.xxh3``, the system libxxhash) against
the JAX package's, on the CPU.

Seeded random bytes at lengths in every XXH3 length class (0, 1-3, 4-8,
9-16, 17-128, 129-240 and past 240, across the stripe and block edges of
the long path) give the JAX values, 64 and 128 bits, with and without a
seed; streaming in pieces of several sizes gives the one-shot values. The
tolerance is 0. Where libxxhash is absent both tiers are off and the tests
skip, as ``tests/test_aux_codecs.py`` does.
"""

import numpy as np
import pytest

from aircompressor_tpu import xxhash as jax_xxhash
from aircompressor_tpu_torch import xxhash
from aircompressor_tpu_torch.xxhash import xxh3

pytestmark = pytest.mark.skipif(not xxhash.xxh3_is_enabled(), reason="libxxhash unavailable")

DATA = np.random.default_rng(19).integers(0, 256, 70000, dtype=np.uint8).tobytes()
LENGTHS = [0, 1, 2, 3, 4, 5, 8, 9, 12, 16, 17, 31, 64, 100, 128, 129, 150, 240, 241,
           255, 256, 1023, 1024, 1025, 4096, 65536, 70000]
SEEDS = [0, 1, 0x9E3779B185EBCA87, 2**64 - 1]


def test_length_grid_covers_every_class():
    bounds = [(0, 0), (1, 3), (4, 8), (9, 16), (17, 128), (129, 240), (241, len(DATA))]
    assert all(any(lo <= n <= hi for n in LENGTHS) for lo, hi in bounds)


@pytest.mark.parametrize("seed", SEEDS)
def test_xxh3_64_equals_the_jax_binding(seed):
    for n in LENGTHS:
        assert xxhash.xxh3_64(DATA[:n], seed) == jax_xxhash.xxh3_64(DATA[:n], seed), n


@pytest.mark.parametrize("seed", SEEDS)
def test_xxh3_128_equals_the_jax_binding(seed):
    for n in LENGTHS:
        got = xxhash.xxh3_128(DATA[:n], seed)
        want = jax_xxhash.xxh3_128(DATA[:n], seed)
        assert (got.low, got.high) == (want.low, want.high), n
        assert isinstance(got, xxhash.XxHash128)


def test_known_values():
    """XXH3 of the empty input, from the xxHash sanity tests."""
    assert xxhash.xxh3_64(b"") == 0x2D06800538D394C2
    assert xxhash.xxh3_128(b"") == (0x6001C324468D497F, 0x99AA06D3014798D8)


def test_buffers_hash_alike():
    view = memoryview(DATA)[:5000]
    arr = np.frombuffer(DATA[:5000], np.uint8)
    for data in (view, bytearray(DATA[:5000]), arr):
        assert xxhash.xxh3_64(data) == xxhash.xxh3_64(DATA[:5000])
        assert xxhash.xxh3_128(data) == xxhash.xxh3_128(DATA[:5000])


@pytest.mark.parametrize("step", [1, 7, 240, 4096, 7777])
def test_streaming_equals_one_shot(step):
    n = 20000 if step > 1 else 1500
    with xxhash.XxHash3Hasher() as h64, xxhash.XxHash3Hasher128() as h128:
        for i in range(0, n, step):
            assert h64.update(DATA[i:min(i + step, n)]) is h64
            h128.update(DATA[i:min(i + step, n)])
        assert h64.digest() == xxhash.xxh3_64(DATA[:n])
        assert h128.digest() == xxhash.xxh3_128(DATA[:n])
        assert h64.digest() == h64.digest()  # a digest does not end the state
    with jax_xxhash.XxHash3Hasher() as j64:
        j64.update(DATA[:n])
        assert j64.digest() == xxhash.xxh3_64(DATA[:n])


def test_closed_state_is_freed_once():
    h = xxhash.XxHash3Hasher()
    h.close()
    h.close()
    assert h._state is None


def test_struct_return_is_declared_by_value():
    """``XXH128_hash_t`` comes back by value as a two-field Structure, as
    the JAX binding declares it."""
    fields = [(name, t) for name, t in xxh3._XXH128Hash._fields_]
    assert [n for n, _ in fields] == ["low64", "high64"]
    assert all(t is xxh3.ctypes.c_uint64 for _, t in fields)
    assert xxh3._LIB.XXH3_128bits.restype is xxh3._XXH128Hash
    assert xxh3._LIB.XXH3_128bits_digest.restype is xxh3._XXH128Hash
