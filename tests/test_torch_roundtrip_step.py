"""The port's Snappy round-trip step against the JAX package's, on the CPU.

On the batch of ``tests/test_torch_pipeline.py``, ``snappy_roundtrip_step``
(kernel #3, then kernel #1, then the masked CRC32-C) must decode every row
to its input with the JAX ``pipeline.snappy_roundtrip_step``'s CRCs, and
its blocks must be the port's unsharded encode's. The JAX step encodes with
``snappy_encode_jax``, which picks other matches, so the compressed bytes
are not compared across the packages. Integer codecs: the tolerance is 0.
Apart from ``tests/test_torch_pipeline.py`` because the JAX step's first
compile takes ~6 s.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aircompressor_tpu.ops import pipeline as jax_pipeline  # noqa: E402
from aircompressor_tpu_torch.ops import pipeline, snappy_encode  # noqa: E402
from test_torch_pipeline import L, make_batch  # noqa: E402


def test_roundtrip_step_decodes_with_the_jax_crcs():
    data, lengths = batch = make_batch()
    comp, comp_lens, out, out_lens, ok, crc = pipeline.snappy_roundtrip_step(
        *map(torch.from_numpy, batch), L)
    assert bool(ok.all()) and out_lens.tolist() == lengths.tolist()
    assert torch.equal(out, torch.from_numpy(data))
    u_comp, u_lens, _ = snappy_encode.encode(*map(torch.from_numpy, batch))
    assert torch.equal(comp, u_comp) and torch.equal(comp_lens, u_lens)
    step = jax.jit(jax_pipeline.snappy_roundtrip_step, static_argnums=2)
    _, _, j_out, j_lens, j_ok, j_crc = step(*map(jnp.asarray, batch), L)
    assert bool(np.asarray(j_ok).all()) and np.array_equal(np.asarray(j_out), data)
    assert np.asarray(j_lens).tolist() == lengths.tolist()
    assert crc.tolist() == np.asarray(j_crc).astype(np.int64).tolist()
