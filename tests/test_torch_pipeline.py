"""The port's pipelines and its data parallelism over a mesh, against the JAX
package on the CPU.

One seed-made batch of 24 rows of at most 1 KB (``batch``, shared with
``tests/test_torch_roundtrip_step.py``, which holds ``snappy_roundtrip_step``
to the JAX step) goes through both packages. ``pipeline.checksum_step``
must equal the JAX ``pipeline.checksum_step`` exactly (xxh64 as one int64
holding ``(hi << 32) | lo``). On a mesh of 4 CPU slots the ``sharded_*`` functions must equal the
port's unsharded calls and the JAX XLA tiers (``snappy_jax.decode``,
``checksum_jax``), with totals equal to the sums; frames from
``assemble_frames`` must decode with the JAX package's host decoder. The
JAX ``shard_map`` functions are not run: on a CPU mesh they reach
``snappy_pallas_w`` in interpret mode. Integer codecs: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from aircompressor_tpu.ops import checksum_jax, snappy_jax  # noqa: E402
from aircompressor_tpu.ops import pipeline as jax_pipeline  # noqa: E402
from aircompressor_tpu.snappy import SnappyRefDecompressor  # noqa: E402
from aircompressor_tpu_torch import entry  # noqa: E402
from aircompressor_tpu_torch.host import snappy as host_snappy  # noqa: E402
from aircompressor_tpu_torch.host.xxhash import xxh64 as host_xxh64  # noqa: E402
from aircompressor_tpu_torch.ops import pipeline, snappy_decode, snappy_encode  # noqa: E402

B, L = 24, 1024
OUT_CAP = 1232  # >= every row's Snappy block: 32 + L + L / 6
MESH = pipeline.make_mesh([torch.device("cpu")] * 4)


def make_batch():
    """Rows of short periods (long matches: few encode probes on the CPU),
    an empty, a one-byte and an incompressible row, and two of short words."""
    rng = np.random.default_rng(15)
    data = np.stack([np.resize(rng.integers(0, 256, int(p), dtype=np.uint8), L)
                     for p in rng.integers(3, 300, B)])
    data[4] = rng.integers(0, 256, L, dtype=np.uint8)
    words = [rng.integers(0, 256, int(k), dtype=np.uint8) for k in rng.integers(3, 9, 24)]
    for i in (5, 6):
        data[i] = np.concatenate([words[j] for j in rng.integers(0, 24, 400)])[:L]
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lengths[:5] = (0, 1, L, 500, L)
    lengths[5:7] = 350
    for i, n in enumerate(lengths):
        data[i, n:] = 0
    return data, lengths


@pytest.fixture(scope="module")
def batch():
    return make_batch()


@pytest.fixture(scope="module")
def encoded(batch):
    """The port's unsharded encode of the batch."""
    return snappy_encode.encode(*map(torch.from_numpy, batch))


def _u64(t) -> list[int]:
    return [int(v) & (2**64 - 1) for v in t]


@pytest.fixture(scope="module")
def checksums(batch):
    """The port's unsharded checksum step on the batch."""
    return pipeline.checksum_step(*map(torch.from_numpy, batch))


def test_checksum_step_equals_the_jax_step(batch, checksums):
    want = jax.jit(jax_pipeline.checksum_step)(*map(jnp.asarray, batch))
    hi, lo = np.asarray(want["xxh64_hi"]), np.asarray(want["xxh64_lo"])
    assert _u64(checksums["xxh64"]) == [(int(h) << 32) | int(w) for h, w in zip(hi, lo)]
    for key in ("xxh32", "crc32c"):
        assert checksums[key].tolist() == np.asarray(want[key]).astype(np.int64).tolist(), key
    assert checksums["bytes"].dtype == torch.int64
    assert int(checksums["bytes"]) == int(want["bytes"]) == int(batch[1].sum())


def test_f11_lengths_outside_the_row_clamp_in_the_port_only():
    """F11, pinned: at L = 256 and lengths -7, 0, 1, 200, 256 and 261 the two
    steps agree on the in-range rows and on ``"bytes"`` (the raw sum, 711);
    on the -7 and 261 rows the port's three hashes are those of the empty
    row and of the whole row (host tiers), and the JAX tiers', which take
    the raw length, differ from them."""
    from aircompressor_tpu_torch.host.crc32c import crc32c_raw, mask_crc
    from aircompressor_tpu_torch.host.xxhash import xxh32 as host_xxh32

    lengths = np.array([-7, 0, 1, 200, 256, 261], np.int32)
    data = np.random.default_rng(11).integers(0, 256, (lengths.size, 256), dtype=np.uint8)
    got = pipeline.checksum_step(torch.from_numpy(data), torch.from_numpy(lengths))
    want = jax.jit(jax_pipeline.checksum_step)(jnp.asarray(data), jnp.asarray(lengths))
    hi, lo = np.asarray(want["xxh64_hi"]), np.asarray(want["xxh64_lo"])
    jax_values = {"xxh64": [(int(h) << 32) | int(w) for h, w in zip(hi, lo)],
                  "xxh32": np.asarray(want["xxh32"]).astype(np.int64).tolist(),
                  "crc32c": np.asarray(want["crc32c"]).astype(np.int64).tolist()}
    port_values = {"xxh64": _u64(got["xxh64"]), "xxh32": got["xxh32"].tolist(),
                   "crc32c": got["crc32c"].tolist()}
    rows = [data[i, :min(max(int(n), 0), 256)] for i, n in enumerate(lengths)]
    host_values = {"xxh64": [host_xxh64(r) for r in rows],
                   "xxh32": [host_xxh32(r) for r in rows],
                   "crc32c": [mask_crc(crc32c_raw(r)) for r in rows]}
    assert int(got["bytes"]) == int(want["bytes"]) == int(lengths.sum()) == 711
    for key in port_values:
        for i in (1, 2, 3, 4):
            assert port_values[key][i] == jax_values[key][i] == host_values[key][i], (key, i)
        for i in (0, 5):
            assert port_values[key][i] == host_values[key][i], (key, i)
            assert jax_values[key][i] != port_values[key][i], (key, i)
    assert host_values["crc32c"][0] == mask_crc(crc32c_raw(b""))


def test_sharded_checksum_equals_unsharded_and_jax(batch, checksums):
    got = pipeline.sharded_checksum_step(MESH)(*map(torch.from_numpy, batch))
    assert got.keys() == checksums.keys()
    for key in checksums:
        assert torch.equal(got[key], checksums[key]), key
    crc = jax.jit(lambda d, n: checksum_jax.mask_crc(checksum_jax.crc32c(d, n)))(
        *map(jnp.asarray, batch))
    assert got["crc32c"].tolist() == np.asarray(crc).astype(np.int64).tolist()
    assert int(got["bytes"]) == int(batch[1].sum())


def test_sharded_compress_and_decompress(batch, encoded):
    d, n = map(torch.from_numpy, batch)
    comp, comp_lens, total = pipeline.sharded_compress(MESH)(d, n)
    u_comp, u_lens, _ = encoded
    assert comp.shape == (B, snappy_encode.OUT_CAP)
    assert torch.equal(comp, u_comp) and torch.equal(comp_lens, u_lens)
    assert total.dtype == torch.int64 and int(total) == int(comp_lens.sum())

    comp = comp[:, :OUT_CAP]  # the zero tail cut off, as out_cap does it
    out, out_lens, ok, total = pipeline.sharded_decompress(MESH, out_cap=L)(comp, comp_lens)
    for a, b in zip((out, out_lens, ok), snappy_decode.decode(comp, comp_lens, out_cap=L)):
        assert torch.equal(a, b)
    j_out, j_lens, j_ok = snappy_jax.decode(jnp.asarray(comp.numpy()),
                                            jnp.asarray(comp_lens.numpy()), out_cap=L)
    assert np.array_equal(out.numpy(), np.asarray(j_out))
    assert out_lens.tolist() == np.asarray(j_lens).tolist()
    assert ok.tolist() == np.asarray(j_ok).tolist() and bool(ok.all())
    assert int(total) == int(out_lens.sum()) == int(batch[1].sum())

    blobs = pipeline.assemble_frames(comp, comp_lens)
    assert blobs == pipeline.assemble_frames(comp.numpy(), comp_lens.numpy())
    host = SnappyRefDecompressor()
    for i, blob in enumerate(blobs):
        assert host.decompress(blob, L) == batch[0][i, :batch[1][i]].tobytes(), i


def test_out_cap_cuts_the_blocks_and_names_a_chunk_past_it(batch, encoded):
    """Rows 2-5 on a mesh of 2: row 4 (incompressible, the second shard's
    first) is the first block past 1000 bytes; OUT_CAP holds every block."""
    d, n = (torch.from_numpy(a[2:6]) for a in batch)
    mesh = pipeline.make_mesh(["cpu"] * 2)
    comp, comp_lens, _ = pipeline.sharded_compress(mesh, out_cap=OUT_CAP)(d, n)
    assert comp.shape == (4, OUT_CAP) and torch.equal(comp, encoded[0][2:6, :OUT_CAP])
    with pytest.raises(RuntimeError, match="chunk 2 failed to encode within 1000 bytes"):
        pipeline.sharded_compress(mesh, out_cap=1000)(d, n)


@pytest.mark.parametrize("fn", ["checksum", "compress", "decompress"])
def test_a_batch_that_does_not_split_raises(batch, fn):
    mesh = pipeline.make_mesh(["cpu"] * 5)
    step = {"checksum": pipeline.sharded_checksum_step, "compress": pipeline.sharded_compress,
            "decompress": pipeline.sharded_decompress}[fn](mesh)
    with pytest.raises(ValueError, match="24 rows does not split evenly over 5"):
        step(*map(torch.from_numpy, batch))


def test_dryrun_multichip_on_cpu_slots():
    """8 CPU slots, 32 chunks: every chunk decodes to its original, hashes as
    the host does, and the batch is the JAX dryrun's."""
    got = entry.dryrun_multichip(8, device="cpu")
    buf, lens, chunk = __graft_entry__._sample_batch(32)
    assert int(got["bytes"]) == 32 * chunk and bool(got["ok"].all())
    for i in range(32):
        raw = host_snappy.decompress(buf[i, :lens[i]].tobytes(), chunk)
        assert got["out"][i].numpy().tobytes() == raw, i
        assert int(got["xxh64"][i]) & (2**64 - 1) == host_xxh64(raw), i


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.make_mesh()
    with pytest.raises(RuntimeError, match="8 CUDA devices asked for, 0 present"):
        entry.dryrun_multichip(8)
