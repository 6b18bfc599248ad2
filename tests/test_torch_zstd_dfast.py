"""The port's DFAST matcher against the JAX package's Pallas kernel.

``find_sequences_plain`` (what the port runs for CPU tensors, and what the
CUDA kernel is held to on the card) must give every output of
``zstd_dfast_pallas.find_sequences_batch``, run here in interpret mode on
one grid step of 8 chunks: ``ll``, ``ml`` and ``of`` up to each chunk's
``nseq``, ``nseq``, ``last_lit`` and ``ok``, exactly (an integer matcher:
the tolerance is 0). The chunks are at most 8 KB: the plain version steps
once per probe. The port's ``_verify_proposals`` must agree with the JAX
package's on sound and unsound proposals.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aircompressor_tpu.ops import zstd_dfast_pallas as dk  # noqa: E402
from aircompressor_tpu.ops import zstd_encode_jax as ze  # noqa: E402
from aircompressor_tpu_torch.host.zstd import device_enc  # noqa: E402
from aircompressor_tpu_torch.ops import zstd_dfast  # noqa: E402
from chip_smoke import DFAST_CUT, REP_A, REP_D, REP_G, REP_M, dfast_cases  # noqa: E402

CUT = DFAST_CUT
A, D, M, G = REP_A, REP_D, REP_M, REP_G


def _probes(stop: int) -> list[int]:
    """The scan's probe positions from 0 while no match is found."""
    out, p = [], 0
    while p < stop:
        out.append(p)
        p += 1 + (p >> 8)
    return out


def _batch(chunks):
    buf = np.zeros((len(chunks), CUT), np.uint8)
    for i, c in enumerate(chunks):
        buf[i, :len(c)] = np.frombuffer(c, np.uint8)
    return buf, np.array([len(c) for c in chunks], np.int32)


@pytest.fixture(scope="module")
def outputs():
    chunks = dfast_cases()
    buf, lens = _batch(chunks)
    want = [np.asarray(t) for t in dk.find_sequences_batch(jnp.asarray(buf), jnp.asarray(lens))]
    got = [t.numpy() for t in zstd_dfast.find_sequences(torch.from_numpy(buf),
                                                        torch.from_numpy(lens))]
    return chunks, got, want


def test_plain_equals_the_pallas_kernel(outputs):
    chunks, got, want = outputs
    nseq = want[3]
    assert np.array_equal(got[3], nseq)
    assert np.array_equal(got[4], want[4])
    assert np.array_equal(got[5], want[5]) and got[5].all()
    for i in range(len(chunks)):
        for k in range(3):
            assert np.array_equal(got[k][i, :nseq[i]], want[k][i, :nseq[i]]), (i, k)
    assert not any(got[k][i, nseq[i]:].any() for k in range(3) for i in range(len(chunks)))
    assert nseq[:3].tolist() == [1, 1, 1] and nseq[3] == 0 and nseq[4:7].min() > 5


def test_the_repeat_chunk_takes_a_repcode_and_a_long_backward_extension(outputs):
    """The first match starts exactly at A, but no probe in [A, A + 33) had
    its source D back in the tables (every table entry is a probe position),
    so it was found at least 33 bytes in and extended back to A. The second
    starts at B, the position after a probe (G < 256 keeps the scan's step
    at 1 after the first match): the repeat offset D at ip + 1, which has
    priority over both tables."""
    chunks, got, _ = outputs
    i = len(chunks) - 1
    assert got[3][i] == 2
    assert (got[0][i, :2].tolist(), got[2][i, :2].tolist()) == ([A, G], [D, D])
    assert got[1][i, 0] == M
    probes = set(_probes(A + 33))
    assert not [p for p in probes if p >= A and p - D in probes]


def test_bytes_past_the_length_do_not_matter(outputs):
    chunks, got, _ = outputs
    buf, lens = _batch(chunks)
    for i, n in enumerate(lens):
        buf[i, n:] = np.random.default_rng(i).integers(0, 256, CUT - n, dtype=np.uint8)
    again = zstd_dfast.find_sequences(torch.from_numpy(buf[:4]), torch.from_numpy(lens[:4]))
    for g, a in zip(got, again):
        assert np.array_equal(g[:4], a.numpy())


def test_find_sequences_checks_its_arguments():
    with pytest.raises(TypeError):
        zstd_dfast.find_sequences(torch.zeros((2, 8), dtype=torch.int32),
                                  torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        zstd_dfast.find_sequences(torch.zeros((2, 65537), dtype=torch.uint8),
                                  torch.zeros(2, dtype=torch.int32))
    ll, ml, of, nseq, last, ok = zstd_dfast.find_sequences(
        torch.zeros((0, 64), dtype=torch.uint8), torch.zeros(0, dtype=torch.int32))
    assert ll.shape == (0, zstd_dfast.SEQ_CAP) and nseq.shape == ok.shape == (0,)


def _proposals(outputs, i):
    chunks, got, _ = outputs
    m = got[3][i]
    data = np.frombuffer(chunks[i], np.uint8)
    return data, [got[k][i, :m].astype(np.int64) for k in range(3)], int(got[4][i])


@pytest.mark.parametrize("fault", ["none", "offset", "short", "coverage", "content"])
def test_verify_proposals_equals_the_jax_check(outputs, fault):
    data, (ll, ml, of), last = _proposals(outputs, 4)
    ll, ml, of = ll.copy(), ml.copy(), of.copy()
    if fault == "offset":  # reaches before the chunk
        of[0] = ll[0] + 1
    elif fault == "short":
        ml[1], ll[1] = 3, ll[1] + ml[1] - 3
    elif fault == "coverage":
        last += 1
    elif fault == "content":  # a real offset that points at other bytes
        of[2] += 1
    args = (data, ll, ml, of, last, dk.MIN_MATCH)
    assert device_enc._verify_proposals(*args) == ze._verify_proposals(*args) == (
        fault == "none")
