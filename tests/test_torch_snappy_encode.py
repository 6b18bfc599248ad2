"""The port's Snappy encode against the JAX package's Pallas encode kernel.

``encode_plain`` (what the port runs for CPU tensors, and what the CUDA
kernel is held to on the card) must equal ``snappy_encode_pallas.encode``
byte for byte: ``comp``, ``comp_lens`` and ``ok``. The Pallas kernel runs
in interpret mode here, at Python speed, so it sees one batch of 8 chunks
of at most 2 KB, once for the module. Integer codec: the tolerance is 0.
``SnappyBatchCodec.compress_chunks`` is held to the host decoders and to
the size of the JAX codec's blocks on the same chunks.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aircompressor_tpu.ops import snappy_encode_pallas, snappy_jax  # noqa: E402
from aircompressor_tpu.ops.batch import SnappyBatchCodec as JaxSnappyBatchCodec  # noqa: E402
from aircompressor_tpu.ops.batch import _pack, _selfcheck_payload  # noqa: E402
from aircompressor_tpu.snappy import SnappyRefDecompressor  # noqa: E402
from aircompressor_tpu_torch.ops import snappy_encode  # noqa: E402
from aircompressor_tpu_torch.ops.batch import SnappyBatchCodec, to_device_batch  # noqa: E402
from chip_smoke import backward_cap_case  # noqa: E402

SMALL = 2048  # the interpret-mode Pallas batch: 8 chunks of at most 2 KB
CUT = 16384  # compress_chunks cases: encode_plain steps once per position


def _small_cases() -> list[bytes]:
    text = b"The quick brown fox jumps over the lazy dog. 0123456789 " * 40
    two_bit = np.random.default_rng(6).integers(0, 4, SMALL, dtype=np.uint8)
    return [b"", b"X", text[:SMALL], bytes(SMALL), b"ab" * (SMALL // 2),
            backward_cap_case(), two_bit.tobytes(), _selfcheck_payload(3)[:SMALL]]


@pytest.fixture(scope="module")
def small():
    cases = _small_cases()
    buf, lens = _pack(cases, SMALL)
    want = [np.asarray(a) for a in snappy_encode_pallas.encode(
        jnp.asarray(buf), jnp.asarray(lens))]
    got = [t.numpy() for t in snappy_encode.encode_plain(
        *to_device_batch(buf, lens, "cpu"))]
    return dict(cases=cases, buf=buf, lens=lens, want=want, got=got)


def test_encode_plain_equals_pallas_kernel(small):
    for name, got, want in zip(("comp", "comp_lens", "ok"), small["got"],
                               small["want"]):
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)
    assert small["got"][2].all()


def test_encode_plain_blocks_decode_on_jax_and_host(small):
    comp, comp_lens, _ = small["got"]
    width = int(comp_lens.max())
    out, out_lens, ok = (np.asarray(a) for a in snappy_jax.decode(
        jnp.asarray(comp[:, :width]), jnp.asarray(comp_lens)))
    ref = SnappyRefDecompressor()
    assert ok.all()
    for i, raw in enumerate(small["cases"]):
        assert out[i, :out_lens[i]].tobytes() == raw, i
        blob = comp[i, :comp_lens[i]].tobytes()
        assert bytes(ref.decompress(blob, max(len(raw), 1))) == raw, i
        assert not comp[i, comp_lens[i]:].any(), i  # zero past the length


def test_encode_ignores_bytes_past_each_length(small):
    rng = np.random.default_rng(11)
    noisy = small["buf"].copy()
    for i, n in enumerate(small["lens"]):
        noisy[i, n:] = rng.integers(0, 256, SMALL - n, dtype=np.uint8)
    again = [t.numpy() for t in snappy_encode.encode(
        *to_device_batch(noisy, small["lens"], "cpu"))]
    for got, want in zip(again, small["got"]):
        np.testing.assert_array_equal(got, want)


def _codec_cases(synthetic) -> list[bytes]:
    return [c[:CUT] for _, c in synthetic] + [
        _selfcheck_payload(s)[-CUT:] for s in (1, 2)]


def test_compress_chunks_round_trips_and_is_no_larger_than_jax(synthetic):
    raws = _codec_cases(synthetic)
    before = snappy_encode.launches
    blobs = SnappyBatchCodec(device="cpu").compress_chunks(raws)
    assert snappy_encode.launches == before  # the CPU runs encode_plain
    assert SnappyBatchCodec(device="cpu").decompress_chunks(blobs) == raws
    ref = SnappyRefDecompressor()
    assert [bytes(ref.decompress(b, CUT)) for b in blobs] == raws
    jax_blobs = JaxSnappyBatchCodec().compress_chunks(raws)
    assert sum(map(len, blobs)) <= sum(map(len, jax_blobs))


def test_compress_chunks_empty_and_oversized():
    codec = SnappyBatchCodec(4096, device="cpu")
    assert codec.compress_chunks([]) == []
    with pytest.raises(ValueError):
        codec.compress_chunks([b"x" * 10, b"y" * 4097])


def test_encode_rejects_bad_arguments():
    data = torch.zeros((2, 16), dtype=torch.uint8)
    lens = torch.full((2,), 16, dtype=torch.int32)
    with pytest.raises(TypeError):
        snappy_encode.encode(data.to(torch.int32), lens)
    with pytest.raises(ValueError):
        snappy_encode.encode(torch.zeros((1, 65537), dtype=torch.uint8), lens[:1])
    with pytest.raises(ValueError):
        snappy_encode.encode(data, lens[:1])
    comp, comp_lens, ok = snappy_encode.encode(
        torch.zeros((0, 16), dtype=torch.uint8), torch.zeros(0, dtype=torch.int32))
    assert comp.shape == (0, snappy_encode.OUT_CAP)
    assert comp_lens.shape == ok.shape == (0,)


def _probe_walk(raw: bytes) -> int:
    """The match-search loop's iterations, by a scalar walk of the matcher:
    one per probe of the scan, a hit with its match being one."""
    def u32(p):
        return int.from_bytes(raw[p:p + 4], "little")

    def hash_at(p):
        return ((u32(p) * 0x1E35A7BD) & 0xFFFFFFFF) >> 18

    n, table, ip, skip, count = len(raw), {}, 0, 32, 0
    while ip < n - 15:
        count += 1
        cand = table.get(hash_at(ip), -1)
        table[hash_at(ip)] = ip
        if cand < 0 or u32(cand) != u32(ip):
            ip, skip = ip + (skip >> 5), skip + 1
            continue
        m = 4
        while ip + m < n and raw[ip + m] == raw[cand + m]:
            m += 1
        ip, skip = ip + m, 32
        table[hash_at(ip - 1)] = ip - 1
    return count


def test_with_steps_counts_the_probes_walked():
    """``with_steps`` on the plain version: the probe walk of each chunk
    (5 for ``abcd`` repeated: four misses, then a hit to the end; none for
    a chunk under 16 bytes); the three outputs as without steps."""
    raws = _small_cases() + [b"abcd" * 10, b"x" * 15, _selfcheck_payload(4)[:6000]]
    buf, lens = _pack(raws, 6000)
    data, lengths = to_device_batch(buf, lens, "cpu")
    *outs, steps = snappy_encode.encode(data, lengths, with_steps=True)
    walks = [_probe_walk(r) for r in raws]
    assert steps.tolist() == walks
    assert walks[-3:-1] == [5, 0] and walks[-1] > 100
    for got, want in zip(outs, snappy_encode.encode(data, lengths)):
        assert torch.equal(got, want)
