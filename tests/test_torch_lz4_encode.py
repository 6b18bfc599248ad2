"""The port's LZ4 encode against the JAX package's Pallas encode kernel.

``encode_plain`` (what the port runs for CPU tensors, and what the CUDA
kernel is held to on the card) must equal ``lz4_encode_pallas.encode`` byte
for byte: ``comp``, ``comp_lens`` and ``ok``. The Pallas kernel runs in
interpret mode here, at Python speed (about 21 s), so it sees one batch of 8
chunks of at most 2 KB, once for the module. The XLA stand-in
``lz4_encode_jax`` picks other matches and is no reference for the bytes.
Integer codec: the tolerance is 0. ``Lz4BatchCodec.compress_chunks`` is
held to the host decoders and to the size of the JAX codec's blocks on the
same chunks.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aircompressor_tpu.lz4 import Lz4RefDecompressor  # noqa: E402
from aircompressor_tpu.ops import lz4_encode_pallas, lz4_jax  # noqa: E402
from aircompressor_tpu.ops.batch import Lz4BatchCodec as JaxLz4BatchCodec  # noqa: E402
from aircompressor_tpu.ops.batch import _pack, _selfcheck_payload  # noqa: E402
from aircompressor_tpu_torch.ops import lz4_encode  # noqa: E402
from aircompressor_tpu_torch.ops.batch import Lz4BatchCodec, to_device_batch  # noqa: E402
from chip_smoke import backward_cap_case, lz4_length_edges_case  # noqa: E402

SMALL = 2048  # the interpret-mode Pallas batch: 8 chunks of at most 2 KB
CUT = 8192  # compress_chunks cases: encode_plain steps once per probe


def _small_cases() -> list[bytes]:
    text = b"The quick brown fox jumps over the lazy dog. 0123456789 " * 40
    two_bit = np.random.default_rng(6).integers(0, 4, SMALL, dtype=np.uint8)
    return [b"", b"X", text[:SMALL], bytes(SMALL), b"ab" * (SMALL // 2),
            backward_cap_case(1000, 200), two_bit.tobytes(),
            _selfcheck_payload(3)[:SMALL]]


@pytest.fixture(scope="module")
def small():
    cases = _small_cases()
    buf, lens = _pack(cases, SMALL)
    want = [np.asarray(a) for a in lz4_encode_pallas.encode(
        jnp.asarray(buf), jnp.asarray(lens))]
    got = [t.numpy() for t in lz4_encode.encode_plain(
        *to_device_batch(buf, lens, "cpu"))]
    return dict(cases=cases, buf=buf, lens=lens, want=want, got=got)


def test_encode_plain_equals_pallas_kernel(small):
    for name, got, want in zip(("comp", "comp_lens", "ok"), small["got"],
                               small["want"]):
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)
    assert small["got"][2].all()


def _decode_everywhere(comp, comp_lens, raws):
    """Each block decodes to its original through lz4_jax and the host
    decoder, and its row is zero past its length."""
    width = int(comp_lens.max())
    out, out_lens, ok = (np.asarray(a) for a in lz4_jax.decode(
        jnp.asarray(comp[:, :width]), jnp.asarray(comp_lens)))
    ref = Lz4RefDecompressor()
    assert ok.all()
    for i, raw in enumerate(raws):
        assert out[i, :out_lens[i]].tobytes() == raw, i
        blob = comp[i, :comp_lens[i]].tobytes()
        assert bytes(ref.decompress(blob, max(len(raw), 1))) == raw, i
        assert not comp[i, comp_lens[i]:].any(), i


def test_encode_plain_blocks_decode_on_jax_and_host(small):
    comp, comp_lens, _ = small["got"]
    _decode_everywhere(comp, comp_lens, small["cases"])


def _sequences(blob: bytes) -> list[tuple[int, int]]:
    """(literal run, match length) of each sequence of an LZ4 block; 0 for
    the match of the last one."""
    seqs, i = [], 0

    def length(n):
        nonlocal i
        while n >= 15:
            b = blob[i]
            i += 1
            n += b
            if b != 255:
                break
        return n

    while True:
        token = blob[i]
        i += 1
        lit = length(token >> 4) if token >> 4 == 15 else token >> 4
        i += lit
        if i == len(blob):
            return seqs + [(lit, 0)]
        i += 2
        ml = length(token & 15) if token & 15 == 15 else token & 15
        seqs.append((lit, ml + 4))


def test_encode_plain_writes_zero_ending_length_extensions():
    """Literal runs and matches less 4 of 15, 270 and 525 bytes end their
    255-extension with a 0 byte, which is always written."""
    raw = lz4_length_edges_case()
    buf, lens = _pack([raw], len(raw))
    comp, comp_lens, ok = (t.numpy() for t in lz4_encode.encode_plain(
        *to_device_batch(buf, lens, "cpu")))
    assert ok.all()
    _decode_everywhere(comp, comp_lens, [raw])
    assert _sequences(comp[0, :comp_lens[0]].tobytes()) == [
        (600, 19), (15, 274), (270, 529), (15, 19), (525, 0)]


def test_encode_ignores_bytes_past_each_length(small):
    rng = np.random.default_rng(11)
    noisy = small["buf"].copy()
    for i, n in enumerate(small["lens"]):
        noisy[i, n:] = rng.integers(0, 256, SMALL - n, dtype=np.uint8)
    again = [t.numpy() for t in lz4_encode.encode(
        *to_device_batch(noisy, small["lens"], "cpu"))]
    for got, want in zip(again, small["got"]):
        np.testing.assert_array_equal(got, want)


def _codec_cases(synthetic) -> list[bytes]:
    return [c[:CUT] for _, c in synthetic] + [
        _selfcheck_payload(s)[-CUT:] for s in (1, 2)]


def test_compress_chunks_round_trips_and_is_no_larger_than_jax(synthetic):
    raws = _codec_cases(synthetic)
    before = lz4_encode.launches
    blobs = Lz4BatchCodec(device="cpu").compress_chunks(raws)
    assert lz4_encode.launches == before  # the CPU runs encode_plain
    assert Lz4BatchCodec(device="cpu").decompress_chunks(blobs) == raws
    ref = Lz4RefDecompressor()
    assert [bytes(ref.decompress(b, CUT)) for b in blobs] == raws
    jax_blobs = JaxLz4BatchCodec().compress_chunks(raws)
    assert sum(map(len, blobs)) <= sum(map(len, jax_blobs))


def test_compress_chunks_empty_and_oversized():
    codec = Lz4BatchCodec(4096, device="cpu")
    assert codec.compress_chunks([]) == []
    with pytest.raises(ValueError):
        codec.compress_chunks([b"x" * 10, b"y" * 4097])


def test_encode_rejects_bad_arguments():
    data = torch.zeros((2, 16), dtype=torch.uint8)
    lens = torch.full((2,), 16, dtype=torch.int32)
    with pytest.raises(TypeError):
        lz4_encode.encode(data.to(torch.int32), lens)
    with pytest.raises(ValueError):
        lz4_encode.encode(torch.zeros((1, 65537), dtype=torch.uint8), lens[:1])
    with pytest.raises(ValueError):
        lz4_encode.encode(data, lens[:1])
    comp, comp_lens, ok = lz4_encode.encode(
        torch.zeros((0, 16), dtype=torch.uint8), torch.zeros(0, dtype=torch.int32))
    assert comp.shape == (0, lz4_encode.OUT_CAP)
    assert comp_lens.shape == ok.shape == (0,)


def _probe_walk(raw: bytes) -> int:
    """The match-search loop's iterations, by a scalar walk of the matcher:
    one per probe of the scan, a hit with its sequence being one."""
    def u32(p):
        return int.from_bytes(raw[p:p + 4], "little")

    def hash_at(p):
        return ((u32(p) * 2654435761) & 0xFFFFFFFF) >> 18

    n, table, ip, skip, count = len(raw), {}, 0, 64, 0
    while ip < n - 12:
        count += 1
        cand = table.get(hash_at(ip), -1)
        table[hash_at(ip)] = ip
        if cand < 0 or u32(cand) != u32(ip):
            ip, skip = ip + (skip >> 6), skip + 1
            continue
        m = 4
        while ip + m < n - 5 and raw[ip + m] == raw[cand + m]:
            m += 1
        ip, skip = ip + m, 64
        table[hash_at(ip - 2)] = ip - 2
    return count


def test_with_steps_counts_the_probes_walked():
    """``with_steps`` on the plain version: the probe walk of each chunk
    (5 for ``abcd`` repeated: four misses, then a hit to len - 5; 2 for 15
    equal bytes); the three outputs as without steps."""
    raws = _small_cases() + [b"abcd" * 10, b"x" * 15, _selfcheck_payload(4)[:6000]]
    buf, lens = _pack(raws, 6000)
    data, lengths = to_device_batch(buf, lens, "cpu")
    *outs, steps = lz4_encode.encode(data, lengths, with_steps=True)
    walks = [_probe_walk(r) for r in raws]
    assert steps.tolist() == walks
    assert walks[-3:-1] == [5, 2] and walks[-1] > 100
    for got, want in zip(outs, lz4_encode.encode(data, lengths)):
        assert torch.equal(got, want)
