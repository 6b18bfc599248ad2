"""The port's LZ4 decode against the JAX package and the host decoder.

``decode_plain`` (what the port runs for CPU tensors, and what the CUDA
kernel is held to on the card) is compared with the JAX package's XLA tier
``lz4_jax.decode`` and with ``Lz4RefDecompressor``, exactly: these are
integer codecs, so the tolerance is 0. ``out_lens`` is compared with
``lz4_jax`` only where ``ok``, because ``lz4_jax`` zeroes it on malformed
chunks while the kernels report the bytes produced before the failure.
``lz4_jax`` accepts a block that ends with a match (ROADMAP F6), where the
Pallas kernel and the host decoder reject it; the port follows the Pallas
kernel, whose values on those blocks were recorded from an interpret-mode
run (``chip_smoke.LZ4_EDGE_BLOCKS``): the interpreter takes about 75 s here.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aircompressor_tpu.errors import MalformedInputException  # noqa: E402
from aircompressor_tpu.lz4 import Lz4RefDecompressor  # noqa: E402
from aircompressor_tpu.ops import lz4_jax  # noqa: E402
from aircompressor_tpu.ops.batch import _pack, _selfcheck_payload  # noqa: E402
from aircompressor_tpu_torch.errors import MalformedInputException as PortMalformed  # noqa: E402
from aircompressor_tpu_torch.host import lz4 as host_lz4  # noqa: E402
from aircompressor_tpu_torch.ops import lz4_decode  # noqa: E402
from aircompressor_tpu_torch.ops.batch import Lz4BatchCodec, to_device_batch  # noqa: E402
from chip_smoke import (  # noqa: E402
    LZ4_EDGE_BLOCKS, lz4_length_edges_case, lz4_malformed_cases)


def _host(blob: bytes, max_len: int = 65536):
    try:
        return bytes(Lz4RefDecompressor().decompress(blob, max_len))
    except MalformedInputException:
        return None


@pytest.fixture(scope="module")
def case(synthetic):
    raws = [c for _, c in synthetic] + [
        lz4_length_edges_case(), _selfcheck_payload(), _selfcheck_payload(7)]
    blobs = [host_lz4.compress(r) for r in raws] + lz4_malformed_cases(
        host_lz4.compress)
    buf, lens = _pack(blobs, max(len(b) for b in blobs) + 5)
    out, out_lens, ok = (t.numpy() for t in lz4_decode.decode_plain(
        *to_device_batch(buf, lens, "cpu")))
    j_out, j_lens, j_ok = (np.asarray(a) for a in lz4_jax.decode(
        jnp.asarray(buf), jnp.asarray(lens)))
    return dict(raws=raws, blobs=blobs, out=out, out_lens=out_lens, ok=ok,
                j_out=j_out, j_lens=j_lens, j_ok=j_ok,
                host=[_host(b) for b in blobs])


def test_decode_plain_matches_lz4_jax(case):
    ok = case["ok"]
    agree = np.array([(h is not None) == bool(j) for h, j in
                      zip(case["host"], case["j_ok"])])
    np.testing.assert_array_equal(ok[agree], case["j_ok"][agree])
    np.testing.assert_array_equal(case["out"][ok], case["j_out"][ok])
    np.testing.assert_array_equal(case["out_lens"][ok], case["j_lens"][ok])
    n_raw = len(case["raws"])
    assert agree[:n_raw].all() and ok.sum() >= 10
    assert not ok[n_raw:].any()


def test_decode_plain_matches_reference_decoder(case):
    for i, want in enumerate(case["host"]):
        n = case["out_lens"][i]
        assert case["ok"][i] == (want is not None), i
        if want is not None:
            assert case["out"][i, :n].tobytes() == want, i
        assert not case["out"][i, min(n, 65536):].any(), i  # zero tail


def test_decode_plain_stops_where_the_parse_fails(case):
    """A malformed chunk keeps the bytes produced before the failure (the
    kernels' out_lens), and they are the original's prefix."""
    raw = (b"The quick brown fox jumps over the lazy dog. 0123456789 "
           * 600)[:30000]
    first_bad = len(case["raws"])
    for i in (first_bad, first_bad + 1):  # truncated blocks
        n = case["out_lens"][i]
        assert 0 < n < len(raw)
        assert case["out"][i, :n].tobytes() == raw[:n]


@pytest.mark.parametrize("blob, ok, out_len", LZ4_EDGE_BLOCKS)
def test_decode_plain_gives_the_pallas_values_on_f6_blocks(blob, ok, out_len):
    """Blocks where lz4_jax differs from the Pallas kernel (ROADMAP F6): the
    port gives the Pallas kernel's ok and out_lens, and agrees with the
    host decoder."""
    buf, lens = _pack([blob], 8)
    out, out_lens, got = lz4_decode.decode(*to_device_batch(buf, lens, "cpu"))
    assert (bool(got[0]), int(out_lens[0])) == (ok, out_len)
    assert (_host(blob) is not None) == ok
    if ok:
        assert out[0, :out_len].numpy().tobytes() == _host(blob)


def test_decode_plain_out_cap():
    """out_cap below the decoded length: not ok, out_lens the full op, and
    the first out_cap bytes exact."""
    raws = [b"ab" * 1000, _selfcheck_payload(3)]
    blobs = [host_lz4.compress(r) for r in raws]
    buf, lens = _pack(blobs, max(len(b) for b in blobs))
    out, out_lens, ok = lz4_decode.decode(
        *to_device_batch(buf, lens, "cpu"), out_cap=4096)
    assert ok.tolist() == [True, False]
    assert out_lens.tolist() == [len(r) for r in raws]
    for i, r in enumerate(raws):
        assert out[i].numpy().tobytes() == r[:4096].ljust(4096, b"\0")


def test_decode_empty_batch_and_bad_arguments():
    out, out_lens, ok = lz4_decode.decode(
        torch.zeros((0, 16), dtype=torch.uint8), torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 65536) and out_lens.shape == ok.shape == (0,)
    comp = torch.zeros((2, 16), dtype=torch.uint8)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        lz4_decode.decode(comp, lens, out_cap=65537)
    with pytest.raises(TypeError):
        lz4_decode.decode(comp.to(torch.int32), lens)
    with pytest.raises(ValueError):
        lz4_decode.decode(comp, lens[:1])


def test_decompress_chunks_round_trip(case):
    raws = [r for r in case["raws"] if len(r) <= 65536]
    blobs = [host_lz4.compress(r) for r in raws]
    codec = Lz4BatchCodec(device="cpu")
    before = lz4_decode.launches
    assert codec.decompress_chunks(blobs) == raws
    assert lz4_decode.launches == before  # the CPU runs decode_plain
    assert codec.decompress_chunks([]) == []


def test_decompress_chunks_names_malformed_chunk():
    good = host_lz4.compress(b"hello world " * 50)
    bad = lz4_malformed_cases(host_lz4.compress)[0]
    with pytest.raises(PortMalformed) as exc:
        Lz4BatchCodec(device="cpu").decompress_chunks([good, good, bad, good])
    assert exc.value.offset == 2


def test_decompress_chunks_flags_chunk_over_max_chunk():
    blob = host_lz4.compress(b"x" * 5000)
    with pytest.raises(PortMalformed) as exc:
        Lz4BatchCodec(4096, device="cpu").decompress_chunks([blob])
    assert exc.value.offset == 0
    with pytest.raises(ValueError):
        Lz4BatchCodec(65537, device="cpu")


def _sequence_walk(blob: bytes) -> int:
    """Sequences the kernel's loop parses in one block, the failing one
    included; 0 for an empty block."""
    clen = len(blob)
    ip = op = sequences = 0

    def ext(ip):  # the 255-extension string at ip: (sum, ip after), or None
        total = 0
        while ip < clen:
            total += blob[ip]
            ip += 1
            if blob[ip - 1] != 255:
                return total, ip
        return None

    while ip < clen:
        sequences += 1
        token = blob[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            more = ext(ip)
            if more is None:
                return sequences
            lit, ip = lit + more[0], more[1]
        if ip + lit > clen or op + lit > 65536:
            return sequences
        op, ip = op + lit, ip + lit
        if ip == clen or ip + 2 > clen:
            return sequences
        dist = blob[ip] | (blob[ip + 1] << 8)
        ip += 2
        if dist == 0 or dist > op:
            return sequences
        ml = token & 15
        if ml == 15:
            more = ext(ip)
            if more is None:
                return sequences
            ml, ip = ml + more[0], more[1]
        if op + ml + 4 > 65536:
            return sequences
        op += ml + 4
    return sequences


def test_with_steps_counts_the_sequences_walked(case):
    blobs = case["blobs"] + [b for b, _, _ in LZ4_EDGE_BLOCKS] + [
        b"", b"\xf0\xff\xff", b"\x14a\x01", b"\x1fa\x01\x00\xff",
        b"\x14a\x02\x00\x00", b"\x1fa\x01\x00" + b"\xff" * 257 + b"\x00\x00"]
    buf, lens = _pack(blobs, max(len(b) for b in blobs) + 5)
    comp, comp_lens = to_device_batch(buf, lens, "cpu")
    *_, steps = lz4_decode.decode(comp, comp_lens, with_steps=True)
    assert steps.dtype == torch.int32
    assert steps.tolist() == [_sequence_walk(b) for b in blobs]
    assert all(n > 0 for n in steps[:len(case["raws"])].tolist())


@pytest.mark.parametrize("out_cap", [65536, 4096])
def test_with_steps_leaves_the_three_outputs_as_they_were(case, out_cap):
    buf, lens = _pack(case["blobs"], max(len(b) for b in case["blobs"]) + 5)
    comp, comp_lens = to_device_batch(buf, lens, "cpu")
    plain = lz4_decode.decode(comp, comp_lens, out_cap=out_cap)
    stepped = lz4_decode.decode(comp, comp_lens, out_cap=out_cap, with_steps=True)
    assert len(plain) == 3 and len(stepped) == 4
    for a, b in zip(plain, stepped):
        assert torch.equal(a, b)
