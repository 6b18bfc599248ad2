"""The port's Snappy decode against the JAX package and the host decoder.

``decode_plain`` (what the port runs for CPU tensors, and what the CUDA
kernel is held to on the card) is compared with the JAX package's XLA tier
``snappy_jax.decode`` and with ``SnappyRefDecompressor``, exactly: these are
integer codecs, so the tolerance is 0. ``out_lens`` is compared only where
``ok``, because ``snappy_jax`` zeroes it on malformed chunks while the
kernels report the bytes produced before the bad token.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aircompressor_tpu.errors import MalformedInputException  # noqa: E402
from aircompressor_tpu.ops import snappy_jax  # noqa: E402
from aircompressor_tpu.ops.batch import _pack, _selfcheck_payload  # noqa: E402
from aircompressor_tpu.snappy import SnappyCompressor, SnappyRefDecompressor  # noqa: E402
from aircompressor_tpu_torch.errors import MalformedInputException as PortMalformed  # noqa: E402
from aircompressor_tpu_torch.ops import snappy_decode  # noqa: E402
from aircompressor_tpu_torch.ops.batch import SnappyBatchCodec, to_device_batch  # noqa: E402


def _malformed(compress) -> list[bytes]:
    """The malformed cases of tests/test_pallas_kernels.py on generated text."""
    text = (b"The quick brown fox jumps over the lazy dog. 0123456789 "
            * 600)[:30000]
    blob = compress(text)
    return [
        blob[: len(blob) // 2],              # truncated mid-stream
        blob[:1] + b"\x01\x00" + blob[3:],   # copy before any output
        b"\xfe\xff\xff\xff\x0f" + blob[5:],  # declared length > 64KB
    ]


@pytest.fixture(scope="module")
def case(synthetic):
    compress = SnappyCompressor.create().compress
    raws = [c for _, c in synthetic] + [
        _selfcheck_payload(), _selfcheck_payload(7)]
    blobs = [compress(r) for r in raws] + _malformed(compress)
    buf, lens = _pack(blobs, max(len(b) for b in blobs) + 5)
    out, out_lens, ok = (t.numpy() for t in snappy_decode.decode_plain(
        *to_device_batch(buf, lens, "cpu")))
    j_out, j_lens, j_ok = (np.asarray(a) for a in snappy_jax.decode(
        jnp.asarray(buf), jnp.asarray(lens)))
    return dict(raws=raws, blobs=blobs, out=out, out_lens=out_lens, ok=ok,
                j_out=j_out, j_lens=j_lens, j_ok=j_ok)


def test_decode_plain_matches_snappy_jax(case):
    ok = case["ok"]
    np.testing.assert_array_equal(ok, case["j_ok"])
    np.testing.assert_array_equal(case["out"][ok], case["j_out"][ok])
    np.testing.assert_array_equal(case["out_lens"][ok], case["j_lens"][ok])
    assert ok.sum() >= 10 and not ok[-3:].any()


def test_decode_plain_matches_reference_decoder(case):
    ref = SnappyRefDecompressor()
    for i, blob in enumerate(case["blobs"]):
        try:
            want = bytes(ref.decompress(blob, 65536))
        except MalformedInputException:
            want = None
        n = case["out_lens"][i]
        assert case["ok"][i] == (want is not None), i
        if want is not None:
            assert case["out"][i, :n].tobytes() == want, i
        assert not case["out"][i, min(n, 65536):].any(), i  # zero tail


def test_decode_plain_stops_at_first_bad_token(case):
    """A malformed chunk keeps the bytes produced before its bad token
    (the kernels' out_lens), and they are the original's prefix."""
    raw = (b"The quick brown fox jumps over the lazy dog. 0123456789 "
           * 600)[:30000]
    n = case["out_lens"][-3]  # truncated mid-stream
    assert 0 < n < len(raw)
    assert case["out"][-3, :n].tobytes() == raw[:n]


@pytest.mark.parametrize("high, ok", [(0, True), (1, False)])
def test_four_byte_offset_uses_all_32_bits(high, ok):
    """Copy with a 4-byte offset: 8 bytes declared, literal 'abcd', then a
    4-byte copy at distance 4 whose high offset byte is `high`."""
    blob = b"\x08\x0cabcd\x0f\x04\x00\x00" + bytes([high])
    buf, lens = _pack([blob], 16)
    out, out_lens, got = snappy_decode.decode_plain(
        *to_device_batch(buf, lens, "cpu"))
    _, _, j_ok = snappy_jax.decode(jnp.asarray(buf), jnp.asarray(lens))
    assert bool(got[0]) == ok == bool(np.asarray(j_ok)[0])
    if ok:
        assert out[0, :8].numpy().tobytes() == b"abcdabcd"


def test_decode_plain_out_cap():
    """out_cap below the declared length: not ok, out_lens the full op,
    and the first out_cap bytes exact."""
    raws = [b"ab" * 1000, _selfcheck_payload(3)]
    blobs = [SnappyCompressor.create().compress(r) for r in raws]
    buf, lens = _pack(blobs, max(len(b) for b in blobs))
    out, out_lens, ok = snappy_decode.decode(
        *to_device_batch(buf, lens, "cpu"), out_cap=4096)
    assert ok.tolist() == [True, False]
    assert out_lens.tolist() == [len(r) for r in raws]
    for i, r in enumerate(raws):
        assert out[i].numpy().tobytes() == r[:4096].ljust(4096, b"\0")


def test_decode_empty_batch_and_bad_arguments():
    out, out_lens, ok = snappy_decode.decode(
        torch.zeros((0, 16), dtype=torch.uint8), torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 65536) and out_lens.shape == ok.shape == (0,)
    comp = torch.zeros((2, 16), dtype=torch.uint8)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        snappy_decode.decode(comp, lens, out_cap=65537)
    with pytest.raises(TypeError):
        snappy_decode.decode(comp.to(torch.int32), lens)
    with pytest.raises(ValueError):
        snappy_decode.decode(comp, lens[:1])


def test_decompress_chunks_round_trip(case):
    raws = [r for r in case["raws"] if len(r) <= 65536]
    blobs = [SnappyCompressor.create().compress(r) for r in raws]
    assert SnappyBatchCodec(device="cpu").decompress_chunks(blobs) == raws
    assert SnappyBatchCodec(device="cpu").decompress_chunks([]) == []


def test_decompress_chunks_names_malformed_chunk(case):
    good = SnappyCompressor.create().compress(b"hello world " * 50)
    bad = _malformed(SnappyCompressor.create().compress)[0]
    with pytest.raises(PortMalformed) as exc:
        SnappyBatchCodec(device="cpu").decompress_chunks([good, good, bad, good])
    assert exc.value.offset == 2


def test_decompress_chunks_flags_chunk_over_max_chunk():
    blob = SnappyCompressor.create().compress(b"x" * 5000)
    with pytest.raises(PortMalformed) as exc:
        SnappyBatchCodec(4096, device="cpu").decompress_chunks([blob])
    assert exc.value.offset == 0
    with pytest.raises(ValueError):
        SnappyBatchCodec(65537, device="cpu")


# Malformed blocks for the step counts: no varint, an overlong varint, a
# literal past the input, a zero offset, an offset past the output, a
# truncated copy, a high offset byte, a declared length with bit 31 set.
STEP_MALFORMED = [
    b"", b"\x80\x80\x80\x80\x80\x01", b"\x05\x10ab", b"\x08\x0cabcd\x01\x00",
    b"\x08\x0cabcd\x01\x09", b"\x08\x0cabcd\x02\x04",
    b"\x08\x0cabcd\x0f\x04\x00\x00\x01", b"\xfe\xff\xff\xff\x0f\x0cabcd"]


def _token_walk(blob: bytes) -> int:
    """Tokens the kernel's loop parses in one chunk, the failing one
    included; 0 where the varint already rejects the chunk."""
    clen, data = len(blob), blob + bytes(5)
    declared, vlen = data[0] & 0x7F, 1
    more = data[0] >= 128
    for k in range(1, 5):
        if more:
            declared |= (data[k] & 0x7F) << (7 * k)
            vlen += 1
        more = more and data[k] >= 128
    if declared > 65536 or vlen > clen:
        return 0
    ip, op, tokens = vlen, 0, 0
    while ip < clen:
        tokens += 1
        tag = data[ip]
        kind, n = tag & 3, tag >> 2
        word = int.from_bytes(data[ip + 1:ip + 5], "little")
        if kind == 0:
            extra = max(0, n - 59)
            length = (word & ((1 << (8 * extra)) - 1) if extra else n) + 1
            if length > 65536 or ip + 1 + extra + length > clen or op + length > declared:
                return tokens
            ip += 1 + extra + length
        else:
            tok = (2, 3, 5)[kind - 1]
            length = 4 + (n & 7) if kind == 1 else n + 1
            dist = (((tag >> 5) << 8) | data[ip + 1] if kind == 1
                    else word & 0xFFFF if kind == 2 else word)
            if ip + tok > clen or op + length > declared or not 0 < dist <= op:
                return tokens
            ip += tok
        op += length
    return tokens


def test_with_steps_counts_the_tokens_walked(case):
    blobs = case["blobs"] + STEP_MALFORMED
    buf, lens = _pack(blobs, max(len(b) for b in blobs) + 5)
    comp, comp_lens = to_device_batch(buf, lens, "cpu")
    *_, steps = snappy_decode.decode(comp, comp_lens, with_steps=True)
    assert steps.dtype == torch.int32
    assert steps.tolist() == [_token_walk(b) for b in blobs]
    assert all((n > 0) == (0 < len(r) <= 65536)
               for n, r in zip(steps.tolist(), case["raws"]))


@pytest.mark.parametrize("out_cap", [65536, 4096])
def test_with_steps_leaves_the_three_outputs_as_they_were(case, out_cap):
    buf, lens = _pack(case["blobs"], max(len(b) for b in case["blobs"]) + 5)
    comp, comp_lens = to_device_batch(buf, lens, "cpu")
    plain = snappy_decode.decode(comp, comp_lens, out_cap=out_cap)
    stepped = snappy_decode.decode(comp, comp_lens, out_cap=out_cap, with_steps=True)
    assert len(plain) == 3 and len(stepped) == 4
    for a, b in zip(plain, stepped):
        assert torch.equal(a, b)
