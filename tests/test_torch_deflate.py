"""The port's raw-deflate decode against the JAX package's planner,
``simulate_chunk`` and zlib.

The port's C++ planner (``host/deflate/inflate_plan.cc``) is held to the JAX
package's (``deflate.device_prep.plan_batch``) on every chunk the JAX one
takes: the same statuses, block descriptors and table entries, with every
table index 128 lower (the port keeps descriptors and tables apart). Where
the JAX planner gives up (more than 16 blocks) the port plans the chunk
anyway, and where the JAX planner takes an incomplete code set (ROADMAP F3)
the port rejects the stream as zlib does. ``decode_plain`` (what the port
runs for CPU tensors, and what the CUDA kernel is held to on the card) is
held to zlib and to ``simulate_chunk`` on the same plan, exactly: integer
codec, tolerance 0. The JAX planner needs ``aircompressor_tpu.native``
(built with g++); its tests skip where that does not build.
"""

import zlib

import numpy as np
import pytest
import torch

from aircompressor_tpu.deflate import device_prep
from aircompressor_tpu_torch.errors import MalformedInputException
from aircompressor_tpu_torch.host.deflate import plan as port_plan
from aircompressor_tpu_torch.ops import deflate_decode
from aircompressor_tpu_torch.ops.batch import (
    DeflateBatchCodec, _pack, _selfcheck_payload, deflate_raw, to_device_batch)
from chip_smoke import (
    deflate_dynamic_block, deflate_f3_stream, deflate_full_flush,
    deflate_malformed_cases)

LEVELS = (0, 1, 6, 9)


def _raws() -> list[bytes]:
    """Short inputs (fixed-Huffman blocks), runs, periods, text and random
    bytes (stored blocks), each a few KB."""
    rng = np.random.default_rng(11)
    return [b"x", b"hello world hello world hello", bytes(2000), b"ab" * 1500,
            rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
            rng.integers(0, 4, 4000, dtype=np.uint8).tobytes(),
            _selfcheck_payload(0)[:5000], _selfcheck_payload(1)[-5000:]]


RAWS = _raws()
CASES = [(r, level) for level in LEVELS for r in RAWS]
BLOBS = [deflate_raw(r, level) for r, level in CASES]


@pytest.fixture(scope="module")
def jax_planner():
    from aircompressor_tpu import native

    if not native.is_enabled():
        pytest.skip("the JAX package's native planner does not build here")
    return device_prep.plan_batch


def _batch(blobs):
    return _pack(blobs, max(map(len, blobs)) + 3)


def _decode(blobs, out_cap=65536, plan=None, lens=None):
    buf, blens = _batch(blobs)
    if lens is not None:
        blens = np.asarray(lens, np.int32)
    plan = port_plan.plan(buf, blens) if plan is None else plan
    got = deflate_decode.decode(*to_device_batch(buf, blens, "cpu"),
                                deflate_decode.upload(plan, "cpu"), out_cap=out_cap)
    return plan, [t.numpy() for t in got]


def _jax_view(desc, tabs, info):
    """The JAX planner's blocks and used table entries of one chunk, with
    every table index 128 lower, as the port lays them out."""
    nb, used = int(info[1]), int(info[2])
    blocks = desc.reshape(16, 8)[:nb].copy()
    huff = blocks[:, 0] == 1
    blocks[huff, 2:4] -= 128
    entries = tabs[128:used].copy()
    entries[(entries >> 28) == 5] -= 128
    return blocks, entries


def test_blocks_of_each_kind_are_made():
    kinds = {(b[0] >> 1) & 3 for b in BLOBS}
    assert kinds == {0, 1, 2}  # stored, fixed and dynamic first blocks


def test_plan_equals_the_jax_planner(jax_planner):
    buf, lens = _batch(BLOBS)
    j_desc, j_tabs, j_info = jax_planner(buf, lens)
    desc, tabs, info = port_plan.plan_batch(buf, lens)
    assert (j_info[:, 3] == device_prep.ST_OK).all()
    np.testing.assert_array_equal(info[:, 3], port_plan.ST_OK)
    np.testing.assert_array_equal(info[:, :2], j_info[:, :2])
    np.testing.assert_array_equal(info[:, 2], j_info[:, 2] - 128)
    for i in range(len(BLOBS)):
        blocks, entries = _jax_view(j_desc[i], j_tabs[i], j_info[i])
        np.testing.assert_array_equal(desc[i, :len(blocks)], blocks)
        np.testing.assert_array_equal(tabs[i, :len(entries)], entries)
        assert not tabs[i, len(entries):].any()


def test_plan_equals_the_jax_planner_on_malformed_streams(jax_planner):
    """Both reject every malformed stream but the F3 ones (incomplete
    codes), which only the port rejects."""
    cases = deflate_malformed_cases()
    buf, lens = _batch([b for _, b in cases])
    _, _, j_info = jax_planner(buf, lens)
    _, _, info = port_plan.plan_batch(buf, lens)
    want = [device_prep.ST_OK if "(F3)" in name else device_prep.ST_MALFORMED
            for name, _ in cases]
    assert want.count(device_prep.ST_OK) == 2
    assert j_info[:, 3].tolist() == want
    assert info[:, 3].tolist() == [port_plan.ST_MALFORMED] * len(cases)


def test_the_f3_stream(jax_planner):
    """An incomplete literal/length code: the JAX planner takes it, zlib
    raises, and the port raises naming the item."""
    blob = deflate_f3_stream()
    buf, lens = _batch([blob])
    assert jax_planner(buf, lens)[2][0, 3] == device_prep.ST_OK
    with pytest.raises(zlib.error, match="invalid literal/lengths set"):
        zlib.decompress(blob, -15)
    assert port_plan.plan(buf, lens).info[0, 3] == port_plan.ST_MALFORMED
    codec = DeflateBatchCodec(device="cpu")
    with pytest.raises(MalformedInputException) as e:
        codec.decompress_chunks([deflate_raw(b"abc"), blob])
    assert e.value.offset == 1
    assert "invalid literal/lengths set" in e.value.reason


def test_a_single_code_of_length_one_is_allowed():
    """zlib's one allowed incomplete code: a lone distance code of length 1
    (and a literal/length code that is complete)."""
    blob = deflate_dynamic_block({97: 1, 256: 2, 257: 2}, {0: 1},
                                 [("ll", 97, 0, 0), ("ll", 257, 0, 0), ("d", 0, 0, 0),
                                  ("ll", 256, 0, 0)])
    assert zlib.decompress(blob, -15) == b"aaaa"
    plan, (out, out_lens, ok) = _decode([blob])
    assert plan.info[0, 3] == port_plan.ST_OK and ok[0]
    assert out[0, :out_lens[0]].tobytes() == b"aaaa"


def test_the_port_plans_more_than_16_blocks(jax_planner):
    """A full flush every 2 KB: the JAX planner gives up (ST_FALLBACK), the
    port plans again at caps that fit and decodes it."""
    raw = _selfcheck_payload(3)[:40000]
    blob = deflate_full_flush(raw)
    buf, lens = _batch([blob])
    assert jax_planner(buf, lens)[2][0, 3] == device_prep.ST_FALLBACK
    _, _, info = port_plan.plan_batch(buf, lens)
    assert info[0, 3] == port_plan.ST_ROOM and info[0, 1] > 16
    plan, (out, out_lens, ok) = _decode([blob])
    assert plan.info[0, 3] == port_plan.ST_OK
    assert plan.info[0, 1] == info[0, 1] and plan.info[0, 2] == info[0, 2]
    assert ok[0] and out[0, :out_lens[0]].tobytes() == raw


def test_caps_are_arguments():
    """At caps too small the planner reports what a chunk needs, and at
    those caps it plans it as at larger ones."""
    blob = deflate_full_flush(_selfcheck_payload(2)[:10000], every=1024)
    buf, lens = _batch([blob])
    _, _, small = port_plan.plan_batch(buf, lens, max_blocks=2, tab_cap=600)
    assert small[0, 3] == port_plan.ST_ROOM
    nb, nt = int(small[0, 1]), int(small[0, 2])
    exact = port_plan.plan_batch(buf, lens, max_blocks=nb, tab_cap=nt)
    large = port_plan.plan_batch(buf, lens, max_blocks=nb + 5, tab_cap=nt + 1000)
    assert exact[2][0, 3] == large[2][0, 3] == port_plan.ST_OK
    np.testing.assert_array_equal(exact[0][0], large[0][0, :nb])
    np.testing.assert_array_equal(exact[1][0], large[1][0, :nt])


def test_decode_plain_equals_zlib_and_simulate_chunk():
    blobs = BLOBS + [deflate_full_flush(_selfcheck_payload(4)[:12000], every=512)]
    raws = [r for r, _ in CASES] + [_selfcheck_payload(4)[:12000]]
    plan, (out, out_lens, ok) = _decode(blobs)
    assert ok.all()
    for i, blob in enumerate(blobs):
        d0, nb, t0, nt = plan.index[i]
        sim = device_prep.simulate_chunk(blob, plan.desc[d0:d0 + nb].reshape(-1),
                                         plan.tabs[t0:t0 + nt])
        assert out_lens[i] == plan.info[i, 0] == len(raws[i])
        assert out[i, :out_lens[i]].tobytes() == zlib.decompress(blob, -15) == sim == raws[i]
        assert not out[i, out_lens[i]:].any()  # zero tail


def test_decode_plain_fails_malformed_streams():
    """Streams the planner rejects get no blocks: not ok, nothing out."""
    blobs = [b for _, b in deflate_malformed_cases()]
    plan, (out, out_lens, ok) = _decode(blobs)
    assert (plan.info[:, 3] == port_plan.ST_MALFORMED).all()
    assert not ok.any() and not out_lens.any() and not out.any()


def test_decode_plain_on_a_plan_whose_stream_was_cut():
    """A chunk cut after planning fails where its bits run out; the bytes
    before are the original's."""
    raw = _selfcheck_payload(6)[:8000]
    blob = deflate_raw(raw, 9)
    buf, lens = _batch([blob, blob, blob])
    plan = port_plan.plan(buf, lens)
    cut = [len(blob), len(blob) * 2 // 3, len(blob) // 3]
    _, (out, out_lens, ok) = _decode([blob] * 3, plan=plan, lens=cut)
    assert ok.tolist() == [True, False, False]
    assert len(raw) == out_lens[0] > out_lens[1] > out_lens[2] > 0
    for i in range(3):
        assert out[i, :out_lens[i]].tobytes() == raw[:out_lens[i]]


def test_decode_plain_out_cap():
    """out_cap below the decoded length: not ok, out_lens the whole output,
    and the first out_cap bytes exact."""
    raws = [b"ab" * 1000, _selfcheck_payload(3)[:9000], bytes(5000)]
    blobs = [deflate_raw(r) for r in raws]
    _, (out, out_lens, ok) = _decode(blobs, out_cap=4096)
    assert ok.tolist() == [True, False, False]
    assert out_lens.tolist() == [len(r) for r in raws]
    for i, r in enumerate(raws):
        assert out[i].tobytes() == r[:4096].ljust(4096, b"\0")


def test_decode_empty_batch_and_bad_arguments():
    buf = np.zeros((0, 16), np.uint8)
    plan = port_plan.plan(buf, np.zeros(0, np.int32))
    out, out_lens, ok = deflate_decode.decode(
        *to_device_batch(buf, np.zeros(0, np.int32), "cpu"), deflate_decode.upload(plan, "cpu"))
    assert out.shape == (0, 65536) and out_lens.shape == ok.shape == (0,)
    comp, lens = to_device_batch(*_batch([deflate_raw(b"abc")]), "cpu")
    dplan = deflate_decode.upload(port_plan.plan(*_batch([deflate_raw(b"abc")])), "cpu")
    with pytest.raises(ValueError):
        deflate_decode.decode(comp, lens, dplan, out_cap=65537)
    with pytest.raises(ValueError):
        deflate_decode.decode(comp, lens, dplan._replace(index=dplan.index + 5))
    with pytest.raises(ValueError):
        port_plan.plan_batch(np.zeros((1, 4), np.uint8), np.array([5], np.int32))


def test_codec_round_trip_on_the_cpu():
    raws = RAWS + [b""]
    codec = DeflateBatchCodec(device="cpu")
    blobs = codec.compress_chunks(raws)
    assert blobs == [deflate_raw(r, 6) for r in raws]
    before = deflate_decode.launches
    assert codec.decompress_chunks(blobs) == raws
    assert deflate_decode.launches == before  # the CPU runs decode_plain
    assert codec.decompress_chunks([]) == []
    assert DeflateBatchCodec(level=1, device="cpu").compress_chunks(raws) == [
        deflate_raw(r, 1) for r in raws]
    with pytest.raises(ValueError):
        codec.compress_chunks([bytes(65537)])


@pytest.mark.parametrize("case", range(len(deflate_malformed_cases())))
def test_codec_names_the_malformed_chunk(case):
    """MalformedInputException with the item index and zlib's reason."""
    name, blob = deflate_malformed_cases()[case]
    with pytest.raises(zlib.error) as want:
        zlib.decompress(blob, -15)
    codec = DeflateBatchCodec(device="cpu")
    with pytest.raises(MalformedInputException) as e:
        codec.decompress_chunks([deflate_raw(b"abc" * 10), deflate_raw(b"x"), blob])
    assert e.value.offset == 2
    assert e.value.reason == str(want.value)


def test_codec_rejects_a_chunk_over_max_chunk():
    codec = DeflateBatchCodec(max_chunk=4096, device="cpu")
    with pytest.raises(MalformedInputException) as e:
        codec.decompress_chunks([deflate_raw(b"a" * 100), deflate_raw(bytes(5000))])
    assert e.value.offset == 1


def test_codec_defaults_to_the_card():
    assert DeflateBatchCodec().device.type == "cuda"


LEN_EXTRA = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]


def _symbol_walk(blob: bytes) -> int:
    """The symbol loop's iterations on a stream of stored and fixed-Huffman
    blocks, by a walk of its bits: one per literal/length symbol (a length
    with its distance is one), each end-of-block symbol included."""
    pos = 0

    def bits(n):  # n bits, least significant first
        nonlocal pos
        v = sum(((blob[(pos + k) >> 3] >> ((pos + k) & 7)) & 1) << k for k in range(n))
        pos += n
        return v

    def code(n, v=0):  # n more bits of a Huffman code, most significant first
        for _ in range(n):
            v = (v << 1) | bits(1)
        return v

    count = 0
    while True:
        final, btype = bits(1), bits(2)
        if btype == 0:
            pos = (pos + 7) & ~7
            n = bits(16)
            pos += 16 + 8 * n
        else:
            assert btype == 1, "the walk knows fixed-Huffman blocks only"
            while True:
                count += 1
                c = code(7)
                if c <= 23:
                    sym = 256 + c
                else:
                    c = code(1, c)
                    if c <= 0xBF:
                        sym = c - 0x30
                    elif c <= 0xC7:
                        sym = 280 + c - 0xC0
                    else:
                        sym = 144 + code(1, c) - 0x190
                if sym == 256:
                    break
                if sym > 256:
                    bits(LEN_EXTRA[sym - 257])
                    d = code(5)
                    bits(max(0, (d - 2) // 2))
        if final:
            return count


def test_with_steps_counts_the_symbols_walked():
    """``with_steps`` on the plain version: the symbol walk of fixed-Huffman
    and stored streams, fewer steps for a stream cut after planning (its
    failing symbol included), 0 for a rejected stream; the three outputs as
    without steps."""
    raws = [b"abc", b"abcabcabcabc", b"hello world hello world hello", b"x",
            b"The quick brown fox jumps over the lazy dog. " * 4]
    good = ([deflate_raw(r, level) for level in (1, 6) for r in raws]
            + [deflate_raw(r, 0) for r in raws[:3]])
    blobs = good + [good[-4], deflate_malformed_cases()[0][1]]
    buf, lens = _batch(blobs)
    plan = port_plan.plan(buf, lens)
    lens[-2] = len(good[-4]) // 2
    comp, comp_lens = to_device_batch(buf, lens, "cpu")
    dplan = deflate_decode.upload(plan, "cpu")
    *outs, steps = deflate_decode.decode(comp, comp_lens, dplan, with_steps=True)
    walks = [_symbol_walk(b) for b in good]
    assert steps.tolist()[:len(good)] == walks
    assert walks[:2] == [4, 6] and walks[-3:] == [0, 0, 0]
    assert 0 < steps[-2] < walks[-4] and steps[-1] == 0
    for got, want in zip(outs, deflate_decode.decode(comp, comp_lens, dplan)):
        assert torch.equal(got, want)
