"""The port's LZO1X codec against the JAX package's host tier.

The port's host copy (``host/lzo.py``) is held to
``aircompressor_tpu.lzo.block_ref``: the same compressed bytes, the same
decoded bytes, the same rejections at the same offsets. ``decode_plain``
(what the port runs for CPU tensors, and what the CUDA kernel is held to on
the card) is held to ``block_ref.decompress`` exactly (integer codec:
tolerance 0), and on the edge blocks to the ok flag and out_lens that the
Pallas kernel ``lzo_pallas_w.decode`` gives in interpret mode
(``chip_smoke.LZO_EDGE_BLOCKS``, recorded once: the interpreter takes
minutes on them, too long for these tests).
"""

import numpy as np
import pytest
import torch

from aircompressor_tpu.errors import MalformedInputException
from aircompressor_tpu.lzo import block_ref
from aircompressor_tpu_torch.errors import MalformedInputException as PortMalformed
from aircompressor_tpu_torch.host import lzo as host_lzo
from aircompressor_tpu_torch.ops import lzo_decode
from aircompressor_tpu_torch.ops.batch import (
    LzoBatchCodec, _pack, _selfcheck_payload, to_device_batch)
from chip_smoke import LZO_EDGE_BLOCKS, LZO_EDGE_CAP, lzo_cases

CAP = 65536


def _ref_compress(raw: bytes) -> bytes:
    dst = np.zeros(block_ref.max_compressed_length(len(raw)), np.uint8)
    return dst[:block_ref.compress(np.frombuffer(raw, np.uint8), dst)].tobytes()


def _ref_decompress(blob: bytes, cap: int = CAP):
    """block_ref's bytes, or None where it rejects the block."""
    dst = np.zeros(cap, np.uint8)
    try:
        return dst[:block_ref.decompress(np.frombuffer(blob, np.uint8), dst)].tobytes()
    except MalformedInputException:
        return None


def _inputs() -> list[bytes]:
    return lzo_cases() + [_selfcheck_payload(s)[-4000:] for s in (0, 7)] + [
        _selfcheck_payload(3)[:3000]]


INPUTS = _inputs()
REJECTED = [b for b, ok, _ in LZO_EDGE_BLOCKS if _ref_decompress(b) is None]


def _decode(blobs, out_cap=CAP):
    buf, lens = _pack(blobs, max(map(len, blobs)) + 3)
    return [t.numpy() for t in lzo_decode.decode(
        *to_device_batch(buf, lens, "cpu"), out_cap=out_cap)]


@pytest.mark.parametrize("case", range(len(INPUTS)))
def test_host_copy_equals_block_ref(case):
    """The port's host encoder writes block_ref's bytes, and both decoders
    read them back."""
    raw = INPUTS[case]
    blob = host_lzo.compress(raw)
    assert blob == _ref_compress(raw)
    assert host_lzo.decompress(blob, CAP) == raw == _ref_decompress(blob)


@pytest.mark.parametrize("case", range(len(REJECTED)))
def test_host_copy_rejects_as_block_ref(case):
    """A malformed block raises in both, at the same offset."""
    blob = REJECTED[case]
    with pytest.raises(MalformedInputException) as want:
        block_ref.decompress(np.frombuffer(blob, np.uint8), np.zeros(CAP, np.uint8))
    with pytest.raises(PortMalformed) as got:
        host_lzo.decompress(blob, CAP)
    assert (got.value.offset, got.value.reason) == (want.value.offset, want.value.reason)


def test_decode_plain_equals_block_ref():
    raws = INPUTS
    blobs = [_ref_compress(r) for r in raws]
    out, out_lens, ok = _decode(blobs)
    assert ok.all()
    for i, r in enumerate(raws):
        assert out_lens[i] == len(r)
        assert out[i, :len(r)].tobytes() == _ref_decompress(blobs[i]) == r
        assert not out[i, len(r):].any()  # zero tail


@pytest.mark.parametrize("blob, ok, out_len", LZO_EDGE_BLOCKS)
def test_decode_plain_gives_the_pallas_values_on_edge_blocks(blob, ok, out_len):
    """The Pallas kernel's ok and out_lens at out_cap LZO_EDGE_CAP, which
    accept exactly what block_ref accepts there."""
    out, out_lens, got = _decode([blob], out_cap=LZO_EDGE_CAP)
    assert (bool(got[0]), int(out_lens[0])) == (ok, out_len)
    want = _ref_decompress(blob, LZO_EDGE_CAP)
    assert (want is not None) == ok
    if ok:
        assert out[0, :out_len].tobytes() == want


def test_decode_plain_stops_where_the_parse_fails():
    """A cut block keeps the bytes produced before the failure, and they are
    the original's prefix (all of it where only the stop command is cut)."""
    raw = _selfcheck_payload(4)[:6000]
    blob = host_lzo.compress(raw)
    cuts = [blob[:n] for n in (len(blob) * 3 // 4, len(blob) * 7 // 8, len(blob) - 3)]
    out, out_lens, ok = _decode(cuts)
    assert not ok.any()
    assert out_lens[0] < out_lens[1] < out_lens[2] == len(raw)
    for i in range(len(cuts)):
        n = out_lens[i]
        assert 0 < n
        assert out[i, :n].tobytes() == raw[:n]
        assert not out[i, n:].any()


def test_decode_plain_out_cap():
    """out_cap below the decoded length: not ok, out_lens the whole output,
    and the first out_cap bytes exact."""
    raws = [b"ab" * 1000, _selfcheck_payload(3)[:9000]]
    out, out_lens, ok = _decode([host_lzo.compress(r) for r in raws], out_cap=4096)
    assert ok.tolist() == [True, False]
    assert out_lens.tolist() == [len(r) for r in raws]
    for i, r in enumerate(raws):
        assert out[i].tobytes() == r[:4096].ljust(4096, b"\0")


def test_decode_empty_batch_and_bad_arguments():
    out, out_lens, ok = lzo_decode.decode(
        torch.zeros((0, 16), dtype=torch.uint8), torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 65536) and out_lens.shape == ok.shape == (0,)
    comp = torch.zeros((2, 16), dtype=torch.uint8)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        lzo_decode.decode(comp, lens, out_cap=65537)
    with pytest.raises(TypeError):
        lzo_decode.decode(comp.to(torch.int32), lens)
    with pytest.raises(ValueError):
        lzo_decode.decode(comp, lens[:1])


def test_codec_round_trip_on_the_cpu():
    raws = INPUTS[:6] + [b"x"]
    codec = LzoBatchCodec(device="cpu")
    blobs = codec.compress_chunks(raws)
    assert blobs == [_ref_compress(r) for r in raws]
    before = lzo_decode.launches
    assert codec.decompress_chunks(blobs) == raws
    assert lzo_decode.launches == before  # the CPU runs decode_plain
    assert codec.decompress_chunks([]) == []
    with pytest.raises(ValueError):
        codec.compress_chunks([bytes(65537)])


def test_codec_names_the_malformed_chunk():
    codec = LzoBatchCodec(device="cpu")
    blobs = codec.compress_chunks([b"abc" * 100, b"hello world" * 30, b"xyz" * 50])
    blobs[1] = blobs[1][:-3]  # the stop command cut off
    with pytest.raises(PortMalformed) as e:
        codec.decompress_chunks(blobs)
    assert e.value.offset == 1


def test_codec_defaults_to_the_card():
    assert LzoBatchCodec().device.type == "cuda"


def _command_walk(blob: bytes) -> int:
    """The command loop's iterations on a well-formed block, by a walk of
    its commands alone: one per command after the first-byte literal run,
    the stop command included."""
    ip, state, count = 0, 0, 0
    if blob[0] > 17:
        ip, state = blob[0] - 16, min(blob[0] - 17, 4)

    def extended(p):  # a zero-extended length at p: (its value, the position after)
        z = p
        while blob[z] == 0:
            z += 1
        return 255 * (z - p) + blob[z], z + 1

    while True:
        count += 1
        t = blob[ip]
        if t < 16 and state == 0:  # literal run
            if t == 0:
                n, p = extended(ip + 1)
                n += 18
            else:
                n, p = t + 3, ip + 1
            ip, state = p + n, 4
            continue
        if t < 16 or t >= 64:  # 2-byte match commands
            trailing, ip = t & 3, ip + 2
        else:  # M3 and M4: a length, then a 2-byte word
            low = t & 7 if t < 32 else t & 31
            w = extended(ip + 1)[1] if low == 0 else ip + 1
            word = blob[w] | (blob[w + 1] << 8)
            if t < 32 and not t & 8 and word >> 2 == 0:  # dist 16384: stop
                return count
            trailing, ip = word & 3, w + 2
        ip += trailing
        state = trailing


def test_with_steps_counts_the_commands_walked():
    """``with_steps`` on the plain version: the command walk of each
    well-formed block, the same with its stop command cut off (then a
    failing iteration), 1 for a first-byte literal run and a stop, 0 for an
    empty chunk; the three outputs as without steps."""
    good = [host_lzo.compress(r) for r in INPUTS + [_selfcheck_payload(5)[:20000]]]
    walks = [_command_walk(b) for b in good]
    long = [i for i, w in enumerate(walks) if w > 2][:3]
    blobs = good + [good[i][:-3] for i in long] + [
        bytes([21]) + b"abcd" + b"\x11\x00\x00", bytes([21]) + b"abcd", b""]
    buf, lens = _pack(blobs, max(map(len, blobs)) + 3)
    comp, comp_lens = to_device_batch(buf, lens, "cpu")
    *outs, steps = lzo_decode.decode(comp, comp_lens, with_steps=True)
    assert steps.tolist() == walks + [walks[i] for i in long] + [1, 1, 0]
    assert len(long) == 3 and max(walks) > 50
    for got, want in zip(outs, lzo_decode.decode(comp, comp_lens)):
        assert torch.equal(got, want)
