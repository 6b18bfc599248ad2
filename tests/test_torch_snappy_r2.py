"""The port's r2 Snappy decode against the JAX package's ``snappy_pallas8``.

``decode_plain`` (what the port runs for CPU tensors, and what the CUDA
kernel is held to on the card) is compared with the Pallas kernel in
interpret mode on one batch of 45 rows of at most 2 KB, in two groups of 32
whose step counts differ, exactly on all four outputs: these are integer
codecs, so the tolerance is 0. Interpret mode takes about 10 s on a CPU for
that batch, so it runs once, in a module-scoped fixture. The per-chunk
counts under the group maximum are held to a window walk written here, and
bytes, lengths and ``ok`` on 64 KB blocks to ``snappy_decode``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aircompressor_tpu.ops import snappy_pallas8  # noqa: E402
from aircompressor_tpu_torch.host import snappy as host_snappy  # noqa: E402
from aircompressor_tpu_torch.errors import MalformedInputException  # noqa: E402
from aircompressor_tpu_torch.ops import snappy_decode, snappy_decode_r2  # noqa: E402
from aircompressor_tpu_torch.ops.batch import _pack, _selfcheck_payload, to_device_batch  # noqa: E402
from chip_smoke import R2_MALFORMED  # noqa: E402

# A 4-byte literal length of 0xFFFFFFFF: the Pallas kernel's int32 length
# wraps to an empty literal, the port rejects it (ROADMAP F10).
F10_BLOB = R2_MALFORMED[-1]


def _pallas_test_cases() -> list[bytes]:
    """The eight inputs of tests/test_ops_jax.py::test_snappy_pallas_megakernel."""
    rng = np.random.default_rng(3)
    return [
        b"hello world hello world hello world",
        b"a" * 300,
        b"ab" * 500,
        bytes(rng.integers(0, 256, 1000, dtype=np.uint8)),
        (b"The quick brown fox jumps over the lazy dog. " * 40),
        b"X",
        b"abcabcabc" + bytes(rng.integers(0, 4, 900, dtype=np.uint8)),
        b"",
    ]


def _malformed() -> list[bytes]:
    """The smoke's r2 malformed rows but F10 (a truncated literal, dist 0,
    dist > op, a high offset byte, declared > 64 KB with bit 31 set and
    65537, a varint longer than the chunk), then bytes after the declared
    end of 2000 zeros (the group's longest chain, its failing token
    included), a block cut mid-stream, and a copy before any output."""
    blob = host_snappy.compress(b"The quick brown fox jumps over the lazy dog. " * 30)
    return R2_MALFORMED[:-1] + [
        host_snappy.compress(bytes(2000)) + b"\x00x",
        blob[: len(blob) // 2],
        blob[:2] + b"\x05\x01" + blob[2:],
    ]


def _rows() -> tuple[list[bytes], list[bytes]]:
    """45 rows: group 0 the eight cases and 24 text heads, group 1 the
    malformed rows, the F10 row, and runs of zeros and a period of 3."""
    group0 = _pallas_test_cases() + [_selfcheck_payload(s)[:2048 - 64 * (s % 7)]
                                     for s in range(24)]
    blobs = [host_snappy.compress(r) for r in group0 + [bytes(1500), b"xyz" * 600]]
    blobs[32:32] = _malformed() + [F10_BLOB]
    return blobs, group0


@pytest.fixture(scope="module")
def batch():
    blobs, raws = _rows()
    assert len(blobs) == 45 and max(map(len, raws)) <= 2048
    buf, lens = _pack(blobs, 3072)
    got = [t.numpy() for t in snappy_decode_r2.decode_plain(
        *to_device_batch(buf, lens, "cpu"), with_steps=True)]
    want = [np.asarray(a) for a in snappy_pallas8.decode(
        jnp.asarray(buf), jnp.asarray(lens), with_steps=True)]
    return dict(blobs=blobs, raws=raws, buf=buf, lens=lens, got=got, want=want,
                f10=blobs.index(F10_BLOB))


def _i32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def _window_walk(blob: bytes) -> int:
    """Iterations the r2 loop spends on one chunk: a window of
    min(rem, 128 - op % 128) bytes, and for a copy at most dist, after which
    dist doubles; one for a token that fails. The varint is a signed 32-bit
    value as in the Pallas kernel; literal lengths are exact (F10)."""
    clen, data = len(blob), blob + bytes(5)
    declared, vlen = data[0] & 0x7F, 1
    more = data[0] >= 128
    for k in range(1, 5):
        if more:
            declared |= (data[k] & 0x7F) << (7 * k)
            vlen += 1
        more = more and data[k] >= 128
    declared = _i32(declared & 0xFFFFFFFF)
    if declared > 65536 or vlen > clen:
        return 0
    ip, op, rem, dist, literal, steps = vlen, 0, 0, 0, False, 0
    while rem > 0 or ip < clen:
        steps += 1
        if rem == 0:
            tag = data[ip]
            kind, n = tag & 3, tag >> 2
            word = int.from_bytes(data[ip + 1:ip + 5], "little")
            literal = kind == 0
            if literal:
                extra = max(0, n - 59)
                length = (word & ((1 << (8 * extra)) - 1) if extra else n) + 1
                tok = 1 + extra
                if length > 65536 or ip + tok + length > clen or op + length > declared:
                    return steps
                ip += tok + length
            else:
                tok = (2, 3, 5)[kind - 1]
                length = 4 + (n & 7) if kind == 1 else n + 1
                dist = (((tag >> 5) << 8) | data[ip + 1] if kind == 1
                        else word & 0xFFFF if kind == 2 else word)
                if ip + tok > clen or op + length > declared or not 0 < dist <= op:
                    return steps
                ip += tok
            rem = length
        take = min(rem, 128 - op % 128)
        if not literal:
            take = min(take, dist)
            if take == dist:
                dist = min(2 * dist, 65536)
        op, rem = op + take, rem - take
    return steps


def test_decode_plain_equals_the_pallas_kernel(batch):
    """All four outputs, exactly; on the F10 row only the step count."""
    got, want = batch["got"], batch["want"]
    keep = np.arange(45) != batch["f10"]
    for name, g, w in zip(("out", "out_lens", "ok"), got, want):
        np.testing.assert_array_equal(g[keep], w[keep], err_msg=name)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[2][:len(batch["raws"])].all() and not got[2][32:43].any()
    for i, raw in enumerate(batch["raws"]):
        assert got[0][i, :len(raw)].tobytes() == raw, i


def test_each_group_shares_its_largest_count(batch):
    """Rows 0-31 share one count, rows 32-44 another, and the two differ:
    the Pallas kernel's loop runs per grid step of 32 chunks."""
    steps = batch["want"][3]
    assert len(set(steps[:32])) == 1 and len(set(steps[32:])) == 1
    assert steps[0] != steps[32] and min(steps[0], steps[32]) > 0
    own = [_window_walk(b) for b in batch["blobs"]]
    assert steps[32] == max(own[32:]) == own[39]  # the row that fails at its end


def test_f10_wrapped_literal_length(batch):
    """The Pallas kernel reads the 0xFFFFFFFF literal length as an empty
    literal and decodes on; the port rejects the chunk at that token, as the
    host decoder does, having produced nothing."""
    i = batch["f10"]
    assert batch["want"][1][i] == 2 and batch["want"][0][i, :2].tobytes() == b"ab"
    assert batch["got"][1][i] == 0 and not batch["got"][2][i]
    assert not batch["got"][0][i].any()
    with pytest.raises(MalformedInputException):
        host_snappy.decompress(F10_BLOB, 65536)


def test_chunk_steps_equal_a_window_walk(batch):
    """The count of each chunk under the group maximum, on the fixture's
    rows and on 64 KB blocks of runs, periods and text."""
    blobs = batch["blobs"] + [host_snappy.compress(r) for r in (
        bytes(65536), b"ab" * 32768, _selfcheck_payload(5), _selfcheck_payload(9))]
    comp, lens = to_device_batch(*_pack(blobs, max(map(len, blobs))), "cpu")
    table = snappy_decode.token_table(comp, lens)
    got = snappy_decode_r2.chunk_steps(table, lens).tolist()
    assert got == [_window_walk(b) for b in blobs]
    # 64 KB of zeros: a literal of one byte, 1023 copies of 64 bytes at dist 1
    # (windows of 1, 2, 4, 8, 16, 32 and 1 bytes) and one of 63 (six windows)
    assert got[45] == 1 + 1023 * 7 + 6


@pytest.mark.parametrize("out_cap", [65536, 4096])
def test_decode_plain_equals_snappy_decode_on_64kb_blocks(out_cap):
    raws = [_selfcheck_payload(s) for s in (0, 3, 11)] + [bytes(65536), b"\x01" * 4096]
    blobs = [host_snappy.compress(r) for r in raws]
    comp, lens = to_device_batch(*_pack(blobs, max(map(len, blobs))), "cpu")
    got = snappy_decode_r2.decode(comp, lens, out_cap=out_cap)
    want = snappy_decode.decode_plain(comp, lens, out_cap=out_cap)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2].tolist() == [len(r) <= out_cap for r in raws]
    for i, r in enumerate(raws):
        assert got[0][i].numpy().tobytes() == r[:out_cap].ljust(out_cap, b"\0")


def test_group_max_over_a_ragged_batch():
    counts = torch.arange(70, dtype=torch.int32)
    got = snappy_decode_r2.group_max(counts)
    assert got.dtype == torch.int32
    assert got.tolist() == [31] * 32 + [63] * 32 + [69] * 6


def test_decode_on_the_cpu_is_the_plain_version():
    before = snappy_decode_r2.launches
    blobs = [host_snappy.compress(b"ab" * 900), b"\x08\x0cabcd\x01\x09"]
    comp, lens = to_device_batch(*_pack(blobs, max(map(len, blobs))), "cpu")
    got = snappy_decode_r2.decode(comp, lens, with_steps=True)
    want = snappy_decode_r2.decode_plain(comp, lens, with_steps=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert snappy_decode_r2.launches == before
    assert got[3].tolist() == [max(_window_walk(b) for b in blobs)] * 2


def test_decode_empty_batch_and_bad_arguments():
    out, out_lens, ok, steps = snappy_decode_r2.decode(
        torch.zeros((0, 16), dtype=torch.uint8), torch.zeros(0, dtype=torch.int32),
        with_steps=True)
    assert out.shape == (0, 65536) and out_lens.shape == ok.shape == steps.shape == (0,)
    comp = torch.zeros((2, 16), dtype=torch.uint8)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        snappy_decode_r2.decode(comp, lens, out_cap=65537)
    with pytest.raises(ValueError):
        snappy_decode_r2.decode(comp, lens, out_cap=0)
    with pytest.raises(TypeError):
        snappy_decode_r2.decode(comp.to(torch.int32), lens)
    with pytest.raises(ValueError):
        snappy_decode_r2.decode(comp, lens[:1])
