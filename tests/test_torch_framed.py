"""The port's CRC32-C and framed Snappy decode against the JAX package.

``ops.checksum.crc32c``/``mask_crc`` must equal ``checksum_jax`` and the
host ``crc32c_raw``; ``snappy_framed_decompress_device`` must give the JAX
function's bytes on streams of ``aircompressor_tpu.snappy.framed``, and on a
bad stream raise the port's ``MalformedInputException`` with the index the
JAX function reports. The port's host framer must write the JAX framer's
bytes. Integer codecs: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aircompressor_tpu.crc import crc32c_raw  # noqa: E402
from aircompressor_tpu.errors import MalformedInputException  # noqa: E402
from aircompressor_tpu.ops import checksum_jax  # noqa: E402
from aircompressor_tpu.ops.batch import snappy_framed_decompress_device as jax_framed  # noqa: E402
from aircompressor_tpu.snappy import SnappyRefCompressor  # noqa: E402
from aircompressor_tpu.snappy import framed as jax_framing  # noqa: E402
from aircompressor_tpu_torch.errors import MalformedInputException as PortMalformed  # noqa: E402
from aircompressor_tpu_torch.host import crc32c as host_crc  # noqa: E402
from aircompressor_tpu_torch.host import framed as port_framing  # noqa: E402
from aircompressor_tpu_torch.ops import checksum  # noqa: E402
from aircompressor_tpu_torch.ops.batch import snappy_framed_decompress_device  # noqa: E402


def _crc_case(width: int, lengths: list[int], seed: int):
    data = np.random.default_rng(seed).integers(0, 256, (len(lengths), width),
                                                dtype=np.uint8)
    return data, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("width, lengths", [
    (300, list(range(301))),
    (65536, [65536, 65535, 4097, 0]),
])
def test_crc32c_equals_checksum_jax_and_host(width, lengths):
    data, lens = _crc_case(width, lengths, width)
    got = checksum.crc32c(torch.from_numpy(data), torch.from_numpy(lens)).numpy()
    want = np.asarray(checksum_jax.crc32c(jnp.asarray(data), jnp.asarray(lens)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    host = [crc32c_raw(data[i, :n].tobytes()) for i, n in enumerate(lens)]
    assert got.tolist() == host
    assert host == [host_crc.crc32c_raw(data[i, :n]) for i, n in enumerate(lens)]
    masked = checksum.mask_crc(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(
        masked, np.asarray(checksum_jax.mask_crc(jnp.asarray(want))).astype(np.int64))
    assert masked.tolist() == [host_crc.mask_crc(c) for c in host]


@pytest.fixture(scope="module")
def stream(synthetic):
    """A JAX-framed stream of the synthetic cases with a stored (random)
    chunk as block 2, and a padding chunk after the header."""
    data = b"".join(c for _, c in synthetic)
    noise = np.random.default_rng(9).integers(0, 256, 65536, dtype=np.uint8)
    data = data[:131072] + noise.tobytes() + data[131072:]
    s = jax_framing.compress_framed(data)
    head = len(jax_framing.HEADER)
    s = s[:head] + bytes([0xFE, 3, 0, 0, 1, 2, 3]) + s[head:]
    kinds = [kind for kind, _, _ in jax_framing.iter_frames(s)]
    assert kinds.count("uncompressed") == 1 and kinds[2] == "uncompressed"
    return data, s


def test_framed_decompress_equals_jax(stream):
    data, s = stream
    got = snappy_framed_decompress_device(s, device="cpu")
    assert got == jax_framed(s) == data
    assert snappy_framed_decompress_device(s, False, device="cpu") == data


def _flip(s: bytes, pos: int) -> bytes:
    return s[:pos] + bytes([s[pos] ^ 0x40]) + s[pos + 1:]


@pytest.mark.parametrize("what", ["compressed_crc", "uncompressed_crc", "header"])
def test_framed_decompress_raises_as_jax(stream, what):
    _, s = stream
    # [padding, block 0, block 1, stored block 2, ...]
    offsets = [pos for _, pos in port_framing.chunk_spans(s)]
    pos = {"compressed_crc": offsets[4] + 4,  # block 3: compressed chunk 2
           "uncompressed_crc": offsets[3] + 4,
           "header": 3}[what]
    bad = _flip(s, pos)
    with pytest.raises(MalformedInputException) as want:
        jax_framed(bad)
    with pytest.raises(PortMalformed) as got:
        snappy_framed_decompress_device(bad, device="cpu")
    assert got.value.offset == want.value.offset
    assert got.value.offset == {"compressed_crc": 2, "uncompressed_crc": 0,
                                "header": 0}[what]


def test_host_framer_writes_the_jax_framer_bytes(stream):
    data, _ = stream
    want = jax_framing.compress_framed(data[:200000], compressor=SnappyRefCompressor())
    assert port_framing.compress_framed(data[:200000]) == want
    assert list(port_framing.iter_frames(want)) == list(jax_framing.iter_frames(want))
