"""Batched Snappy, LZ4, LZO, deflate and zstd on a torch device: the user
surface over the kernels.

Counterpart of ``aircompressor_tpu.ops.batch``'s ``SnappyBatchCodec``,
``Lz4BatchCodec``, ``LzoBatchCodec``, ``DeflateBatchCodec``,
``ZstdBatchCodec`` and ``snappy_framed_decompress_device``. Every chunk to
decode goes to the kernels: the decode kernels read their input from device
memory and have no limit on the compressed length or on a deflate chunk's
blocks, so there is no host tier for large blobs. Every Snappy or LZ4 chunk
to compress goes through an encode kernel, and zstd through its matcher
and emission kernels around a host planner; LZO and deflate compress on
the host, as in the JAX package. Before its first batch each way, a codec
runs a 64 KB canary through the kernels and raises if the bytes differ;
there is no fallback. A codec runs on the card unless it is given
``device="cpu"``, where the plain PyTorch versions run.
"""

from __future__ import annotations

import functools
import zlib
from typing import Sequence

import numpy as np
import torch

from ..errors import MalformedInputException
from ..host import framed, lz4 as host_lz4, lzo as host_lzo, snappy as host_snappy
from ..host.crc32c import crc32c_raw, mask_crc
from ..host.deflate import plan as deflate_plan
from ..host.zstd import frame_enc as host_zstd_enc
from . import (checksum, deflate_decode, lz4_decode, lz4_encode, lzo_decode,
               snappy_decode, snappy_encode, zstd_decode, zstd_encode)

CHUNK = 65536


def _selfcheck_payload(seed: int = 0xA1C0) -> bytes:
    """A 64 KB canary of mixed content: repeated text at varied distances
    and an incompressible stretch (the same bytes as
    ``aircompressor_tpu.ops.batch._selfcheck_payload``). A small repetitive
    canary can pass a kernel that corrupts real chunks. The text is capped
    so that the random stretch always survives the cut to 64 KB."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(32, 127, int(n), dtype=np.uint8)
             for n in rng.integers(5, 400, 60)]
    parts: list = []
    total = 0
    for i in rng.integers(0, len(words), 400):
        w = words[int(i)]
        if total + w.size > 65536 - 8192:
            break
        parts.append(w)
        total += w.size
    parts.append(rng.integers(0, 256, 8192, dtype=np.uint8))
    return np.concatenate(parts).tobytes()[:65536]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _check_capacity(chunks: Sequence[bytes], max_chunk: int) -> None:
    """Raises ValueError naming the first chunk over ``max_chunk`` bytes."""
    for i, c in enumerate(chunks):
        if len(c) > max_chunk:
            raise ValueError(f"chunk {i} exceeds capacity {max_chunk}")


def _pack(blobs: Sequence[bytes], cap: int):
    B = len(blobs)
    buf = np.zeros((B, cap), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, b in enumerate(blobs):
        if len(b) > cap:
            raise ValueError(f"chunk {i} exceeds capacity {cap}")
        buf[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return buf, lens


@functools.cache
def _canary(host) -> tuple[bytes, bytes]:
    """The canary payload and its block from a host reference codec."""
    payload = _selfcheck_payload()
    return payload, host.compress(payload)


@functools.cache
def _zstd_canary() -> tuple[bytes, bytes]:
    """The canary payload and its frame from the host zstd encoder."""
    payload = _selfcheck_payload()
    return payload, host_zstd_enc.compress_bytes(payload)


def to_device_batch(buf: np.ndarray, lens: np.ndarray, device):
    """(B, cap) uint8 and (B,) lengths from numpy to ``device``, as the
    (uint8 (B, cap), int32 (B,)) tensors the kernels take."""
    buf = np.ascontiguousarray(buf)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    if buf.dtype != np.uint8 or buf.ndim != 2 or lens.shape != buf.shape[:1]:
        raise ValueError(f"need a (B, cap) uint8 batch and (B,) lengths, got "
                         f"{buf.dtype} {buf.shape} and {lens.shape}")
    return (torch.from_numpy(buf).to(device), torch.from_numpy(lens).to(device))


def _rows(out: torch.Tensor, lens: torch.Tensor) -> list[bytes]:
    """Each row's first ``lens[i]`` bytes, copying to the host only the
    columns that some row needs."""
    lens = lens.cpu().numpy()
    width = int(lens.max()) if lens.size else 0
    out = out[:, :width].cpu().numpy()
    return [out[i, :lens[i]].tobytes() for i in range(len(lens))]


class _BlockBatchCodec:
    """Chunk-parallel block encode and decode of chunks up to ``max_chunk``
    bytes, on ``device`` (the card by default), through the ``decoder`` and
    ``encoder`` op modules, with ``host`` the reference codec of the
    self-checks."""

    name: str
    host = decoder = encoder = None

    def __init__(self, max_chunk: int = CHUNK, *, device="cuda"):
        if max_chunk > CHUNK:
            raise ValueError(f"{self.name} batch chunks are capped at 64KB")
        self.max_chunk = max_chunk
        self.device = torch.device(device)
        self._decode_checked = False
        self._encode_checked = False

    def _decode_self_check(self) -> None:
        payload, blob = _canary(self.host)
        out, out_lens, ok = self.decoder.decode(
            *to_device_batch(*_pack([blob], len(blob)), self.device))
        n = int(out_lens[0])
        if not (bool(ok[0]) and out[0, :n].cpu().numpy().tobytes() == payload):
            raise RuntimeError(
                f"{self.name} decode failed its self-check on {self.device}")
        self._decode_checked = True

    def _encode_self_check(self) -> None:
        payload, _ = _canary(self.host)
        comp, comp_lens, ok = self.encoder.encode(
            *to_device_batch(*_pack([payload], len(payload)), self.device))
        blob = _rows(comp, comp_lens)[0]
        if not (bool(ok[0]) and self.host.decompress(blob, len(payload)) == payload):
            raise RuntimeError(
                f"{self.name} encode failed its self-check on {self.device}")
        self._encode_checked = True

    def compress_chunks(self, chunks: Sequence[bytes]) -> list[bytes]:
        """One block for each chunk; raises ValueError for a chunk over
        ``max_chunk`` and RuntimeError if the kernel flags a chunk not ok."""
        if not chunks:
            return []
        _check_capacity(chunks, self.max_chunk)
        if not self._encode_checked:
            self._encode_self_check()
        cap = _round_up(max(1, max(len(c) for c in chunks)), 16)
        comp, comp_lens, ok = self.encoder.encode(
            *to_device_batch(*_pack(chunks, cap), self.device))
        bad = np.nonzero(~ok.cpu().numpy())[0]
        if bad.size:
            raise RuntimeError(f"{self.name} encode overflowed its output on "
                               f"chunk {int(bad[0])}")
        return _rows(comp, comp_lens)

    def decompress_chunks(self, blobs: Sequence[bytes]) -> list[bytes]:
        """Decode each blob; raises MalformedInputException naming the
        index of the first chunk that is malformed or over ``max_chunk``."""
        if not blobs:
            return []
        if not self._decode_checked:
            self._decode_self_check()
        cap = _round_up(max(1, max(len(b) for b in blobs)), 16)
        comp, comp_lens = to_device_batch(*_pack(blobs, cap), self.device)
        out, out_lens, ok = self.decoder.decode(comp, comp_lens,
                                                out_cap=self.max_chunk)
        bad = np.nonzero(~ok.cpu().numpy())[0]
        if bad.size:
            raise MalformedInputException(int(bad[0]),
                                          f"malformed {self.name} chunk in batch")
        return _rows(out, out_lens)


class SnappyBatchCodec(_BlockBatchCodec):
    """Chunk-parallel Snappy encode and decode of chunks up to ``max_chunk``
    bytes, on ``device`` (the card by default)."""

    name, host, decoder, encoder = "snappy", host_snappy, snappy_decode, snappy_encode


class Lz4BatchCodec(_BlockBatchCodec):
    """Chunk-parallel LZ4 block encode and decode of chunks up to
    ``max_chunk`` bytes, on ``device`` (the card by default)."""

    name, host, decoder, encoder = "lz4", host_lz4, lz4_decode, lz4_encode


class LzoBatchCodec(_BlockBatchCodec):
    """Chunk-parallel LZO1X decode of chunks up to ``max_chunk`` bytes on
    ``device`` (the card by default). Compression runs the host encoder
    for each chunk: the reference has no native LZO, and neither does the
    JAX package."""

    name, host, decoder = "lzo", host_lzo, lzo_decode

    def compress_chunks(self, chunks: Sequence[bytes]) -> list[bytes]:
        """One LZO1X block for each chunk, on the host; raises ValueError for
        a chunk over ``max_chunk``."""
        _check_capacity(chunks, self.max_chunk)
        return [host_lzo.compress(c) for c in chunks]


def deflate_raw(data: bytes, level: int = 6) -> bytes:
    """One raw-deflate stream of ``data`` from the standard library's zlib."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


@functools.cache
def _deflate_canary() -> tuple[bytes, bytes]:
    """The canary payload and its raw-deflate stream at level 6."""
    payload = _selfcheck_payload()
    return payload, deflate_raw(payload)


def _zlib_reason(blob: bytes, max_chunk: int) -> str:
    """What the standard library's zlib says of a chunk the planner
    rejected."""
    try:
        out = zlib.decompress(blob, -15)
    except zlib.error as e:
        return str(e)
    if len(out) > max_chunk:
        return f"deflate chunk decodes to more than {max_chunk} bytes"
    return "malformed deflate chunk in batch"


class DeflateBatchCodec:
    """Chunk-parallel raw-deflate decode of chunks of up to ``max_chunk``
    bytes out, on ``device`` (the card by default): the C++ planner on the
    host (blocks and Huffman tables), then the decode kernel, which derives
    every byte from the bitstream. Every chunk goes through the kernel,
    whatever its number of blocks. Compression runs zlib on the host at
    ``level``, as the JAX package's host tier does."""

    def __init__(self, max_chunk: int = CHUNK, level: int = 6, *, device="cuda"):
        if max_chunk > CHUNK:
            raise ValueError(f"deflate batch chunks are capped at {CHUNK} bytes")
        self.max_chunk = max_chunk
        self.level = level
        self.device = torch.device(device)
        self._decode_checked = False

    def compress_chunks(self, chunks: Sequence[bytes]) -> list[bytes]:
        """One raw-deflate stream for each chunk, on the host; raises
        ValueError for a chunk over ``max_chunk``."""
        _check_capacity(chunks, self.max_chunk)
        return [deflate_raw(c, self.level) for c in chunks]

    def _decode_self_check(self) -> None:
        payload, blob = _deflate_canary()
        if self._decode([blob], CHUNK) != [payload]:
            raise RuntimeError(f"deflate decode failed its self-check on {self.device}")
        self._decode_checked = True

    def _decode(self, blobs: Sequence[bytes], out_cap: int) -> list[bytes]:
        buf, lens = _pack(blobs, _round_up(max(1, max(len(b) for b in blobs)), 16))
        plan = deflate_plan.plan(buf, lens, out_cap=out_cap)
        comp, comp_lens = to_device_batch(buf, lens, self.device)
        out, out_lens, ok = deflate_decode.decode(
            comp, comp_lens, deflate_decode.upload(plan, self.device), out_cap=out_cap)
        planned = plan.info[:, 3] == deflate_plan.ST_OK
        good = ok.cpu().numpy() & planned & (out_lens.cpu().numpy() == plan.info[:, 0])
        bad = np.nonzero(~good)[0]
        if bad.size:
            i = int(bad[0])
            reason = (_zlib_reason(blobs[i], out_cap) if not planned[i]
                      else "malformed deflate chunk in batch")
            raise MalformedInputException(i, reason)
        return _rows(out, out_lens)

    def decompress_chunks(self, blobs: Sequence[bytes]) -> list[bytes]:
        """Decode each blob, one raw-deflate stream each; raises
        MalformedInputException naming the index of the first chunk that is
        malformed or over ``max_chunk``, with zlib's reason where the
        planner rejected it."""
        if not blobs:
            return []
        if not self._decode_checked:
            self._decode_self_check()
        return self._decode(blobs, self.max_chunk)


class ZstdBatchCodec:
    """Frame-parallel zstd of chunks of up to ``max_chunk`` bytes each, one
    single-block frame a chunk, on ``device`` (the card by default).
    ``compress_chunks`` runs ``zstd_encode.compress_batch`` at ``level``:
    the DFAST matcher kernel (level 3), the host planner, the emission
    kernel and host frame assembly; ``decompress_chunks`` the three kernels
    of ``zstd_decode``. Every frame goes through them, with no host
    fallback. Before its first batch each way, the codec runs a canary
    through them and raises if it does not come back exact."""

    def __init__(self, max_chunk: int = CHUNK, level: int = 3, *, device="cuda"):
        if max_chunk > CHUNK:
            raise ValueError(f"zstd device chunks are capped at {CHUNK} bytes")
        self.max_chunk = max_chunk
        self.level = level
        self.device = torch.device(device)
        self._decode_checked = False
        self._encode_checked = False

    def _decode_self_check(self) -> None:
        payload, frame = _zstd_canary()
        out = zstd_decode.decode_batch([frame], device=self.device)
        if out != [payload]:
            raise RuntimeError(f"zstd decode failed its self-check on {self.device}")
        self._decode_checked = True

    def _encode_self_check(self) -> None:
        """The 64 KB canary and a 1600-byte tiled string (the payloads of
        the JAX codec's encode self-check), compressed at ``level`` and
        decoded by the port's own zstd decode."""
        payloads = [_selfcheck_payload(), bytes(np.tile(np.frombuffer(
            b"zstd device encode self check 0123456789", np.uint8), 40))]
        frames = zstd_encode.compress_batch(payloads, self.level, device=self.device)
        try:
            ok = zstd_decode.decode_batch(frames, device=self.device) == payloads
        except MalformedInputException as e:
            raise RuntimeError(f"zstd encode failed its self-check on {self.device}: "
                               f"{e}") from e
        if not ok:
            raise RuntimeError(f"zstd encode failed its self-check on {self.device}")
        self._encode_checked = True

    def compress_chunks(self, chunks: Sequence[bytes]) -> list[bytes]:
        """One zstd frame for each chunk; raises ValueError for a chunk over
        ``max_chunk`` and RuntimeError where the matcher kernel flags a
        chunk or proposes sequences that fail the host check."""
        if not chunks:
            return []
        _check_capacity(chunks, self.max_chunk)
        if not self._encode_checked:
            self._encode_self_check()
        return zstd_encode.compress_batch(chunks, self.level, device=self.device)

    def decompress_chunks(self, blobs: Sequence[bytes]) -> list[bytes]:
        """Decode each blob, one zstd frame each; raises
        MalformedInputException naming the index of the first frame that is
        malformed, over ``max_chunk``, or fails its checksum."""
        if not blobs:
            return []
        if not self._decode_checked:
            self._decode_self_check()
        return zstd_decode.decode_batch(blobs, out_cap=self.max_chunk,
                                        device=self.device)


def snappy_framed_decompress_device(data: bytes, verify_checksums: bool = True,
                                    *, device="cuda") -> bytes:
    """Decode an x-snappy-framed stream: the framing walk on the host, every
    compressed chunk in one batch through the decode kernel, their CRCs in
    one batched CRC32-C on the device, and the CRCs of uncompressed chunks
    on the host. A bad compressed chunk or CRC raises
    MalformedInputException with the chunk's index among the compressed
    chunks; a bad uncompressed-chunk CRC raises it with index 0, as the JAX
    function does."""
    comp_chunks: list[bytes] = []
    comp_crcs: list[int] = []
    parts: list[bytes | None] = []
    plain: list[tuple[bytes, int]] = []
    for kind, payload, crc in framed.iter_frames(data):
        if kind == "compressed":
            comp_chunks.append(payload)
            comp_crcs.append(crc)
            parts.append(None)
        else:
            plain.append((payload, crc))
            parts.append(payload)
    decoded: list[bytes] = []
    if comp_chunks:
        cap = _round_up(max(1, max(len(b) for b in comp_chunks)), 16)
        comp, comp_lens = to_device_batch(*_pack(comp_chunks, cap), device)
        out, out_lens, ok = snappy_decode.decode(comp, comp_lens, out_cap=CHUNK)
        okn = ok.cpu().numpy()
        if not okn.all():
            raise MalformedInputException(
                int(np.nonzero(~okn)[0][0]), "malformed snappy framed chunk")
        if verify_checksums:
            got = checksum.mask_crc(checksum.crc32c(out, out_lens)).cpu().numpy()
            bad = np.nonzero(got != np.asarray(comp_crcs, np.int64))[0]
            if bad.size:
                raise MalformedInputException(int(bad[0]), "chunk checksum mismatch")
        decoded = _rows(out, out_lens)
    if verify_checksums:
        for payload, crc in plain:
            if mask_crc(crc32c_raw(payload)) != crc:
                raise MalformedInputException(0, "uncompressed chunk checksum mismatch")
    it = iter(decoded)
    return b"".join(p if p is not None else next(it) for p in parts)
