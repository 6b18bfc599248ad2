"""Batched device pipelines, and data parallelism over the devices of one
process. Counterpart of ``aircompressor_tpu.ops.pipeline``.

The unit of device work is a batch of independent chunks: a (B, L) uint8
batch and (B,) lengths. ``checksum_step`` and ``snappy_roundtrip_step`` chain
the kernels over one batch on one device. A ``Mesh`` is an ordered tuple of
devices; the ``sharded_*`` functions split the batch along dim 0 into equal
shards in order (B must be a multiple of the mesh size, as ``shard_map``
requires), run shard k on device k under ``torch.cuda.device`` (each
wrapper launches on the current stream of the current device), gather the
per-chunk results back in batch order on the device of the input, and sum
the byte totals as int64: the ``psum`` of the JAX functions, which sum
int32 (the two agree below 2 GiB). Launches on one device do not wait for
another's, so the shards of a mesh of cards run side by side.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from . import checksum, snappy_decode, snappy_encode, xxhash
from .batch import _rows


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one batch axis."""
    devices: tuple[torch.device, ...]
    axis: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis: str = "dp") -> Mesh:
    """A mesh over ``devices``, or over every CUDA device when none are
    given (raises where there is none). The CPU has no separate devices:
    pass ``[torch.device("cpu")] * n`` for a mesh of n CPU slots."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a mesh: pass devices= to use others")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(torch.device("cuda", torch.cuda.current_device())
                      if d.type == "cuda" and d.index is None else d for d in devices), axis)


def on_device(device: torch.device):
    """The context a shard runs in: its card made current."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


# --------------------------------------------------------------- one device
def checksum_step(data: torch.Tensor, lengths: torch.Tensor) -> dict:
    """Batched checksums: xxh64 (zstd frames) as one int64 holding its 64
    bits, xxh32 (LZ4 frames), masked CRC32-C (Snappy framing) and the byte
    total of the lengths (int64).

    ``"bytes"`` sums the raw lengths, as the JAX step's sum (and its
    ``psum``) does, while the three hashes clamp each length to [0, L]: a
    row of length -7 hashes as the empty row and one past L as the whole
    row. The JAX tiers hash such rows by the raw length and give values of
    neither row (F11 in ROADMAP.md)."""
    return {"xxh64": xxhash.xxh64(data, lengths), "xxh32": xxhash.xxh32(data, lengths),
            "crc32c": checksum.mask_crc(checksum.crc32c(data, lengths)),
            "bytes": lengths.to(torch.int64).sum()}


def snappy_roundtrip_step(data: torch.Tensor, lengths: torch.Tensor, out_cap: int):
    """Compress, decompress and checksum on the device: ``(comp, comp_lens,
    out, out_lens, ok, crc)``. ``ok`` is the decode's and the encode's."""
    comp, comp_lens, enc_ok = snappy_encode.encode(data, lengths)
    out, out_lens, ok = snappy_decode.decode(comp, comp_lens, out_cap=out_cap)
    crc = checksum.mask_crc(checksum.crc32c(out, out_lens))
    return comp, comp_lens, out, out_lens, ok & enc_ok, crc


# ---------------------------------------------------------------- the mesh
def _shards(mesh: Mesh, *arrays: torch.Tensor):
    """Each device with its rows of every array, in batch order."""
    rows = arrays[0].shape[0]
    if rows % mesh.size:
        raise ValueError(f"a batch of {rows} rows does not split evenly over "
                         f"{mesh.size} devices")
    per = rows // mesh.size
    for k, device in enumerate(mesh.devices):
        yield device, [a[k * per:(k + 1) * per].to(device) for a in arrays]


def _gather(parts: list, device: torch.device):
    """Concatenate the shards' per-chunk results (tuples or dicts of
    tensors) in batch order on ``device``; one shard's are not copied."""
    def cat(ts):
        return ts[0].to(device) if len(ts) == 1 else torch.cat([t.to(device) for t in ts])

    if isinstance(parts[0], dict):
        return {key: cat([p[key] for p in parts]) for key in parts[0]}
    return tuple(cat([p[i] for p in parts]) for i in range(len(parts[0])))


def _psum(totals: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    return torch.stack([t.to(device) for t in totals]).sum()


def sharded(mesh: Mesh, step):
    """``step(*shard) -> (per-chunk results, total)`` run data-parallel over
    the mesh: returns ``run(*arrays) -> (gathered results, summed total)``."""

    def run(*arrays: torch.Tensor):
        parts, totals = [], []
        for device, shard in _shards(mesh, *arrays):
            with on_device(device):
                rows, total = step(*shard)
            parts.append(rows)
            totals.append(total)
        home = arrays[0].device
        return _gather(parts, home), _psum(totals, home)

    return run


def _checksum_shard(data, lengths):
    out = checksum_step(data, lengths)
    return out, out.pop("bytes")


def sharded_checksum_step(mesh: Mesh):
    """``checksum_step`` over the mesh; "bytes" is the global total."""
    run = sharded(mesh, _checksum_shard)

    def checksums(data: torch.Tensor, lengths: torch.Tensor) -> dict:
        out, total = run(data, lengths)
        return {**out, "bytes": total}

    return checksums


def _compress_shard(data, lengths, width: int):
    """Kernel #3 on one shard, its blocks cut or zero-padded to ``width``."""
    comp, comp_lens, ok = snappy_encode.encode(data, lengths)
    if comp.shape[1] >= width:
        comp = comp[:, :width]
    else:
        comp = torch.nn.functional.pad(comp, (0, width - comp.shape[1]))
    return (comp, comp_lens, ok), comp_lens.to(torch.int64).sum()


def _check_encoded(comp_lens: torch.Tensor, ok: torch.Tensor, width: int, offset: int = 0):
    """Raise RuntimeError naming the first chunk (``offset`` + its row) that
    the encode kernel flags or whose block does not fit in ``width``."""
    bad = torch.nonzero(~ok | (comp_lens > width)).flatten().tolist()
    if bad:
        raise RuntimeError(f"chunk {offset + bad[0]} failed to encode within {width} "
                           f"bytes (encoded length {int(comp_lens[bad[0]])}, ok "
                           f"{bool(ok[bad[0]])})")


def sharded_compress(mesh: Mesh, out_cap: int | None = None):
    """Snappy compress over the mesh: ``run(data, lengths) -> (comp,
    comp_lens, total)``, comp (B, out_cap or the encoder's OUT_CAP) in batch
    order. Raises RuntimeError naming the first chunk that the encode kernel
    flags, or whose block does not fit in ``out_cap``."""
    width = snappy_encode.OUT_CAP if out_cap is None else out_cap
    run = sharded(mesh, lambda data, lengths: _compress_shard(data, lengths, width))

    def compress(data: torch.Tensor, lengths: torch.Tensor):
        (comp, comp_lens, ok), total = run(data, lengths)
        _check_encoded(comp_lens, ok, width)
        return comp, comp_lens, total

    return compress


def _decompress_shard(comp, comp_lens, out_cap: int):
    out, out_lens, ok = snappy_decode.decode(comp, comp_lens, out_cap=out_cap)
    return (out, out_lens, ok), out_lens.to(torch.int64).sum()


def sharded_decompress(mesh: Mesh, out_cap: int = snappy_decode.MAX_OUT):
    """Snappy decode (kernel #1) over the mesh: ``run(comp, comp_lens) ->
    (out, out_lens, ok, total)``, total the sum of out_lens."""
    run = sharded(mesh, lambda comp, comp_lens: _decompress_shard(comp, comp_lens, out_cap))

    def decompress(comp: torch.Tensor, comp_lens: torch.Tensor):
        (out, out_lens, ok), total = run(comp, comp_lens)
        return out, out_lens, ok, total

    return decompress


def assemble_frames(comp, comp_lens) -> list[bytes]:
    """Each row's first ``comp_lens[i]`` bytes, in batch order, on the host."""
    if isinstance(comp, torch.Tensor):
        return _rows(comp, comp_lens)
    comp, comp_lens = np.asarray(comp), np.asarray(comp_lens)
    return [comp[i, :comp_lens[i]].tobytes() for i in range(comp.shape[0])]
