"""Data parallelism over processes, on ``torch.distributed``. Counterpart of
``aircompressor_tpu.ops.multihost``.

One rank a device. Every process calls ``initialize`` with the store's
address, the world size and its rank; it feeds its own rows of the global
batch (``make_global_batch``), runs the same step on them on its device,
and the byte totals are summed over the ranks by ``all_reduce``, so every
rank holds the global total. Per-chunk results stay with the rank that made
them (``local_rows``), in batch order.

The backend is NCCL for a rank on a card and gloo for a rank on the CPU.
``backend="gloo"`` on a card is allowed (several ranks on one card, which
NCCL refuses): the totals are then reduced as CPU tensors. An error of the
backend propagates; nothing retries on another.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from . import pipeline, snappy_encode

_device: torch.device | None = None  # this rank's device, set by initialize


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device=None, backend: str | None = None) -> None:
    """Join the process group; a second call is a no-op.

    ``coordinator_address`` is ``"host:port"`` (a TCP store, served by rank
    0) or a ``file://`` URL shared by the ranks; without it, the ``env://``
    variables that launchers set (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) are read. The rank's device defaults to
    ``cuda:{rank % device_count}``; without CUDA the call raises, unless
    ``device="cpu"`` is given. The backend defaults to NCCL on a card and
    gloo on the CPU.
    """
    global _device
    if dist.is_initialized():
        return
    if coordinator_address is None:
        init_method = "env://"
        rank = int(os.environ["RANK"]) if process_id is None else process_id
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        rank = process_id
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this rank: pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {} if num_processes is None else {"world_size": num_processes}
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    _device = device


def _local_device() -> torch.device:
    if not dist.is_initialized() or _device is None:
        raise RuntimeError("call multihost.initialize first")
    return _device


def _wire_device() -> torch.device:
    """Where a collective's tensors live: the card for NCCL, else the CPU."""
    return _local_device() if dist.get_backend() == "nccl" else torch.device("cpu")


def _check_mesh(mesh: pipeline.Mesh) -> None:
    if mesh.size != dist.get_world_size() or mesh.devices[dist.get_rank()] != _local_device():
        raise ValueError(f"{mesh} is not the process group's mesh: use global_mesh()")


def global_mesh(axis: str = "dp") -> pipeline.Mesh:
    """The process group's mesh: each rank's device, in rank order."""
    local = _local_device()
    devices = [None] * dist.get_world_size()
    dist.all_gather_object(devices, str(local))
    return pipeline.Mesh(tuple(torch.device(d) for d in devices), axis)


@dataclass(frozen=True)
class GlobalRows:
    """This rank's rows ``[offset, offset + len(local))`` of a batch of
    ``rows`` rows along the mesh's batch axis."""
    local: torch.Tensor
    offset: int
    rows: int

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.rows, *self.local.shape[1:])


def _all_gather_ints(value: int) -> list[int]:
    t = torch.tensor([value], dtype=torch.int64, device=_wire_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [int(v) for v in out]


def make_global_batch(mesh: pipeline.Mesh, local_data: np.ndarray,
                      local_lengths: np.ndarray) -> tuple[GlobalRows, GlobalRows]:
    """This rank's rows of the global (B, L) batch and lengths, on its
    device. Every rank must give the same number of rows, as
    ``make_array_from_process_local_data`` needs; ranks hold the global
    batch's rows in rank order."""
    _check_mesh(mesh)
    device = _local_device()
    data = torch.from_numpy(np.ascontiguousarray(local_data, dtype=np.uint8)).to(device)
    lengths = torch.from_numpy(np.ascontiguousarray(local_lengths, dtype=np.int32)).to(device)
    if data.dim() != 2 or lengths.shape != data.shape[:1]:
        raise ValueError(f"need (B, L) rows and (B,) lengths, got {tuple(data.shape)} "
                         f"and {tuple(lengths.shape)}")
    counts = _all_gather_ints(data.shape[0])
    if len(set(counts)) != 1:
        raise ValueError(f"every rank must give the same number of rows, got {counts}")
    offset, rows = dist.get_rank() * counts[0], sum(counts)
    return GlobalRows(data, offset, rows), GlobalRows(lengths, offset, rows)


def _local_step(shard_step, *args: GlobalRows):
    """``shard_step`` on this rank's rows, on its device: its per-chunk
    results as GlobalRows (a tuple or a dict) and its total summed over the
    ranks, on every rank."""
    first = args[0]
    with pipeline.on_device(_local_device()):
        rows, total = shard_step(*(a.local for a in args))
    total = total.to(_wire_device())
    dist.all_reduce(total)
    wrap = lambda t: GlobalRows(t, first.offset, first.rows)  # noqa: E731
    if isinstance(rows, dict):
        return {key: wrap(t) for key, t in rows.items()}, total
    return tuple(wrap(t) for t in rows), total


def distributed_checksum(mesh: pipeline.Mesh):
    """``pipeline.checksum_step`` on every rank's rows; "bytes" is the global
    total, on every rank."""
    _check_mesh(mesh)

    def run(data: GlobalRows, lengths: GlobalRows) -> dict:
        out, total = _local_step(pipeline._checksum_shard, data, lengths)
        return {**out, "bytes": total}

    return run


def distributed_compress(mesh: pipeline.Mesh, out_cap: int | None = None):
    """Snappy compress (kernel #3) on every rank's rows: ``(comp, comp_lens,
    total)``, the total over all ranks. A chunk that the kernel flags, or
    whose block does not fit in ``out_cap``, raises RuntimeError naming its
    index in the global batch (after the totals' collective, which every
    rank reaches)."""
    _check_mesh(mesh)
    width = snappy_encode.OUT_CAP if out_cap is None else out_cap

    def run(data: GlobalRows, lengths: GlobalRows):
        (comp, comp_lens, ok), total = _local_step(
            lambda d, n: pipeline._compress_shard(d, n, width), data, lengths)
        pipeline._check_encoded(comp_lens.local, ok.local, width, data.offset)
        return comp, comp_lens, total

    return run


def distributed_decompress(mesh: pipeline.Mesh, out_cap: int = 65536):
    """Snappy decode (kernel #1) on every rank's rows: ``(out, out_lens, ok,
    total)``, the total over all ranks."""
    _check_mesh(mesh)

    def run(comp: GlobalRows, comp_lens: GlobalRows):
        (out, out_lens, ok), total = _local_step(
            lambda c, n: pipeline._decompress_shard(c, n, out_cap), comp, comp_lens)
        return out, out_lens, ok, total

    return run


def local_rows(x) -> np.ndarray:
    """This rank's rows of a batch-sharded result, in batch order, as numpy."""
    return (x.local if isinstance(x, GlobalRows) else x).cpu().numpy()


def scaling_report(mesh: pipeline.Mesh, seconds_1dev: float, seconds_mesh: float,
                   total_bytes: int) -> dict:
    """Throughput and efficiency of a mesh run against a one-device run."""
    n = mesh.size
    t1 = total_bytes / seconds_1dev if seconds_1dev else 0.0
    tn = total_bytes / seconds_mesh if seconds_mesh else 0.0
    return {
        "devices": int(n),
        "processes": dist.get_world_size() if dist.is_initialized() else 1,
        "GBps_1dev": t1 / 1e9,
        "GBps_mesh": tn / 1e9,
        "scaling_efficiency": (tn / (t1 * n)) if t1 else 0.0,
    }
