"""Entry of the port's main path: batched Snappy decode, then xxh64 of every
decoded chunk, on one device (``entry``), and the same step data-parallel
over n devices (``dryrun_multichip``). Counterparts of
``__graft_entry__.entry`` and ``__graft_entry__.dryrun_multichip``."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .host import snappy as host_snappy
from .ops import pipeline, snappy_decode, xxhash
from .ops.batch import to_device_batch


def _sample_batch(n_chunks: int, chunk: int = 4096, cap: int = 5120):
    """Compressed chunks (via the host reference codec) padded to (B, cap);
    the same arrays as ``__graft_entry__._sample_batch``."""
    rng = np.random.default_rng(0)
    base = bytes(rng.integers(0, 4, size=chunk, dtype=np.uint8))
    blobs = [host_snappy.compress(base[i % 7:] + base[:i % 7])
             for i in range(n_chunks)]
    buf = np.zeros((n_chunks, cap), np.uint8)
    lens = np.zeros(n_chunks, np.int32)
    for i, b in enumerate(blobs):
        buf[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return buf, lens, chunk


def decode_and_hash(comp: torch.Tensor, comp_lens: torch.Tensor,
                    out_cap: int = snappy_decode.MAX_OUT) -> dict:
    """Decode a (B, cap) batch and hash each decoded chunk with XXH64."""
    out, out_lens, ok = snappy_decode.decode(comp, comp_lens, out_cap=out_cap)
    return {"out": out, "out_lens": out_lens, "ok": ok,
            "xxh64": xxhash.xxh64(out, out_lens)}


def entry(device="cuda"):
    """``(step, (comp, comp_lens))`` for the 8-chunk sample batch on
    ``device`` (the card unless the caller asks for "cpu");
    ``step(comp, comp_lens)`` returns the dict of ``decode_and_hash``."""
    buf, lens, chunk = _sample_batch(8)
    return (functools.partial(decode_and_hash, out_cap=chunk),
            to_device_batch(buf, lens, device))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Decode and hash 4 sample chunks a device over a mesh of the first
    ``n_devices`` CUDA devices (raises if there are fewer), or of
    ``n_devices`` CPU slots for ``device="cpu"``, with the byte total summed
    over the mesh. Raises unless every chunk decodes and the total is 4096
    bytes a chunk; returns the gathered results of ``decode_and_hash`` with
    the total under "bytes"."""
    if torch.device(device).type == "cpu":
        devices = [torch.device("cpu")] * n_devices
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n_devices:
            raise RuntimeError(f"{n_devices} CUDA devices asked for, {count} present")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    mesh = pipeline.make_mesh(devices)
    n_chunks = 4 * n_devices
    buf, lens, chunk = _sample_batch(n_chunks)

    def step(comp, comp_lens):
        out = decode_and_hash(comp, comp_lens, out_cap=chunk)
        return out, out["out_lens"].to(torch.int64).sum()

    out, total = pipeline.sharded(mesh, step)(*to_device_batch(buf, lens, devices[0]))
    if not bool(out["ok"].all()):
        raise RuntimeError("sharded decode failed")
    if int(total) != n_chunks * chunk:
        raise RuntimeError(f"decoded {int(total)} bytes, want {n_chunks * chunk}")
    return {**out, "bytes": total}
