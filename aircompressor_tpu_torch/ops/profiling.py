"""Per-kernel micro-profiling on the card.

Counterpart of ``aircompressor_tpu.ops.profiling`` (the reference's
BenchmarkCount/JMH analogue):

- ``match_length_grid()`` times the host match-length primitive
  (``host/zstd/block_enc._match_lengths``, shared by the zstd and LZO
  matchers) over a match-length x candidate-count grid and reports ns per
  resolved candidate. It runs on the host (numpy).
- ``kernel_rows()`` times the Snappy and LZ4 decode kernels and the xxh64
  kernel on 64 KB chunks of generated data, by CUDA events, and reports
  each one beside its bytes bound at the card's memory rate. The decode
  rows also read the kernels' loop counts (``with_steps``): one warp
  decodes a chunk, so a batch that fits in one wave of the card is bound by
  its longest chain, and ``ns_per_iteration`` is the time over that chain.
  It needs a CUDA device and raises without one: there is no CPU path.
- ``trace(outdir)`` wraps ``torch.profiler`` (the CPU, and the card when
  there is one) and writes a Chrome trace into ``outdir``;
  ``kernel_ms(fn, kernel, reps, outdir)`` reads one kernel's mean device
  time from such a trace.

CLI: ``python -m aircompressor_tpu_torch.ops.profiling [outdir]`` prints the
report as JSON; with ``outdir`` the kernel rows run inside ``trace``.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time

import numpy as np
import torch

from ._rows import MAX_CHUNK as CHUNK

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)


# ----------------------------------------------------------------- primitives
def match_length_grid(match_lengths=(8, 64, 512, 4096),
                      counts=(64, 4096),
                      trials: int = 3) -> list[dict]:
    """Cost of the match-length primitive per candidate over a grid (the
    reference's lz4/BenchmarkCount.java:40-59)."""
    from ..host.zstd import block_enc

    rows = []
    rng = np.random.default_rng(0)
    for mlen in match_lengths:
        for cnt in counts:
            # cnt segments of [random(mlen) x2 + unique separator]: each
            # second copy matches the first for exactly mlen bytes
            seg = 2 * mlen + 16
            block = rng.integers(0, 256, cnt * seg + 64, dtype=np.uint8)
            for k in range(cnt):
                base = k * seg
                block[base + mlen: base + 2 * mlen] = block[base: base + mlen]
            n = block.size
            pos = np.arange(cnt, dtype=np.int64) * seg + mlen
            cand = pos - mlen
            w8 = block_enc._u64_windows(block)
            best = float("inf")
            for _ in range(trials):
                breaks = block_enc._PeriodBreaks(block)
                t0 = time.perf_counter()
                out = block_enc._match_lengths(w8, pos, cand, n, breaks)
                best = min(best, time.perf_counter() - t0)
            rows.append({
                "primitive": "match_lengths",
                "match_len": mlen,
                "candidates": cnt,
                "ns_per_candidate": best / cnt * 1e9,
                "mean_len": float(out.mean()),
            })
    return rows


# -------------------------------------------------------------- device kernels
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def generated_data(batch: int) -> bytes:
    """The JAX function's data: 3 * batch * 1024 pieces of one random
    64-byte word, each 8 to 63 bytes long (``rng(0)``)."""
    rng = np.random.default_rng(0)
    word = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    return b"".join(word[: 8 + int(x)] for x in rng.integers(0, 56, 3 * batch * 1024))


def _best_ms(fn, trials: int) -> float:
    """Best device time of fn over ``trials`` calls by CUDA events, after
    one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def decode_bound_ms(comp_bytes: int, b: int, out_cap: int = CHUNK) -> float:
    """The bytes bound of a batched decode: the compressed bytes and the
    lengths read once, every output byte (zero tails included), each length
    and ok flag written once, at the card's memory rate."""
    return (comp_bytes + 4 * b + b * out_cap + 5 * b) / HBM_BYTES_PER_S * 1e3


def kernel_rows(data: bytes | None = None, batch: int = 256,
                trials: int = 3) -> list[dict]:
    """Event-timed rows for the Snappy and LZ4 decode kernels and the xxh64
    kernel on up to ``batch`` 64 KB chunks of ``data``: GB/s, loop counts,
    ns and bytes per iteration, and each kernel against its bytes bound."""
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_rows needs a CUDA device")
    from ..host import lz4 as host_lz4
    from ..host import snappy as host_snappy
    from . import lz4_decode, snappy_decode, xxhash
    from .batch import _pack, _round_up, to_device_batch

    dev = torch.device("cuda")
    name = card()
    if data is None:
        data = generated_data(batch)
    chunks = [data[i * CHUNK: (i + 1) * CHUNK]
              for i in range(min(batch, len(data) // CHUNK))]
    raw = sum(map(len, chunks))
    rows = []
    for kernel, compress, dec in (
            ("snappy_decode", host_snappy.compress, snappy_decode.decode),
            ("lz4_decode", host_lz4.compress, lz4_decode.decode)):
        blobs = [compress(c) for c in chunks]
        d, n = to_device_batch(*_pack(blobs, _round_up(max(map(len, blobs)) + 1, 1024)), dev)
        out, out_lens, ok, steps = dec(d, n, with_steps=True)
        if not bool(ok.all()) or out_lens.tolist() != [len(c) for c in chunks]:
            raise RuntimeError(f"{kernel} did not decode every chunk of the batch")
        ms = _best_ms(lambda: dec(d, n), trials)
        iterations, longest = int(steps.sum()), int(steps.max())
        bound = decode_bound_ms(sum(map(len, blobs)), len(chunks))
        rows.append({
            "kernel": kernel, "chunks": len(chunks), "ms": ms,
            "GBps": raw / ms / 1e6,
            "loop_iterations": iterations, "longest_chain": longest,
            "ns_per_iteration": ms * 1e6 / longest,
            "bytes_per_iteration": raw / iterations,
            "bound_ms": bound, "x_over_bound": ms / bound, "card": name,
        })

    b = len(chunks)
    tiled = (data * (b * CHUNK // len(data) + 1))[: b * CHUNK]
    d = torch.from_numpy(np.frombuffer(tiled, np.uint8).reshape(b, CHUNK).copy()).to(dev)
    n = torch.full((b,), CHUNK, dtype=torch.int32, device=dev)
    ms = _best_ms(lambda: xxhash.xxh64(d, n), trials)
    bound = (d.numel() + 4 * b + 8 * b) / HBM_BYTES_PER_S * 1e3
    gbps = d.numel() / ms / 1e6
    rows.append({
        "kernel": "xxh64", "chunks": b, "ms": ms, "GBps": gbps,
        "pct_of_hbm_roofline": 100.0 * gbps / (HBM_BYTES_PER_S / 1e9),
        "bound_ms": bound, "x_over_bound": ms / bound, "card": name,
    })
    return rows


@contextlib.contextmanager
def trace(outdir: str):
    """Profile the body with ``torch.profiler`` and write a Chrome trace to
    ``outdir/trace.json``; yields that path. A failure of the profiler or of the
    export is raised, not swallowed."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def kernel_ms(fn, kernel: str, reps: int, outdir: str, traces: int = 3) -> float:
    """Mean device time of the CUDA kernels whose name holds ``kernel``
    over ``reps`` calls of fn (after one warm-up call), from the kernel
    events of a ``trace`` into ``outdir``: the kernel alone, without the
    wrapper's allocations, copies and host time. The profiler now and then
    returns a trace without the device's kernel events, so a trace without
    the kernel is taken again, up to ``traces`` in all; raises if none
    holds it."""
    import json

    fn()
    for _ in range(traces):
        with trace(outdir) as path:
            for _ in range(reps):
                fn()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        durs = [e["dur"] for e in events
                if e.get("cat") == "kernel" and kernel in e.get("name", "")]
        if durs:
            return sum(durs) / len(durs) / 1e3
    raise RuntimeError(f"{traces} traces hold no kernel named like {kernel!r}")


def main(argv=None) -> None:
    import json
    import sys

    argv = sys.argv[1:] if argv is None else argv
    report = {"match_length_grid": match_length_grid()}
    if argv:
        with trace(argv[0]) as path:  # the trace wraps the device work
            report["kernels"] = kernel_rows()
        report["trace"] = path
    else:
        report["kernels"] = kernel_rows()
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
