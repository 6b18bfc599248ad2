"""The benchmark of ``aircompressor_tpu_torch`` on one card: one cell, one run.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run makes the cell's chunks from the seed, compresses them with the
benchmark's own compressor where the cell decodes, uploads them, warms up
the cell's shapes, then keeps the traffic mix's batches going for
``--seconds``: a closed loop of one caller that enqueues batch k + 1 before
it reads back batch k (depth 2). With ``--trace 1`` a second window of the
same length follows under the profiler. Then it compares what the batches
produced with the plain references and prints one JSON line: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, those of the host's clock from the first window and
those of the device from the profiler's trace of the second. It needs a
CUDA card, and exits non-zero without printing a result where there is
none, where the port cannot be imported, or where JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

CACHE = Path(__file__).resolve().parent / "_cache"
# Build and kernel caches at fixed paths inside the checkout, so that only a
# cell's first run there builds.
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_port import check, manifest, native, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "aircompressor_tpu")


def prepare(cell: dict, seed: int, device: torch.device, traced: bool) -> SimpleNamespace:
    """Chunks from the seed, the variants' row orders, and the device inputs.

    A batch is ``batch_chunks`` rows drawn from the configuration's distinct
    chunks, each row its own copy in device memory. ``variants`` row orders
    of the same rows take turns from batch to batch, so that a batch whose
    work was skipped cannot pass with the outputs of the one before it.
    """
    cfg, mix = cell["config"], cell["traffic"]
    phases = {"imports": time.perf_counter() - START}
    t = time.perf_counter()
    adapter = manifest.codec(cfg["codec"])
    C, D, B = cfg["chunk_bytes"], cfg["distinct_chunks"], mix["batch_chunks"]
    phases["port_import"], t = time.perf_counter() - t, time.perf_counter()
    chunks = manifest.data(cfg["data"]).chunks(seed, D, C, cfg["scale_factor"])
    phases["data"], t = time.perf_counter() - t, time.perf_counter()
    rng = np.random.default_rng([seed, 0])
    perms = [rng.permutation(np.arange(B) % D) for _ in range(mix["variants"])]
    direction = mix["direction"]
    s = SimpleNamespace(adapter=adapter, direction=direction, chunks=chunks, perms=perms,
                        chunk_bytes=C, rows=B, depth=mix["depth"], comp_bytes=None,
                        phases=phases)
    if direction == "decode" or traced:
        blocks, blens = native.compress(adapter.COMPRESSOR, chunks)
        s.blocks, s.blens = blocks, blens
        s.comp_bytes = int(blens[perms[0]].sum())
    phases["compress"], t = time.perf_counter() - t, time.perf_counter()
    if direction == "decode":
        width = -(-int(blens.max()) // 64) * 64
        dev_rows = torch.from_numpy(blocks[:, :width]).to(device)
        dev_lens = torch.from_numpy(blens.astype(np.int32)).to(device)
        s.fn = lambda rows, lens: adapter.decode(rows, lens, C)
    elif direction == "encode":
        dev_rows = torch.from_numpy(chunks).to(device)
        dev_lens = torch.full((D,), C, dtype=torch.int32, device=device)
        s.fn = adapter.encode
    else:
        raise ValueError(f"unknown direction {direction!r}")
    s.inputs = []
    for p in perms:
        idx = torch.from_numpy(p).to(device)
        s.inputs.append((dev_rows.index_select(0, idx), dev_lens.index_select(0, idx)))
    del dev_rows, dev_lens
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["upload"] = time.perf_counter() - t
    s.digest_bytes = adapter.DIGEST_BYTES[direction]
    return s


class Slot:
    """Host buffers (pinned on a card) for one batch's read-back, with the
    event that marks it done."""

    def __init__(self, rows: int, device: torch.device):
        pin = device.type == "cuda"
        self.lens = torch.empty(rows, dtype=torch.int32, pin_memory=pin)
        self.ok = torch.empty(rows, dtype=torch.bool, pin_memory=pin)
        self.digest = torch.empty(rows, dtype=torch.int64, pin_memory=pin)
        self.event = torch.cuda.Event() if pin else None

    def issue(self, lens, ok, digest):
        self.lens.copy_(lens, non_blocking=True)
        self.ok.copy_(ok, non_blocking=True)
        self.digest.copy_(digest, non_blocking=True)
        if self.event is not None:
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


def window(s: SimpleNamespace, seconds: float, device: torch.device, traced: bool,
           last: dict):
    """Run batches for ``seconds`` in a closed loop of depth ``s.depth``.
    Returns ``(records, stats)``: each batch's read-back and the window's
    totals; ``last`` maps each variant to the rows and lengths of its last
    batch."""
    slots = [Slot(s.rows, device) for _ in range(s.depth)]
    pending = collections.deque()
    records = []
    enqueue_s = 0.0
    k = 0

    def submit(k):
        nonlocal enqueue_s
        v = k % len(s.inputs)
        with trace.span("bench.enqueue", traced):
            t0 = time.perf_counter()
            rows, lens, ok, digest = s.fn(*s.inputs[v])
            enqueue_s += time.perf_counter() - t0
        slot = slots[k % s.depth]
        with trace.span("bench.readback", traced):
            slot.issue(lens, ok, digest)
        return v, slot, rows, lens

    def finish(p):
        v, slot, rows, lens = p
        with trace.span("bench.wait", traced):
            slot.wait()
        with trace.span("bench.keep", traced):
            records.append((v, slot.lens.numpy().copy(), slot.ok.numpy().copy(),
                            slot.digest.numpy().copy()))
        last[v] = (rows, lens)

    with trace.span("bench.window", traced):
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:  # at least one batch of each row order, however short
            if time.perf_counter() < deadline or k < len(s.inputs):
                pending.append(submit(k))
                k += 1
                if len(pending) < s.depth:
                    continue
            elif not pending:
                break
            finish(pending.popleft())
        window_s = time.perf_counter() - t_start
    return records, {"window_s": window_s, "enqueue_s": enqueue_s, "batches": len(records)}


def warm_up(s: SimpleNamespace, device: torch.device):
    """Every shape of the window once per variant, twice, the read-back
    included: builds and loads the kernels and fills the allocator."""
    slot = Slot(s.rows, device)
    for _ in range(2):
        for inputs in s.inputs:
            rows, lens, ok, digest = s.fn(*inputs)
            slot.issue(lens, ok, digest)
            slot.wait()
    s.block_width = rows.shape[1]
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(cell: dict, seed: int, seconds: float, traced: bool,
            device: torch.device, fn=None) -> dict:
    """One run of ``cell``: set-up, the window, with ``traced`` a second one
    under the profiler, and the check of both. ``fn`` stands in for the
    adapter's batch call (the control). Returns the result line's fields,
    with ``checks`` last."""
    s = prepare(cell, seed, device, traced)
    if fn is not None:
        s.fn = fn(s)
    t = time.perf_counter()
    warm_up(s, device)
    s.phases["warm_up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - START
    last = {}
    # The host's clock reads the untraced window: the profiler's own cost
    # would sit inside every timed call of the traced one.
    records, stats = window(s, seconds, device, False, last)
    batches = stats["batches"]
    out_bytes_done = sum(int(r[1].astype(np.int64).sum()) for r in records)
    with trace.profiled(traced) as prof:
        if traced:
            records += window(s, seconds, device, True, last)[0]
    if prof.trace is not None and device.type == "cuda" and not prof.trace.device:
        raise RuntimeError("the profiler's trace holds no device events")
    mem_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del s.inputs
    t_check = time.perf_counter()
    checks, failed = check.compare(s, records, last)
    check_s = time.perf_counter() - t_check
    del last
    run = SimpleNamespace(
        direction=s.direction, setup_s=setup_s, window_s=stats["window_s"],
        batches=batches, enqueue_s=stats["enqueue_s"], trace=prof.trace,
        raw_bytes_done=batches * s.rows * s.chunk_bytes, out_bytes_done=out_bytes_done,
        batch=SimpleNamespace(rows=s.rows, chunk_bytes=s.chunk_bytes,
                              raw_bytes=s.rows * s.chunk_bytes, comp_bytes=s.comp_bytes,
                              digest_bytes=s.digest_bytes))
    metrics = {}
    for m in cell["per_layer" if traced else "end_to_end"]:
        value = manifest.reader(m["name"]).read(run)
        if value is None:
            if not traced:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": batches > 0 and all(v <= lim for v, lim in checks.values()),
              "attempted": len(records) * s.rows, "failed": failed, "metrics": metrics,
              "device": dev}
    if prof.trace is not None:
        dev["busy_s"] = prof.trace.busy_s
        dev["window_s"] = prof.trace.window_s
        result["breakdown"] = {"device_ops": prof.trace.device_ops(),
                               "idle_gaps": prof.trace.idle_gaps()}
    result["seconds"] = {"setup": setup_s, **s.phases, "window": stats["window_s"],
                         "check": check_s, "batches": batches}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = manifest.cell(manifest.load(), args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); {have} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = measure(cell, args.seed % (1 << 63), args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {', '.join(found)}", file=sys.stderr)
        return 3
    print("seconds " + " ".join(f"{k} {v}" for k, v in result["seconds"].items()),
          file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():  # the numbers compared come last
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
