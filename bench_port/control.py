"""The controls: the plain reference put in the port's place with one of
the configuration's guarantees broken, run through the harness at the
cell's own size, so that the comparison is seen to fail.

    python3 -m bench_port.control --workload <cell> --seeds <n> [<n> ...]

- decode (scan cells): the scalar reference decoder with a window: a copy
  from farther back than the port's 4 KB shared-memory window reaches
  reads zeros, as a kernel that skipped device memory would; the digests
  are the reference's over those rows.
- encode (write cells): the benchmark's own compressor taking each hash
  table hit as a match without comparing its bytes, as a matcher that
  skipped the check would; the digests are the reference's over the input.

Each seed prints one JSON line with the checks the run compared. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from bench_port import manifest, native
from bench_port import run as harness


def control_fn(s):
    """The control's batch call for a prepared run ``s``: the same outputs
    as the port's call, one set a variant, made before the window."""
    C = s.chunk_bytes
    if s.direction == "decode":
        rows = np.stack([np.frombuffer(s.adapter.reference_decode(
            s.blocks[i, :s.blens[i]].tobytes(), C, s.adapter.CONTROL_WINDOW), np.uint8)
            for i in range(len(s.blocks))])
        lens = np.full(len(rows), C, np.int64)
        digests = s.adapter.reference_digest("decode", rows, lens)
    else:
        blocks, blens = native.compress(s.adapter.COMPRESSOR, s.chunks, unchecked=True)
        rows, lens = blocks, blens
        digests = s.adapter.reference_digest("encode", s.chunks, np.full(len(s.chunks), C))
    device = s.inputs[0][0].device
    outs = []
    for p in s.perms:
        outs.append((torch.from_numpy(rows[p]).to(device),
                     torch.from_numpy(lens[p].astype(np.int32)).to(device),
                     torch.ones(len(p), dtype=torch.bool, device=device),
                     torch.from_numpy(digests[p].astype(np.uint64).view(np.int64)).to(device)))
    order = {id(inp[0]): out for inp, out in zip(s.inputs, outs)}
    return lambda rows_in, lens_in: order[id(rows_in)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    cell = manifest.cell(manifest.load(), args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in args.seeds:
        r = harness.measure(cell, seed, args.seconds, False, device, fn=control_fn)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
