"""Each cell of the benchmark for 2 s on the card, as the benchmark's command
runs it: exit 0, ``correct`` true, and every end-to-end metric of the cell
in the result. Marked ``cuda``; each test skips where there is no card.

    python -m pytest -m cuda bench_port -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench_port import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload", name, "--seed", str(2**31 + 5),
         "--seconds", "2", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    want = {m["name"] for m in manifest.cell(manifest.load(), name)["end_to_end"]}
    assert set(result["metrics"]) == want
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
