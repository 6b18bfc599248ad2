"""The port's data parallelism over processes: two gloo ranks on the CPU.

Each rank is a subprocess that imports neither ``jax`` nor the JAX package
(both blocked in ``sys.modules``) and meets the other through a
``file://`` store under the test's temporary directory. Each feeds 4 rows
of its own to the global batch of 8 and runs the checksum step, Snappy
compress and decompress on them. Every rank must hold the global totals;
its ``local_rows`` must decode on the host to its own rows; unequal local
row counts must raise on both ranks; a second ``initialize`` must be a
no-op. ``scaling_report`` must give what the JAX package's formula gives.
Integer codecs: the tolerance is 0.
"""

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aircompressor_tpu.ops import multihost as jax_multihost
from aircompressor_tpu_torch.ops import multihost, pipeline

ROOT = Path(__file__).resolve().parent.parent
B_LOCAL, L = 4, 1024


def rows_of(rank: int):
    """Rank ``rank``'s rows (periodic, so the CPU encode takes few probes)
    and their lengths."""
    rng = np.random.default_rng(rank)
    raw = np.stack([np.resize(rng.integers(0, 256, int(p), dtype=np.uint8), L)
                    for p in rng.integers(5, 200, B_LOCAL)])
    lengths = rng.integers(1, L + 1, B_LOCAL).astype(np.int32)
    lengths[0] = L
    for i, n in enumerate(lengths):
        raw[i, n:] = 0
    return raw, lengths


WORKER = f"""
B_LOCAL, L = {B_LOCAL}, {L}
{inspect.getsource(rows_of)}
""" + r"""
import json, sys
for name in ("jax", "aircompressor_tpu"):
    sys.modules[name] = None
import numpy as np
import torch.distributed as dist
from aircompressor_tpu_torch.host import snappy as host_snappy
from aircompressor_tpu_torch.ops import multihost

rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
multihost.initialize(store, world, rank, device="cpu")
multihost.initialize("file:///nonexistent/store", world + 1, rank)  # a no-op
assert dist.get_world_size() == world and dist.get_rank() == rank
assert dist.get_backend() == "gloo"
mesh = multihost.global_mesh()
raw, lengths = rows_of(rank)
data, lens = multihost.make_global_batch(mesh, raw, lengths)
assert data.shape == (world * B_LOCAL, L) and data.offset == rank * B_LOCAL

everything = sum(int(rows_of(r)[1].sum()) for r in range(world))
ck = multihost.distributed_checksum(mesh)(data, lens)
comp, comp_lens, c_total = multihost.distributed_compress(mesh)(data, lens)
out, out_lens, ok, d_total = multihost.distributed_decompress(mesh, out_cap=L)(comp, comp_lens)
local_comp = [None] * world
dist.all_gather_object(local_comp, int(comp_lens.local.sum()))

rows, blens = multihost.local_rows(comp), multihost.local_rows(comp_lens)
assert rows.shape[0] == B_LOCAL
for i in range(B_LOCAL):
    got = host_snappy.decompress(rows[i, :blens[i]].tobytes(), L)
    assert got == raw[i, :lengths[i]].tobytes(), f"row {i}"
assert bool(ok.local.all()) and np.array_equal(multihost.local_rows(out), raw)
assert multihost.local_rows(out_lens).tolist() == lengths.tolist()

try:
    multihost.make_global_batch(mesh, raw[:B_LOCAL - rank], lengths[:B_LOCAL - rank])
    unequal = "accepted"
except ValueError as e:
    unequal = str(e)
report = multihost.scaling_report(mesh, 2.0, 1.25, everything)
dist.destroy_process_group()
print(json.dumps({"rank": rank, "bytes": int(ck["bytes"]), "everything": everything,
                  "comp_total": int(c_total), "comp_sums": local_comp,
                  "out_total": int(d_total), "unequal": unequal, "report": report,
                  "xxh64": ck["xxh64"].local.tolist(), "crc32c": ck["crc32c"].local.tolist()}))
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' JSON reports."""
    store = tmp_path_factory.mktemp("store") / "rendezvous"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), "2", f"file://{store}"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=ROOT, env=env) for r in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=120))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def test_every_rank_holds_the_global_totals(ranks):
    for r, rep in enumerate(ranks):
        assert rep["rank"] == r
        assert rep["bytes"] == rep["out_total"] == rep["everything"]
        assert rep["comp_total"] == sum(rep["comp_sums"])
    assert ranks[0]["comp_sums"] == ranks[1]["comp_sums"]


def test_the_checksums_are_those_of_each_ranks_rows(ranks):
    """Rank r's per-chunk checksums equal the unsharded step on its rows."""
    for r, rep in enumerate(ranks):
        raw, lengths = rows_of(r)
        want = pipeline.checksum_step(torch.from_numpy(raw), torch.from_numpy(lengths))
        assert rep["xxh64"] == want["xxh64"].tolist()
        assert rep["crc32c"] == want["crc32c"].tolist()


def test_unequal_local_rows_raise_on_every_rank(ranks):
    for rep in ranks:
        assert rep["unequal"] == "every rank must give the same number of rows, got [4, 3]"


def test_scaling_report_follows_the_jax_formula(ranks):
    class JaxMesh:  # all that the JAX function reads of a mesh
        devices = np.empty(2)

    want = jax_multihost.scaling_report(JaxMesh(), 2.0, 1.25, ranks[0]["everything"])
    for rep in ranks:
        assert rep["report"] == {**want, "processes": 2}
    local = multihost.scaling_report(pipeline.make_mesh(["cpu"] * 2), 2.0, 0.0, 10)
    assert local == {**jax_multihost.scaling_report(JaxMesh(), 2.0, 0.0, 10), "processes": 1}


def test_initialize_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0)
    with pytest.raises(ValueError, match="needs num_processes and process_id"):
        multihost.initialize("localhost:1234", device="cpu")
