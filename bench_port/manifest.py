"""Where the harness finds a cell's parts, by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's ``file`` holds its sizes and names its codec adapter
(``codecs/<codec>.py``) and its data generator (``data/<data>.py``); the mix
is ``traffic/<traffic>.json``; each metric is read by ``metrics/<name>.py``.
So a later cell, configuration, mix or metric is a new file and a new entry,
and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _one(entries: list, name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{len(found)} {what} named {name!r} in BENCHMARK.json")
    return found[0]


def cell(manifest: dict, name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration file and traffic mix read:
    ``{"workload", "config", "traffic", "end_to_end", "per_layer"}``."""
    work = _one(manifest["workloads"], name, "workloads")
    entry = _one(manifest["configs"], work["config"], "configs")
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(root / BENCH_DIR.name / "traffic" / f"{work['traffic']}.json") as f:
        traffic = json.load(f)
    return {"workload": work, "config": config, "traffic": traffic,
            "end_to_end": metrics_of(manifest, "end_to_end", name),
            "per_layer": metrics_of(manifest, "per_layer", name)}


def metrics_of(manifest: dict, kind: str, workload: str) -> list[dict]:
    """The metrics of ``kind`` that the cell reports: those whose
    ``workloads`` name it, and those without the key."""
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]


def _module(path: Path) -> ModuleType:
    name = "bench_port_part_" + re.sub(r"\W", "_", str(path.relative_to(path.parents[1])))
    if name in sys.modules:
        return sys.modules[name]
    if not path.exists():
        raise FileNotFoundError(f"{path} is not there")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def reader(name: str, root: Path = ROOT) -> ModuleType:
    """The module ``metrics/<name>.py``: ``read(run)`` gives the metric's
    value, or None where the run has nothing to read."""
    return _module(root / BENCH_DIR.name / "metrics" / f"{name}.py")


def codec(name: str, root: Path = ROOT) -> ModuleType:
    """The adapter ``codecs/<name>.py`` between the harness and the port."""
    return _module(root / BENCH_DIR.name / "codecs" / f"{name}.py")


def data(name: str, root: Path = ROOT) -> ModuleType:
    """The generator ``data/<name>.py``: ``chunks(seed, count, chunk_bytes,
    scale_factor)``."""
    return _module(root / BENCH_DIR.name / "data" / f"{name}.py")
