"""The traced run: ``torch.profiler`` over the window, read from its events.

The trace is read from its Chrome export, whose categories (``kernel``,
``gpu_memcpy``, ``gpu_memset``, ``user_annotation``) stay the same across
torch versions. The benchmark marks its own host spans with ``record_function`` under the
prefix ``bench.``: the window, and in each batch the calls into the port
(``bench.enqueue``), the read-back's copies (``bench.readback``), the wait
for it (``bench.wait``) and keeping its values (``bench.keep``). From the
device's events (kernels, copies, sets) within the window come the busy
time, each kernel's mean time, the operations that took most time, and the
idle gaps, each put to the host span in which it fell.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")  # not gpu_user_annotation
SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"
TOP = 10


def span(name: str, enabled: bool):
    """A host span of the benchmark's in the trace, or nothing when the run
    is not traced."""
    return torch.profiler.record_function(name) if enabled else contextlib.nullcontext()


@contextlib.contextmanager
def profiled(enabled: bool):
    """Profile the body when ``enabled``; yields a holder whose ``trace``
    is set to a ``Trace`` after the body."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield holder
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:  # under TMPDIR
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.trace = Trace.from_chrome(json.load(f)["traceEvents"])


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


class Trace:
    """Device events and the benchmark's spans of one traced window, in ns
    of the profiler's clock."""

    def __init__(self, device: list, spans: list, window: tuple[int, int]):
        self.device = device  # (name, start, end), within the window
        self.spans = spans  # (start, end, name), sorted by start
        self.window = window

    @classmethod
    def from_chrome(cls, events: list) -> "Trace":
        """From the ``traceEvents`` of a Chrome trace (times in us)."""
        device, spans, window = [], [], None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            start = round(float(e["ts"]) * 1000)
            end = start + round(float(e["dur"]) * 1000)
            name, cat = e.get("name", ""), e.get("cat")
            if cat in DEVICE_ACTIVITIES:
                device.append((name, start, end))
            elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
                s = (start, end, name)
                if name == WINDOW_SPAN:
                    window = s[:2]
                else:
                    spans.append(s)
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        lo, hi = window
        device = [(n, max(s, lo), min(t, hi)) for n, s, t in device if t > lo and s < hi]
        return cls(device, sorted(spans), window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self):
        return _merge((s, t) for _, s, t in self.device)

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which a kernel, copy or set ran."""
        return sum(t - s for s, t in self.busy_intervals()) / 1e9

    def kernel_mean_s(self, pattern: str) -> float | None:
        """Mean duration of the device events whose name matches the regular
        expression ``pattern``; None where there are none."""
        rx = re.compile(pattern)
        durs = [t - s for n, s, t in self.device if rx.search(n)]
        return sum(durs) / len(durs) / 1e9 if durs else None

    def device_ops(self) -> list:
        """The device operations that took most time: [[name, seconds]]."""
        total = defaultdict(int)
        for n, s, t in self.device:
            total[n] += t - s
        return [[n, v / 1e9] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """Idle time of the device, summed by the host span in which each
        gap's middle fell ("other" outside every span): [[span, seconds]]."""
        lo, hi = self.window
        edges = [lo]
        for s, t in self.busy_intervals():
            edges += [s, t]
        edges.append(hi)
        starts = [s for s, _, _ in self.spans]
        total = defaultdict(int)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1  # batch spans do not nest
            held = i >= 0 and self.spans[i][1] >= mid
            total[self.spans[i][2] if held else "other"] += b - a
        return [[n, v / 1e9] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]
