"""The port's profiling module: the host match-length grid against the JAX
package's, ``kernel_rows`` refusing to run without a card, ``trace``
writing a Chrome trace and ``kernel_ms`` reading one."""

import json

import pytest
import torch

from aircompressor_tpu_torch.ops import profiling


def test_match_length_grid_equals_the_jax_rows():
    """Every field but the time: the same grid, the same rng(0) blocks, the
    port's copy of the match-length primitive."""
    pytest.importorskip("jax")
    from aircompressor_tpu.ops import profiling as jax_profiling

    got = profiling.match_length_grid(trials=1)
    want = jax_profiling.match_length_grid(trials=1)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.pop("ns_per_candidate") > 0
        w.pop("ns_per_candidate")
        assert g == w


def test_kernel_rows_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.kernel_rows(batch=1, trials=1)


def test_main_propagates_a_kernel_rows_failure(monkeypatch, capsys):
    """No ``kernels_error`` entry: the failure leaves main, so the exit code
    is not 0."""
    monkeypatch.setattr(profiling, "match_length_grid", lambda: [])

    def fail(**_):
        raise RuntimeError("kernel_rows needs a CUDA device")

    monkeypatch.setattr(profiling, "kernel_rows", fail)
    with pytest.raises(RuntimeError):
        profiling.main([])
    assert capsys.readouterr().out == ""


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as path:
        torch.arange(10000).sum()
    events = json.loads(open(path).read())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::sum") for e in events)


def test_kernel_ms_reads_kernel_events_and_raises_without_one(tmp_path, monkeypatch):
    """The mean ``dur`` of the trace's kernel events whose name holds the
    kernel's, in ms; none (as on the CPU) raises."""
    with pytest.raises(RuntimeError, match="no kernel named like 'huffman_kernel'"):
        profiling.kernel_ms(lambda: torch.arange(100).sum(), "huffman_kernel", 2,
                            str(tmp_path / "cpu"))
    events = [{"cat": "kernel", "name": "void (anonymous namespace)::huffman_kernel(int)",
               "dur": 30.0},
              {"cat": "kernel", "name": "huffman_kernel", "dur": 50.0},
              {"cat": "kernel", "name": "vectorized_elementwise_kernel", "dur": 7.0},
              {"cat": "cpu_op", "name": "huffman_kernel", "dur": 900.0}]

    class FakeProfile:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    monkeypatch.setattr(torch.profiler, "profile", lambda **_: FakeProfile())
    assert profiling.kernel_ms(lambda: None, "huffman_kernel", 2,
                               str(tmp_path / "fake")) == pytest.approx(0.04)


def test_kernel_ms_takes_a_trace_again_when_one_lacks_the_kernel(tmp_path, monkeypatch):
    """A trace without the kernel's events (the profiler loses them now and
    then) is taken again; the first one that holds them gives the time."""
    traces = [[], [{"cat": "kernel", "name": "fse_kernel", "dur": 20.0}]]

    class FakeProfile:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": traces.pop(0)}, f)

    monkeypatch.setattr(torch.profiler, "profile", lambda **_: FakeProfile())
    assert profiling.kernel_ms(lambda: None, "fse_kernel", 2,
                               str(tmp_path / "t")) == pytest.approx(0.02)
    assert traces == []


def test_decode_bound_counts_bytes_at_the_memory_rate():
    """Compressed bytes and lengths read, 64 KB rows, lengths and flags
    written, at 3.35 TB/s."""
    got = profiling.decode_bound_ms(1_000_000, 10)
    assert got == pytest.approx((1_000_000 + 40 + 655_360 + 50) / 3.35e12 * 1e3)
    assert profiling.decode_bound_ms(0, 1, out_cap=4096) == pytest.approx(
        (4 + 4096 + 5) / 3.35e12 * 1e3)


def test_generated_data_holds_the_batch():
    data = profiling.generated_data(4)
    assert len(data) >= 4 * profiling.CHUNK
    assert data == profiling.generated_data(4)
