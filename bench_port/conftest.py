"""Test settings of the benchmark's own tests (``python -m pytest bench_port``)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips where there is none")
