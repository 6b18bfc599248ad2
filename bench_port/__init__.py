"""The benchmark of ``aircompressor_tpu_torch`` on an NVIDIA H100.

``BENCHMARK.json`` at the repository's root lists its cells; ``run.py`` runs
one (``python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``), finding the cell's configuration, traffic mix, codec
adapter, data generator and metric readers by name (``manifest.py``).
``control.py`` runs the controls; ``python -m pytest bench_port`` the tests.
Nothing here imports JAX or the JAX package, and ``reference/`` imports
nothing of the port.
"""
