"""portbench: the benchmark of the PyTorch and CUDA port (``docqa_tpu_torch``).

One run measures one cell of ``BENCHMARK.json`` (a model configuration under a
traffic mix) on the card it is started on:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs sits in files found by name: the configuration under
``configs/``, the traffic mix under ``traffic/``, the limits of its output
check under ``checks/`` and one reader a per-layer metric under ``metrics/``.
The plain PyTorch reference that decides ``correct`` is under ``reference/``
and imports nothing of the port.
"""
