"""The benchmark of the PyTorch and CUDA port (``avsl_tpu_torch``).

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line. Each configuration, traffic mix, per-layer metric
and cell limit is a file of its own under this folder, found by name
(:mod:`portbench.registry`).
"""
