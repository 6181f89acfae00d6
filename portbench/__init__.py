"""The benchmark of the PyTorch / CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
per-layer metric or cell's limits is a file of its own here, found by its
name (``spec.py``); the arithmetic the numbers rest on (``counts.py``), the
weights (``weights.py``), the trace reduction (``trace.py``) and the plain
reference (``reference/``) are the benchmark's, not the program's.
"""
