"""The benchmark of ``waveunet_tpu_torch`` on an NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``run.py``). Cells, configurations,
traffic mixes and per-layer metrics are files found by name
(``catalog.py``); the reference that decides ``correct`` is
``reference/``, which imports nothing of the program.
"""
