"""The benchmark of the PyTorch/CUDA REMD port (``repro_torch``).

``python remdbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Configurations, traffic, correctness limits and per-layer
metric readers are data and small files found by name:
``configs/<config>.json``, ``workloads/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py``; the reference's
modules (``reference/``) and the counts (``counts/<kind>.py``) by the
configuration's own fields."""
