"""The benchmark of ``vrdd_tpu_torch`` on an NVIDIA H100: ``run.py`` runs one
cell of ``BENCHMARK.json``; the configurations, traffic mixes and
per-layer metrics are files found by name (``harness``)."""
