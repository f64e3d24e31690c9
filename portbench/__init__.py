"""Benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once.  Every configuration,
traffic mix, loop, application and per-layer metric lives in files of its
own under this folder, found by the name that ``BENCHMARK.json`` gives."""
