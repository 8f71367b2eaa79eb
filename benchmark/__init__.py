"""The benchmark of alan_tpu_torch, the PyTorch/CUDA port: ``run.py`` runs
one cell of ``BENCHMARK.json``; everything a cell reads is found by name
(``harness.py``)."""
