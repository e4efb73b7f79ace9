"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell a
run, driven by ``BENCHMARK.json`` at the repository's root. See
``run.py``."""
