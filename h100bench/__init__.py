"""The benchmark of the PyTorch and CUDA package ``repro_torch`` on one
NVIDIA H100: see ``README.md`` and the root ``BENCHMARK.json``."""
