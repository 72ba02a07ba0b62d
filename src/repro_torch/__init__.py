"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s module paths so each port sits beside its
reference counterpart.  It imports ``torch`` and numpy only: never ``jax``
and never ``repro`` (``import repro`` pulls in jax), so the framework-free
numpy modules it needs are kept here as copies.  Kernels are written by hand
for ``sm_90a`` under ``csrc/`` and built on first use; nothing is built or
loaded when a module is imported.

Every module of ``repro`` has its counterpart here except
``dist/compat.py`` (a shim of jax's API): the graph and reuse layers, the
eight kernels and their plans, the models and their bundles, serving,
training and resilience, observability, the distributed layer, the chaos
drill, and the dry-run and roofline (``launch.dryrun``,
``launch.roofline_run``, ``roofline``).
"""

__version__ = "1.0.0"
