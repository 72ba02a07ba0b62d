"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s module paths so each port sits beside its
reference counterpart.  It imports ``torch`` and numpy only: never ``jax``
and never ``repro`` (``import repro`` pulls in jax), so the framework-free
numpy modules it needs are kept here as copies.  Kernels are written by hand
for ``sm_90a`` under ``csrc/`` and built on first use; nothing is built or
loaded when a module is imported.

Ported so far: graph, reorder, block-ELL builder, LRU cache, telemetry,
the five block-ELL kernels, the execution plans with their backwards and
the autotuner, GCN, GIN, wide & deep with the ``embedding_bag`` kernel,
the ``sddmm`` kernel (``kernels.ops.sddmm``), the serving engine and
``launch.serve``, training (``train``, ``configs``, ``launch.train``), and
dense LM serving (``nn.attention``, ``models.transformer``, the LM configs,
``launch.serve --arch``) with the ``decode_attention`` kernel, and the
paper's reuse layer (``core``: shared-set plans and executor, the other
reorders, the hierarchical mapping, the G-D/G-C cache and Table II cost
models).
"""
