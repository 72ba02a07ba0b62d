"""Public entry points over a ``BlockEll`` container (the port of the spmm
part of ``repro/kernels/ops.py``; its other wrappers wait for their
kernels).

``spmm`` is the entry point of the padded kernel ``spmm_blockell``: on a
CUDA tensor it launches the kernel, on a CPU tensor its plain version.
``spmm_ref`` always runs the plain version.  The reference pads x to C*bk
rows and 128 lanes for the TPU; the port hands x over as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from .ref import spmm_blockell_ref
from .spmm_blockell import spmm_blockell


def _operands(ell, x: torch.Tensor):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(x.device)
    # the exact 0/1 bitmask travels as uint8 tiles; weighted tiles as fp32
    tiles = ell.dense_blocks(np.uint8 if ell.implicit else np.float32)
    return t(ell.block_cols), t(tiles)


def spmm(ell, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` from a :class:`~repro_torch.core.BlockEll`; x: (n, d)
    float32, returns (n, d)."""
    block_cols, blocks = _operands(ell, x)
    return spmm_blockell(block_cols, blocks, x.contiguous(), bm=ell.bm,
                         bk=ell.bk, n_dst=x.shape[0])


def spmm_ref(ell, x: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`spmm`."""
    block_cols, blocks = _operands(ell, x)
    return spmm_blockell_ref(block_cols, blocks, x, bm=ell.bm, bk=ell.bk,
                             n_dst=x.shape[0])
