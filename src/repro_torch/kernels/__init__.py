"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain
versions.  Importing this package builds and loads nothing.  The padded
``y = A x`` wrapper is reached as ``kernels.spmm_blockell.spmm_blockell``
(exporting it here would shadow its module) or through ``kernels.ops``."""
from .spmm_blockell import (spmm_blockell_compact, spmm_blockell_fused,
                            spmm_blockell_update,
                            spmm_blockell_update_compact)
from .ref import (spmm_blockell_compact_ref, spmm_blockell_fused_ref,
                  spmm_blockell_ref, spmm_blockell_update_compact_ref,
                  spmm_blockell_update_ref)
