"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain
versions.  Importing this package builds and loads nothing.  The wrappers
named like their modules (``spmm_blockell.spmm_blockell``,
``embedding_bag.embedding_bag``, ``sddmm.sddmm``,
``decode_attention.decode_attention``) are reached through their
modules (exporting them here would shadow the modules) or through
``kernels.ops``."""
from .spmm_blockell import (spmm_blockell_compact, spmm_blockell_fused,
                            spmm_blockell_update,
                            spmm_blockell_update_compact)
from .ref import (decode_attention_ref, embedding_bag_ref, sddmm_ref,
                  spmm_blockell_compact_ref, spmm_blockell_fused_ref,
                  spmm_blockell_ref,
                  spmm_blockell_update_compact_ref, spmm_blockell_update_ref)
