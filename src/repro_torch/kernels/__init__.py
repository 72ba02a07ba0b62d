"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain
versions.  Importing this package builds and loads nothing."""
from .spmm_blockell import spmm_blockell_compact, spmm_blockell_update_compact
from .ref import spmm_blockell_compact_ref, spmm_blockell_update_compact_ref
