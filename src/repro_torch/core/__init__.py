"""Host-side (numpy) graph compilers: reordering, block-ELL tiling, LRU."""
from .reorder import minhash_reorder, identity_order
from .blocksparse import (BlockCompaction, BlockEll, build_blockell,
                          build_blockell_coo, transpose_graph, traffic_model)
from .cache_model import LRUCache
