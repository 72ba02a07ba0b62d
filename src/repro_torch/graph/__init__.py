"""Graph containers, the paper's stand-in datasets, the neighbor sampler
and serving expanders, small-graph packing, window partitions and their halo plans."""
from .structure import Graph, CSR, from_dense, to_dense
from .datasets import (DatasetSpec, PAPER_TABLE_I, spec_for_paper, synthesize,
                       cora_like, reddit_like, citeseer_s_like,
                       products_like, molecules_like)
from .sampler import (NeighborSampler, MiniBatch, SampledBlock,
                      FullNeighborhood, static_block_shapes)
from .batching import GraphBatch, pack, readout_segments
from .partition import (Partition, window_partition, HaloPlan,
                        build_halo_plan, uniform_local_n, cut_edges)
