"""Graph containers, the paper's stand-in datasets, the neighbor sampler
and serving expanders, small-graph packing, and window partitions."""
from .structure import Graph, CSR
from .datasets import (DatasetSpec, PAPER_TABLE_I, spec_for_paper, synthesize,
                       cora_like, reddit_like, citeseer_s_like,
                       products_like, molecules_like)
from .sampler import (NeighborSampler, MiniBatch, SampledBlock,
                      FullNeighborhood, static_block_shapes)
from .batching import GraphBatch, pack, readout_segments
from .partition import Partition, window_partition
