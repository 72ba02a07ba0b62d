"""Rubik's primary contribution, ported: LSH reordering, shared-set
computation reuse, block-sparse aggregation, hierarchical mapping, and the
cache/perf models of the paper (host numpy, byte-equal to the reference's)
with the aggregation executors in torch."""
from .reorder import (lsh_reorder, minhash_reorder, degree_reorder, bfs_reorder,
                      identity_order, mean_reuse_distance, bandwidth,
                      lsh_order_from_projection, lsh_reorder_torch,
                      REORDERINGS)
from .shared_set import SharedSetPlan, build_shared_plan
from .blocksparse import (BlockEll, BlockCompaction, build_blockell,
                          build_blockell_coo, transpose_graph,
                          transpose_blockell, traffic_model,
                          choose_block_shape)
from .aggregate import (segment_aggregate, shared_aggregate, blockell_matmul,
                        blockell_aggregate)
from .mapping import (GraphLevelMapping, NodeLevelTiling, map_graph_level,
                      map_node_level, pe_edge_lists)
from .cache_model import (LRUCache, TrafficReport, simulate_gd, simulate_gd_gc,
                          schedule_comparison)
from .perf_model import (Platform, NN_ACC, GRAPH_ACC, RUBIK, GPU, LayerShape,
                         ModelCost, layer_cost, gcn_cost, aggregation_traffic,
                         model_shapes, GRAPHSAGE_DIMS, GIN_DIMS)
