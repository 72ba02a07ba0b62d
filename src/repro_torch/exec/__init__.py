"""Execution plans (aggregation and whole layers, with their backwards)
over the block-ELL kernels, their plain versions, or a dst-sorted edge
list; degree-bucketed multi-grid plans; the measuring autotuner and the
whole-forward DP that pick every layer's configuration; the fallback chain
(``ResilientPlan``) that demotes a failing backend and quarantines it."""
from .plan import (BACKENDS, MODES, ORDERS, GraphExecutionPlan,
                   LayerExecutionPlan, build_layer_plan, build_plan,
                   choose_order, layer_order_costs, spmm_cost)
from .bucketing import (parse_bucket_sig, bucket_sig, assign_buckets,
                        bucket_occupancy, default_scheme, bucket_candidates,
                        bucket_layer_candidates, split_graph_cand,
                        split_layer_cand, make_graph_cand, make_layer_cand)
from .autotune import (autotune, autotune_plan, autotune_layer,
                       autotune_layer_plan, graph_fingerprint, device_sig,
                       AutotuneRecord, LayerAutotuneRecord,
                       default_candidates, default_layer_candidates,
                       cached_layer_costs, prune_cache, CACHE_MAX_ENTRIES,
                       record_quarantine, quarantined_backends,
                       clear_quarantine)
from .forward import (LayerSpec, ForwardExecutionPlan, ForwardAutotuneRecord,
                      ForwardCostOracle, build_cost_oracle, dp_schedule,
                      exhaustive_schedule, plan_forward, build_forward_plan,
                      autotune_forward, gcn_chain, sage_chain, gin_chain,
                      chain_params, model_layer_cost, residual_edge_cost,
                      plan_switch_cost)
from .fallback import (FALLBACK_CHAIN, BackendFailure, FallbackVerdict,
                       ResilientPlan, parity_probe)
