"""repro_torch.dist — the distributed execution layer (port of
``repro.dist``).

Builds on ``graph.partition.HaloPlan`` (the paper's graph-level mapping
with mesh ranks as PEs) to run graph aggregation, decode attention and
gradient reduction across ``torch.distributed`` ranks with collective
volume proportional to what the computation needs (cut-edge rows, LSE
partials, compressed gradients) instead of full-table all-gathers;
``elastic`` runs the shard membership state machine in one process over
per-shard plans.

``sharding`` is the LM half: the parameter and activation shardings of
the LM bundles, the ambient mesh (``use_mesh``, the counterpart of ``with
mesh:``), and ``spmd``'s autograd collectives, which the bundles' mesh
paths (the LMs', the GNNs', wide & deep's) run on rank-local tensors where
GSPMD would insert its own.  The reference's
``compat`` (shims for older jax APIs) has no counterpart here.  Submodules
load lazily (PEP 562), as in the reference.
"""

_EXPORTS = {
    "ambient_mesh": "sharding", "batch_axes": "sharding",
    "shard_activation": "sharding", "activation_spec": "sharding",
    "maybe_shard": "sharding", "to_shardings": "sharding",
    "lm_param_specs": "sharding",
    "use_mesh": "sharding", "unshard_activation": "sharding",
    "AbstractMesh": "sharding", "Mesh": "sharding",
    "NamedSharding": "sharding", "P": "sharding",
    "SendPlan": "plan", "build_send_plan": "plan",
    "collective_bytes_estimate": "plan",
    "halo_aggregate": "halo", "allgather_aggregate": "halo",
    "resilient_halo_aggregate": "resilient",
    "ElasticAggregator": "elastic", "ElasticTopology": "elastic",
    "RetryPolicy": "elastic", "HealthPolicy": "elastic",
    "ShardHealth": "elastic", "ModeledClock": "elastic",
    "build_elastic_topology": "elastic", "train_elastic": "elastic",
    "distributed_decode_attention": "attention",
    "quantize_int8": "compress", "dequantize_int8": "compress",
    "int8_allreduce_psum": "compress", "topk_compress": "compress",
    "pad_graph_nodes": "gnn", "dist_gnn_init": "gnn",
    "dist_gnn_apply": "gnn", "dist_gnn_loss": "gnn",
    "make_dist_train_step": "gnn", "train_distributed": "gnn",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return __all__
