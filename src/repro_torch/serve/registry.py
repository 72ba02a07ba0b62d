"""Model sessions for the serving engine (port of ``repro/serve/registry.py``).

A session owns the model parameters and turns a batch of node ids into
embeddings: ``expand`` (one-hop frontier growth), ``gather`` (leaf
features), ``layer_forward`` (one GCN or GraphSAGE layer over flat edge
lists, on the device) and ``layer_values`` (the offline full-graph forward:
the oracle rows and the ``warm()`` payloads).  Registered: ``gcn``,
``sage_gin`` (GraphSAGE) and ``wide_deep``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.wide_deep import REDUCED
from ..device import resolve_device
from ..exec import gcn_chain, plan_forward, sage_chain
from ..graph.structure import Graph
from ..graph.sampler import FullNeighborhood, NeighborSampler
from ..models.gcn import gcn_apply, gcn_init, make_graph_inputs
from ..models.recsys import WideDeepConfig, user_tower, widedeep_init
from ..models.sage_gin import l2_normalize, sage_init, sage_layer
from .batcher import pow2_bucket as _pow2


def _gcn_layer(w: torch.Tensor, b: torch.Tensor, src_h: torch.Tensor,
               self_h: torch.Tensor, inv_src: torch.Tensor,
               inv_dst: torch.Tensor, dst_index: torch.Tensor,
               is_last: bool) -> torch.Tensor:
    """One GCN layer over a sampled block: scaled messages summed into their
    destinations with ``index_add_``, the self loop, the update."""
    msgs = src_h * inv_src[:, None]
    agg = torch.zeros_like(self_h).index_add_(0, dst_index, msgs)
    agg = (agg + self_h * inv_dst[:, None]) * inv_dst[:, None]
    h = agg @ w + b
    return h if is_last else torch.relu(h)


def _sage_layer(w: torch.Tensor, b: torch.Tensor, src_h: torch.Tensor,
                self_h: torch.Tensor, dst_index: torch.Tensor,
                is_last: bool) -> torch.Tensor:
    """One GraphSAGE layer over a sampled block: the mean of each
    destination's messages (0 where it has none), ``concat(self, nbr) @ w +
    b``, ReLU except on the last layer, then the L2 normalize."""
    B = self_h.shape[0]
    s = torch.zeros_like(self_h).index_add_(0, dst_index, src_h)
    cnt = self_h.new_zeros(B).index_add_(
        0, dst_index, self_h.new_ones(dst_index.shape[0]))
    nbr = s / torch.clamp(cnt, min=1.0)[:, None]
    h = torch.cat([self_h, nbr], dim=-1) @ w + b
    if not is_last:
        h = torch.relu(h)
    return l2_normalize(h)


class GNNSession:
    """Serves a full-batch-trained GCN (``kind="gcn"``) or GraphSAGE
    (``kind="sage"``) over sampled blocks.

    ``expander='full'`` (default) aggregates every in-edge with global
    degrees, so block outputs equal the offline full-graph forward row for
    row and the engine's oracle check is exact.  ``expander='fanout'``
    swaps in the GraphSAGE sampler for approximate serving.

    ``executor='fused'`` (default) compiles the offline forward through
    :func:`~repro_torch.exec.plan_forward`, as the reference does: the DP
    over the layer chain picks every layer's (order, fuse, backend, bm,
    compact, buckets) jointly — measured costs when the autotune cache
    (``$REPRO_TORCH_EXEC_CACHE``) is warm for this graph and device, the
    FLOP/byte model when cold — over the card's candidate grid on ``cuda``
    and the CPU grid on the CPU; layers with matching configs share one
    graph plan.  SAGE layers run the two-W epilogue, one plan call per
    layer, then the L2 normalize.  ``executor='segment'`` runs the plain
    edge-list forward.

    ``params`` (a tree like ``gcn_init``'s or ``sage_init``'s) replaces the
    seeded init, e.g. with the reference's weights carried over by
    ``params_from_jax``.
    """

    def __init__(self, name: str, g: Graph, kind: str = "gcn",
                 hidden: int = 64, out_dim: int = 16, seed: int = 0,
                 expander: str = "full", fanouts: Tuple[int, ...] = (10, 10),
                 executor: str = "fused", device="cuda",
                 params: Optional[dict] = None):
        if g.node_feat is None:
            raise ValueError("GNNSession needs node features")
        if kind not in ("gcn", "sage"):
            raise ValueError(f"unknown session kind {kind!r} (gcn | sage)")
        if executor not in ("fused", "segment"):
            raise ValueError(f"unknown executor {executor!r} "
                             "(fused | segment)")
        self.name = name
        self.g = g
        self.kind = kind
        self.executor = executor
        self.device = resolve_device(device)
        self.feats = np.asarray(g.node_feat, dtype=np.float32)
        self.dims = [self.feats.shape[1], hidden, out_dim]
        if params is None:
            init = gcn_init if kind == "gcn" else sage_init
            params = init(torch.Generator().manual_seed(seed), self.dims,
                          device=self.device)
        self.params = params
        self.inv_sqrt = None
        if kind == "gcn":
            deg = g.in_degrees().astype(np.float32) + 1.0
            self.inv_sqrt = (1.0 / np.sqrt(np.maximum(deg, 1.0))
                             ).astype(np.float32)
        self._expander = (FullNeighborhood(g) if expander == "full"
                          else NeighborSampler(g, list(fanouts), seed=seed))
        self._layer_cache: Optional[List[np.ndarray]] = None
        self._layer_plans = None
        self._fplan = None
        if executor == "fused":
            chain = gcn_chain if kind == "gcn" else sage_chain
            self._fplan = plan_forward(g, chain(self.dims),
                                       device=self.device)
            self._layer_plans = self._fplan.layers

    @property
    def num_layers(self) -> int:
        return len(self.dims) - 1

    @property
    def layer_dims(self) -> List[int]:
        return list(self.dims)

    # ------------------------------------------------------------- serving
    def expand(self, nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return self._expander.expand(nodes)

    def gather(self, ids: np.ndarray) -> np.ndarray:
        return self.feats[np.asarray(ids, dtype=np.int64)]

    @torch.no_grad()
    def layer_forward(self, l: int, dst_ids: np.ndarray, edge_src: np.ndarray,
                      dst_index: np.ndarray, src_h: np.ndarray,
                      self_h: np.ndarray) -> np.ndarray:
        dev = self.device
        t = lambda a, dt: torch.as_tensor(np.asarray(a, dt)).to(dev)
        p = self.params["layers"][l - 1]
        is_last = l == self.num_layers
        if self.kind == "gcn":
            out = _gcn_layer(p["w"], p["b"], t(src_h, np.float32),
                             t(self_h, np.float32),
                             t(self.inv_sqrt[edge_src], np.float32),
                             t(self.inv_sqrt[dst_ids], np.float32),
                             t(dst_index, np.int64), is_last=is_last)
        else:
            out = _sage_layer(p["w"], p["b"], t(src_h, np.float32),
                              t(self_h, np.float32), t(dst_index, np.int64),
                              is_last=is_last)
        return out.cpu().numpy()

    # -------------------------------------------------------------- oracle
    def layer_values(self, l: int) -> np.ndarray:
        """Offline full-graph values of layer ``l`` for every node."""
        if self._layer_cache is None:
            self._layer_cache = self._offline_layers()
        return self._layer_cache[l]

    def oracle(self, ids: np.ndarray) -> np.ndarray:
        return self.layer_values(self.num_layers)[np.asarray(ids, np.int64)]

    @torch.no_grad()
    def _offline_layers(self) -> List[np.ndarray]:
        """Offline full-graph forward, capturing each layer's output as the
        next layer consumes it (post-activation for non-final layers; SAGE's
        after its L2 normalize)."""
        h = torch.as_tensor(self.feats).to(self.device)
        vals = [self.feats]
        L = self.num_layers
        lps = self._layer_plans
        graph = (make_graph_inputs(self.g, self.device) if lps is None
                 else None)
        for i, p in enumerate(self.params["layers"]):
            last = i + 1 == L
            if self.kind == "sage":
                # fused: the two-W epilogue, the self and neighbor halves
                # of the concat-form W in ONE plan call (ReLU folded in)
                h = (sage_layer(p, h, graph, last=last) if lps is None
                     else sage_layer(p, h, None, "fused", lps[i], last=last))
            elif lps is not None:
                h = lps[i].apply(h, p["w"], p.get("b"), relu=not last)
            else:
                h = gcn_apply({"layers": [p]}, h, graph, "segment")
                if not last:
                    h = torch.relu(h)
            vals.append(h.cpu().numpy())
        return vals


class WideDeepSession:
    """Recsys scorer session: one level deep, the leaf compute IS the model.

    Each "node id" is a user whose sparse and dense features are a
    deterministic function of the id (a stand-in for a feature store); the
    served embedding is the wide & deep user tower, on the device, its
    field lookup through ``kernels.ops.embedding_bag`` unless ``lookup=
    "dense"``.  ``num_layers == 0``: the engine's whole job is dedupe,
    cache and the batched tower.  The seeded init draws on a generator on
    the session's device (the published width's table is 5.12 GB), so a
    seed gives other weights on the card than on the CPU; ``params``
    replaces it, e.g. with the reference's weights carried over by
    ``params_from_jax``.
    """

    def __init__(self, name: str, num_users: int,
                 cfg: Optional[WideDeepConfig] = None, seed: int = 0,
                 device="cuda", params: Optional[dict] = None,
                 lookup: str = "bag"):
        self.name = name
        self.num_users = num_users
        self.cfg = cfg or REDUCED
        self.device = resolve_device(device)
        self.lookup = lookup
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = widedeep_init(gen, self.cfg, device=self.device)
        self.params = params

    @property
    def num_layers(self) -> int:
        return 0

    @property
    def layer_dims(self) -> List[int]:
        return [self.cfg.mlp_dims[-1]]

    def features(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic per-user feature-store stand-in."""
        u = np.asarray(ids, dtype=np.int64)[:, None]
        f = np.arange(self.cfg.n_sparse, dtype=np.int64)[None, :]
        sparse = ((u * 2654435761 + f * 40503 + 7) %
                  self.cfg.rows_per_field).astype(np.int32)
        k = np.arange(self.cfg.n_dense, dtype=np.int64)[None, :]
        dense = (((u * 97 + k * 31 + 13) % 1000) / 1000.0 - 0.5
                 ).astype(np.float32)
        return sparse, dense

    @torch.no_grad()
    def gather(self, ids: np.ndarray) -> np.ndarray:
        """The user tower of ``ids``, the batch padded to a power of two
        (as the reference pads it for its compiled tower)."""
        ids = np.asarray(ids, dtype=np.int64)
        Bp = _pow2(max(ids.shape[0], 1))
        sparse, dense = self.features(
            np.concatenate([ids, np.zeros(Bp - ids.shape[0], np.int64)]))
        t = lambda a: torch.as_tensor(a).to(self.device)
        out = user_tower(self.params, t(sparse), t(dense), self.cfg,
                         self.lookup)
        return out.cpu().numpy()[:ids.shape[0]]

    def layer_values(self, l: int) -> np.ndarray:
        if l != 0:
            raise ValueError(f"a wide & deep session has layer 0 only, "
                             f"not {l}")
        return self.gather(np.arange(self.num_users))

    def oracle(self, ids: np.ndarray) -> np.ndarray:
        return self.gather(ids)


def _build_widedeep(g, **kw):
    num_users = kw.pop("num_users", g.num_nodes if g is not None else 4096)
    return WideDeepSession("wide_deep", num_users=num_users, **kw)


SESSION_BUILDERS: Dict[str, Callable[..., object]] = {
    "gcn": lambda g, **kw: GNNSession("gcn", g, "gcn", **kw),
    "sage_gin": lambda g, **kw: GNNSession("sage_gin", g, "sage", **kw),
    "wide_deep": _build_widedeep,
}


def make_session(model: str, g: Optional[Graph] = None, **kw):
    """Build a registered serving session (``gcn`` | ``sage_gin`` |
    ``wide_deep``)."""
    try:
        build = SESSION_BUILDERS[model]
    except KeyError:
        raise ValueError(f"unknown serve model {model!r}; "
                         f"registered: {sorted(SESSION_BUILDERS)}") from None
    return build(g, **kw)
