"""Model sessions for the serving engine (port of ``repro/serve/registry.py``).

A session owns the model parameters and turns a batch of node ids into
embeddings: ``expand`` (one-hop frontier growth), ``gather`` (leaf
features), ``layer_forward`` (one GCN layer over flat edge lists, on the
device) and ``layer_values`` (the offline full-graph forward: the oracle
rows and the ``warm()`` payloads).  Only the ``gcn`` session is ported; the
``sage_gin`` and ``wide_deep`` sessions raise until they are.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..exec import gcn_chain, plan_forward
from ..graph.structure import Graph
from ..graph.sampler import FullNeighborhood, NeighborSampler
from ..models.gcn import gcn_apply, gcn_init, make_graph_inputs


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


class GNNSession:
    """Serves a full-batch GCN over sampled blocks.

    ``expander='full'`` (default) aggregates every in-edge with global
    degrees, so block outputs equal the offline full-graph forward row for
    row and the engine's oracle check is exact.

    ``executor='fused'`` (default) compiles the offline forward through
    :func:`~repro_torch.exec.plan_forward`, as the reference does: the DP
    over the layer chain picks every layer's (order, fuse, backend, bm,
    compact, buckets) jointly — measured costs when the autotune cache
    (``$REPRO_TORCH_EXEC_CACHE``) is warm for this graph and device, the
    FLOP/byte model when cold — over the card's candidate grid on ``cuda``
    and the CPU grid on the CPU; layers with matching configs share one
    graph plan.  ``executor='segment'`` runs the plain edge-list forward.

    ``params`` (a tree like ``gcn_init``'s) replaces the seeded init, e.g.
    with the reference's weights carried over by ``params_from_jax``.
    """

    def __init__(self, name: str, g: Graph, kind: str = "gcn",
                 hidden: int = 64, out_dim: int = 16, seed: int = 0,
                 expander: str = "full", fanouts: Tuple[int, ...] = (10, 10),
                 executor: str = "fused", device="cuda",
                 params: Optional[dict] = None):
        if g.node_feat is None:
            raise ValueError("GNNSession needs node features")
        if kind != "gcn":
            raise NotImplementedError(f"session kind {kind!r} is not ported "
                                      "yet (only 'gcn')")
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
            params = gcn_init(torch.Generator().manual_seed(seed), self.dims,
                              device=self.device)
        self.params = params
        deg = g.in_degrees().astype(np.float32) + 1.0
        self.inv_sqrt = (1.0 / np.sqrt(np.maximum(deg, 1.0))).astype(np.float32)
        self._expander = (FullNeighborhood(g) if expander == "full"
                          else NeighborSampler(g, list(fanouts), seed=seed))
        self._layer_cache: Optional[List[np.ndarray]] = None
        self._layer_plans = None
        self._fplan = None
        if executor == "fused":
            self._fplan = plan_forward(g, gcn_chain(self.dims),
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
        out = _gcn_layer(p["w"], p["b"], t(src_h, np.float32),
                         t(self_h, np.float32),
                         t(self.inv_sqrt[edge_src], np.float32),
                         t(self.inv_sqrt[dst_ids], np.float32),
                         t(dst_index, np.int64),
                         is_last=l == self.num_layers)
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
        next layer consumes it (post-activation for non-final layers)."""
        h = torch.as_tensor(self.feats).to(self.device)
        vals = [self.feats]
        L = self.num_layers
        graph = (make_graph_inputs(self.g, self.device)
                 if self._layer_plans is None else None)
        for i, p in enumerate(self.params["layers"]):
            if self._layer_plans is not None:
                h = self._layer_plans[i].apply(h, p["w"], p.get("b"),
                                               relu=i + 1 < L)
            else:
                h = gcn_apply({"layers": [p]}, h, graph, "segment")
                if i + 1 < L:
                    h = torch.relu(h)
            vals.append(h.cpu().numpy())
        return vals


def _not_ported(model: str) -> Callable[..., object]:
    def build(g, **kw):
        raise NotImplementedError(f"serve model {model!r} is not ported to "
                                  "repro_torch yet (only 'gcn')")
    return build


SESSION_BUILDERS: Dict[str, Callable[..., object]] = {
    "gcn": lambda g, **kw: GNNSession("gcn", g, "gcn", **kw),
    "sage_gin": _not_ported("sage_gin"),
    "wide_deep": _not_ported("wide_deep"),
}


def make_session(model: str, g: Optional[Graph] = None, **kw):
    """Build a registered serving session (only ``gcn`` is ported)."""
    try:
        build = SESSION_BUILDERS[model]
    except KeyError:
        raise ValueError(f"unknown serve model {model!r}; "
                         f"registered: {sorted(SESSION_BUILDERS)}") from None
    return build(g, **kw)
