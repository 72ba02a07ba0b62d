"""GraphExecutionPlan / LayerExecutionPlan — forward half of
``repro/exec/plan.py``.

A plan compiles a Graph once into the fused aggregation

    F(x) = s_out ⊙ (A (s_in ⊙ x) [+ s_in ⊙ x])

with the modes of the reference ("gcn": D^-1/2 (A + I) D^-1/2; "sum";
"mean"), and a layer plan runs ``act(F(x) @ W + b)`` in either computation
order (``F`` is linear, so ``F(x) W == F(x W)``).

Backends, all over the slot-compacted block-ELL except ``coo``:

    "cuda"  : the hand-written Hopper kernel ``spmm_blockell_compact``
              (kernels/spmm_blockell.py); on a CPU tensor its wrapper runs
              the plain version;
    "torch" : the plain version ``kernels/ref.spmm_blockell_compact_ref``
              (a batched dense-tile einsum) on float32 tiles — the twin of
              the reference's ``_jnp_blocks``;
    "coo"   : one ``index_add_`` over dst-sorted edges whose weights fold
              in the normalization (the twin of the reference's coo path).

Rows whose destination block has no active slot are not written by the
kernel; the plan patches them with the analytic diagonal term.

Forward only: the transpose plan, the custom backward, degree buckets,
padded (uncompacted) grids, the one-launch fused layer kernel and the chaos
hooks of the reference are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import obs
from ..core.blocksparse import BlockEll, build_blockell, traffic_model
from ..device import resolve_device
from ..graph.structure import Graph
from ..kernels.ref import spmm_blockell_compact_ref
from ..kernels.spmm_blockell import spmm_blockell_compact

MODES = ("gcn", "sum", "mean")
BACKENDS = ("cuda", "torch", "coo")
ORDERS = ("aggregate_first", "update_first")


class SideMeta(NamedTuple):
    """Static facts one direction of the plan needs."""
    backend: str
    add_diag: bool
    bm: int
    bk: int
    R: int
    C: int
    n_active: int
    n: int            # num_nodes


# ---------------------------------------------------------------------------
# the fused op, on any backend
# ---------------------------------------------------------------------------
def _run_side(meta: SideMeta, a: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> torch.Tensor:
    if meta.backend == "coo":
        y = torch.zeros_like(x).index_add_(0, a["dst"],
                                           x[a["src"]] * a["w"][:, None])
        if meta.add_diag:
            y = y + a["dvec"][:, None] * x
        return y
    if meta.backend in ("cuda", "torch"):
        return _compact_blocks(meta, a, x)
    raise ValueError(meta.backend)


def _compact_blocks(meta: SideMeta, a: Dict[str, torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
    # destination blocks with no active slot are never written: patch them
    # with the analytic diagonal term (zero when there is no self-loop)
    fb = (x * a["s_in"][:, None] * a["s_out"][:, None] if meta.add_diag
          else torch.zeros_like(x))
    if meta.n_active == 0:
        return fb
    spmm = (spmm_blockell_compact if meta.backend == "cuda"
            else spmm_blockell_compact_ref)
    y = spmm(a["row_offsets"], a["cols"], a["blocks"], x.contiguous(),
             a["s_in"], a["s_out"], bm=meta.bm, bk=meta.bk,
             add_diag=meta.add_diag)
    return torch.where(a["node_active"][:, None], y, fb)


# ---------------------------------------------------------------------------
# the plan container
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class GraphExecutionPlan:
    """Everything the forward hot path needs, compiled from a Graph once.

    The block-ELL is built eagerly for the block backends and lazily for
    ``coo`` (which only needs the sorted edge arrays)."""

    mode: str
    backend: str
    bm: int
    bk: int
    num_nodes: int
    add_diag: bool
    meta_fwd: SideMeta
    _fwd: Dict[str, torch.Tensor] = dataclasses.field(repr=False)
    _ell: Optional[BlockEll] = dataclasses.field(default=None, repr=False)
    _g_adj: Optional[Graph] = dataclasses.field(default=None, repr=False)

    @property
    def ell(self) -> BlockEll:
        if self._ell is None:
            self._ell = build_blockell(self._g_adj, bm=self.bm, bk=self.bk,
                                       storage="auto")
        return self._ell

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """One forward aggregation ``F(x)``.  The backward (through the
        transpose plan) is not ported yet, so the kernel backend refuses
        inputs that need a gradient instead of silently detaching them."""
        if x.shape[0] != self.num_nodes:
            raise ValueError(f"plan compiled for {self.num_nodes} nodes but "
                             f"x has {x.shape[0]} rows (wrong graph?)")
        if (self.backend == "cuda" and x.requires_grad
                and torch.is_grad_enabled()):
            raise NotImplementedError("the cuda backend has no backward yet "
                                      "(transpose plan not ported)")
        return _run_side(self.meta_fwd, self._fwd, x)

    @property
    def n_active(self) -> int:
        return self.ell.n_active

    @property
    def grid_size(self) -> int:
        """Accumulation steps of one forward: ``n_active`` on the block
        backends, nnz for coo."""
        if self.backend == "coo":
            return int(self._fwd["src"].shape[0])
        return self.ell.n_active

    def describe(self, d: int = 128) -> dict:
        return {"mode": self.mode, "backend": self.backend,
                "bm": self.bm, "bk": self.bk,
                "grid_size": self.grid_size,
                "padded_grid_size": self.ell.n_row_blocks * self.ell.width,
                "plan_bytes": self.ell.storage_bytes(),
                **traffic_model(self.ell, d)}


# ---------------------------------------------------------------------------
# building
# ---------------------------------------------------------------------------
def _mode_scales(mode: str, g: Graph):
    deg = g.in_degrees().astype(np.float32)
    if mode == "gcn":
        s = 1.0 / np.sqrt(np.maximum(deg + 1.0, 1.0))
        return s, s, True
    if mode == "sum":
        ones = np.ones(g.num_nodes, np.float32)
        return ones, ones, False
    if mode == "mean":
        return (np.ones(g.num_nodes, np.float32),
                (1.0 / np.maximum(deg, 1.0)).astype(np.float32), False)
    raise ValueError(f"unknown plan mode {mode!r}; expected one of {MODES}")


def _side_arrays(ell: BlockEll, s_in: np.ndarray, s_out: np.ndarray,
                 backend: str, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    t = lambda a: torch.as_tensor(a).to(device)
    # the kernel takes the exact 0/1 bitmask as uint8 tiles; the plain
    # version computes in float32
    comp = ell.compact(np.uint8 if ell.implicit and backend == "cuda"
                       else np.float32)
    node_active = np.repeat(comp.row_active, ell.bm)[:ell.num_nodes]
    return {"s_in": t(s_in.astype(np.float32)),
            "s_out": t(s_out.astype(np.float32)),
            "blocks": t(comp.blocks),
            # each destination block's slots are walked by offset
            "row_offsets": t(comp.row_offsets.astype(np.int32)),
            "cols": t(comp.cols),
            "node_active": t(node_active)}


def _coo_arrays(g: Graph, s_in: np.ndarray, s_out: np.ndarray,
                add_diag: bool, device: torch.device
                ) -> Dict[str, torch.Tensor]:
    valid = (g.edge_mask if g.edge_mask is not None
             else np.ones(g.num_edges, bool))
    src = g.src[valid].astype(np.int64)
    dst = g.dst[valid].astype(np.int64)
    w = s_out[dst] * s_in[src]
    order = np.argsort(dst, kind="stable")   # dst-major: scatter locality
    t = lambda a: torch.as_tensor(a).to(device)
    out = {"src": t(src[order]), "dst": t(dst[order]),
           "w": t(w[order].astype(np.float32))}
    if add_diag:
        out["dvec"] = t((s_out * s_in).astype(np.float32))
    return out


def build_plan(g: Graph, mode: str = "gcn", *,
               bm: Optional[int] = None, bk: Optional[int] = None,
               backend: Optional[str] = None,
               device="cuda") -> GraphExecutionPlan:
    """Compile ``g`` into a :class:`GraphExecutionPlan` on ``device``.

    ``backend=None`` picks ``"cuda"`` on a CUDA device and ``"coo"`` on the
    CPU.  Square blocks are required, as in the reference.  The block
    backends always run slot-compacted (the reference's ``compact=True``);
    the padded grid waits for the padded kernel and the autotune that races
    the two.  Tiles are the exact 0/1 bitmask whenever it is exact
    (``storage="auto"``); edge weights are ignored (the reference's
    ``weighted=True`` sum plans and its ``width``/``storage`` overrides are
    not ported yet)."""
    dev = resolve_device(device)
    bm = bm or 128
    bk = bk or bm
    if bm != bk:
        raise ValueError("GraphExecutionPlan requires square blocks "
                         f"(got bm={bm}, bk={bk})")
    if backend is None:
        backend = "cuda" if dev.type == "cuda" else "coo"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    s_in, s_out, add_diag = _mode_scales(mode, g)
    g_adj = dataclasses.replace(g, edge_weight=None)
    R = int(np.ceil(g.num_nodes / bm))
    C = int(np.ceil(g.num_nodes / bk))
    with obs.span("exec.plan.compile", cat="exec", backend=backend,
                  mode=mode, bm=bm, n=g.num_nodes) as sp:
        if backend == "coo":
            fwd = _coo_arrays(g_adj, s_in, s_out, add_diag, dev)
            ell, n_active = None, 0
        else:
            ell = build_blockell(g_adj, bm=bm, bk=bk, storage="auto")
            fwd = _side_arrays(ell, s_in, s_out, backend, dev)
            n_active = ell.n_active
            sp.set(n_active=n_active, plan_bytes=ell.storage_bytes())
    obs.counter("exec.plan.compiles", backend=backend).inc()
    meta = SideMeta(backend=backend, add_diag=add_diag,
                    bm=bm, bk=bk, R=R, C=C, n_active=n_active,
                    n=g.num_nodes)
    return GraphExecutionPlan(
        mode=mode, backend=backend, bm=bm, bk=bk,
        num_nodes=g.num_nodes, add_diag=add_diag, meta_fwd=meta, _fwd=fwd,
        _ell=ell, _g_adj=g_adj)


# ===========================================================================
# layer plans: aggregation ∘ update with computation-order selection
# ===========================================================================
def layer_order_costs(n: int, e: int, d_in: int, d_out: int, *,
                      bytes_per_el: int = 4, balance: float = 8.0) -> dict:
    """FLOP/byte model of the two computation orders of one GNN layer:

        aggregate_first: spmm(d_in)  + matmul(n, d_in, d_out)
        update_first:    matmul(n, d_in, d_out) + spmm(d_out)

    in byte-equivalents ``bytes + flops / balance``."""
    def spmm(d: int) -> float:
        return spmm_cost(n, e, d, bytes_per_el=bytes_per_el, balance=balance)

    matmul = ((n * d_in + n * d_out + d_in * d_out) * bytes_per_el
              + 2.0 * n * d_in * d_out / balance)
    return {"aggregate_first": spmm(d_in) + matmul,
            "update_first": matmul + spmm(d_out)}


def spmm_cost(n: int, e: int, d: int, *, bytes_per_el: int = 4,
              balance: float = 8.0) -> float:
    """Byte-equivalent cost of one SpMM at feature width ``d``."""
    flops = 2.0 * e * d
    bytes_ = (e * d + 2.0 * n * d) * bytes_per_el   # gathers + in/out rows
    return bytes_ + flops / balance


def choose_order(n: int, e: int, d_in: int, d_out: int) -> str:
    """Shrinking layers aggregate after the update, growing layers before
    it; ties go to aggregate-first."""
    c = layer_order_costs(n, e, d_in, d_out)
    return ("update_first" if c["update_first"] < c["aggregate_first"]
            else "aggregate_first")


@dataclasses.dataclass
class LayerExecutionPlan:
    """A whole GNN layer ``act(F(x) @ w + b)`` as one scheduled op.

    ``order="update_first"`` evaluates it as ``act(F(x @ w) + b)``, so the
    aggregation streams the narrower width.  The update matmul runs in
    ``torch.matmul`` (full fp32: TF32 is off), as the reference leaves it
    to XLA."""

    gplan: GraphExecutionPlan
    d_in: int
    d_out: int
    order: str

    @property
    def mode(self) -> str:
        return self.gplan.mode

    def apply(self, x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None, *,
              relu: bool = False) -> torch.Tensor:
        if tuple(w.shape) != (self.d_in, self.d_out):
            raise ValueError(f"layer plan compiled for W {self.d_in}x"
                             f"{self.d_out}, got {tuple(w.shape)}")
        if self.order == "aggregate_first":
            y = self.gplan.apply(x) @ w
        else:
            y = self.gplan.apply(x @ w)
        if b is not None:
            y = y + b
        return torch.relu(y) if relu else y


def build_layer_plan(g: Graph, mode: str = "gcn", *, d_in: int, d_out: int,
                     order: str = "auto", bm: Optional[int] = None,
                     bk: Optional[int] = None, backend: Optional[str] = None,
                     gplan: Optional[GraphExecutionPlan] = None,
                     device="cuda") -> LayerExecutionPlan:
    """Compile one GNN layer ``(d_in -> d_out)`` over ``g``.

    ``order="auto"`` consults the FLOP/byte model.  Pass a prebuilt
    ``gplan`` to share one block-ELL construction across a model's layers.
    """
    if order in (None, "auto"):
        order = choose_order(g.num_nodes, g.num_valid_edges, d_in, d_out)
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}; expected {ORDERS}")
    if gplan is None:
        gplan = build_plan(g, mode, bm=bm, bk=bk, backend=backend,
                           device=device)
    elif gplan.mode != mode:
        raise ValueError(f"prebuilt gplan has mode {gplan.mode!r}, layer "
                         f"plan wants {mode!r}")
    return LayerExecutionPlan(gplan=gplan, d_in=d_in, d_out=d_out,
                              order=order)
