"""GraphExecutionPlan / LayerExecutionPlan — port of ``repro/exec/plan.py``.

A plan compiles a Graph once into both directions of the aggregation

    F(x)   = s_out ⊙ (A (s_in ⊙ x) [+ s_in ⊙ x])         (forward)
    F*(g)  = s_in ⊙ (Aᵀ (s_out ⊙ g) [+ s_out ⊙ g])       (backward, wrt x)

with the modes of the reference ("gcn": D^-1/2 (A + I) D^-1/2; "sum";
"mean").  F is linear, so its backward is the same fused op over a
precompiled transpose plan (Aᵀ, scales swapped); a ``torch.autograd.Function``
wires that in.  A layer plan runs
``act(F(x) @ W + c · (x @ W_self) + b)`` in either computation order
(``F(x) W == F(x W)``), fused into one launch when it aggregates first on
the kernel backend, with a hand-written backward of its own.

Backends (the reference's ``pallas`` is ``cuda`` here, its ``jnp`` is
``torch``):

    "cuda"  : the hand-written Hopper kernels (kernels/spmm_blockell.py):
              ``spmm_blockell_compact`` / ``spmm_blockell_update_compact``
              over the slot-compacted block-ELL (``compact=True``),
              ``spmm_blockell_fused`` / ``spmm_blockell_update`` over the
              padded (R, W) grid (``compact=False``); on a CPU tensor the
              wrappers run the plain versions;
    "torch" : the plain versions in ``kernels/ref.py`` on float32 tiles —
              the twin of the reference's ``jnp`` path; it never fuses;
    "coo"   : one ``index_add_`` over dst-sorted edges whose weights fold
              in the normalization (the twin of the reference's coo path).

A compact ``cuda`` direction whose tiles would be sparse takes the list
form instead (``_side_host``): per destination row, the entries a walk
over its tiles would find (``core.blocksparse.row_lists``), built from the
edges and read by the compact kernels' list walk; no tile is built.  It
does so when the lists are fewer bytes than the tiles: below a mean tile
fill of 1/4 on uint8 tiles (4 B an entry against 1 B a tile entry), 1/2 on
float32 ones (8 B with the coefficient against 4).  Each direction built
counts once on the ungated ``exec.plan.directions{form=list|tiles}``.

Rows whose destination block has no active slot are not written by the
compact tile walk; the plan patches them with the analytic diagonal (and
self) term.  The list walk and the padded kernels write every row.

Degree-bucketed plans (``buckets="128@7+256"``, see ``bucketing.py``)
partition destination nodes by in-degree, build one rectangular block-ELL
per bucket at its own tile and launch one compact kernel per bucket on
``cuda`` (destination operands gathered into bucket-local order through the
kernels' ``x_diag`` / ``s_in_diag`` / ``x_self`` overrides), or one padded
plain product per bucket on ``torch``; the outputs are stitched back
through the inverse permutation.  Each direction buckets by its own
in-degrees, so the transpose plan re-buckets.

``weighted=True`` ``sum`` plans aggregate over the edge weights (float32
tiles on ``cuda``, the weights folded into the coo edge list); otherwise
the weights are dropped, as in the reference.  The reference's ``width``
and ``storage`` overrides are left out: no caller of the port sets them.

The kernel path carries the reference's two chaos sites (``chaos/inject``):
``exec.pallas_launch`` (``fail_point``) before each ``cuda`` launch, one per
sub-grid of a bucketed plan, and ``exec.kernel_result`` (``mangle``) on each
``cuda`` result; ``exec/fallback.ResilientPlan`` demotes a call that trips
either.  Disarmed, each is one global load and a ``None`` check.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import obs
from ..chaos import inject as chaos
from ..core.blocksparse import (BlockEll, build_blockell, build_blockell_coo,
                                row_lists, transpose_graph, traffic_model)
from ..device import resolve_device
from ..graph.structure import Graph
from ..kernels.ref import (spmm_blockell_compact_ref, spmm_blockell_fused_ref,
                           spmm_blockell_ref)
from ..kernels.spmm_blockell import (Lists, list_arrays,
                                     spmm_blockell_compact,
                                     spmm_blockell_fused,
                                     spmm_blockell_update,
                                     spmm_blockell_update_compact)
from .bucketing import assign_buckets, bucket_occupancy, parse_bucket_sig

MODES = ("gcn", "sum", "mean")
BACKENDS = ("cuda", "torch", "coo")
ORDERS = ("aggregate_first", "update_first")


class SideMeta(NamedTuple):
    """Static facts one direction of the plan needs."""
    backend: str
    compact: bool
    add_diag: bool
    bm: int
    bk: int
    R: int
    C: int
    n_active: int
    n: int            # num_nodes
    lists: bool = False   # per-row entry lists in place of tiles


class BucketMeta(NamedTuple):
    """Geometry of ONE degree bucket's rectangular block-ELL."""
    bm: int
    bk: int
    R: int            # ceil(n_rows / bm)  (bucket-local destination blocks)
    C: int            # ceil(n / bk)       (global source blocks)
    W: int            # ELL width of this bucket
    n_active: int
    n_rows: int       # nodes assigned to this bucket


class BucketedSideMeta(NamedTuple):
    """One direction of a degree-bucketed plan.  Forward and backward carry
    independent bucket tuples: the transpose graph is re-bucketed by its
    own in-degrees (the original graph's out-degrees)."""
    backend: str
    compact: bool
    add_diag: bool
    n: int            # num_nodes
    buckets: tuple    # Tuple[BucketMeta, ...]


# ---------------------------------------------------------------------------
# one direction of the fused op, on any backend
# ---------------------------------------------------------------------------
def _run_side(meta, a: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> torch.Tensor:
    if isinstance(meta, BucketedSideMeta):
        return _run_bucketed(meta, a, x)
    if meta.backend == "coo":
        y = torch.zeros_like(x).index_add_(0, a["dst"],
                                           x[a["src"]] * a["w"][:, None])
        if meta.add_diag:
            y = y + a["dvec"][:, None] * x
        return y
    if meta.backend not in ("cuda", "torch"):
        raise ValueError(meta.backend)
    kernel = meta.backend == "cuda"
    if kernel:
        chaos.fail_point("exec.pallas_launch")   # no-op unless a drill armed it
    if meta.compact:
        y = _compact_blocks(meta, a, x)
    else:
        spmm = spmm_blockell_fused if kernel else spmm_blockell_fused_ref
        # the padded kernel writes every row: no fallback patch
        y = spmm(a["block_cols"], a["blocks"], x.contiguous(), a["s_in"],
                 a["s_out"], bm=meta.bm, bk=meta.bk, add_diag=meta.add_diag)
    return chaos.mangle("exec.kernel_result", y) if kernel else y


def _diag_fallback(add_diag: bool, a: Dict[str, torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """What rows with no active slot hold: the analytic diagonal term, zero
    when there is no self-loop."""
    return (x * a["s_in"][:, None] * a["s_out"][:, None] if add_diag
            else torch.zeros_like(x))


def _compact_blocks(meta: SideMeta, a: Dict[str, torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
    if meta.n_active == 0:
        return _diag_fallback(meta.add_diag, a, x)
    if meta.lists:
        # the list walk writes every row: nothing to patch
        return spmm_blockell_compact(
            None, None, None, x.contiguous(), a["s_in"], a["s_out"],
            bm=meta.bm, bk=meta.bk, add_diag=meta.add_diag,
            lists=Lists.of(a))
    # destination blocks with no active slot are never written: patch them
    fb = _diag_fallback(meta.add_diag, a, x)
    spmm = (spmm_blockell_compact if meta.backend == "cuda"
            else spmm_blockell_compact_ref)
    y = spmm(a["row_offsets"], a["cols"], a["blocks"], x.contiguous(),
             a["s_in"], a["s_out"], bm=meta.bm, bk=meta.bk,
             add_diag=meta.add_diag)
    return torch.where(a["node_active"][:, None], y, fb)


def _run_bucketed(meta: BucketedSideMeta, a: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
    """Multi-grid aggregation: one launch per degree bucket, outputs
    stitched back to node order through the inverse permutation."""
    x = x.contiguous()
    outs = []
    if meta.backend == "torch":
        # per-bucket padded plain product (the reference's jnp path): every
        # bucket row is computed, so nothing needs patching
        xs = x * a["s_in"][:, None]
        for bmeta, ab in zip(meta.buckets, a["buckets"]):
            if not bmeta.n_rows:
                continue
            y = spmm_blockell_ref(ab["block_cols"], ab["blocks"], xs,
                                  bm=bmeta.bm, bk=bmeta.bk,
                                  n_dst=bmeta.n_rows)
            if meta.add_diag:
                y = y + xs[ab["idx"]]
            outs.append(y * ab["s_out_sel"][:, None])
        return torch.cat(outs, dim=0)[a["inv_perm"]]
    for bmeta, ab in zip(meta.buckets, a["buckets"]):
        if not bmeta.n_rows:
            continue
        # one fail point per sub-grid: a launch failure in ANY bucket aborts
        # the whole call, so the fallback chain demotes it whole instead of
        # stitching a half-bucketed output
        chaos.fail_point("exec.pallas_launch")
        if not bmeta.n_active:
            # every row of this bucket takes the global diagonal fallback
            outs.append(x.new_zeros((bmeta.n_rows, x.shape[1])))
            continue
        xd = sd = None
        if meta.add_diag:
            xd, sd = x[ab["idx"]], ab["s_in_diag"]
        outs.append(spmm_blockell_compact(
            ab["row_offsets"], ab["cols"], ab["blocks"], x, a["s_in"],
            ab["s_out_sel"], xd, sd, bm=bmeta.bm, bk=bmeta.bk,
            add_diag=meta.add_diag))
    y = torch.cat(outs, dim=0)[a["inv_perm"]]
    return chaos.mangle("exec.kernel_result",
                        torch.where(a["node_active"][:, None], y,
                                    _diag_fallback(meta.add_diag, a, x)))


def _self_term(x: torch.Tensor, w_self: torch.Tensor,
               self_coeff: Optional[torch.Tensor]) -> torch.Tensor:
    """The epilogue's self half ``self_coeff * (x @ w_self)`` (coeff None
    means 1)."""
    s = x @ w_self
    return s if self_coeff is None else s * self_coeff


def _layer_fallback(add_diag: bool, a: Dict[str, torch.Tensor],
                    x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor], relu: bool,
                    w_self: Optional[torch.Tensor],
                    self_coeff: Optional[torch.Tensor]) -> torch.Tensor:
    """The layer's rows whose destination block has no active slot: the
    analytic diagonal and self terms through the same update."""
    fb = (x * (a["s_in"] * a["s_out"])[:, None] @ w if add_diag
          else x.new_zeros((x.shape[0], w.shape[1])))
    if w_self is not None:
        fb = fb + _self_term(x, w_self, self_coeff)
    if b is not None:
        fb = fb + b
    if relu:
        fb = torch.relu(fb)
    return fb


def _fused_layer(meta, a: Dict[str, torch.Tensor], x: torch.Tensor,
                 w: torch.Tensor, b: Optional[torch.Tensor], relu: bool,
                 w_self: Optional[torch.Tensor] = None,
                 self_coeff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused layer: aggregation + (two-)W epilogue (+bias/ReLU) in one
    launch, or one per bucket (the reference's ``_pallas_layer``)."""
    x, w = x.contiguous(), w.contiguous()
    if isinstance(meta, BucketedSideMeta):
        return _bucketed_layer(meta, a, x, w, b, relu, w_self, self_coeff)
    chaos.fail_point("exec.pallas_launch")   # no-op unless a drill armed it
    if not meta.compact:
        # the padded kernel writes every row: no fallback patch
        return chaos.mangle("exec.kernel_result", spmm_blockell_update(
            a["block_cols"], a["blocks"], x, a["s_in"], a["s_out"], w, b,
            w_self, self_coeff, bm=meta.bm, bk=meta.bk,
            add_diag=meta.add_diag, relu=relu))
    if not meta.n_active:
        return chaos.mangle("exec.kernel_result", _layer_fallback(
            meta.add_diag, a, x, w, b, relu, w_self, self_coeff))
    if meta.lists:
        # the list walk writes every row: nothing to patch
        return chaos.mangle("exec.kernel_result", spmm_blockell_update_compact(
            None, None, None, x, a["s_in"], a["s_out"], w, b, w_self,
            self_coeff, bm=meta.bm, bk=meta.bk, add_diag=meta.add_diag,
            relu=relu, lists=Lists.of(a)))
    fb = _layer_fallback(meta.add_diag, a, x, w, b, relu, w_self,
                         self_coeff)
    y = spmm_blockell_update_compact(
        a["row_offsets"], a["cols"], a["blocks"], x, a["s_in"], a["s_out"],
        w, b, w_self, self_coeff, bm=meta.bm, bk=meta.bk,
        add_diag=meta.add_diag, relu=relu)
    return chaos.mangle("exec.kernel_result",
                        torch.where(a["node_active"][:, None], y, fb))


def _bucketed_layer(meta: BucketedSideMeta, a: Dict[str, torch.Tensor],
                    x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor], relu: bool,
                    w_self: Optional[torch.Tensor] = None,
                    self_coeff: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Fused layer over degree buckets: one update-epilogue compact launch
    per bucket (destination-row operands gathered into bucket-local order),
    outputs stitched through the inverse permutation."""
    d_out = w.shape[1]
    outs = []
    for bmeta, ab in zip(meta.buckets, a["buckets"]):
        if not bmeta.n_rows:
            continue
        if not bmeta.n_active:
            outs.append(x.new_zeros((bmeta.n_rows, d_out)))
            continue
        # per-sub-grid fail point: any bucket's launch failure aborts the
        # whole fused-layer call (consistent demotion, no half-stitched y)
        chaos.fail_point("exec.pallas_launch")
        xg = (x[ab["idx"]] if meta.add_diag or w_self is not None
              else None)
        outs.append(spmm_blockell_update_compact(
            ab["row_offsets"], ab["cols"], ab["blocks"], x, a["s_in"],
            ab["s_out_sel"], w, b, w_self, self_coeff,
            x_self=xg if w_self is not None else None,
            x_diag=xg if meta.add_diag else None,
            s_in_diag=ab["s_in_diag"] if meta.add_diag else None,
            bm=bmeta.bm, bk=bmeta.bk, add_diag=meta.add_diag, relu=relu))
    y = torch.cat(outs, dim=0)[a["inv_perm"]]
    fb = _layer_fallback(meta.add_diag, a, x, w, b, relu, w_self,
                         self_coeff)
    return chaos.mangle("exec.kernel_result",
                        torch.where(a["node_active"][:, None], y, fb))


# ---------------------------------------------------------------------------
# the plan container
# ---------------------------------------------------------------------------
class _Aggregate(torch.autograd.Function):
    """``F(x)`` forward; ``F*(g)`` through the transpose plan backward."""

    @staticmethod
    def forward(ctx, plan: "GraphExecutionPlan", x: torch.Tensor):
        ctx.plan = plan
        return plan.raw_apply(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return None, ctx.plan.raw_apply_t(g)


@dataclasses.dataclass
class GraphExecutionPlan:
    """Everything the hot path needs, compiled from a Graph once.

    The block-ELL structures are built eagerly for the tile directions of
    the block backends and lazily for ``coo`` (which only needs the sorted
    edge arrays), for list directions (which hold entry lists instead) and
    for bucketed plans (which keep one block-ELL per bucket instead)."""

    mode: str
    backend: str
    compact: bool
    bm: int
    bk: int
    num_nodes: int
    add_diag: bool
    meta_fwd: object                  # SideMeta | BucketedSideMeta
    meta_bwd: object
    _fwd: Dict[str, torch.Tensor] = dataclasses.field(repr=False)
    _bwd: Dict[str, torch.Tensor] = dataclasses.field(repr=False)
    _ell: Optional[BlockEll] = dataclasses.field(default=None, repr=False)
    _ell_t: Optional[BlockEll] = dataclasses.field(default=None, repr=False)
    _g_adj: Optional[Graph] = dataclasses.field(default=None, repr=False)
    _g_adj_t: Optional[Graph] = dataclasses.field(default=None, repr=False)
    buckets: str = ""                 # bucket signature, "" = single grid
    _plan_bytes: int = 0              # bucketed: total per-bucket tile bytes
    _occupancy: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def ell(self) -> BlockEll:
        if self._ell is None:
            self._ell = build_blockell(self._g_adj, bm=self.bm, bk=self.bk,
                                       storage="auto")
        return self._ell

    @property
    def ell_t(self) -> BlockEll:
        if self._ell_t is None:
            self._ell_t = build_blockell(self._g_adj_t, bm=self.bm,
                                         bk=self.bk, storage="auto")
        return self._ell_t

    @property
    def device(self) -> torch.device:
        """Where the plan's arrays (and the inputs it takes) live."""
        return next(t.device for t in self._fwd.values()
                    if isinstance(t, torch.Tensor))

    def raw_apply(self, x: torch.Tensor) -> torch.Tensor:
        """One forward aggregation with no autograd attached — the building
        block :class:`LayerExecutionPlan` composes inside its own backward."""
        return _run_side(self.meta_fwd, self._fwd, x)

    def raw_apply_t(self, g: torch.Tensor) -> torch.Tensor:
        """One aggregation through the precompiled TRANSPOSE plan (``Aᵀ``
        with the scales swapped) — the cotangent hot path."""
        return _run_side(self.meta_bwd, self._bwd, g)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable fused aggregation ``F(x)``: one launch forward, one
        through the transpose plan backward (one per bucket when
        bucketed)."""
        if x.shape[0] != self.num_nodes:
            raise ValueError(f"plan compiled for {self.num_nodes} nodes but "
                             f"x has {x.shape[0]} rows (wrong graph?)")
        return _Aggregate.apply(self, x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    @property
    def n_active(self) -> int:
        if self.buckets:
            return sum(m.n_active for m in self.meta_fwd.buckets)
        if self.backend == "coo":
            return self.ell.n_active
        return self.meta_fwd.n_active

    @property
    def grid_size(self) -> int:
        """Accumulation steps of one forward: ``n_active`` for the compacted
        grid, ``R * W`` for the padded one, nnz for coo; for a bucketed
        plan the sum over sub-grids (compacted on ``cuda``, padded at
        per-bucket widths on ``torch``)."""
        if self.buckets:
            ms = self.meta_fwd.buckets
            if self.backend == "cuda":
                return sum(m.n_active for m in ms)
            return sum(m.R * m.W for m in ms if m.n_rows)
        if self.backend == "coo":
            return int(self._fwd["src"].shape[0])
        if self.compact:
            return self.meta_fwd.n_active
        return self.ell.n_row_blocks * self.ell.width

    def describe(self, d: int = 128) -> dict:
        if self.buckets:
            return {"mode": self.mode, "backend": self.backend,
                    "compact": self.compact, "bm": self.bm, "bk": self.bk,
                    "buckets": self.buckets,
                    "bucket_occupancy": list(self._occupancy),
                    "grid_size": self.grid_size,
                    "plan_bytes": self._plan_bytes}
        return {"mode": self.mode, "backend": self.backend,
                "compact": self.compact, "bm": self.bm, "bk": self.bk,
                "grid_size": self.grid_size,
                "padded_grid_size": self.ell.n_row_blocks * self.ell.width,
                "plan_bytes": (self.ell.storage_bytes()
                               + self.ell_t.storage_bytes()),
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


def _upload(host, device: torch.device):
    """A direction's host arrays (numpy, in dicts and lists) copied to
    ``device`` in the same structure."""
    if isinstance(host, dict):
        return {k: _upload(v, device) for k, v in host.items()}
    if isinstance(host, list):
        return [_upload(v, device) for v in host]
    return torch.as_tensor(np.ascontiguousarray(host)).to(device)


def _direction(build, device: torch.device):
    """One direction of a block plan: ``build()`` makes its tiles and other
    host arrays (``exec.plan.tiles``), which are then copied to ``device``,
    ending in a synchronise (``exec.plan.upload``).  Each phase is one
    observation of its ungated histogram, which set-up readers take
    whatever the telemetry flag says.  Returns ``build()``'s tuple with the
    device arrays in place of the host ones."""
    t0 = time.perf_counter()
    with obs.span("exec.plan.tiles", cat="exec"):
        host, *rest = build()
    t1 = time.perf_counter()
    obs.histogram("exec.plan.tiles_seconds", gated=False).observe(t1 - t0)
    with obs.span("exec.plan.upload", cat="exec"):
        arrays = _upload(host, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    obs.histogram("exec.plan.upload_seconds", gated=False).observe(
        time.perf_counter() - t1)
    return (arrays, *rest)


def _tile_dtype(ell: BlockEll, backend: str):
    """The kernels take the exact 0/1 bitmask as uint8 tiles; the plain
    version computes in float32."""
    return np.uint8 if ell.implicit and backend == "cuda" else np.float32


def _tile_arrays(ell: BlockEll, s_in: np.ndarray, s_out: np.ndarray,
                 backend: str, compact: bool) -> Dict[str, np.ndarray]:
    """A tile direction's host arrays."""
    a = {"s_in": s_in.astype(np.float32), "s_out": s_out.astype(np.float32)}
    if compact:
        comp = ell.compact(_tile_dtype(ell, backend))
        node_active = np.repeat(comp.row_active, ell.bm)[:ell.num_nodes]
        a.update(blocks=comp.blocks,
                 # each destination block's slots are walked by offset
                 row_offsets=comp.row_offsets.astype(np.int32),
                 cols=comp.cols, node_active=node_active)
    else:
        a.update(block_cols=ell.block_cols,
                 blocks=ell.dense_blocks(_tile_dtype(ell, backend)))
    return a


def _side_host(g: Graph, bm: int, s_in: np.ndarray, s_out: np.ndarray,
               backend: str, compact: bool):
    """One direction's host arrays: ``(arrays, n_active, nbytes, ell)``,
    ``ell`` None for a list direction (see the module's docstring)."""
    if backend == "cuda" and compact:
        lists = row_lists(g, bm=bm, bk=bm)
        if lists.nbytes() < lists.tile_bytes(bm, bm):
            obs.counter("exec.plan.directions", gated=False, form="list").inc()
            a = {"s_in": s_in.astype(np.float32),
                 "s_out": s_out.astype(np.float32),
                 **list_arrays(lists.row_ptr, lists.src, lists.coef)}
            return a, lists.n_active, lists.nbytes(), None
    obs.counter("exec.plan.directions", gated=False, form="tiles").inc()
    ell = build_blockell(g, bm=bm, bk=bm, storage="auto")
    return (_tile_arrays(ell, s_in, s_out, backend, compact), ell.n_active,
            ell.storage_bytes(), ell)


def _bucketed_side_host(g: Graph, scheme, s_in: np.ndarray,
                        s_out: np.ndarray, backend: str):
    """Per-bucket host arrays + metas for ONE direction of a bucketed plan.

    Destination nodes are partitioned by ``g``'s in-degrees (so the
    transpose direction re-buckets by its own skew) and remapped to a
    bucket-local contiguous row space; sources stay global.  Returns
    ``(arrays, metas, plan_bytes)``."""
    n = g.num_nodes
    valid = (g.edge_mask if g.edge_mask is not None
             else np.ones(g.num_edges, bool))
    src = g.src[valid].astype(np.int64)
    dst = g.dst[valid].astype(np.int64)
    w = (g.edge_weight[valid] if g.edge_weight is not None
         else np.ones(src.shape[0], np.float32))
    idx_list = assign_buckets(g.in_degrees(), scheme)
    bucket_of = np.zeros(n, np.int64)
    local_of = np.zeros(n, np.int64)
    for b, idx in enumerate(idx_list):
        bucket_of[idx] = b
        local_of[idx] = np.arange(idx.size)
    dst_bucket = bucket_of[dst]

    obs.counter("exec.plan.directions", gated=False, form="tiles").inc()
    metas, buckets_a = [], []
    node_active = np.zeros(n, bool)
    plan_bytes = 0
    for b, ((bm_b, _cut), idx) in enumerate(zip(scheme, idx_list)):
        if idx.size == 0:
            metas.append(BucketMeta(bm=bm_b, bk=bm_b, R=0, C=0, W=0,
                                    n_active=0, n_rows=0))
            buckets_a.append({})
            continue
        sel = dst_bucket == b
        ell_b = build_blockell_coo(
            src[sel], local_of[dst[sel]], w[sel], num_nodes=n,
            num_rows=int(idx.size), bm=bm_b, bk=bm_b, storage="auto")
        plan_bytes += ell_b.storage_bytes()
        ab = {"idx": idx, "s_out_sel": s_out[idx].astype(np.float32)}
        if backend == "torch":
            ab["block_cols"] = ell_b.block_cols
            ab["blocks"] = ell_b.dense_blocks(np.float32)
            node_active[idx] = True         # every bucket row is computed
            n_act = ell_b.n_active
        else:
            comp = ell_b.compact(_tile_dtype(ell_b, backend))
            ab["row_offsets"] = comp.row_offsets.astype(np.int32)
            ab["cols"] = comp.cols
            ab["blocks"] = comp.blocks
            ab["s_in_diag"] = s_in[idx].astype(np.float32)
            node_active[idx] = np.repeat(comp.row_active, bm_b)[:idx.size]
            n_act = comp.n_active
        metas.append(BucketMeta(bm=bm_b, bk=bm_b, R=ell_b.n_row_blocks,
                                C=int(np.ceil(n / bm_b)), W=ell_b.width,
                                n_active=int(n_act), n_rows=int(idx.size)))
        buckets_a.append(ab)

    perm = np.concatenate([idx for idx in idx_list if idx.size])
    inv = np.zeros(n, np.int64)
    inv[perm] = np.arange(n)
    a = {"s_in": s_in.astype(np.float32),
         "s_out": s_out.astype(np.float32),
         "buckets": buckets_a, "inv_perm": inv,
         "node_active": node_active}
    return a, tuple(metas), int(plan_bytes)


def _coo_arrays(g: Graph, s_in: np.ndarray, s_out: np.ndarray,
                add_diag: bool, weighted: bool, device: torch.device
                ) -> Dict[str, torch.Tensor]:
    valid = (g.edge_mask if g.edge_mask is not None
             else np.ones(g.num_edges, bool))
    src = g.src[valid].astype(np.int64)
    dst = g.dst[valid].astype(np.int64)
    w = s_out[dst] * s_in[src]
    if weighted and g.edge_weight is not None:
        w = w * g.edge_weight[valid]
    order = np.argsort(dst, kind="stable")   # dst-major: scatter locality
    out = {"src": src[order], "dst": dst[order],
           "w": w[order].astype(np.float32)}
    if add_diag:
        out["dvec"] = (s_out * s_in).astype(np.float32)
    return _upload(out, device)


def build_plan(g: Graph, mode: str = "gcn", *,
               bm: Optional[int] = None, bk: Optional[int] = None,
               backend: Optional[str] = None, compact: bool = True,
               weighted: bool = False, buckets: str = "",
               device="cuda") -> GraphExecutionPlan:
    """Compile ``g`` into a :class:`GraphExecutionPlan` on ``device``.

    ``backend=None`` picks ``"cuda"`` on a CUDA device and ``"coo"`` on the
    CPU (``repro_torch.exec.autotune_plan`` picks by measurement instead).
    Square blocks are required, as in the reference (the transpose plan
    reuses the same tiling).  ``compact=False`` runs the padded (R, W) grid.
    ``buckets`` is a degree-bucket signature (``"128@7+256"``; see
    ``bucketing.py``): one sub-grid per bucket at that bucket's square tile,
    on ``cuda`` (compact kernels) or ``torch`` (padded plain products);
    bucketed plans imply compaction and a block backend.  Tiles are the
    exact 0/1 bitmask whenever it is exact (``storage="auto"``).  Edge
    weights are dropped unless ``weighted=True``, which composes with
    ``mode="sum"`` only: the plan then computes ``A_w x`` over the weighted
    adjacency, on float32 tiles (or a list's coefficients) for ``cuda``.

    A compact ``cuda`` plan holds each direction as per-row entry lists
    where they are fewer bytes than its tiles (the module's docstring).  A
    block plan builds each direction in two timed phases: its tiles or
    lists and other host arrays, then their copy to ``device``
    (``exec.plan.tiles`` and ``exec.plan.upload`` spans under
    ``exec.plan.compile``, and one observation each of the ungated
    ``exec.plan.tiles_seconds`` and ``exec.plan.upload_seconds``
    histograms)."""
    dev = resolve_device(device)
    scheme = parse_bucket_sig(buckets)
    if scheme:
        bm = bk = max(b for b, _ in scheme)
    bm = bm or 128
    bk = bk or bm
    if bm != bk:
        raise ValueError("GraphExecutionPlan requires square blocks "
                         f"(got bm={bm}, bk={bk})")
    if backend is None:
        backend = "cuda" if dev.type == "cuda" else "coo"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    if scheme and backend == "coo":
        raise ValueError("degree buckets need a block backend "
                         "(cuda or torch), not coo")
    if scheme and not compact:
        raise ValueError("bucketed plans imply slot compaction "
                         "(compact=True)")
    if weighted and mode != "sum":
        raise ValueError("weighted adjacency only composes with mode='sum'")
    s_in, s_out, add_diag = _mode_scales(mode, g)
    g_adj = g if weighted else dataclasses.replace(g, edge_weight=None)
    g_adj_t = transpose_graph(g_adj)
    R = int(np.ceil(g.num_nodes / bm))
    C = int(np.ceil(g.num_nodes / bk))

    def meta_for(n_active: int, lists: bool = False) -> SideMeta:
        return SideMeta(backend=backend, compact=compact, add_diag=add_diag,
                        bm=bm, bk=bk, R=R, C=C, n_active=n_active,
                        n=g.num_nodes, lists=lists)

    plan_bytes = 0
    occupancy: list = []
    with obs.span("exec.plan.compile", cat="exec", backend=backend,
                  mode=mode, bm=bm, compact=compact, n=g.num_nodes,
                  buckets=buckets) as sp:
        ell = ell_t = None
        if scheme:
            # each direction bucketed by ITS OWN in-degrees
            fwd, metas_f, bytes_f = _direction(lambda: _bucketed_side_host(
                g_adj, scheme, s_in, s_out, backend), dev)
            bwd, metas_b, bytes_b = _direction(lambda: _bucketed_side_host(
                g_adj_t, scheme, s_out, s_in, backend), dev)
            plan_bytes = bytes_f + bytes_b
            meta_f, meta_b = (
                BucketedSideMeta(backend=backend, compact=compact,
                                 add_diag=add_diag, n=g.num_nodes,
                                 buckets=m) for m in (metas_f, metas_b))
            occupancy = bucket_occupancy(g.in_degrees(), scheme)
            sp.set(n_active=sum(m.n_active for m in metas_f),
                   plan_bytes=plan_bytes)
        elif backend == "coo":
            # the coo path never touches tiles: block-ELL on first access
            fwd = _coo_arrays(g_adj, s_in, s_out, add_diag, weighted, dev)
            bwd = _coo_arrays(g_adj_t, s_out, s_in, add_diag, weighted, dev)
            meta_f, meta_b = meta_for(0), meta_for(0)
        else:
            fwd, n_f, bytes_f, ell = _direction(lambda: _side_host(
                g_adj, bm, s_in, s_out, backend, compact), dev)
            bwd, n_b, bytes_b, ell_t = _direction(lambda: _side_host(
                g_adj_t, bm, s_out, s_in, backend, compact), dev)
            meta_f = meta_for(n_f, lists=ell is None)
            meta_b = meta_for(n_b, lists=ell_t is None)
            sp.set(n_active=n_f, plan_bytes=int(bytes_f + bytes_b))
    obs.counter("exec.plan.compiles", backend=backend).inc()
    return GraphExecutionPlan(
        mode=mode, backend=backend, compact=compact, bm=bm, bk=bk,
        num_nodes=g.num_nodes, add_diag=add_diag, meta_fwd=meta_f,
        meta_bwd=meta_b, _fwd=fwd, _bwd=bwd, _ell=ell, _ell_t=ell_t,
        _g_adj=g_adj, _g_adj_t=g_adj_t, buckets=buckets, _plan_bytes=plan_bytes, _occupancy=occupancy)


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
    it; ties go to aggregate-first, the fusable order."""
    c = layer_order_costs(n, e, d_in, d_out)
    return ("update_first" if c["update_first"] < c["aggregate_first"]
            else "aggregate_first")


class _Layer(torch.autograd.Function):
    """One layer ``act(F(x) @ w + c · (x @ ws) + b)`` and the reference's
    hand-written backward (``repro/exec/plan.py`` ``bwd_core``), which never
    re-runs the forward."""

    @staticmethod
    def forward(ctx, lp: "LayerExecutionPlan", relu: bool, x, w, b, ws, c):
        gp = lp.gplan
        # the backward mirrors the forward's order so the transpose SpMM
        # always streams the narrow feature side; fused layers keep no
        # aggregation residual, so they use the d_out-side form
        agg = None
        with obs.span("exec.layer", cat="exec", d_in=lp.d_in, d_out=lp.d_out,
                      order=lp.order, fuse=lp.fuse) as sp:
            if lp.fuse:
                y = _fused_layer(gp.meta_fwd, gp._fwd, x, w, b, relu, ws, c)
            else:
                if lp.order == "aggregate_first":
                    agg = gp.raw_apply(x)
                    y = agg @ w
                else:
                    y = gp.raw_apply(x @ w)
                if ws is not None:
                    y = y + _self_term(x, ws, c)
                if b is not None:
                    y = y + b
                if relu:
                    y = torch.relu(y)
        # the backward's span belongs to whatever is open on this thread
        # then (on CUDA it runs on autograd's device thread)
        ctx.lp, ctx.relu, ctx.caller = lp, relu, sp.thread
        # dW needs x unless the aggregation residual stands in for it; the
        # self half's dW_self and dc need x in any case
        keep_x = agg is None or ws is not None
        ctx.save_for_backward(agg, x if keep_x else None, w, ws, c,
                              y if relu else None)
        return y

    @staticmethod
    def backward(ctx, g):
        with obs.span("exec.layer.backward", cat="exec",
                      parent=obs.open_span(ctx.caller)):
            return _Layer._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        agg, x, w, ws, c, y = ctx.saved_tensors
        gp = ctx.lp.gplan
        need_x, need_w, need_b, need_ws, need_c = ctx.needs_input_grad[2:]
        if ctx.relu:
            g = torch.where(y > 0, g, torch.zeros_like(g))
        dx = dw = db = dws = dc = None
        if agg is not None:
            # agg = M x: dx = Mᵀ (ḡ Wᵀ) runs at width d_in and dW = aggᵀ ḡ
            # reuses the forward's aggregation
            if need_x:
                dx = gp.raw_apply_t(g @ w.T)
            if need_w:
                dw = agg.T @ g
        elif need_x or need_w:
            # h = Mᵀ ḡ runs at width d_out, dW = Σ_v x_v ⊗ h_v
            h = gp.raw_apply_t(g)
            if need_x:
                dx = h @ w.T
            if need_w:
                dw = x.T @ h
        if ws is not None:
            # the self half shares one xᵀ ḡ between dW_self and dc
            xtg = x.T @ g if (need_ws or need_c) else None
            if c is None:
                if need_x:
                    dx = dx + g @ ws.T
                dws = xtg if need_ws else None
            else:
                if need_x:
                    dx = dx + c * (g @ ws.T)
                dws = c * xtg if need_ws else None
                if need_c:
                    dc = torch.sum(ws * xtg).reshape(c.shape)
        if need_b:
            db = torch.sum(g, dim=0)
        return None, None, dx, dw, db, dws, dc


@dataclasses.dataclass
class LayerExecutionPlan:
    """A whole GNN layer ``act(F(x) @ w + self_coeff · (x @ w_self) + b)``
    as one scheduled op.

    ``order="update_first"`` evaluates it as ``act(F(x @ w) + …)``, so the
    aggregation streams the narrower width.  ``fuse=True`` (the ``cuda``
    backend in aggregate-first order) runs aggregation, W product(s), bias
    and ReLU as ONE launch: ``spmm_blockell_update_compact`` on a compact
    plan, ``spmm_blockell_update`` on a padded one, one compact launch per
    bucket on a bucketed one.  The unfused
    update matmuls run in ``torch.matmul`` (full fp32: TF32 is off), as the
    reference leaves them to XLA.  GraphSAGE's concat form and GIN's
    ``((1+ε) h + F(h)) @ W`` (``w_self=w``, ``self_coeff=1+ε``) are each
    one plan call.

    The backward runs ONE aggregation through the transpose plan and
    mirrors the forward's order: update-first and fused layers take
    ``h = Mᵀ ḡ`` (width d_out), ``dx = h Wᵀ``, ``dW = xᵀ h``; unfused
    aggregate-first layers keep ``agg = M x`` and take ``dx = Mᵀ (ḡ Wᵀ)``,
    ``dW = aggᵀ ḡ``.  The self half adds ``dx += c ḡ W_selfᵀ``,
    ``dW_self = c xᵀ ḡ`` and ``dc = ⟨W_self, xᵀ ḡ⟩``; when ``w_self`` is
    ``w`` autograd sums both gradient paths into it.
    """

    gplan: GraphExecutionPlan
    d_in: int
    d_out: int
    order: str
    fuse: bool = False
    model_order: str = ""

    @property
    def mode(self) -> str:
        return self.gplan.mode

    @property
    def backend(self) -> str:
        return self.gplan.backend

    @property
    def num_nodes(self) -> int:
        return self.gplan.num_nodes

    def apply(self, x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None, *, relu: bool = False,
              w_self: Optional[torch.Tensor] = None, self_coeff=None
              ) -> torch.Tensor:
        """Differentiable layer
        ``act(F(x) @ w + self_coeff * (x @ w_self) + b)``; ``self_coeff`` is
        a number or a tensor of one element (a trained parameter)."""
        if x.shape[0] != self.num_nodes:
            raise ValueError(f"plan compiled for {self.num_nodes} nodes but "
                             f"x has {x.shape[0]} rows (wrong graph?)")
        if tuple(w.shape) != (self.d_in, self.d_out):
            raise ValueError(f"layer plan compiled for W {self.d_in}x"
                             f"{self.d_out}, got {tuple(w.shape)}")
        if w_self is not None and tuple(w_self.shape) != (self.d_in,
                                                          self.d_out):
            raise ValueError(f"w_self must match W {self.d_in}x{self.d_out}, "
                             f"got {tuple(w_self.shape)}")
        if self_coeff is not None:
            if w_self is None:
                raise ValueError("self_coeff needs w_self (the self half it "
                                 "scales)")
            if not torch.is_tensor(self_coeff):
                self_coeff = torch.tensor(float(self_coeff), device=x.device)
            self_coeff = self_coeff.reshape(())
        return _Layer.apply(self, relu, x, w, b, w_self, self_coeff)

    def __call__(self, x, w, b=None, *, relu: bool = False, w_self=None,
                 self_coeff=None) -> torch.Tensor:
        return self.apply(x, w, b, relu=relu, w_self=w_self,
                          self_coeff=self_coeff)

    def describe(self) -> dict:
        return {"order": self.order, "fuse": self.fuse,
                "model_order": self.model_order,
                "d_in": self.d_in, "d_out": self.d_out,
                **self.gplan.describe(self.d_in if
                                      self.order == "aggregate_first"
                                      else self.d_out)}


def build_layer_plan(g: Graph, mode: str = "gcn", *, d_in: int, d_out: int,
                     order: str = "auto", fuse: Optional[bool] = None,
                     bm: Optional[int] = None, bk: Optional[int] = None,
                     backend: Optional[str] = None, compact: bool = True,
                     gplan: Optional[GraphExecutionPlan] = None,
                     buckets: str = "", device="cuda") -> LayerExecutionPlan:
    """Compile one GNN layer ``(d_in -> d_out)`` over ``g``.

    ``order="auto"`` consults the FLOP/byte model; ``fuse=None`` turns the
    one-launch layer kernel on exactly when it applies (``cuda`` backend,
    aggregate-first order), as the reference does for ``pallas``.  Pass a
    prebuilt ``gplan`` to share one block-ELL construction across a model's
    layers.
    """
    model_order = choose_order(g.num_nodes, g.num_valid_edges, d_in, d_out)
    if order in (None, "auto"):
        order = model_order
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}; expected {ORDERS}")
    if gplan is None:
        gplan = build_plan(g, mode, bm=bm, bk=bk, backend=backend,
                           compact=compact, buckets=buckets, device=device)
    elif gplan.mode != mode:
        raise ValueError(f"prebuilt gplan has mode {gplan.mode!r}, layer "
                         f"plan wants {mode!r}")
    fusable = gplan.backend == "cuda" and order == "aggregate_first"
    if fuse is None:
        fuse = fusable
    elif fuse and not fusable:
        raise ValueError("fuse=True requires backend='cuda' and "
                         f"order='aggregate_first' (got {gplan.backend!r}, "
                         f"{order!r})")
    return LayerExecutionPlan(gplan=gplan, d_in=d_in, d_out=d_out,
                              order=order, fuse=fuse,
                              model_order=model_order)
