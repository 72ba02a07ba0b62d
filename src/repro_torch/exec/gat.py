"""GAT's attention plan: a graph's two directions of edge-softmax attention
as per-row entry lists on the device, and the differentiable layer step
that runs the ``gat::`` kernels over them.

:func:`build_attention_plan` lists each destination's in-neighbours and,
by default, itself (``core.blocksparse.attention_lists``: every edge an
entry, no coefficient), and the transposed lists with each entry's forward
place for the backward; hubs and the walk's order come from
``kernels.spmm_blockell.list_arrays``, as for the block-ELL list plans.  It
builds in the block plans' two timed phases (``exec.plan.tiles`` and
``exec.plan.upload``, one observation each of the ungated
``exec.plan.tiles_seconds`` / ``exec.plan.upload_seconds``) inside an
``exec.gat.plan`` span.

:meth:`AttentionPlan.layer` runs one GAT layer: ``z = h W``, per head, the
scores ``s_src = z · a_src`` and ``s_dst = z · a_dst``, then ``out[v, h] =
Σ_j softmax_j(LeakyReLU(s_dst[v, h] + s_src[j, h])) z[j, h]``
(``kernels.gat_attention``: the kernels on the card, their plain versions
on the CPU).  The attention keeps z, the scores, out and each row's
log-sum-exp, and its backward recomputes the weights from them.  The layer
runs inside an ``exec.gat.layer`` span; the attention's backward, on
autograd's thread, inside ``exec.gat.layer.backward``, whose parent is the
span open on the forward's thread when the backward started
(``train.backward`` in a training step).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict

import torch

from .. import obs
from ..core.blocksparse import attention_lists
from ..device import resolve_device
from ..graph.structure import Graph
from ..kernels.gat_attention import gat_attention, gat_attention_bwd
from ..kernels.spmm_blockell import Lists, list_arrays
from ..nn.layers import linear_apply
from .plan import _direction


@dataclasses.dataclass
class AttentionPlan:
    """Both directions of a graph's attention on one device (see the
    module's docstring).  ``fwd`` and ``bwd`` hold
    :func:`~repro_torch.kernels.spmm_blockell.list_arrays`' keys (the
    transposed lists' ``src`` holds the rows that list each source) and
    ``bwd["fwd_pos"]`` each transposed entry's forward place."""

    num_nodes: int
    nnz: int
    self_loops: bool
    fwd: Dict[str, torch.Tensor]
    bwd: Dict[str, torch.Tensor]

    @property
    def device(self) -> torch.device:
        return self.fwd["row_ptr"].device

    def layer(self, p: Dict, h: torch.Tensor, *,
              negative_slope: float = 0.2, layer: int = 0) -> torch.Tensor:
        """One GAT layer over the plan, (N, H, F), with ``p`` a layer of
        ``models.gat.gat_init`` (H, F from ``a_src``'s shape): ``z =
        linear_apply(p["w"], h)`` as (N, H, F), the scores ``s_src = z ·
        a_src`` and ``s_dst = z · a_dst`` per head, then the attention."""
        if h.shape[0] != self.num_nodes:
            raise ValueError(f"attention plan compiled for {self.num_nodes} "
                             f"nodes but h has {h.shape[0]} rows")
        H, F = p["a_src"].shape
        with obs.span("exec.gat.layer", cat="exec", layer=layer, heads=H,
                      width=F):
            z = linear_apply(p["w"], h).reshape(h.shape[0], H, F)
            s_src = torch.einsum("nhd,hd->nh", z, p["a_src"].to(z.dtype))
            s_dst = torch.einsum("nhd,hd->nh", z, p["a_dst"].to(z.dtype))
            return _Attention.apply(self, float(negative_slope), int(layer),
                                    z, s_src, s_dst)

    def describe(self) -> dict:
        return {"num_nodes": self.num_nodes, "nnz": self.nnz,
                "self_loops": self.self_loops,
                "hubs": int(self.fwd["hubs"].shape[0]),
                "hubs_t": int(self.bwd["hubs"].shape[0])}


class _Attention(torch.autograd.Function):
    """One layer's attention over an :class:`AttentionPlan`."""

    @staticmethod
    def forward(ctx, plan: AttentionPlan, slope: float, layer: int, z,
                s_src, s_dst):
        z, s_src, s_dst = (t.contiguous() for t in (z, s_src, s_dst))
        out, lse = gat_attention(Lists.of(plan.fwd), z, s_src, s_dst,
                                 negative_slope=slope)
        # the backward's span belongs to whatever is open on this thread
        # then (on CUDA it runs on autograd's device thread)
        ctx.plan, ctx.slope, ctx.layer = plan, slope, layer
        ctx.caller = threading.get_ident()
        ctx.save_for_backward(z, s_src, s_dst, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        z, s_src, s_dst, out, lse = ctx.saved_tensors
        plan = ctx.plan
        with obs.span("exec.gat.layer.backward", cat="exec",
                      parent=obs.open_span(ctx.caller), layer=ctx.layer,
                      heads=z.shape[1], width=z.shape[2]):
            dz, ds_src, ds_dst = gat_attention_bwd(
                Lists.of(plan.fwd), Lists.of(plan.bwd), plan.bwd["fwd_pos"],
                z, s_src, s_dst, lse, out, dout.contiguous(),
                negative_slope=ctx.slope)
        return None, None, None, dz, ds_src, ds_dst


def build_attention_plan(g: Graph, *, self_loops: bool = True,
                         device="cuda") -> AttentionPlan:
    """Compile ``g``'s attention lists onto ``device`` (the module's
    docstring)."""
    dev = resolve_device(device)
    with obs.span("exec.gat.plan", cat="exec", n=g.num_nodes,
                  self_loops=self_loops) as sp:
        def lists():
            al = attention_lists(g, self_loops=self_loops)
            fwd = list_arrays(al.row_ptr, al.src)
            bwd = list_arrays(al.row_ptr_t, al.dst_t)
            bwd["fwd_pos"] = al.fwd_pos
            return {"fwd": fwd, "bwd": bwd}, al.nnz

        arrays, nnz = _direction(lists, dev)
        plan = AttentionPlan(num_nodes=g.num_nodes, nnz=int(nnz),
                             self_loops=self_loops, fwd=arrays["fwd"],
                             bwd=arrays["bwd"])
        sp.set(**plan.describe())
    return plan
