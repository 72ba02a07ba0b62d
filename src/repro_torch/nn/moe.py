"""Mixture-of-Experts FFN with top-k routing and static capacity (the port
of ``repro/nn/moe.py``).

Routing is a bipartite tokens -> experts aggregation: a softmax router in
fp32, the top k experts of each token, renormalised gates, the Switch
load-balancing loss, and a static capacity of ``C`` slots an expert; a
token past its expert's capacity is dropped (Switch / GShard semantics, as
the reference).  ``sort_tokens`` groups the assignments by expert first,
the paper's reorder carried over to LMs.

Every step is deterministic, so that ``torch.utils.checkpoint``'s
recomputation routes exactly as the forward did and a rerun repeats bit for
bit: the top k come from a stable descending sort (``jax.lax.top_k``'s
order among equal values: the lower index first), each kept slot receives
its one token by an index copy, and the combine sums each token's k
assignments in a fixed order (``reshape(T, k, d).sum(1)``); no
``index_add_`` / ``scatter_add_`` meets a row from several terms.  The
experts are batched matmuls, as the reference's einsums.  There is no
``tp_axis``: the expert-parallel mesh branch waits for ROADMAP item 9.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .layers import swiglu


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, shared_expert: bool = False,
             d_shared: Optional[int] = None, device="cuda",
             dtype=torch.float32) -> dict:
    """Router ``(d, E)``, ``wg`` / ``wu`` ``(E, d, f)``, ``wd`` ``(E, f,
    d)``, and with ``shared_expert`` a ``shared`` SwiGLU of width
    ``d_shared`` (``d_ff`` by default); N(0, 1/d) (``wd``: 1/f), drawn
    where ``generator`` lives one expert at a time and stored on ``device``
    in ``dtype``, so no fp32 copy of an expert stack is ever made."""
    dev = resolve_device(device)

    def draw(shape, fan_in):
        t = torch.empty(shape, device=dev, dtype=dtype)
        fill_normal_(t, 1.0 / math.sqrt(fan_in), generator)
        return t

    E, D, F = n_experts, d_model, d_ff
    p = {"router": draw((D, E), D), "wg": draw((E, D, F), D),
         "wu": draw((E, D, F), D), "wd": draw((E, F, D), F)}
    if shared_expert:
        dsh = d_shared or F
        p["shared"] = {"wg": draw((D, dsh), D), "wu": draw((D, dsh), D),
                       "wd": draw((dsh, D), dsh)}
    return p


def fill_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    """Fill ``t`` in place with N(0, std²), one matrix of its last two axes
    at a time (so the fp32 draw is one matrix, never the whole stack)."""
    if t.dim() > 2:
        for sub in t:
            fill_normal_(sub, std, generator)
        return
    r = torch.randn(tuple(t.shape), generator=generator,
                    device=generator.device)
    t.copy_(r.mul_(std))


@dataclasses.dataclass
class MoERoutes:
    """One ``moe_apply`` call's routing, flat over its T·k assignments (in
    expert-sorted order under ``sort_tokens``)."""
    probs: torch.Tensor        # (T, E) fp32 router softmax
    expert_ids: torch.Tensor   # (T, k) top-k experts, largest first
    gates: torch.Tensor        # (T·k,) renormalised gates
    flat_expert: torch.Tensor  # (T·k,)
    flat_token: torch.Tensor   # (T·k,)
    seg_pos: torch.Tensor      # (T·k,) int32 rank within the expert
    keep: torch.Tensor         # (T·k,) bool: within capacity
    slot: torch.Tensor         # (T·k,) expert * C + min(rank, C - 1)
    order: Optional[torch.Tensor]   # the sort_tokens permutation, or None
    capacity: int              # C


def capacity(T: int, top_k: int, n_experts: int,
             capacity_factor: float = 1.25) -> int:
    """``C = max(ceil(T k / E · cf), min(k, T))``, the reference's Python
    float arithmetic."""
    return max(int(math.ceil(T * top_k / n_experts * capacity_factor)),
               min(top_k, T))


def _segment_cumcount(seg_ids: torch.Tensor, num_segments: int
                      ) -> torch.Tensor:
    """Rank of each element within its segment, stable in array order: the
    cumulative sum of the one-hot segment matrix, in int32 as the
    reference's.  The matrix is laid out (segments, elements), so the scan
    runs along the inner axis: a scan along the outer axis of an (N, E)
    matrix runs one thread a column, 3.2 s of an 11.6 s training step at
    granite-moe's 131,072 assignments on the H100."""
    onehot = (torch.arange(num_segments, dtype=seg_ids.dtype,
                           device=seg_ids.device)[:, None]
              == seg_ids[None, :]).to(torch.int32)
    csum = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    rank = torch.sum(torch.where(onehot > 0, csum - 1, 0), dim=0)
    return rank.to(torch.int32)


def moe_routes(p: dict, x: torch.Tensor, top_k: int,
               capacity_factor: float = 1.25,
               sort_tokens: bool = False) -> MoERoutes:
    """The routing of ``x`` (T, d): fp32 softmax over ``x @ router``, the
    top k from a stable descending sort (ties to the lower expert id, as
    ``jax.lax.top_k``), gates renormalised, each assignment's rank within
    its expert and whether it fits the capacity."""
    T = x.shape[0]
    E = p["router"].shape[1]
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :top_k], idx[:, :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    C = capacity(T, top_k, E, capacity_factor)
    flat_expert = expert_ids.reshape(-1)
    flat_token = torch.arange(T, device=x.device).repeat_interleave(top_k)
    flat_gate = gate_vals.reshape(-1)
    order = None
    if sort_tokens:
        order = torch.argsort(flat_expert, stable=True)
        flat_expert = flat_expert[order]
        flat_token = flat_token[order]
        flat_gate = flat_gate[order]
    seg_pos = _segment_cumcount(flat_expert, E)
    keep = seg_pos < C
    slot = flat_expert * C + torch.clamp(seg_pos, max=C - 1)
    return MoERoutes(probs, expert_ids, flat_gate, flat_expert, flat_token,
                     seg_pos, keep, slot, order, C)


def _moe_apply_impl(p: dict, x: torch.Tensor, top_k: int,
                    capacity_factor: float = 1.25, sort_tokens: bool = False):
    """x: (T, d) token-major.  Returns (out (T, d), aux loss)."""
    T, d = x.shape
    E = p["router"].shape[1]
    r = moe_routes(p, x, top_k, capacity_factor, sort_tokens)
    # the Switch load-balancing loss, E * sum_e f_e * p_e
    me = r.probs.mean(dim=0)
    counts = (r.flat_expert[:, None] == torch.arange(
        E, device=x.device)[None, :]).sum(dim=0)
    ce = counts.to(torch.float32) / (T * top_k)
    aux = E * torch.sum(me * ce)

    C = r.capacity
    # each assignment's token, a view of x expanded over k: its backward
    # sums a token's k gradients in a fixed order
    xk = x[:, None].expand(T, top_k, d).reshape(T * top_k, d)
    if r.order is not None:
        xk = xk[r.order]
    # dispatch: every kept slot receives exactly one token; the dropped
    # assignments land in a spare row that is cut off
    dest = torch.where(r.keep, r.slot, E * C)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device
                      ).index_copy(0, dest, xk)
    eb = buf[:E * C].reshape(E, C, d)
    h = swiglu(torch.bmm(eb, p["wg"].to(x.dtype)),
               torch.bmm(eb, p["wu"].to(x.dtype)))
    eo = torch.bmm(h, p["wd"].to(x.dtype)).reshape(E * C, d)

    # combine: each assignment's expert output times its gate (0 if
    # dropped), back in token order, summed over k
    gathered = eo[r.slot] * (r.gates * r.keep).to(x.dtype)[:, None]
    if r.order is not None:
        gathered = gathered[torch.argsort(r.order)]
    out = gathered.reshape(T, top_k, d).sum(dim=1)

    if "shared" in p:
        sh = p["shared"]
        out = out + swiglu(x @ sh["wg"].to(x.dtype),
                           x @ sh["wu"].to(x.dtype)) @ sh["wd"].to(x.dtype)
    return out, aux


def moe_apply(p: dict, x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25, sort_tokens: bool = False,
              token_chunks: int = 1):
    """(T, d) -> (out (T, d), aux).  ``token_chunks > 1`` (dividing T) runs
    routing, dispatch and the experts on T / token_chunks tokens at a time,
    each chunk under ``torch.utils.checkpoint`` when autograd records
    (the capacity is then per chunk), and returns the mean of the chunks'
    aux, as the reference's scan does."""
    T = x.shape[0]
    if token_chunks > 1 and T % token_chunks == 0:
        outs, auxs = [], []
        for xc in x.split(T // token_chunks):
            if torch.is_grad_enabled():
                o, a = checkpoint(_moe_apply_impl, p, xc, top_k,
                                  capacity_factor, sort_tokens,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                o, a = _moe_apply_impl(p, xc, top_k, capacity_factor,
                                       sort_tokens)
            outs.append(o)
            auxs.append(a)
        return torch.cat(outs), torch.mean(torch.stack(auxs))
    return _moe_apply_impl(p, x, top_k, capacity_factor, sort_tokens)
