"""Straggler/shard-loss degradation for the mesh halo exchange (port of
``repro/dist/resilient.py``).

``halo_aggregate`` is the efficient collective (cut-edge rows only), but it
is also the fragile one: it needs every rank of the ``all_to_all`` to show
up.  :func:`resilient_halo_aggregate` is the drop-in wrapper that degrades
instead of hanging: a faulted exchange walks the
:class:`repro_torch.dist.elastic.RetryPolicy` ladder (seeded, bounded
exponential backoff + jitter charged to a
:class:`~repro_torch.dist.elastic.ModeledClock`) before the *affected
step* is recomputed through ``allgather_aggregate``, which ships the full
feature table and depends on no per-rank send tables.  A transient fault
recovers on the halo path at retry cost; only a fault that outlives the
ladder (or the ``budget_s`` delay budget) degrades the step.  Persistent
faults are the membership state machine's business
(:class:`repro_torch.dist.elastic.ElasticAggregator`).

Every rank of the group must take the same path, or one rank waits alone
in a collective.  So the fault decision comes from the same seeded
``FaultPlan`` armed on every rank (its ``dist.halo`` hit counters advance
identically, since every rank walks the same ladder), and a local
exception on the halo path (building the rows to send, or filing and
summing the received ones) becomes a collective decision before anything
falls back: an all-reduce MAX of a failure flag, once before the exchange
and once after, so every rank falls back together.  The reference degrades
on any exception of its one-program exchange; here an error of the
exchange itself (a broken process group) raises: no rank could take part
in the fallback's all-gather either.

Every retry counts ``dist.halo_retry{kind=...}``; every degraded step counts
``dist.halo_fallback{reason=...}`` and drops a trace instant, under the
reference's names.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .. import obs
from ..chaos import inject as chaos
from . import halo as _halo
from .elastic import FAULT_KINDS, ModeledClock, RetryPolicy


def _fallback(mesh, x, plan, local_n, axis_name, reason: str
              ) -> torch.Tensor:
    obs.counter("dist.halo_fallback", reason=reason).inc()
    obs.instant("dist.halo_fallback", cat="dist", reason=reason)
    return _halo.allgather_aggregate(mesh, x, plan, local_n, axis_name)


def _any_failed(failed: bool, group, device) -> bool:
    """True on every rank when any rank of ``group`` failed."""
    flag = torch.tensor([1.0 if failed else 0.0], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item() > 0)


def _halo_or_fallback(mesh, x, plan, send, local_n, axis_name
                      ) -> torch.Tensor:
    """``halo_aggregate`` with every local step's failure agreed on by the
    group before the collective that follows it."""
    group, _ = _halo.axis_group(mesh, axis_name, plan.parts.num_parts)
    rows = y = None
    try:
        _, _, t, e = _halo._prepare(mesh, x, plan, send, local_n, axis_name)
        rows = _halo.send_rows(x, t)
    except Exception:
        pass
    if _any_failed(rows is None, group, x.device):
        return _fallback(mesh, x, plan, local_n, axis_name, "exchange_error")
    got = _halo._Exchange.apply(rows, group)
    try:
        y = _halo.local_aggregate(x, got, t, e, plan.halo_capacity, local_n)
    except Exception:
        pass
    if _any_failed(y is None, group, x.device):
        return _fallback(mesh, x, plan, local_n, axis_name, "exchange_error")
    return y


def resilient_halo_aggregate(mesh, x, plan, send, local_n,
                             axis_name: Optional[str] = None,
                             timeout_s: Optional[float] = None, *,
                             policy: Optional[RetryPolicy] = None,
                             clock: Optional[ModeledClock] = None,
                             step: int = 0) -> torch.Tensor:
    """``halo_aggregate`` with a deterministic retry ladder and per-step
    fallback to ``allgather_aggregate``; called by every rank of the group
    with its window, as ``halo_aggregate`` is.

    A ``dist.halo`` fault (shard loss or straggler) is retried up to
    ``policy.max_retries`` times with seeded exponential backoff charged to
    ``clock`` (modeled time, never wall time); if the fault persists
    through the ladder, or the accumulated backoff would exceed
    ``policy.budget_s``, the step degrades to the all-gather path.  A local
    exception on the halo path degrades immediately, on every rank
    together (reason ``exchange_error``).  ``timeout_s`` is the legacy
    alias for ``budget_s``.
    """
    if policy is None:
        policy = RetryPolicy(budget_s=timeout_s)
    elif timeout_s is not None and policy.budget_s is None:
        policy = dataclasses.replace(policy, budget_s=timeout_s)
    clock = clock or ModeledClock()
    waited = 0.0
    for attempt in range(policy.max_retries + 1):
        f = chaos.fire("dist.halo")
        if f is not None and f.kind in FAULT_KINDS:
            if attempt == policy.max_retries:
                return _fallback(mesh, x, plan, local_n, axis_name, f.kind)
            delay = policy.backoff(step, attempt)
            if (policy.budget_s is not None
                    and waited + delay > policy.budget_s):
                return _fallback(mesh, x, plan, local_n, axis_name, f.kind)
            waited += delay
            clock.advance(delay)
            obs.counter("dist.halo_retry", kind=f.kind).inc()
            continue
        return _halo_or_fallback(mesh, x, plan, send, local_n, axis_name)
    return _fallback(mesh, x, plan, local_n, axis_name, "retries_exhausted")
