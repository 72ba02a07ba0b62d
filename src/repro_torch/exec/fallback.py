"""Backend fallback chain with quarantine — port of ``repro/exec/fallback.py``.

A kernel launch can die two ways: it raises, or it returns garbage (a
NaN-producing backend).  :class:`ResilientPlan` wraps the plan chain
``cuda → torch → coo`` so a failure demotes to the next engine for the SAME
call: the caller gets a finite answer from some backend or the last
backend's exception, never silent NaNs.

Unlike the reference, which demotes on any exception, the ``cuda`` engine is
demoted only for a drill's :class:`repro_torch.chaos.InjectedFault` and for
non-finite output.  A real build, launch or driver failure of the
hand-written kernels propagates and is quarantined nowhere: demoting it would
answer from the plain version without a word, and the verdict on disk would
keep every later autotuned run on that graph off the kernels.  The ``torch``
and ``coo`` engines keep the reference's catch-all.

A failed backend is **quarantined**: the verdict is written into the
autotune disk cache (:func:`repro_torch.exec.autotune.record_quarantine`,
keyed by graph fingerprint + device signature), ``exec.quarantine`` is
counted, and :func:`repro_torch.exec.forward.build_cost_oracle` drops the
backend from every layer's candidate set.  In-process, the chain also stops
retrying it.

The finiteness probe on the winning output is one ``isfinite`` reduction per
call; ``probe=False`` trusts the backend (:func:`parity_probe` vets one
against another offline).  Layer plans have no chain, in the reference
either: a fault on a fused layer's sites propagates to its caller.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..chaos.inject import InjectedFault
from ..device import resolve_device
from ..graph.structure import Graph
from .autotune import (graph_fingerprint, platform_of, quarantined_backends,
                       record_quarantine)
from .bucketing import quarantine_class
from .plan import GraphExecutionPlan, build_plan

FALLBACK_CHAIN = ("cuda", "torch", "coo")


class BackendFailure(RuntimeError):
    """A backend produced an unusable result (e.g. non-finite output)."""

    def __init__(self, backend: str, reason: str):
        super().__init__(f"backend {backend!r} failed: {reason}")
        self.backend = backend
        self.reason = reason


def parity_probe(plan: GraphExecutionPlan, ref: GraphExecutionPlan, *,
                 d: int = 8, seed: int = 0, rtol: float = 1e-4,
                 atol: float = 1e-4) -> bool:
    """Does ``plan`` agree with ``ref`` on a seeded probe input?

    A cheap narrow-width forward comparison (``d`` columns, drawn with
    numpy's generator as the reference draws them) against a trusted
    engine; each plan runs on its own device."""
    x = np.random.default_rng(seed).standard_normal(
        (plan.num_nodes, d)).astype(np.float32)
    try:
        y = plan.apply(torch.as_tensor(x, device=plan.device))
        y_ref = ref.apply(torch.as_tensor(x, device=ref.device))
        y, y_ref = y.detach().cpu().numpy(), y_ref.detach().cpu().numpy()
    except Exception:
        return False
    return bool(np.isfinite(y).all()
                and np.allclose(y, y_ref, rtol=rtol, atol=atol))


@dataclasses.dataclass(frozen=True)
class FallbackVerdict:
    """What one ``apply`` call actually ran: the serving backend, whether it
    was a demotion, and every (backend, reason) attempt that failed first."""
    backend: str
    degraded: bool
    attempts: Tuple[Tuple[str, str], ...] = ()


class ResilientPlan:
    """A :class:`GraphExecutionPlan` chain that degrades instead of dying.

    ``apply(x)`` tries the primary backend (``cuda`` on a CUDA ``device``,
    ``coo`` on the CPU, as ``build_plan`` picks), then each fallback,
    quarantining every engine that raises or emits non-finite output (of
    ``cuda``'s exceptions, only an ``InjectedFault``; any other propagates
    with no verdict written).
    Fallback plans are built lazily and memoized, so the healthy path holds
    exactly one plan.  ``verdict`` records what the most recent call ran.
    Verdicts are keyed by ``platform`` (``platform_of(device)`` by default)
    and the card's kind, in ``cache_dir`` (the autotune cache's directory by
    default).
    """

    def __init__(self, g: Graph, mode: str = "gcn", *,
                 backend: Optional[str] = None, bm: int = 128,
                 compact: bool = True, probe: bool = True,
                 cache_dir: Optional[str] = None,
                 platform: Optional[str] = None, buckets: str = "",
                 weighted: bool = False, device="cuda"):
        self.g = g
        self.mode = mode
        self.bm = bm
        self.compact = compact
        self.probe = probe
        self.cache_dir = cache_dir
        self.device = resolve_device(device)
        self.platform = platform or platform_of(self.device)
        self.buckets = buckets
        self.weighted = weighted
        self.fingerprint = graph_fingerprint(g)
        primary = backend or ("cuda" if self.device.type == "cuda"
                              else "coo")
        chain = [primary] + [b for b in FALLBACK_CHAIN if b != primary]
        bad = quarantined_backends(self.fingerprint, platform=self.platform,
                                   cache_dir=cache_dir)
        # a verdict matches a chain entry by its candidate CLASS: the
        # bucketed plan ("cuda|128@7+256") is another engine than the
        # single-grid one ("cuda"), but a bare-backend verdict bans every
        # bucketing of it.  Never filter down to nothing: coo (no kernels,
        # never bucketed) is the engine of last resort even when
        # quarantined.
        self.chain: List[str] = ([b for b in chain
                                  if self._class(b) not in bad
                                  and b not in bad]
                                 or ["coo"])
        self._plans: Dict[str, GraphExecutionPlan] = {}
        self.verdict: Optional[FallbackVerdict] = None

    def _buckets_for(self, backend: str) -> str:
        # the coo engine has no multi-grid form: the last rung drops the
        # bucket signature with the kernels
        return "" if backend == "coo" else self.buckets

    def _class(self, backend: str) -> str:
        return quarantine_class(backend, self._buckets_for(backend))

    def plan_for(self, backend: str) -> GraphExecutionPlan:
        if backend not in self._plans:
            self._plans[backend] = build_plan(
                self.g, self.mode, bm=self.bm, bk=self.bm, backend=backend,
                compact=self.compact, weighted=self.weighted,
                buckets=self._buckets_for(backend), device=self.device)
        return self._plans[backend]

    @property
    def backend(self) -> str:
        return self.chain[0]

    def _quarantine(self, backend: str, reason: str) -> None:
        record_quarantine(self.fingerprint, self._class(backend),
                          reason=reason, platform=self.platform,
                          cache_dir=self.cache_dir)
        if backend in self.chain and len(self.chain) > 1:
            self.chain.remove(backend)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        attempts: List[Tuple[str, str]] = []
        last_err: Optional[BaseException] = None
        for backend in list(self.chain):
            try:
                y = self.plan_for(backend).apply(x)
                if self.probe and not bool(torch.isfinite(y).all()):
                    raise BackendFailure(backend, "nonfinite_output")
            except InjectedFault as err:
                reason, last_err = err.fault.kind, err
            except BackendFailure as err:
                reason, last_err = err.reason, err
            except Exception as err:
                if backend == "cuda":
                    # a real kernel failure: raise it, never serve around it
                    raise
                reason, last_err = type(err).__name__, err
            else:
                if attempts:
                    obs.counter("exec.fallback", backend=backend).inc()
                    obs.instant("exec.fallback", cat="exec", backend=backend,
                                attempts=attempts)
                self.verdict = FallbackVerdict(backend=backend,
                                               degraded=bool(attempts),
                                               attempts=tuple(attempts))
                return y
            attempts.append((backend, reason))
            self._quarantine(backend, reason)
        self.verdict = FallbackVerdict(backend="", degraded=True,
                                       attempts=tuple(attempts))
        raise last_err if last_err is not None else RuntimeError(
            "ResilientPlan: empty backend chain")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)
