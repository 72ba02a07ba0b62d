"""Deterministic fault injection: FaultPlan, injection points, file mangling
(the port of ``repro/chaos/inject.py``).

A :class:`Fault` names a *site* (an injection point placed in the stack),
the *hit index* at which it fires (the site's 0-based call counter while
armed), a *kind*, and an optional payload.  A :class:`FaultPlan` is an
ordered set of faults; :meth:`FaultPlan.generate` derives one from a seed
with numpy's generator, so a drill's fault schedule is a pure function of
``(seed, spec)`` and equal to the reference's for the same pair.

Injection points are cooperative: subsystem code calls

* :func:`fire` — returns the scheduled :class:`Fault` for this hit (or
  ``None``), for sites that implement their own degradation;
* :func:`fail_point` — raises :class:`InjectedFault` when a fault is
  scheduled (kernel-launch failures, crashes);
* :func:`mangle` — corrupts a result in a kind-specific way
  (``nan_backend`` overwrites a deterministic slice with NaNs).

While disarmed every one of these is one module-global load and a ``None``
check — no allocation, no RNG, no clock.

Sites placed in the port: ``train.step``, the training step boundary
(``fail_point`` in ``train.loop.fit``): ``crash`` stops the run for the
resume drill; ``exec.pallas_launch`` (``fail_point`` before each ``cuda``
kernel launch of ``exec.plan``, one per sub-grid of a bucketed plan) and
``exec.kernel_result`` (``mangle`` of each ``cuda`` result), which
``exec.fallback.ResilientPlan`` answers by demoting the call.  The site
strings are the reference's, so one ``FaultPlan`` arms either package.
``dist.halo`` (``fire``, walked by the retry ladders of
``dist.resilient.resilient_halo_aggregate`` and
``dist.elastic.ElasticAggregator``): ``shard_loss`` and ``straggler``
faults, retried then degraded to the all-gather path; every rank of a mesh
arms the same plan, so each takes the same path.

File corruption (:func:`corrupt_file`) is applied directly by drills: it
truncates or garbles bytes of a checkpoint or cache file deterministically
from a seed, modeling torn writes and bit rot.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs

KINDS = ("kernel_launch", "nan_backend", "corrupt_file", "shard_loss",
         "straggler", "crash", "overload", "malformed")


class InjectedFault(RuntimeError):
    """The exception injection points raise; carries the fault that fired."""

    def __init__(self, fault: "Fault"):
        super().__init__(f"injected {fault.kind} at {fault.site} "
                         f"(hit {fault.hit})")
        self.fault = fault


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: fire ``kind`` at injection point ``site`` on its
    ``hit``-th armed call (0-based), ``count`` consecutive times."""

    site: str
    kind: str
    hit: int = 0
    count: int = 1
    payload: Tuple[Tuple[str, object], ...] = ()

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.hit < 0 or self.count < 1:
            raise ValueError("fault needs hit >= 0 and count >= 1")

    def arg(self, key: str, default=None):
        return dict(self.payload).get(key, default)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered, immutable fault schedule (plus the seed that derived it).

    ``describe()`` is the canonical serialization two same-seed runs must
    agree on — the drill asserts exactly that.
    """

    faults: Tuple[Fault, ...] = ()
    seed: Optional[int] = None

    @staticmethod
    def of(*faults: Fault, seed: Optional[int] = None) -> "FaultPlan":
        return FaultPlan(faults=tuple(faults), seed=seed)

    @staticmethod
    def generate(seed: int,
                 spec: Dict[str, Sequence[Tuple[str, int]]]) -> "FaultPlan":
        """Derive a schedule deterministically from ``seed``.

        ``spec`` maps site -> [(kind, max_hit), ...]; each entry becomes one
        fault whose hit index is drawn uniformly from ``[0, max_hit)`` by a
        seeded generator.  Same ``(seed, spec)`` -> identical plan, always.
        """
        rng = np.random.default_rng(seed)
        faults: List[Fault] = []
        for site in sorted(spec):
            for kind, max_hit in spec[site]:
                hit = int(rng.integers(0, max(int(max_hit), 1)))
                faults.append(Fault(site=site, kind=kind, hit=hit))
        return FaultPlan(faults=tuple(faults), seed=seed)

    def for_site(self, site: str) -> Tuple[Fault, ...]:
        return tuple(f for f in self.faults if f.site == site)

    def describe(self) -> List[dict]:
        return [{"site": f.site, "kind": f.kind, "hit": f.hit,
                 "count": f.count, "payload": list(f.payload)}
                for f in self.faults]


class FaultInjector:
    """Live state of an armed plan: per-site hit counters + fired log."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.hits: Dict[str, int] = {}
        self.fired: List[Fault] = []

    def fire(self, site: str) -> Optional[Fault]:
        """Advance ``site``'s hit counter; return the fault scheduled for
        this hit (if any), recording it as fired."""
        hit = self.hits.get(site, 0)
        self.hits[site] = hit + 1
        for f in self.plan.faults:
            if f.site == site and f.hit <= hit < f.hit + f.count:
                fired = dataclasses.replace(f, hit=hit, count=1)
                self.fired.append(fired)
                obs.counter("chaos.fired", site=site, kind=f.kind).inc()
                obs.instant("chaos.fault", cat="chaos", site=site,
                            kind=f.kind, hit=hit)
                return fired
        return None


# ---------------------------------------------------------------------------
# the armed injector (module-level, like obs' enabled flag / tracer)
# ---------------------------------------------------------------------------
class _ChaosState:
    __slots__ = ("injector",)

    def __init__(self) -> None:
        self.injector: Optional[FaultInjector] = None


_STATE = _ChaosState()


def active() -> Optional[FaultInjector]:
    """The armed injector, or None (the zero-overhead common case)."""
    return _STATE.injector


class armed:
    """``with chaos.armed(plan) as inj:`` — arm a fault plan over a block.

    Restores the previously armed injector on exit (nesting replaces, not
    merges).  The injector is returned so callers can inspect
    ``inj.fired`` / ``inj.hits`` afterwards.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.injector = FaultInjector(plan)
        self._prev: Optional[FaultInjector] = None

    def __enter__(self) -> FaultInjector:
        self._prev = _STATE.injector
        _STATE.injector = self.injector
        obs.counter("chaos.armed").inc()
        return self.injector

    def __exit__(self, *exc):
        _STATE.injector = self._prev
        return False


# ---------------------------------------------------------------------------
# injection-point helpers (the calls subsystem code compiles in)
# ---------------------------------------------------------------------------
def fire(site: str) -> Optional[Fault]:
    """The scheduled fault for this site hit, or None.  Disarmed: one load
    and a None check."""
    inj = _STATE.injector
    if inj is None:
        return None
    return inj.fire(site)


def fail_point(site: str) -> None:
    """Raise :class:`InjectedFault` if a fault is scheduled for this hit."""
    inj = _STATE.injector
    if inj is None:
        return
    f = inj.fire(site)
    if f is not None:
        raise InjectedFault(f)


def mangle(site: str, value):
    """Corrupt ``value`` (a tensor or an array) per the scheduled fault's
    kind (identity if none).

    ``nan_backend`` returns a copy whose first eighth of the elements (at
    least one) are NaN — deterministic, detectable by any finite-ness
    probe."""
    inj = _STATE.injector
    if inj is None:
        return value
    f = inj.fire(site)
    if f is None:
        return value
    if f.kind == "nan_backend":
        arr = (value.clone() if isinstance(value, torch.Tensor)
               else np.asarray(value).copy())
        flat = arr.reshape(-1)
        flat[: max(1, flat.shape[0] // 8)] = float("nan")
        return arr
    if f.kind == "kernel_launch":
        raise InjectedFault(f)
    return value


# ---------------------------------------------------------------------------
# file corruption (applied by drills, not an inline injection point)
# ---------------------------------------------------------------------------
def corrupt_file(path: str, seed: int = 0, mode: str = "garble") -> str:
    """Deterministically corrupt a file in place (returns the path).

    ``mode="garble"`` overwrites a seeded slice of bytes (bit rot);
    ``mode="truncate"`` cuts the file to 60% (a torn write).  Both model the
    states :mod:`repro_torch.train.checkpoint`'s fallback restore must survive.
    """
    size = os.path.getsize(path)
    if size == 0:
        return path
    rng = np.random.default_rng(seed)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(int(size * 0.6), 1))
    elif mode == "garble":
        start = int(rng.integers(0, max(size // 2, 1)))
        n = max(min(size - start, 64), 1)
        junk = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        with open(path, "r+b") as f:
            f.seek(start)
            f.write(junk)
    else:
        raise ValueError(f"unknown corrupt_file mode {mode!r}")
    obs.counter("chaos.fired", site="io.file", kind="corrupt_file").inc()
    return path
