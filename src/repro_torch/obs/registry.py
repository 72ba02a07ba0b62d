"""Process-local telemetry registry: counters, gauges, streaming histograms.

A framework-free copy of ``repro/obs/registry.py``; the JSONL dump with
the run's provenance lives in :mod:`repro_torch.obs.export`.

Design constraints:

* **near-zero overhead when disabled** — metrics are *gated* on a single
  module-level flag; a disabled ``inc``/``set``/``observe`` is one attribute
  load and a branch, no allocation, no formatting.  Hot loops hold the
  metric object (``c = obs.counter(...)`` once, ``c.inc()`` per event).
* **bounded memory** — histograms are streaming with FIXED log-spaced
  buckets (no per-sample storage), so latency percentiles survive sustained
  traffic; see :class:`Histogram` for the accuracy bound.
* **ungated metrics** — a subsystem whose own report depends on a metric
  (e.g. ``serve.engine``'s latency percentiles) creates it with
  ``gated=False`` so it records regardless of the global flag; the flag
  then only gates *telemetry*, never correctness.

``snapshot()`` returns the whole registry as a nested dict;
``to_prometheus()`` renders Prometheus text exposition format (byte-equal
to the reference's for the same metric operations).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Tuple


class _State:
    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = False


_STATE = _State()


def enable() -> None:
    """Turn gated metric recording on (module-level flag)."""
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


def enabled() -> bool:
    return _STATE.enabled


class enabled_scope:
    """``with obs.enabled_scope():`` — enable within a block, restore after."""

    def __init__(self, on: bool = True):
        self._on = on
        self._prev = False

    def __enter__(self):
        self._prev = _STATE.enabled
        _STATE.enabled = self._on
        return self

    def __exit__(self, *exc):
        _STATE.enabled = self._prev
        return False


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count (events, bytes, requests)."""

    __slots__ = ("name", "labels", "gated", "value")
    kind = "counter"

    def __init__(self, name: str, labels: LabelKey = (), gated: bool = True):
        self.name = name
        self.labels = labels
        self.gated = gated
        self.value = 0

    def inc(self, v: int = 1) -> None:
        if self.gated and not _STATE.enabled:
            return
        self.value += v

    def payload(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Last-written value (queue depth, hit rate, verdict microseconds)."""

    __slots__ = ("name", "labels", "gated", "value")
    kind = "gauge"

    def __init__(self, name: str, labels: LabelKey = (), gated: bool = True):
        self.name = name
        self.labels = labels
        self.gated = gated
        self.value = 0.0

    def set(self, v: float) -> None:
        if self.gated and not _STATE.enabled:
            return
        self.value = v

    def payload(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Streaming histogram over FIXED log-spaced buckets.

    Buckets span ``[lo, hi)`` with ``per_decade`` buckets per decade (bucket
    boundary ratio ``r = 10 ** (1 / per_decade)``), plus underflow/overflow
    buckets at the ends.  Memory is a fixed int list — O(decades *
    per_decade), independent of sample count.

    ``percentile(q)`` log-interpolates within the hit bucket and clamps to
    the observed ``[min, max]``, so for positive samples the estimate's
    relative error is bounded by one bucket ratio:

        exact / r  <=  estimate  <=  exact * r

    (the tests assert exactly this bound against ``np.percentile``).  The
    default ``per_decade=100`` puts r at ~2.3%.
    """

    __slots__ = ("name", "labels", "gated", "lo", "hi", "per_decade",
                 "_log_lo", "_nb", "buckets", "count", "sum", "min", "max")
    kind = "histogram"

    def __init__(self, name: str, labels: LabelKey = (), gated: bool = True,
                 lo: float = 1e-7, hi: float = 1e4, per_decade: int = 100):
        assert lo > 0 and hi > lo and per_decade >= 1
        self.name = name
        self.labels = labels
        self.gated = gated
        self.lo = float(lo)
        self.hi = float(hi)
        self.per_decade = int(per_decade)
        self._log_lo = math.log10(lo)
        decades = math.log10(hi) - self._log_lo
        # [0] underflow, [1..nb] log buckets, [nb+1] overflow
        self._nb = int(math.ceil(decades * per_decade))
        self.buckets = [0] * (self._nb + 2)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    @property
    def ratio(self) -> float:
        """Bucket boundary ratio — the percentile relative-error bound."""
        return 10.0 ** (1.0 / self.per_decade)

    def observe(self, v: float) -> None:
        if self.gated and not _STATE.enabled:
            return
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v < self.lo:
            self.buckets[0] += 1
        elif v >= self.hi:
            self.buckets[self._nb + 1] += 1
        else:
            i = int((math.log10(v) - self._log_lo) * self.per_decade)
            # guard float edge cases at bucket boundaries
            self.buckets[min(max(i, 0), self._nb - 1) + 1] += 1

    def _edge(self, i: int) -> float:
        """Lower edge of log bucket ``i`` (0-based within the log range)."""
        return 10.0 ** (self._log_lo + i / self.per_decade)

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-th percentile (0..100) of the observed stream."""
        if self.count == 0:
            return 0.0
        target = q / 100.0 * (self.count - 1) + 1.0   # 1-based rank
        cum = 0
        for j, c in enumerate(self.buckets):
            if c == 0:
                continue
            if cum + c >= target:
                if j == 0:                             # underflow bucket
                    est = min(self.lo, self.max)
                elif j == self._nb + 1:                # overflow bucket
                    est = max(self.hi, self.min)
                else:
                    frac = (target - cum) / c
                    lo = self._edge(j - 1)
                    est = lo * (self.ratio ** frac)    # log interpolation
                return float(min(max(est, self.min), self.max))
            cum += c
        return float(self.max)

    def payload(self) -> dict:
        empty = self.count == 0
        return {"count": self.count, "sum": self.sum,
                "min": 0.0 if empty else self.min,
                "max": 0.0 if empty else self.max,
                "mean": 0.0 if empty else self.sum / self.count,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
class Registry:
    """Name → metric store; metrics are interned on first use."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: Dict[str, object],
             gated: bool, **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[1], gated=gated, **kw)
                    self._metrics[key] = m
        return m

    def counter(self, name: str, gated: bool = True, **labels) -> Counter:
        return self._get(Counter, name, labels, gated)

    def gauge(self, name: str, gated: bool = True, **labels) -> Gauge:
        return self._get(Gauge, name, labels, gated)

    def histogram(self, name: str, gated: bool = True,
                  lo: float = 1e-7, hi: float = 1e4, per_decade: int = 100,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, gated,
                         lo=lo, hi=hi, per_decade=per_decade)

    def metrics(self):
        return list(self._metrics.values())

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """Nested dict: kind → full metric name → payload."""
        out: Dict[str, Dict[str, dict]] = {"counters": {}, "gauges": {},
                                           "histograms": {}}
        for m in self.metrics():
            payload = m.payload()
            if m.kind == "counter":
                out["counters"][full_name(m)] = payload["value"]
            elif m.kind == "gauge":
                out["gauges"][full_name(m)] = payload["value"]
            else:
                out["histograms"][full_name(m)] = payload
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (counters/gauges native; histograms as
        summaries: ``_count``, ``_sum``, and ``quantile`` series)."""
        lines = []
        seen_types = set()
        for m in sorted(self.metrics(), key=full_name):
            base = _prom_name(m.name)
            if m.kind in ("counter", "gauge"):
                if base not in seen_types:
                    lines.append(f"# TYPE {base} {m.kind}")
                    seen_types.add(base)
                lines.append(f"{base}{_prom_labels(m.labels)} "
                             f"{m.payload()['value']}")
            else:
                if base not in seen_types:
                    lines.append(f"# TYPE {base} summary")
                    seen_types.add(base)
                p = m.payload()
                for q, v in (("0.5", p["p50"]), ("0.9", p["p90"]),
                             ("0.99", p["p99"])):
                    lines.append(
                        f"{base}{_prom_labels(m.labels, quantile=q)} {v}")
                lines.append(f"{base}_sum{_prom_labels(m.labels)} "
                             f"{p['sum']}")
                lines.append(f"{base}_count{_prom_labels(m.labels)} "
                             f"{p['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


def full_name(m) -> str:
    if not m.labels:
        return m.name
    inner = ",".join(f"{k}={v}" for k, v in m.labels)
    return f"{m.name}{{{inner}}}"


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _prom_labels(labels: LabelKey, **extra) -> str:
    items = list(labels) + sorted(extra.items())
    if not items:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{v}"' for k, v in items)
    return f"{{{inner}}}"


# the process-global default registry and its module-level helpers
REGISTRY = Registry()


def counter(name: str, gated: bool = True, **labels) -> Counter:
    return REGISTRY.counter(name, gated=gated, **labels)


def gauge(name: str, gated: bool = True, **labels) -> Gauge:
    return REGISTRY.gauge(name, gated=gated, **labels)


def histogram(name: str, gated: bool = True, lo: float = 1e-7,
              hi: float = 1e4, per_decade: int = 100, **labels) -> Histogram:
    return REGISTRY.histogram(name, gated=gated, lo=lo, hi=hi,
                              per_decade=per_decade, **labels)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def to_prometheus() -> str:
    return REGISTRY.to_prometheus()


def reset() -> None:
    REGISTRY.reset()
