"""repro_torch.obs — framework-free counters, gauges, histograms and spans
(copies of ``repro.obs.registry`` / ``repro.obs.trace``)."""
from .registry import (Counter, Gauge, Histogram, Registry, REGISTRY,
                       counter, gauge, histogram, snapshot, reset, enable,
                       disable, enabled, full_name)
from .trace import (Tracer, Span, NOOP_SPAN, span, instant, start_trace,
                    stop_trace)
