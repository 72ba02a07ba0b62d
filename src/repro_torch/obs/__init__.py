"""repro_torch.obs — counters, gauges, histograms, spans, and their export
(the port of ``repro.obs``; the seven modules keep the reference's names).

* :mod:`.registry` — process-local counters / gauges / streaming histograms
  gated on one module-level flag; Prometheus text exposition.
* :mod:`.trace`    — span tracer emitting Perfetto / chrome://tracing JSON
  on the host clock.
* :mod:`.export`   — run provenance (git SHA, the device the run resolved,
  torch and CUDA versions, the card's power limit), the shared event
  schema, the ``--metrics-out FILE.jsonl`` dump and ``observed_run``.
* :mod:`.validate` — schema validators for the emitted files
  (``python -m repro_torch.obs.validate out.jsonl trace.json``).
* :mod:`.summary`  — terminal one-pager over metrics JSONL + traces
  (``python -m repro_torch.obs.summary out.jsonl trace.json``).
* :mod:`.audit`    — joins measured autotune trials against the cold cost
  model into a calibration table keyed by ``device_sig`` (read by the
  whole-forward DP) plus a drift report (``python -m
  repro_torch.obs.audit``).
* :mod:`.regress`  — noise-aware perf-regression gate over BENCH documents
  (``python -m repro_torch.obs.regress compare BASE.json CURRENT.json``).

Turn it on with ``obs.enable()`` + ``obs.start_trace()``, or the
``--metrics-out`` / ``--trace`` flags of ``launch/train.py`` and
``launch/serve.py``.
"""
from .registry import (Counter, Gauge, Histogram, Registry, REGISTRY,
                       counter, gauge, histogram, snapshot, to_prometheus,
                       reset, enable, disable, enabled, enabled_scope,
                       full_name)
from .trace import (Tracer, Span, NOOP_SPAN, span, instant, start_trace,
                    stop_trace, tracing, tracing_to, current_tracer)
from .export import (provenance, event, git_sha, device_kind, torch_version,
                     cuda_version, metric_records, dump_metrics_jsonl,
                     add_cli_flags, observed_run,
                     SCHEMA_PROVENANCE, SCHEMA_METRIC, SCHEMA_EVENT)
