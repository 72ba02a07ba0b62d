"""The readers of the program's own records (``metrics/_program_spans.py``
and the four metrics on it) on synthetic traces and spans, and, on the
card, one profiled step of each model: the program's spans stay out of
the device trace, its clock marker adds no device work, the optimizer's
events read between 0 and the step, and the step itself never
synchronises."""
import types

import pytest
import torch

from ._small import WORKLOADS, manifest, small_spec
from h100bench.harness import devtrace
from repro_torch import obs
from repro_torch.obs import trace as program_trace

PROGRAM = {"train.forward", "train.backward", "train.clip", "train.update",
           "exec.layer", "exec.layer.backward"}


def _reader(name):
    return manifest.metric_reader(name).read


class _Event:
    def __init__(self, t_ms):
        self.t_ms = t_ms

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t_ms - self.t_ms


def _span(name, t0_us, t1_us, step=None, events=None):
    """A program span whose perf_counter times sit ``t0_us``, ``t1_us``
    after the session's clock note."""
    return types.SimpleNamespace(name=name, t0=10.0 + t0_us / 1e6,
                                 t1=10.0 + t1_us / 1e6,
                                 args={} if step is None else {"step": step},
                                 events=events)


def _ctx(spans, host=(), marker=True, monkeypatch=None):
    """Device work 1000-1100 and 1200-1300 µs in a step 1000-1300; the
    clock marker ends at 1000 µs, so a span at ``t`` µs after the note
    sits at 1000 + t on the trace."""
    host = list(host) + ([("obs.clock", 990.0, 1000.0)] if marker else [])
    trace = devtrace.DeviceTrace([("k", 1000.0, 1100.0),
                                  ("k", 1200.0, 1300.0)], host,
                                 [(1000.0, 1300.0)])
    session = types.SimpleNamespace(spans=spans, clock=10.0)
    monkeypatch.setattr(program_trace, "profiled_spans", lambda: session)
    return types.SimpleNamespace(trace=trace)


@pytest.mark.parametrize("span,host,want", [
    ((50, 250), (), 100 / 3),                       # the gap inside a span
    ((50, 250), [("Activity Buffer Request", 1100.0, 1200.0)], 0.0),
    ((50, 250), [("Activity_Buffer_Request", 1100.0, 1200.0)], 0.0),
    ((50, 250), [("Activity Buffer Request", 1120.0, 1180.0),
                 ("Activity Buffer Request", 1150.0, 1190.0)], 100 / 10),
    ((50, 250), [("aten::detach", 1120.0, 1180.0)], 100 / 3),
    ((0, 90), (), 0.0),                             # no span at the gap
    ((150, 250), (), 100 / 6),                      # a span over half of it
], ids=["inside", "buffer-request", "buffer-request-sanitised",
        "buffer-request-part", "program-op", "outside", "half"])
def test_program_idle_pct(span, host, want, monkeypatch):
    ctx = _ctx([_span("train.forward", *span)], host,
               monkeypatch=monkeypatch)
    assert _reader("program_idle_pct")(ctx) == pytest.approx(want)
    assert _reader("device_idle_pct")(ctx) == pytest.approx(100 / 3)


def test_optimizer_ms_pairs_clip_start_and_update_end(monkeypatch):
    spans = [_span("train.clip", 10, 20, 0, (_Event(1.0), _Event(1.5))),
             _span("train.update", 20, 30, 0, (_Event(1.6), _Event(2.5))),
             _span("train.clip", 110, 120, 1, (_Event(5.0), _Event(5.1))),
             _span("train.update", 120, 130, 1, (_Event(5.2), _Event(5.6))),
             _span("train.forward", 0, 10, 0)]
    ctx = _ctx(spans, monkeypatch=monkeypatch)
    assert _reader("optimizer_ms")(ctx) == pytest.approx((1.5 + 0.6) / 2)


@pytest.mark.parametrize("name", ["program_idle_pct", "optimizer_ms"])
def test_span_readers_find_nothing(name, monkeypatch):
    read = _reader(name)
    spans = [_span("train.clip", 10, 20, 0, (_Event(1.0), _Event(1.5))),
             _span("train.update", 20, 30, 0, (_Event(1.6), _Event(2.5)))]
    assert read(types.SimpleNamespace(trace=None)) is None
    assert read(_ctx(spans, marker=False, monkeypatch=monkeypatch)) is None
    assert read(_ctx([], monkeypatch=monkeypatch)) is None
    # a program that keeps no profiled spans (the parent of this reader)
    ctx = _ctx(spans, monkeypatch=monkeypatch)
    monkeypatch.delattr(program_trace, "profiled_spans")
    assert read(ctx) is None


@pytest.mark.parametrize("metric,hist", [
    ("plan_tiles_s", "exec.plan.tiles_seconds"),
    ("plan_upload_s", "exec.plan.upload_seconds")])
def test_plan_phase_readers(metric, hist, monkeypatch):
    read = _reader(metric)
    ctx = types.SimpleNamespace(trace=None)
    snap = {"counters": {}, "gauges": {}, "histograms": {}}
    monkeypatch.setattr(obs, "snapshot", lambda: snap)
    assert read(ctx) is None
    snap["histograms"][hist] = {"count": 0, "sum": 0.0}
    assert read(ctx) is None
    snap["histograms"][hist] = {"count": 2, "sum": 1.25}
    assert read(ctx) == 1.25


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_spans_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    spec = small_spec(workload, nodes=20000, edges=80000, feat=512,
                      hidden=64)
    session = manifest.driver(spec["config"]["driver"]).Session(
        spec, 2 ** 31 + 11, dev, log=lambda s: None)
    session.setup()
    try:
        trace = devtrace.profile_steps(session.step, 2)
        ctx = types.SimpleNamespace(trace=trace)
        spans = obs.profiled_spans().spans
        assert {sp.name for sp in spans} == PROGRAM
        device_names = {n for n, _, _ in trace.device_ops}
        assert not device_names & (PROGRAM | {obs.CLOCK_MARK})
        assert [n for n, _, _ in trace.host_ops].count(obs.CLOCK_MARK) == 1
        # autograd's device thread ran the layers' backward, under the
        # caller's train.backward
        by_id = {sp.id: sp for sp in spans}
        for sp in spans:
            if sp.name == "exec.layer.backward":
                parent = by_id[sp.parent]
                assert parent.name == "train.backward"
                assert parent.t0 <= sp.t0 <= sp.t1 <= parent.t1
        step_ms = 1e3 * trace.window_s / trace.n_steps
        opt_ms = _reader("optimizer_ms")(ctx)
        assert 0 < opt_ms < step_ms
        idle = _reader("program_idle_pct")(ctx)
        assert 0 <= idle <= _reader("device_idle_pct")(ctx) + 1e-9

        # the program's step, alone, never synchronises
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            session.params, session.opt_state, loss = session.step_fn(
                session.params, session.opt_state, session.batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.isfinite(loss).item()
    finally:
        session.release()
