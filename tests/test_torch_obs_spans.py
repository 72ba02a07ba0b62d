"""The port's spans inside the training step, the layers and the plan
build: ids and parents (across threads too), collection while a
``torch.profiler`` session records, mapped onto its clock through the one
``obs.clock`` marker the program puts into it, the no-op path with neither
recording, and the plan build's two ungated set-up histograms.

Tolerances: a span mapped onto the profiler's clock lies inside the
``record_function`` interval of its step to within 5 µs (the marker's end
and the ``perf_counter`` read after it are a few µs apart); everything
else is exact.
"""
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.exec import build_layer_plan, build_plan
from repro_torch.graph import DatasetSpec, synthesize
from repro_torch.train import adam, fit, make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the script at the repository's root)

STEP_SPANS = ("train.forward", "train.backward", "train.clip",
              "train.update")
LAYER_SPANS = ("exec.layer", "exec.layer.backward")
PROGRAM = set(STEP_SPANS + LAYER_SPANS)
SLACK_US = 5.0


@pytest.fixture(autouse=True)
def _no_tracer():
    obs.stop_trace()
    yield
    obs.stop_trace()


def _graph(n=240, e=1500):
    return synthesize(DatasetSpec("t", n, e, 8, 3, seed=4))


def _model(backend="torch"):
    """A two-layer GCN of layer plans, its loss, params and batch."""
    g = _graph()
    lps = [build_layer_plan(g, "gcn", d_in=d_in, d_out=d_out,
                            backend=backend, bm=32, device="cpu")
           for d_in, d_out in ((8, 16), (16, 3))]
    gen = torch.Generator().manual_seed(0)
    params = {"layers": [{"w": torch.randn(a, b, generator=gen) * 0.3,
                          "b": torch.zeros(b)} for a, b in ((8, 16),
                                                            (16, 3))]}
    batch = {"x": torch.randn(g.num_nodes, 8, generator=gen),
             "y": torch.as_tensor(g.labels).long()}

    def loss_fn(p, b):
        h = b["x"]
        for i, (lp, lay) in enumerate(zip(lps, p["layers"])):
            h = lp.apply(h, lay["w"], lay["b"], relu=i == 0)
        return torch.nn.functional.cross_entropy(h, b["y"])
    return loss_fn, params, batch


def _profiled_steps(n=3):
    """``n`` steps, each in a ``record_function``, under a CPU profiler."""
    loss_fn, params, batch = _model()
    opt = adam(1e-2)
    state = opt.init(params)
    step = make_train_step(loss_fn, opt, clip_norm=1.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            with record_function("test.step"):
                params, state, loss = step(params, state, batch)
                float(loss)
    return prof, obs.profiled_spans()


def test_span_ids_and_parents_across_threads():
    obs.start_trace()
    seen = {}
    with obs.span("outer", cat="test") as outer:
        with obs.span("inner", cat="test") as inner:
            main = threading.get_ident()

            def worker():
                with obs.span("adopted", cat="test",
                              parent=obs.open_span(main)) as a:
                    seen["adopted"] = a
                with obs.span("orphan", cat="test") as o:
                    seen["orphan"] = o
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    doc = obs.stop_trace()
    by = {e["name"]: e["args"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert by["outer"]["parent"] is None
    assert by["inner"]["parent"] == by["outer"]["id"] == outer.id
    assert by["adopted"]["parent"] == inner.id
    assert by["orphan"]["parent"] is None
    assert len({a["id"] for a in by.values()}) == 4
    assert seen["adopted"].thread != main
    assert obs.open_span(main) is None and obs.open_span(None) is None


def test_idle_span_is_the_shared_noop_and_collects_nothing():
    assert not obs.tracing() and not obs.profiling()
    before = obs.profiled_spans()
    assert obs.span("x", step=1) is obs.NOOP_SPAN
    assert obs.span("x", timed=True, parent=None) is obs.NOOP_SPAN
    loss_fn, params, batch = _model()
    opt = adam(1e-2)
    make_train_step(loss_fn, opt)(params, opt.init(params), batch)
    assert obs.profiled_spans() is before


def test_profiling_follows_the_autograd_profiler_flag():
    """The flag spans follow is the profiler's own Python flag, which
    agrees with the C++ profiler's state on either side of a session."""
    flags = lambda: (obs.profiling(), torch._C._autograd._profiler_enabled())
    assert flags() == (False, False)
    with profile(activities=[ProfilerActivity.CPU]):
        assert flags() == (True, True)
    assert flags() == (False, False)


def test_spans_are_collected_under_the_profiler():
    _, session = _profiled_steps(3)
    names = [sp.name for sp in session.spans]
    for name in STEP_SPANS:
        assert names.count(name) == 3
    assert names.count("exec.layer") == 6
    assert names.count("exec.layer.backward") == 6
    steps = {sp.args["step"] for sp in session.spans
             if sp.name in STEP_SPANS}
    assert steps == {0, 1, 2}
    layer = [sp.args for sp in session.spans if sp.name == "exec.layer"]
    assert {(a["d_in"], a["d_out"]) for a in layer} == {(8, 16), (16, 3)}
    assert all(a["order"] in ("aggregate_first", "update_first")
               and a["fuse"] is False for a in layer)
    # the step's phases are roots here; each layer's backward belongs to
    # the train.backward span of its step
    by_id = {sp.id: sp for sp in session.spans}
    for sp in session.spans:
        if sp.name in STEP_SPANS:
            assert sp.parent is None
        elif sp.name == "exec.layer":
            assert by_id[sp.parent].name == "train.forward"
        else:
            assert by_id[sp.parent].name == "train.backward"
    # no CUDA here: no device events
    assert all(sp.events is None for sp in session.spans)


def test_spans_map_into_their_steps_on_the_profiler_clock():
    prof, session = _profiled_steps(3)
    events = list(prof.events())
    (mark,) = [e for e in events if e.name == obs.CLOCK_MARK]
    steps = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "test.step")
    assert len(steps) == 3
    end = mark.time_range.end
    assert steps[0][0] <= end <= steps[0][1]
    for sp in session.spans:
        a = end + (sp.t0 - session.clock) * 1e6
        b = end + (sp.t1 - session.clock) * 1e6
        step = steps[sp.args["step"]] if "step" in sp.args else next(
            s for s in steps if s[0] - SLACK_US <= a <= s[1] + SLACK_US)
        assert step[0] - SLACK_US <= a <= b <= step[1] + SLACK_US, (
            sp.name, a - step[0], step[1] - b)


def test_the_clock_marker_is_the_only_program_event_in_the_profiler():
    prof, _ = _profiled_steps(2)
    names = [e.name for e in prof.events()]
    assert names.count(obs.CLOCK_MARK) == 1
    assert not PROGRAM & set(names)
    assert not [n for n in names if n.startswith(("train.", "exec."))]


def test_each_profiler_session_gets_its_own_collection():
    _, first = _profiled_steps(1)
    assert obs.profiled_spans() is first
    # a span opened with the profiler off closes the session; the next
    # session takes a marker of its own
    assert obs.span("between") is obs.NOOP_SPAN
    prof, second = _profiled_steps(1)
    assert second is not first and second.clock > first.clock
    assert [e.name for e in prof.events()].count(obs.CLOCK_MARK) == 1
    assert len(first.spans) == len(second.spans) == 4 + 4


def test_fit_step_phases_are_children_of_train_step():
    loss_fn, params, batch = _model()
    obs.start_trace()
    fit(loss_fn, adam(1e-2), params, iter([batch] * 2), steps=2,
        log_every=0, log=lambda s: None)
    doc = obs.stop_trace()
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    steps = {e["args"]["id"]: e for e in spans if e["name"] == "train.step"}
    assert len(steps) == 2
    for e in spans:
        if e["name"] in STEP_SPANS:
            parent = steps[e["args"]["parent"]]
            assert parent["args"]["step"] == e["args"]["step"]
            assert parent["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= parent["ts"] + parent["dur"] + 1e-3
    assert sum(e["name"] == "train.update" for e in spans) == 2


def _counts():
    h = obs.snapshot()["histograms"]
    return tuple(h.get(name, {}).get("count", 0)
                 for name in ("exec.plan.tiles_seconds",
                              "exec.plan.upload_seconds"))


@pytest.mark.parametrize("kw,observed", [
    ({"backend": "torch"}, 2),
    ({"backend": "torch", "compact": False}, 2),
    ({"backend": "cuda"}, 2),                    # the CPU runs plain versions
    ({"backend": "torch", "buckets": "16@8+64"}, 2),
    ({"backend": "coo"}, 0),                     # no tiles, no phases
], ids=["torch", "torch-padded", "cuda-compact", "bucketed", "coo"])
def test_plan_phase_histograms_record_with_obs_disabled(kw, observed):
    assert not obs.enabled()
    before = _counts()
    obs.start_trace()
    build_plan(_graph(), "gcn", bm=32, device="cpu", **kw)
    doc = obs.stop_trace()
    after = _counts()
    assert after == (before[0] + observed, before[1] + observed)
    spans = {e["args"]["id"]: e for e in doc["traceEvents"]
             if e["ph"] == "X"}
    (compile_,) = [e for e in spans.values()
                   if e["name"] == "exec.plan.compile"]
    phases = [e for e in spans.values()
              if e["name"] in ("exec.plan.tiles", "exec.plan.upload")]
    assert len(phases) == 2 * observed
    assert all(e["args"]["parent"] == compile_["args"]["id"]
               for e in phases)
    if observed:
        h = obs.snapshot()["histograms"]["exec.plan.tiles_seconds"]
        assert h["sum"] > 0


def test_plan_arrays_are_what_the_host_built():
    """The upload copies the host arrays as they are: dtypes and values of
    both directions match entry lists and a block-ELL built directly (the
    plan's tiles, as ``tile_arrays`` builds them for a list plan)."""
    from repro_torch.core.blocksparse import (build_blockell, row_lists,
                                              transpose_graph)
    g = _graph()
    p = build_plan(g, "gcn", bm=32, backend="cuda", device="cpu")
    for side, gg, t in ((p._fwd, g, False),
                        (p._bwd, transpose_graph(g), True)):
        lists = row_lists(gg, bm=32, bk=32)
        assert side["row_ptr"].dtype == side["src"].dtype == torch.int32
        assert np.array_equal(side["row_ptr"].numpy(), lists.row_ptr)
        assert np.array_equal(side["src"].numpy(), lists.src)
        side = chip_smoke.tile_arrays(p, transposed=t)
        comp = build_blockell(gg, bm=32, bk=32,
                              storage="auto").compact(np.uint8)
        assert side["blocks"].dtype == torch.uint8
        assert np.array_equal(side["blocks"].numpy(), comp.blocks)
        assert np.array_equal(side["cols"].numpy(), comp.cols)
        assert side["row_offsets"].dtype == torch.int32
        assert np.array_equal(side["row_offsets"].numpy(),
                              comp.row_offsets.astype(np.int32))
