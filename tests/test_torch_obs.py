"""The port's framework-free telemetry copies behave like the reference's:
streaming-histogram percentiles agree exactly on the same samples, gated
metrics stay silent until enabled, and plan compiles and served batches
emit spans on the host timeline."""
import numpy as np
import pytest

from repro.obs import Histogram as RefHistogram
from repro_torch import obs
from repro_torch.exec import build_plan
from repro_torch.graph import DatasetSpec, synthesize
from repro_torch.serve import (MicroBatcher, ServeEngine, make_session,
                               zipfian_trace)



@pytest.mark.parametrize("dist", ["lognormal", "uniform", "exponential"])
def test_histogram_percentiles_match_reference(dist):
    rng = np.random.default_rng(0)
    samples = {"lognormal": rng.lognormal(-6, 1.5, 2000),
               "uniform": rng.uniform(1e-4, 2e-2, 2000),
               "exponential": rng.exponential(3e-3, 2000)}[dist]
    h = obs.Histogram("lat", gated=False)
    ref = RefHistogram("lat", gated=False)
    for v in samples:
        h.observe(float(v))
        ref.observe(float(v))
    for q in (50, 90, 99):
        assert h.percentile(q) == ref.percentile(q)
        # the documented bound: within one bucket ratio of the exact value
        exact = float(np.percentile(samples, q))
        assert exact / h.ratio <= h.percentile(q) <= exact * h.ratio
    assert h.payload() == ref.payload()


def test_gated_metrics_and_spans():
    obs.reset()
    c = obs.counter("exec.plan.compiles", backend="torch")
    c.inc()
    assert c.value == 0                       # disabled: a no-op
    assert obs.span("x") is obs.NOOP_SPAN     # no tracer installed
    obs.enable()
    tracer = obs.start_trace()
    try:
        g = synthesize(DatasetSpec("t", 200, 1200, 8, 2, seed=1))
        build_plan(g, "gcn", bm=32, backend="torch", device="cpu")
        sess = make_session("gcn", g, hidden=8, out_dim=4, device="cpu")
        eng = ServeEngine(sess, None, MicroBatcher(max_batch=4,
                                                   max_wait=1e-3))
        rep = eng.serve(zipfian_trace(g.num_nodes, 12, seed=2))
    finally:
        doc = obs.stop_trace()
        obs.disable()
    assert rep.num_requests == 12 and rep.max_oracle_err < 1e-4
    names = [e["name"] for e in doc["traceEvents"]]
    assert "exec.plan.compile" in names and "serve.batch" in names
    assert names.count("serve.request") == 12
    snap = obs.snapshot()
    # the explicit torch plan, then the session's plans on whatever backend
    # its whole-forward DP picks over the CPU grid
    compiles = {k: v for k, v in snap["counters"].items()
                if k.startswith("exec.plan.compiles{")}
    assert compiles["exec.plan.compiles{backend=torch}"] >= 1
    assert sum(compiles.values()) >= 2
    assert snap["counters"]["serve.requests"] == 12
    assert tracer.events and obs.stop_trace() is None
    obs.reset()
