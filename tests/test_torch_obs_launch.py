"""The port's launchers under ``--metrics-out`` / ``--trace`` /
``--summary`` against the reference's on the same arguments, on the CPU;
the schedule verdict counter of ``--executor auto``; the batcher's bounded
queue and load shedding; the adversarial traffic that drives it.

Each launcher of either package runs once per module (module-scoped
fixtures).  Tolerances: counters and count-based metrics are compared
exactly.  Excepted, and listed in ``WALL_CLOCK`` / ``FLOAT_SUMS``: gauges
and histograms of the wall clock (latency percentiles, request rate,
step seconds, rows per second), and values that are fp32 sums taken in
another order by another framework (the oracle error, the loss: held by
the port's parity tests of serving and training, not here).  The
``backend`` label names the plain CPU backend ``jnp`` in the reference and
``torch`` in the port.
"""
import json
import os

import numpy as np
import pytest

from repro import obs as ref_obs
from repro.chaos.traffic import adversarial_trace as ref_adversarial_trace
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro.obs import validate as ref_validate
from repro.serve.batcher import MicroBatcher as RefMicroBatcher
from repro_torch import obs
from repro_torch.chaos import adversarial_trace
from repro_torch.launch import serve, train
from repro_torch.obs import validate
from repro_torch.serve import MicroBatcher

SERVE_ARGV = ["--graph", "cora", "--model", "gcn", "--requests", "50"]
TRAIN_ARGV = ["--arch", "gcn-cora", "--steps", "3", "--executor", "fused"]
WALL_CLOCK = {"serve.latency_p50_ms", "serve.latency_p99_ms",
              "serve.req_per_s", "serve.batch_wall_ms",
              "train.step_seconds", "train.rows_per_s"}
FLOAT_SUMS = {"serve.max_oracle_err", "train.loss"}


def _reset_both():
    for o in (obs, ref_obs):
        o.reset()
        o.disable()
        o.stop_trace()


def _observed(main, argv, tmp, tag):
    """Run a launcher with both files in ``tmp``; returns their paths."""
    m, t = str(tmp / f"{tag}.jsonl"), str(tmp / f"{tag}.json")
    _reset_both()
    try:
        main(argv + ["--metrics-out", m, "--trace", t])
    finally:
        _reset_both()
    return m, t


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    port = _observed(serve.main, SERVE_ARGV + ["--device", "cpu",
                                               "--summary"], tmp, "port")
    ref = _observed(ref_serve.main, SERVE_ARGV, tmp, "ref")
    return port, ref


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    port = _observed(train.main, TRAIN_ARGV + ["--device", "cpu"], tmp,
                     "port")
    ref = _observed(ref_train.main, TRAIN_ARGV, tmp, "ref")
    return port, ref


def _metrics(path):
    """``{(name, labels): payload}`` of a metrics file, with the CPU's
    plain backend label read as the port's."""
    out = {}
    with open(path) as f:
        for rec in map(json.loads, f):
            if rec.get("schema") != "repro.obs/metric@1":
                continue
            labels = {k: ("torch" if (k, v) == ("backend", "jnp") else v)
                      for k, v in rec["labels"].items()}
            payload = {k: v for k, v in rec.items()
                       if k not in ("schema", "name", "labels")}
            out[(rec["name"], tuple(sorted(labels.items())))] = payload
    return out


def _assert_same_metrics(port_path, ref_path, must_have):
    mine, theirs = _metrics(port_path), _metrics(ref_path)
    assert set(mine) == set(theirs)
    compared = 0
    for key, payload in mine.items():
        if key[0] in WALL_CLOCK or key[0] in FLOAT_SUMS:
            continue
        assert payload == theirs[key], key
        compared += 1
    names = {k[0] for k in mine}
    assert set(must_have) <= names
    return compared


@pytest.mark.parametrize("which", ["port", "ref"])
def test_serve_files_validate_with_cpu_provenance(serve_runs, which):
    (m, t), (rm, rt) = serve_runs
    if which == "port":
        assert validate.validate_metrics_file(m) == []
        assert validate.validate_trace_file(t) == []
        head = json.loads(open(m).readline())
        other = json.load(open(t))["otherData"]
        for prov in (head, other):
            assert prov["backend"] == "cpu" and prov["device_kind"] == "cpu"
    else:
        assert ref_validate.validate_metrics_file(rm) == []
        assert ref_validate.validate_trace_file(rt) == []
    doc = json.load(open(t if which == "port" else rt))
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("serve.request") == 50
    snap = _metrics(m if which == "port" else rm)
    assert snap[("serve.batches", ())]["value"] \
        == names.count("serve.batch")


def test_serve_counters_equal_the_reference(serve_runs):
    (m, _), (rm, _) = serve_runs
    compared = _assert_same_metrics(m, rm, [
        "serve.requests", "serve.batches", "serve.flush",
        "serve.cache.hits", "serve.cache.misses", "serve.cache.evictions",
        "serve.cache.hit_rate", "exec.plan.compiles", "serve.flush_size"])
    assert compared >= 25
    assert _metrics(m)[("serve.requests", ())]["value"] == 50


def test_train_files_and_counters_equal_the_reference(train_runs):
    (m, t), (rm, rt) = train_runs
    assert validate.main([m, t]) == 0
    assert ref_validate.main([rm, rt]) == 0
    assert json.loads(open(m).readline())["backend"] == "cpu"
    _assert_same_metrics(m, rm, ["train.steps", "exec.plan.compiles",
                                 "train.loss", "train.step_seconds"])
    assert _metrics(m)[("train.steps", ())]["value"] == 3
    steps = [e for e in json.load(open(t))["traceEvents"]
             if e["name"] == "train.step"]
    assert len(steps) == 3 and all(e["dur"] > 0 for e in steps)


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_summary_alone_exits_2_as_in_the_reference(launcher, capsys):
    mine, theirs = {"serve": (serve.main, ref_serve.main),
                    "train": (train.main, ref_train.main)}[launcher]
    argv = (SERVE_ARGV if launcher == "serve" else TRAIN_ARGV) \
        + ["--summary"]
    codes = []
    for main in (mine, theirs):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        codes.append(exc.value.code)
    assert codes == [2, 2]
    assert "--summary needs --metrics-out" in capsys.readouterr().err


def test_a_failed_run_still_leaves_both_files(tmp_path, capsys):
    """The launcher's run raises inside ``observed_run`` (an unknown
    graph): both files are written, valid and stamped, the summary is
    printed, and the error propagates."""
    m, t = str(tmp_path / "m.jsonl"), str(tmp_path / "t.json")
    try:
        with pytest.raises(SystemExit, match="unknown --graph"):
            serve.main(["--graph", "nope", "--device", "cpu",
                        "--metrics-out", m, "--trace", t, "--summary"])
    finally:
        _reset_both()
    assert validate.main([m, t]) == 0
    out = capsys.readouterr().out
    assert f"=== {m} ===" in out and "backend=cpu" in out


def test_auto_schedule_verdict_counts_like_the_reference(tmp_path,
                                                         monkeypatch):
    """``--executor auto`` counts its schedule's verdict in
    ``exec.forward.verdict{source}`` and sets ``exec.forward.verdict_us``
    (each package with a tuning cache of its own)."""
    monkeypatch.setenv("REPRO_EXEC_CACHE", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_EXEC_CACHE", str(tmp_path / "port"))
    _reset_both()
    try:
        for o in (obs, ref_obs):
            o.enable()
        train.gnn_driver("gcn-cora", 2, None, executor="auto",
                         device="cpu")
        ref_train.gnn_driver("gcn-cora", 2, None, executor="auto")
        snaps = [o.snapshot() for o in (obs, ref_obs)]
    finally:
        _reset_both()
    for snap in snaps:
        verdicts = {k: v for k, v in snap["counters"].items()
                    if k.startswith("exec.forward.verdict{source=")}
        assert sum(verdicts.values()) == 1 and len(verdicts) == 1
        assert snap["gauges"]["exec.forward.verdict_us"] > 0


def _replay(batcher, stream):
    """Feed ``stream`` through ``try_submit`` with a deadline poll before
    each arrival, then drain; every flush as (reason, ids, t, live)."""
    flushes, admitted = [], []
    for req in stream:
        mb = batcher.poll(req.t_arrival)
        if mb is not None:
            flushes.append(mb)
        ok, mb = batcher.try_submit(req)
        admitted.append(ok)
        if mb is not None:
            flushes.append(mb)
    mb = batcher.drain(stream[-1].t_arrival + 1.0)
    if mb is not None:
        flushes.append(mb)
    return ([(f.reason, f.node_ids.tolist(), f.valid.tolist(), f.t_flush,
              [r.req_id for r in f.requests]) for f in flushes], admitted)


@pytest.mark.parametrize("max_queue", [4, None])
def test_bounded_queue_sheds_like_the_reference(max_queue):
    stream = adversarial_trace(2708, 400, overload=20.0, seed=3)
    _reset_both()
    try:
        for o in (obs, ref_obs):
            o.enable()
        mine = MicroBatcher(max_batch=8, max_wait=1e-3, max_queue=max_queue)
        theirs = RefMicroBatcher(max_batch=8, max_wait=1e-3,
                                 max_queue=max_queue)
        got, ref = _replay(mine, stream), _replay(theirs, stream)
        shed = [o.snapshot()["counters"].get(
            "serve.shed{reason=queue_full}", 0) for o in (obs, ref_obs)]
    finally:
        _reset_both()
    assert got == ref
    assert mine.shed == theirs.shed == shed[0] == shed[1]
    assert mine.depth_hwm == theirs.depth_hwm
    if max_queue is None:
        assert mine.shed == 0 and not mine.queue_full
    else:
        assert mine.shed > 0 and mine.depth_hwm <= max_queue


@pytest.mark.parametrize("kw", [{}, {"overload": 1.0, "burst_fraction": 0.0,
                                     "malformed_fraction": 0.0},
                                {"malformed_fraction": 0.2, "seed": 11}])
def test_adversarial_trace_is_byte_equal(kw):
    mine = adversarial_trace(2708, 300, **kw)
    theirs = ref_adversarial_trace(2708, 300, **kw)
    assert [(r.req_id, r.node_id, repr(r.t_arrival)) for r in mine] \
        == [(r.req_id, r.node_id, repr(r.t_arrival)) for r in theirs]
    t = np.array([r.t_arrival for r in mine])
    assert np.all(np.diff(t) > 0)
