"""The port's telemetry export against the reference's (``repro.obs``):
Prometheus text byte-equal after the same metric operations,
``enabled_scope``, ``metric_records`` equal but for ``ts``, trace files
valid under both validators, every rejection case of ``tests/test_obs.py``
rejected by the port's validator with the same problems, the trajectory
validator, the summary's text, and the provenance a run stamps (the device
the run resolved, never whether a card is present).

Tolerances: none. Every comparison is exact (texts byte-equal, records
equal); ``ts`` is the wall clock and is left out where records are
compared.
"""
import importlib
import json
import os

import pytest
import torch

from repro import obs as ref_obs
from repro.obs import summary as ref_summary
from repro.obs import validate as ref_validate
from repro_torch import obs
from repro_torch.obs import export, summary, validate

# the module (``repro_torch.exec.autotune`` the attribute is the function)
port_autotune = importlib.import_module("repro_torch.exec.autotune")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _clean_obs():
    """Both packages start each test with an empty registry, telemetry
    off and no tracer."""
    for o in (obs, ref_obs):
        o.reset()
        o.disable()
        o.stop_trace()
    yield
    for o in (obs, ref_obs):
        o.reset()
        o.disable()
        o.stop_trace()


def _same_operations(o):
    """One sequence of metric operations: labels, gauges, histograms,
    a metric whose name needs Prometheus escaping, and a gated metric
    touched while disabled."""
    o.counter("serve.flush", reason="full").inc(3)
    o.counter("serve.flush", reason="deadline").inc()
    o.counter("exec.plan.compiles", backend="coo").inc(2)
    o.gauge("serve.cache.hit_rate", layer=0).set(0.25)
    o.gauge("serve.cache.hit_rate", layer=1).set(0.978261)
    o.gauge("exec.forward.verdict_us").set(1234.5)
    h = o.histogram("serve.flush_size", lo=1.0, hi=1e5, per_decade=20)
    for v in (1.0, 3.0, 8.0, 8.0, 5.0):
        h.observe(v)
    lat = o.histogram("train.step_seconds", phase="warm")
    for v in (0.011, 0.0123, 0.0101, 0.5):
        lat.observe(v)
    o.counter("weird-name.with/chars", **{"a-b": "x y"}).inc(7)
    with o.enabled_scope(False):
        o.counter("serve.flush", reason="full").inc(100)   # gated: dropped


def test_to_prometheus_is_byte_equal_to_the_reference():
    with obs.enabled_scope(), ref_obs.enabled_scope():
        _same_operations(obs)
        _same_operations(ref_obs)
    text = obs.to_prometheus()
    assert text == ref_obs.to_prometheus()
    assert '# TYPE serve_flush counter' in text
    assert 'serve_flush_size_count 5' in text
    assert 'weird_name_with_chars{a_b="x y"} 7' in text
    assert obs.REGISTRY.to_prometheus() == text
    assert obs.Registry().to_prometheus() == "" \
        == ref_obs.Registry().to_prometheus()


@pytest.mark.parametrize("start", [False, True])
def test_enabled_scope_restores_the_flag(start):
    for o in (obs, ref_obs):
        (o.enable if start else o.disable)()
        with o.enabled_scope() as scope:
            assert o.enabled()
            with o.enabled_scope(False):
                assert not o.enabled()
            assert o.enabled()
        assert o.enabled() is start
        assert isinstance(scope, o.enabled_scope)
    c = obs.counter("t.c")
    with obs.enabled_scope(False):
        c.inc()
    assert c.value == 0


def test_metric_records_equal_the_reference_but_ts():
    with obs.enabled_scope(), ref_obs.enabled_scope():
        _same_operations(obs)
        _same_operations(ref_obs)
    mine, theirs = obs.metric_records(), ref_obs.metric_records()
    assert mine == theirs and len(mine) == 9
    ev, ref_ev = obs.event("bench.row", us=5.0), ref_obs.event("bench.row",
                                                                us=5.0)
    ev.pop("ts")
    ref_ev.pop("ts")
    assert ev == ref_ev


def test_tracing_to_file_is_valid_under_both_validators(tmp_path):
    path = str(tmp_path / "t.json")
    assert not obs.tracing() and obs.current_tracer() is None
    with obs.tracing_to(path, other_data=obs.provenance("cpu")) as tracer:
        assert obs.tracing() and obs.current_tracer() is tracer
        with obs.span("outer", cat="test", k=1) as sp:
            sp.set(verdict="ok")
            with obs.span("inner", cat="test"):
                pass
        obs.instant("mark", cat="test", n=3)
    assert not obs.tracing()
    doc = json.load(open(path))
    assert validate.validate_trace(doc) == []
    assert ref_validate.validate_trace(doc) == []
    assert validate.validate_trace_file(path) == []
    assert ref_validate.validate_trace_file(path) == []
    names = [e["name"] for e in doc["traceEvents"]]
    assert {"outer", "inner", "mark", "process_name"} <= set(names)
    assert doc["otherData"]["backend"] == "cpu"


# the rejection cases of tests/test_obs.py (and one more per validator)
TRACE_REJECTS = {
    "no_trace_events": {"notTraceEvents": []},
    "no_ph": {"traceEvents": [{"name": "x"}]},
    "no_dur": {"traceEvents": [{"name": "x", "ph": "X", "ts": 0.0,
                                "pid": 1, "tid": 0}]},
    "bad_args": {"traceEvents": [{"name": "x", "ph": "i", "ts": 0.0,
                                  "pid": 1, "tid": 0, "args": 3}]},
    "not_a_doc": "trace",
}


@pytest.mark.parametrize("case", sorted(TRACE_REJECTS))
def test_trace_rejections_match_the_reference(case):
    doc = TRACE_REJECTS[case]
    errs = validate.validate_trace(doc)
    assert errs and errs == ref_validate.validate_trace(doc)


METRIC_REJECTS = {
    "missing_provenance": [json.dumps({"schema": "repro.obs/metric@1",
                                       "type": "counter", "name": "x",
                                       "value": 1})],
    "bad_type": [json.dumps({"schema": "repro.obs/provenance@1", "ts": "t",
                             "git_sha": "s", "device_kind": "cpu",
                             "torch_version": "v", "jax_version": "v"}),
                 json.dumps({"schema": "repro.obs/metric@1",
                             "type": "meter", "name": "x"})],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(METRIC_REJECTS))
def test_metrics_rejections_match_the_reference(case):
    lines = METRIC_REJECTS[case]
    errs = validate.validate_metrics_lines(lines)
    assert errs and errs == ref_validate.validate_metrics_lines(lines)


def test_provenance_keys_are_a_deliberate_divergence(tmp_path):
    """The port's files carry ``torch_version``, the reference's
    ``jax_version``: each validator rejects the other's metrics file,
    for that key alone."""
    mine, theirs = str(tmp_path / "p.jsonl"), str(tmp_path / "r.jsonl")
    with obs.enabled_scope(), ref_obs.enabled_scope():
        obs.counter("t.c").inc()
        ref_obs.counter("t.c").inc()
        obs.dump_metrics_jsonl(mine, device="cpu")
        ref_obs.dump_metrics_jsonl(theirs)
    assert validate.validate_metrics_file(mine) == []
    assert ref_validate.validate_metrics_file(theirs) == []
    assert validate.validate_metrics_file(theirs) == [
        "line 1: provenance missing 'torch_version'"]
    assert ref_validate.validate_metrics_file(mine) == [
        "line 1: provenance missing 'jax_version'"]


def _mangled_trajectory(tmp_path):
    lines = open(os.path.join(REPO, "BENCH_trajectory.jsonl")).readlines()
    row = json.loads(lines[0])
    no_rows = dict(row)
    no_rows.pop("rows")
    no_ts = dict(row, _ts="yesterday")
    return lines + ["not json\n", json.dumps({"schema": "x"}) + "\n",
                    json.dumps(no_rows) + "\n", json.dumps(no_ts) + "\n"]


@pytest.mark.parametrize("which", ["committed", "mangled", "empty"])
def test_trajectory_validation_matches_the_reference(which, tmp_path):
    if which == "committed":
        lines = open(os.path.join(REPO, "BENCH_trajectory.jsonl")).readlines()
    elif which == "mangled":
        lines = _mangled_trajectory(tmp_path)
    else:
        lines = ["\n"]
    errs = validate.validate_trajectory_lines(lines)
    assert errs == ref_validate.validate_trajectory_lines(lines)
    assert (errs == []) is (which == "committed")
    path = str(tmp_path / "traj.jsonl")
    with open(path, "w") as f:
        f.writelines(lines)
    assert validate.validate_metrics_file(path) \
        == ref_validate.validate_metrics_file(path)


# one record list and one trace doc, shared by both renderers; the
# provenance carries both packages' backend keys, so the headers agree
SHARED_RECORDS = [
    {"schema": "repro.obs/provenance@1", "ts": "2026-01-01T00:00:00",
     "git_sha": "abc", "jax_backend": "cpu", "backend": "cpu",
     "device_kind": "cpu", "jax_version": "0", "torch_version": "0"},
    {"schema": "repro.obs/metric@1", "type": "counter",
     "name": "serve.flush", "labels": {"reason": "full"}, "value": 7},
    {"schema": "repro.obs/metric@1", "type": "gauge",
     "name": "serve.cache.hit_rate", "labels": {"layer": "0"},
     "value": 0.93},
    {"schema": "repro.obs/metric@1", "type": "histogram",
     "name": "serve.latency_s", "labels": {}, "count": 10, "sum": 1.0,
     "mean": 0.1, "min": 0.05, "max": 0.3, "p50": 0.09, "p90": 0.2,
     "p99": 0.3},
    {"schema": "repro.obs/event@1", "name": "bench.row", "us": 5.0},
]
SHARED_TRACE = {"traceEvents": [
    {"ph": "X", "name": "exec.plan.compile", "ts": 0, "dur": 2000,
     "pid": 1, "tid": 1},
    {"ph": "X", "name": "exec.plan.compile", "ts": 0, "dur": 1000,
     "pid": 1, "tid": 1},
    {"ph": "X", "name": "train.step", "ts": 5, "dur": 1500.5, "pid": 1,
     "tid": 1},
    {"ph": "i", "name": "v", "ts": 0, "pid": 1, "tid": 1}],
    "otherData": {"git_sha": "abc", "jax_backend": "cuda",
                  "backend": "cuda", "device_kind": H100}}


def test_summary_text_equals_the_reference(tmp_path):
    assert summary.render_metrics(SHARED_RECORDS) \
        == ref_summary.render_metrics(SHARED_RECORDS)
    for top in (1, 10):
        assert summary.render_trace(SHARED_TRACE, top=top) \
            == ref_summary.render_trace(SHARED_TRACE, top=top)
    assert summary.span_stats(SHARED_TRACE) \
        == ref_summary.span_stats(SHARED_TRACE)
    assert summary.render_metrics([]) == ref_summary.render_metrics([])
    # the header prints the port's key
    port_only = [dict(SHARED_RECORDS[0], backend="cuda",
                      jax_backend="tpu")]
    assert "backend=cuda" in summary.render_metrics(port_only)
    jsonl = str(tmp_path / "m.jsonl")
    with open(jsonl, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in SHARED_RECORDS)
    trace = str(tmp_path / "t.json")
    json.dump(SHARED_TRACE, open(trace, "w"))
    for path, kind in ((jsonl, "metrics"), (trace, "trace")):
        assert summary.load_file(path) == ref_summary.load_file(path)
        assert summary.load_file(path)[0] == kind
    assert summary.main([jsonl, trace, "--top", "3"]) == 0
    assert summary.main([str(tmp_path / "missing.json")]) == 1


def test_provenance_names_the_resolved_device(monkeypatch):
    """A ``cpu`` run stamps ``cpu`` whatever the machine holds; a ``cuda``
    run stamps the card's name (``torch.cuda.get_device_name``), and
    asking for ``cuda`` without a card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    cpu = obs.provenance("cpu")
    assert (cpu["backend"], cpu["device_kind"]) == ("cpu", "cpu")
    cuda = obs.provenance("cuda")
    assert (cuda["backend"], cuda["device_kind"]) == ("cuda", H100)
    assert set(cuda) == {"schema", "ts", "git_sha", "device_kind",
                         "backend", "torch_version", "cuda_version",
                         "power_limit_w", "platform"}
    assert cuda["schema"] == obs.SCHEMA_PROVENANCE == "repro.obs/provenance@1"
    assert cuda["torch_version"] == torch.__version__
    assert cuda["power_limit_w"] == export.power_limit_w("cuda")
    assert cuda["git_sha"] == obs.git_sha()
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            obs.provenance("cuda")


def test_power_limit_reads_nvidia_smi_once(monkeypatch):
    """``power_limit_w`` is nvidia-smi's text for the device's card, read
    once a process, and ``"unknown"`` where it cannot be read."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append((cmd, kw.get("timeout")))
        return type("R", (), {"returncode": 0,
                              "stdout": "700.00\n350.00\n"})()

    export._power_limits.cache_clear()
    monkeypatch.setattr(export.subprocess, "run", fake_run)
    try:
        assert export.power_limit_w("cuda") == "700.00"
        assert export.power_limit_w("cuda:1") == "350.00"
        assert export.power_limit_w("cuda:2") == "unknown"
        assert calls == [(["nvidia-smi", "--query-gpu=power.limit",
                           "--format=csv,noheader,nounits"], 5)]
    finally:
        export._power_limits.cache_clear()
    monkeypatch.setattr(export.subprocess, "run",
                        lambda *a, **k: (_ for _ in ()).throw(OSError()))
    try:
        assert export.power_limit_w("cuda") == "unknown"
    finally:
        export._power_limits.cache_clear()


def test_observed_run_writes_both_files_on_error(tmp_path):
    """A run that raises inside ``observed_run`` still leaves both files
    (valid, stamped ``cpu``), and its exception is not swallowed."""
    m, t = str(tmp_path / "m.jsonl"), str(tmp_path / "t.json")
    logged = []
    with pytest.raises(ZeroDivisionError):
        with obs.observed_run(m, t, log=logged.append, device="cpu",
                              extra_events=[obs.event("drill")]):
            obs.counter("t.before").inc()
            with obs.span("t.span"):
                1 / 0
    assert validate.main([m, t]) == 0
    head = json.loads(open(m).readline())
    assert head["backend"] == "cpu" and head["device_kind"] == "cpu"
    doc = json.load(open(t))
    assert doc["otherData"]["backend"] == "cpu"
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"] \
        == ["t.span"]
    names = [json.loads(ln)["name"] for ln in open(m).readlines()[1:]]
    assert names == ["drill", "t.before"]
    assert len(logged) == 2 and not obs.tracing()


def test_observed_run_raises_on_an_unwritable_path(tmp_path):
    bad = str(tmp_path / "missing-dir" / "m.jsonl")
    with pytest.raises(OSError):
        with obs.observed_run(bad, None, log=lambda s: None, device="cpu"):
            pass


def test_validate_cli(tmp_path, capsys):
    m = str(tmp_path / "m.jsonl")
    with obs.enabled_scope():
        obs.counter("t.c").inc()
        obs.dump_metrics_jsonl(m, device="cpu")
    assert validate.main([m]) == 0
    assert validate.main([]) == 2
    bad = str(tmp_path / "bad.json")
    json.dump({"notTraceEvents": []}, open(bad, "w"))
    assert validate.main([bad]) == 1
    assert "INVALID" in capsys.readouterr().out


def test_trace_device_sig_of_a_cuda_run_is_the_cache_signature(
        monkeypatch, tmp_path):
    """A trace stamped by a ``cuda`` run names exactly the signature the
    card's autotune entries are keyed by."""
    from repro_torch.obs.audit import trace_device_sig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    path = str(tmp_path / "t.json")
    with obs.tracing_to(path, other_data=obs.provenance("cuda")):
        pass
    doc = json.load(open(path))
    assert trace_device_sig(doc) == port_autotune.device_sig("cuda") \
        == "cuda-NVIDIA-H100-80GB-HBM3"
    cpu = {"otherData": obs.provenance("cpu")}
    assert trace_device_sig(cpu) == port_autotune.device_sig("cpu") == "cpu"


CLI_SCRIPT = r"""
import runpy, sys
for mod, argv in (("summary", [sys.argv[1]]), ("validate", [sys.argv[1]]),
                  ("audit", ["--device", "cpu", "--no-write",
                             "--cache-dir", sys.argv[2]]),
                  ("regress", ["show", sys.argv[3]])):
    sys.argv = ["-m"] + argv
    try:
        runpy.run_module("repro_torch.obs." + mod, run_name="__main__")
    except SystemExit as e:
        print(f"{mod} exit {e.code}")
print("jax" in sys.modules, any(m == "repro" or m.startswith("repro.")
                                for m in sys.modules))
"""


def test_the_four_clis_run_as_modules_without_jax(tmp_path):
    """``python -m repro_torch.obs.{summary,validate,audit,regress}`` run
    on the CPU, in an interpreter that never imports jax or repro."""
    import subprocess
    import sys
    m = str(tmp_path / "m.jsonl")
    with obs.enabled_scope():
        obs.counter("t.c").inc()
        obs.dump_metrics_jsonl(m, device="cpu")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-c", CLI_SCRIPT, m, str(tmp_path / "cache"),
         os.path.join(REPO, "BENCH_trajectory.jsonl")],
        capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert [ln for ln in lines if " exit " in ln] == [
        "summary exit 0", "validate exit 0", "audit exit 0",
        "regress exit 0"]
    assert lines[-1] == "False False"
    assert f"OK {m}" in r.stdout and "counters (1):" in r.stdout
