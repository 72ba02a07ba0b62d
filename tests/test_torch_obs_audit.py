"""The port's cost-model audit (``repro_torch.obs.audit``) against the
reference's: the same calibration table, misranks, Spearman and findings
on the same evidence; the same observations from an autotune cache the
port wrote on the CPU; the table it saves read back by the port's cold DP;
the CLI's ``--device`` (the port's ``device_sig()`` answers ``"cuda"``
without a card, while the CPU's entries are keyed ``"cpu"``).

Tolerances: none. Both audits do the same numpy arithmetic on the same
floats, so tables, findings and report lines are compared exactly (the
table's ``_ts`` is the wall clock and is left out).  One report line
differs by design: the port's roofline line names the H100's 3.35 TB/s,
the reference's its TPU target's rate.
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

from repro.obs import audit as ref_audit
from repro_torch.exec import gcn_chain
from repro_torch.exec.forward import build_cost_oracle
from repro_torch.obs import audit

from _torch_parity import random_graph, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
at = importlib.import_module("repro_torch.exec.autotune")


def _observations(mod):
    """One seeded evidence list: two rank groups, layer and graph classes,
    a bucketed class, and a pair the model misranks by 3x."""
    rng = np.random.default_rng(0)
    out = []
    cands = [("update_first", False, "cuda", 128, True),
             ("aggregate_first", True, "cuda", 128, True),
             ("update_first", False, "cuda", 256, False),
             ("aggregate_first", False, "coo", 128, True),
             ("update_first", False, "cuda", 128, True, "128@7+256")]
    for group in ("g1:layer:1433x16", "g1:layer:16x7"):
        for cand in cands:
            model = float(rng.uniform(1e5, 1e6))
            us = float(model * rng.lognormal(-3.0, 0.6))
            out.append(mod.Observation(
                group=group, ckey=mod.cand_class(cand), label=str(cand),
                us=us, model=model, source="cache"))
    out.append(mod.Observation(group="g2:d16", ckey=mod.class_key(
        "cuda", 128, True), label="graph a", us=10.0, model=100.0,
        source="trace"))
    out.append(mod.Observation(group="g2:d16", ckey=mod.class_key(
        "coo", 128, True), label="graph b", us=30.0, model=50.0,
        source="trace"))
    return out


def _no_ts(table):
    return {k: v for k, v in table.items() if k != "_ts"}


def _report_lines(text):
    return [ln for ln in text.splitlines() if "HBM roofline" not in ln]


@pytest.mark.parametrize("tol", [1.25, 2.0])
def test_calibration_misranks_and_report_equal_the_reference(tol):
    mine = audit.compute_calibration(_observations(audit), "cuda-X", tol=tol)
    theirs = ref_audit.compute_calibration(_observations(ref_audit),
                                           "cuda-X", tol=tol)
    assert _no_ts(mine) == _no_ts(theirs)
    assert mine["misranks"] and mine["groups"]
    assert audit.find_misranks(_observations(audit), tol) \
        == ref_audit.find_misranks(_observations(ref_audit), tol)
    findings = [{"kind": "forward_dp_lost_race", "dp_us": 3.0,
                 "greedy_us": 1.0, "slowdown": 3.0, "winner": "greedy"}]
    text = audit.render_report(mine, findings, tol=tol)
    ref_text = ref_audit.render_report(theirs, findings, tol=tol)
    assert _report_lines(text) == _report_lines(ref_text)
    roof = [ln for ln in text.splitlines() if "HBM roofline" in ln]
    bps = 1e6 / mine["global_ratio"]
    assert roof == [f"  implied {bps / 1e9:.2f} GB-equiv/s vs the H100's "
                    f"3350 GB/s HBM roofline ({bps / 3.35e12:.1%}; CPU "
                    "hosts are expected to sit far below it)"]
    empty = audit.compute_calibration([], "cpu")
    assert _no_ts(empty) == _no_ts(ref_audit.compute_calibration([], "cpu"))
    assert audit.render_report(empty, []) \
        == ref_audit.render_report(ref_audit.compute_calibration([], "cpu"),
                                   [])


@pytest.mark.parametrize("x,y", [
    ([1, 2, 3, 4], [10, 20, 30, 40]),
    ([1, 2, 2, 3], [3, 1, 1, 0]),
    ([5, 5, 5], [1, 2, 3]),
    ([1.5], [2.0]),
    (list(np.random.default_rng(1).normal(size=20)),
     list(np.random.default_rng(2).normal(size=20)))])
def test_spearman_and_ranks_equal_the_reference(x, y):
    assert audit.spearman(x, y) == ref_audit.spearman(x, y)
    assert np.array_equal(audit._rankdata(np.asarray(x)),
                          ref_audit._rankdata(np.asarray(x)))


@pytest.mark.parametrize("name", ["BENCH_exec_pr3.json",
                                  "BENCH_forward_pr5.json",
                                  "BENCH_exec_pr9.json"])
def test_bench_findings_equal_the_reference(name):
    with open(os.path.join(REPO, name)) as f:
        doc = json.load(f)
    for tol in (1.25, 1.05):
        assert audit.bench_findings(doc, tol) \
            == ref_audit.bench_findings(doc, tol)
    if name == "BENCH_exec_pr3.json":
        assert any(f["kind"] == "compacted_grid_slower"
                   for f in audit.bench_findings(doc))


def _trial(us, model, order="update_first", **extra):
    args = {"backend": "cuda", "bm": 128, "compact": True, "order": order,
            "fuse": False, "us": us, "model_cost": model, "n": 2708,
            "e": 10556, "d_in": 1433, "d_out": 16, "mode": "gcn"}
    args.update(extra)
    return {"ph": "X", "name": "exec.autotune.trial", "ts": 0, "dur": us,
            "pid": 1, "tid": 0, "args": args}


TRACE = {"traceEvents": [
    _trial(50.0, 100.0), _trial(80.0, 120.0, order="aggregate_first"),
    _trial(999.0, 100.0, failed=True),
    _trial(40.0, 90.0, buckets="128@7+256"),
    {"ph": "X", "name": "exec.autotune.trial", "ts": 0, "dur": 1, "pid": 1,
     "tid": 0, "args": {"backend": "coo", "bm": 128, "compact": True,
                        "us": 12.0, "model_cost": 30.0, "d": 16, "n": 5,
                        "e": 9, "mode": "gcn"}},
    {"ph": "i", "name": "exec.forward.verdict", "ts": 0, "pid": 1, "tid": 0,
     "args": {"source": "greedy", "us": 10.0,
              "table": {"dp": 30.0, "greedy": 10.0}}},
    {"ph": "i", "name": "exec.forward.verdict", "ts": 0, "pid": 1, "tid": 0,
     "args": {"source": "dp", "us": 9.0, "table": {"dp": 9.0,
                                                    "greedy": 10.0}}}],
    "otherData": {"backend": "cuda", "jax_backend": "cuda",
                  "device_kind": "NVIDIA H100 80GB HBM3"}}


def test_trace_evidence_equals_the_reference():
    for tol in (1.25, 3.5):
        assert audit.forward_verdict_findings(TRACE, tol) \
            == ref_audit.forward_verdict_findings(TRACE, tol)
    mine = audit.observations_from_trace(TRACE)
    theirs = ref_audit.observations_from_trace(TRACE)
    assert len(mine) == 4
    assert [vars(o) for o in mine] == [vars(o) for o in theirs]
    # the port reads its own provenance key, the reference its own
    assert audit.trace_device_sig(TRACE) \
        == ref_audit.trace_device_sig(TRACE) == "cuda-NVIDIA-H100-80GB-HBM3"
    assert audit.trace_device_sig({"otherData": {"jax_backend": "cpu"}}) \
        is None
    assert audit.trace_device_sig({}) is None


@pytest.fixture(scope="module")
def cpu_cache(tmp_path_factory):
    """An autotune cache the port's tuner wrote on the CPU: two layers'
    trial tables and one aggregation-only table on a small graph."""
    d = str(tmp_path_factory.mktemp("exec-cache"))
    g = to_port(random_graph(n=300, e=2000, seed=0))
    for d_in, d_out, relu in ((32, 16, True), (16, 8, False)):
        at.autotune_layer(g, d_in, d_out, "gcn", relu=relu, bias=True,
                          cache_dir=d, iters=1, device="cpu")
    at.autotune(g, 16, "gcn", cache_dir=d, iters=1, device="cpu")
    return g, d


def test_observations_from_a_port_written_cache(cpu_cache):
    _, d = cpu_cache
    with open(os.path.join(d, "autotune.json")) as f:
        entries = json.load(f)
    rows = sum(len(e["table"]) for e in entries.values())
    assert {e["device_sig"] for e in entries.values()} == {"cpu"}
    mine = audit.observations_from_cache(d, sig="cpu")
    assert len(mine) == rows > 0
    assert all(o.source == "cache" and o.us > 0 and o.model > 0
               for o in mine)
    # the reference re-models the same rows with its own cost model
    theirs = ref_audit.observations_from_cache(d, sig="cpu")
    assert [vars(o) for o in mine] == [vars(o) for o in theirs]
    # the trap: the default signature is the card's, which keys nothing
    # here (without a card ``device_sig()`` answers "cuda")
    if not torch.cuda.is_available():
        assert at.device_sig() == "cuda"
        assert audit.observations_from_cache(d) == []


def test_audit_cli_writes_a_table_the_cold_dp_takes(cpu_cache, capsys):
    g, d = cpu_cache
    assert audit.main(["--cache-dir", d, "--device", "cpu",
                       "--no-write"]) == 0
    assert not os.path.exists(audit.calibration_path(d))
    assert audit.main(["--cache-dir", d, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device_sig=cpu" in out and "calibration table written" in out
    table = audit.load_calibration("cpu", d)
    n_rows = len(audit.observations_from_cache(d, sig="cpu"))
    assert table["n_obs"] == n_rows and table["device_sig"] == "cpu"
    assert audit.load_calibration("cuda", d) is None
    # the cold DP rescales each class by the table's ratio
    specs = gcn_chain([32, 16, 8])
    oracle = build_cost_oracle(g, specs, cache_dir=d, platform="cpu",
                               use_cache=False)
    assert oracle.class_scale == audit.class_ratios(table)
    cand = next(c for c in oracle.cands[0]
                if audit.cand_class(c) in oracle.class_scale)
    from repro_torch.exec.forward import model_layer_cost
    assert oracle.node_cost(0, cand) == model_layer_cost(
        g.num_nodes, g.num_valid_edges, specs[0], cand) \
        * table["classes"][audit.cand_class(cand)]["ratio"]
    # a second save replaces only this device's entry
    other = dict(table, device_sig="cuda-NVIDIA-H100-80GB-HBM3")
    audit.save_calibration(other, d)
    assert audit.load_calibration("cpu", d)["n_obs"] == n_rows
    assert audit.load_calibration("cuda-NVIDIA-H100-80GB-HBM3", d)


def test_audit_cli_on_a_trace_and_the_cuda_default(tmp_path, capsys):
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump(TRACE, f)
    cache = str(tmp_path / "cache")
    assert audit.main([path, "--cache-dir", cache, "--device", "cpu"]) == 0
    table = audit.load_calibration("cuda-NVIDIA-H100-80GB-HBM3", cache)
    assert table["n_obs"] == 4
    assert "forward_dp_lost_race" in capsys.readouterr().out
    assert audit.main([str(tmp_path / "missing.json"), "--device",
                       "cpu"]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            audit.main(["--cache-dir", cache])
