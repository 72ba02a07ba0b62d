"""The GAT cell (``gat-reddit.full``) on the CPU at a small size: its work
counts by hand and their independence of the plan's hub split and walk
geometry, the driver's ``shape()``, the blocked reference against an
unblocked one, whole runs (sound ones correct, planted faults caught),
and a program without the fused GAT path stopping at once; on the card
(``-m cuda``), the program's spans and the attention readers of a few
profiled steps."""
import json
import sys

import pytest
import torch

from ._small import ROOT, manifest  # noqa: F401  (puts the checkout on the path)
from h100bench import run as bench_run
from h100bench.drivers import gnn_full
from h100bench.harness import peaks
from h100bench.metrics import _gat_work as work
from h100bench.reference import gat_full as reference
from h100bench.tools import limits as limits_tool

CELL = "gat-reddit.full"
BENCH = manifest.load_benchmark()
SEED = 2 ** 31 + 11


def small_config(nodes=1200, edges=24000, feat=24, width=8, classes=6):
    cfg = manifest.load_config(BENCH, "gat-reddit")
    cfg["graph"].update(num_nodes=nodes, num_edges=edges, feat_dim=feat,
                        num_classes=classes)
    cfg["dims"] = [feat, width, width, classes]
    return cfg


def small_spec(**kw):
    return manifest.cell_spec(BENCH, CELL, config=small_config(**kw))


def _session(spec=None, seed=SEED):
    drv = manifest.driver("gat_full")
    s = drv.Session(spec or small_spec(), seed, torch.device("cpu"),
                    log=lambda m: None)
    s.setup()
    return s


# ------------------------------------------------------------- counts
def test_gat_counts_by_hand():
    shape = {"dims": [10, 4, 4, 3], "heads": [2, 2, 3], "num_nodes": 100,
             "num_edges": 400, "self_loops": True}
    assert work.layers(shape) == [(10, 2, 4), (8, 2, 4), (8, 3, 3)]
    e = 500
    assert work.entries(shape) == e
    dense = (2 * 2 * 100 * 10 * 8 + 3 * 2 * 100 * 8 * 8
             + 3 * 2 * 100 * 8 * 9)
    assert work.dense_flops(shape) == dense
    fwd = sum(2 * e * h * f + work.SCORE_FLOPS_FWD * e * h
              for h, f in ((2, 4), (2, 4), (3, 3)))
    bwd = sum(4 * e * h * f + work.SCORE_FLOPS_BWD * e * h
              for h, f in ((2, 4), (2, 4), (3, 3)))
    assert work.attention_flops(shape, False) == fwd
    assert work.attention_flops(shape, True) == bwd
    assert work.model_flops(shape) == dense + fwd + bwd
    lists = 4 * (e + 101)
    assert work.attention_bytes(shape, False) == [
        4 * (2 * 100 * 8 + 3 * 100 * 2) + lists] * 2 + [
        4 * (2 * 100 * 9 + 3 * 100 * 3) + lists]
    assert work.attention_bound_s(shape, True) == pytest.approx(sum(
        max(f / peaks.PEAK_FLOPS_FP32, b / peaks.HBM_BW) for f, b in zip(
            (4 * e * 8 + 10 * e * 2, 4 * e * 8 + 10 * e * 2,
             4 * e * 9 + 10 * e * 3),
            work.attention_bytes(shape, True))))


def test_the_cell_counts_by_hand():
    shape = {"dims": [602, 256, 256, 6], "heads": [4, 4, 6],
             "num_nodes": 58241, "num_edges": 28653973, "self_loops": True}
    e = 28653973 + 58241
    assert work.dense_flops(shape) == pytest.approx(0.5229e12, rel=1e-3)
    assert work.attention_flops(shape, False) == pytest.approx(
        2 * e * (1024 + 1024 + 36) + 7 * e * (4 + 4 + 6))


def test_counts_do_not_move_with_the_plan(monkeypatch):
    """The plan's hub split and walk blocks change; the shape the counts
    read, and so every count, do not."""
    from repro_torch.kernels import spmm_blockell as sk
    a = _session()
    monkeypatch.setattr(sk, "HUB_ENTRIES", 8)
    monkeypatch.setattr(sk, "WALK_ROWS", 2)
    b = _session()
    assert a.plan.describe()["hubs"] == 0 < b.plan.describe()["hubs"]
    assert a.shape() == b.shape()
    for backward in (False, True):
        assert work.attention_bound_s(a.shape(), backward) == \
            work.attention_bound_s(b.shape(), backward)
    assert work.model_flops(a.shape()) == work.model_flops(b.shape())


def test_driver_shape():
    s = _session()
    assert s.shape() == {"family": "gat_full", "model": "gat",
                         "dims": [24, 8, 8, 6], "heads": [4, 4, 6],
                         "self_loops": True, "num_nodes": 1200,
                         "num_edges": int(s.topo["src"].shape[0])}
    assert s.plan.nnz == s.shape()["num_edges"] + 1200
    assert set(s.readings) == {"graph_s", "reorder_s", "plan_build_s"}


# ---------------------------------------------------------- reference
def test_blocked_reference_matches_unblocked(monkeypatch):
    s = _session()
    whole = s.reference()
    monkeypatch.setattr(reference, "EDGE_BLOCK_BYTES", 4 * 32 * 500)
    graph = reference.Graph(s.topo["src"], s.topo["dst"], 1200,
                            torch.device("cpu"))
    assert len(graph.blocks(32)) > 20
    blocked = s.reference()
    for a, b in zip(whole["losses"], blocked["losses"]):
        assert a == pytest.approx(b, rel=1e-6)
    for key in ("grad", "change"):
        for x, y in zip(whole[key], blocked[key]):
            scale = max(float(y.abs().max()), 1e-30)
            assert float((x - y).abs().max()) <= 1e-5 * scale, key


# --------------------------------------------------------------- runs
def _run(capsys, trace=0, seed=SEED):
    args = bench_run.parse_args(["--workload", CELL, "--seed", str(seed),
                                 "--seconds", "0.3", "--trace", str(trace)])
    rc = bench_run.run(args, device="cpu", config=small_config())
    out = capsys.readouterr()
    assert rc == 0, out.err
    return json.loads(out.out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(capsys, trace):
    res = _run(capsys, trace)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        assert {"plan_build_s", "reorder_s", "plan_tiles_s",
                "plan_upload_s", "gat_step_mfu_pct"} <= set(res["metrics"])
        # no device here: the kernels' readers find nothing to read
        assert "gat_attention_share_pct" not in res["metrics"]
    else:
        assert {"step_ms", "step_p95_ms", "setup_s"} <= set(res["metrics"])


def _state_unchanged(drv, monkeypatch):
    real = drv.make_train_step

    def make(loss_fn, opt, clip_norm=None):
        step = real(loss_fn, opt, clip_norm=clip_norm, donate=False)
        return lambda p, s, b: (p, s, step(p, s, b)[2])
    monkeypatch.setattr(drv, "make_train_step", make)


def _half_batch(drv, monkeypatch):
    real = drv._fused_path

    def fused_path():
        build, loss = real()
        return build, lambda *a, **kw: loss(*a[:4], gnn_full.half_batch(a[4]),
                                            *a[5:], **kw)
    monkeypatch.setattr(drv, "_fused_path", fused_path)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_faults_are_caught(fault, capsys, monkeypatch):
    fault(manifest.driver("gat_full"), monkeypatch)
    res = _run(capsys)
    assert res["correct"] is False, res["checks"]


def test_control_fails_the_limits():
    spec = small_spec()
    lim = spec["limits"]["limits"]
    line = limits_tool.seed_readings(spec, 5, torch.device("cpu"), True)
    assert all(line["program"][k] <= lim[k] for k in lim), line
    assert any(line["control"][k] > lim[k] for k in lim), line
    assert any(line["half_batch"][k] > lim[k] for k in lim), line


def test_a_program_without_the_fused_path_stops_at_once(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.exec.gat", None)
    drv = manifest.driver("gat_full")
    s = drv.Session(small_spec(), SEED, torch.device("cpu"))
    with pytest.raises(SystemExit, match="fused GAT path"):
        s.setup()
    assert not hasattr(s, "topo")           # before the graph is drawn


GAT_STEP_SPANS = {"train.forward", "train.backward", "train.clip",
                  "train.update", "exec.gat.layer", "exec.gat.layer.backward"}


@pytest.mark.cuda
def test_program_spans_and_readers_on_the_card():
    """Set-up under the program's tracer records ``exec.gat.plan``; two
    profiled steps record the step's and the layers' spans (the backward's
    under ``train.backward``), the attention readers read between 0 and
    100, and the step never synchronises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import types

    from h100bench.harness import devtrace
    from repro_torch import obs

    dev = torch.device("cuda")
    spec = small_spec(nodes=20000, edges=400000, feat=64, width=32)
    session = manifest.driver("gat_full").Session(spec, SEED, dev,
                                                  log=lambda s: None)
    tracer = obs.start_trace()
    try:
        session.setup()
    finally:
        obs.stop_trace()
    assert "exec.gat.plan" in {ev["name"] for ev in tracer.events}
    try:
        trace = devtrace.profile_steps(session.step, 2)
        spans = obs.profiled_spans().spans
        assert {sp.name for sp in spans} == GAT_STEP_SPANS
        by_id = {sp.id: sp for sp in spans}
        for sp in spans:
            if sp.name == "exec.gat.layer.backward":
                assert by_id[sp.parent].name == "train.backward"
        assert [(sp.args["layer"], sp.args["heads"], sp.args["width"])
                for sp in spans if sp.name == "exec.gat.layer"] == [
            (0, 4, 32), (1, 4, 32), (2, 6, 6)] * 2
        ctx = types.SimpleNamespace(trace=trace, shape=session.shape())
        for name in ("gat_attention_roofline_pct",
                     "gat_attention_bwd_roofline_pct",
                     "gat_attention_share_pct"):
            value = manifest.metric_reader(name).read(ctx)
            assert value is not None and 0 < value < 100, (name, value)
        assert manifest.metric_reader("program_idle_pct").read(ctx) >= 0

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
