"""Whole runs of ``run.py`` on the CPU at a small size: a sound run is
correct; the control and the planted faults are not; no module of JAX or
of the JAX package is loaded."""
import json
import subprocess
import sys
import types

import pytest
import torch

from ._small import ROOT, WORKLOADS, manifest, small_config, small_spec
from h100bench import run as bench_run
from h100bench.tools import limits as limits_tool


def _run(workload, capsys, seed=2 ** 31 + 3, seconds=0.3, trace=0):
    args = bench_run.parse_args(["--workload", workload, "--seed", str(seed),
                                 "--seconds", str(seconds), "--trace",
                                 str(trace)])
    rc = bench_run.run(args, device="cpu", config=small_config(workload))
    out = capsys.readouterr()
    assert rc == 0, out.err
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload, capsys):
    res, err = _run(workload, capsys)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(res)[-1] == "checks"
    assert {"step_ms", "step_p95_ms", "setup_s"} <= set(res["metrics"])
    lines = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and " limit " in line
               for line in lines)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run(workload, capsys):
    res, _ = _run(workload, capsys, trace=1)
    assert res["correct"] is True
    assert {"plan_build_s", "reorder_s", "step_mfu_pct"} <= set(res["metrics"])
    assert "busy_s" in res["device"] and "window_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _state_unchanged(drv, monkeypatch):
    real = drv.make_train_step

    def make(loss_fn, opt, clip_norm=None):
        step = real(loss_fn, opt, clip_norm=clip_norm, donate=False)
        return lambda p, s, b: (p, s, step(p, s, b)[2])
    monkeypatch.setattr(drv, "make_train_step", make)


def _half_batch(drv, monkeypatch):
    for name in ("sage_loss", "gcn_loss"):
        real = getattr(drv, name)
        monkeypatch.setattr(drv, name, lambda *a, _real=real, **kw: _real(
            *a[:4], drv.half_batch(a[4]), *a[5:], **kw))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_faults_are_caught(workload, fault, capsys, monkeypatch):
    drv = manifest.driver("gnn_full")
    fault(drv, monkeypatch)
    res, _ = _run(workload, capsys)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limits(workload):
    """The reference in the program's place with TF32 products (rounded
    operands on the CPU) reads above a limit; the program does not."""
    spec = small_spec(workload)
    lim = spec["limits"]["limits"]
    line = limits_tool.seed_readings(spec, 5, torch.device("cpu"), True)
    assert all(line["program"][k] <= lim[k] for k in lim), line
    assert any(line["control"][k] > lim[k] for k in lim), line
    assert any(line["half_batch"][k] > lim[k] for k in lim), line


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limits_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the control runs cuBLAS in TF32)")
    spec = small_spec(workload, nodes=20000, edges=80000, feat=512,
                      hidden=64)
    lim = spec["limits"]["limits"]
    line = limits_tool.seed_readings(spec, 5, torch.device("cuda"), True)
    assert all(line["program"][k] <= lim[k] for k in lim), line
    assert any(line["control"][k] > lim[k] for k in lim), line


def test_forbidden_names_are_whole(monkeypatch):
    assert "repro_torch" in {k.split(".")[0] for k in sys.modules}
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("f"))
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("f"))
    assert bench_run.forbidden_modules() == ["jaxlib", "repro"]


def test_no_jax_in_a_run():
    """A whole CPU run in a fresh process loads no module of JAX or of the
    JAX package, by whole top-level name."""
    script = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / "h100bench" / "tests")!r})
from h100bench import run
from h100bench.tests._small import small_config
args = run.parse_args(["--workload", "gcn-citeseer-s.full", "--seed", "9",
                       "--seconds", "0.2", "--trace", "1"])
rc = run.run(args, device="cpu", config=small_config("gcn-citeseer-s.full"))
print(json.dumps({{"rc": rc, "top": sorted({{m.split(".")[0]
                                             for m in sys.modules}})}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["rc"] == 0
    assert "repro_torch" in last["top"]
    assert not set(last["top"]) & {"jax", "jaxlib", "flax", "repro"}


def test_no_result_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = bench_run.main(["--workload", WORKLOADS[0], "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""


def test_no_result_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder has no program to run: the run fails and prints no result."""
    import os
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    script = f"""
import sys
sys.path.insert(0, {str(tmp_path)!r})
from h100bench import run
args = run.parse_args(["--workload", "gcn-citeseer-s.full", "--seed", "9",
                       "--seconds", "0.2", "--trace", "0"])
sys.exit(run.run(args, device="cpu"))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "repro_torch" in out.stderr
