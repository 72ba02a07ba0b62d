"""The port's regression gate (``repro_torch.obs.regress``, numpy only)
against the reference's: the same bootstrap intervals from the same seed,
the same comparisons of the committed `BENCH_exec_pr9.json` and its
recheck, the same report text, the same CLI exit codes.

Tolerances: none. Both sides draw from ``np.random.default_rng(seed)`` in
the same order, so every ratio, interval and verdict is compared exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.obs import regress as ref_regress
from repro_torch.obs import regress, validate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _doc(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def _row(name, median_us, seed, n=12):
    s = (median_us * np.random.default_rng(seed).lognormal(0.0, 0.1, n))
    return {"name": name, "us_per_call": float(np.median(s)),
            "samples": s.tolist()}


def _asdicts(comps):
    return [dataclasses.asdict(c) for c in comps]


@pytest.mark.parametrize("seed", [0, 7])
def test_compare_docs_on_the_pr9_recheck_equals_the_reference(seed):
    base = _doc("BENCH_exec_pr9.json")
    cur = _doc("BENCH_exec_pr9_recheck.json")
    mine = regress.compare_docs(base, cur, seed=seed)
    theirs = ref_regress.compare_docs(base, cur, seed=seed)
    assert _asdicts(mine) == _asdicts(theirs)
    assert any(c.ci_lo is not None for c in mine)     # bootstrapped rows
    for thr in (regress.DEFAULT_THRESHOLD, 1.05):
        assert regress.render_comparisons(mine, thr) \
            == ref_regress.render_comparisons(theirs, thr)


def test_bootstrap_ratio_and_rows_equal_the_reference():
    a, b = _row("x", 100.0, 1), _row("x", 180.0, 2)
    for kw in ({}, {"n_boot": 300, "seed": 3, "conf": 0.9}):
        assert regress.bootstrap_ratio(a["samples"], b["samples"], **kw) \
            == ref_regress.bootstrap_ratio(a["samples"], b["samples"], **kw)
    few = dict(b, samples=b["samples"][:2])
    for base, cur in ((a, b), (a, few), (a, {"name": "x", "ms": 3.0}),
                      (dict(a, samples=None), dict(b, samples=None))):
        assert dataclasses.asdict(regress.compare_rows(base, cur)) \
            == dataclasses.asdict(ref_regress.compare_rows(base, cur))
    for rec in (a, {"graph": "cora", "mode": "gcn", "us": 3},
                {"zzz": 1}):
        assert regress.row_id(rec) == ref_regress.row_id(rec)
        assert regress.row_time(rec) == ref_regress.row_time(rec)


def test_trajectory_row_and_append(tmp_path):
    doc = _doc("BENCH_exec_pr9.json")
    mine = regress.trajectory_row(doc, "BENCH_exec_pr9.json")
    theirs = ref_regress.trajectory_row(doc, "BENCH_exec_pr9.json")
    for r in (mine, theirs):
        r.pop("_ts")
    # the port's rows carry the provenance's ``backend``, the reference's
    # ``jax_backend``; everything else is the same
    assert mine.pop("backend") == doc["provenance"].get("backend")
    theirs.pop("jax_backend")
    assert mine == theirs and mine["schema"] == regress.SCHEMA_TRAJECTORY
    path = str(tmp_path / "traj.jsonl")
    regress.append_trajectory(doc, path, "BENCH_exec_pr9.json")
    regress.append_trajectory(doc, path, "BENCH_exec_pr9.json")
    with open(path) as f:
        lines = f.readlines()
    assert len(lines) == 2 and validate.validate_trajectory_lines(lines) == []


def _write(tmp_path, name, rows):
    p = str(tmp_path / name)
    with open(p, "w") as f:
        json.dump({"bench": "t", "provenance": {"git_sha": "s"},
                   "results": rows}, f)
    return p


def test_cli_exit_codes_equal_the_reference(tmp_path, capsys):
    base = _write(tmp_path, "base.json", [_row("a", 100.0, 0)])
    slow = _write(tmp_path, "slow.json", [_row("a", 300.0, 1)])
    same = _write(tmp_path, "same.json", [_row("a", 100.0, 2)])
    cases = [["compare", base, slow, "--boot", "300"],
             ["compare", base, slow, "--boot", "300", "--warn-only"],
             ["compare", base, same, "--boot", "300"],
             ["compare", base, str(tmp_path / "missing.json")],
             ["append", base, "--trajectory", str(tmp_path / "p.jsonl")],
             ["append", str(tmp_path / "missing.json")],
             ["show", os.path.join(REPO, "BENCH_trajectory.jsonl")],
             ["show", str(tmp_path / "missing.jsonl")]]
    codes = []
    for argv in cases:
        mine = regress.main(argv)
        out_mine = capsys.readouterr().out
        theirs = ref_regress.main(
            [a.replace("p.jsonl", "r.jsonl") for a in argv])
        out_theirs = capsys.readouterr().out
        assert mine == theirs, argv
        if argv[0] == "compare":
            assert out_mine == out_theirs
        codes.append(mine)
    assert codes == [1, 0, 0, 2, 0, 2, 0, 2]
    assert regress.main(["show", str(tmp_path / "p.jsonl")]) == 0
    assert "backend=None" in capsys.readouterr().out


def test_cli_module_entrypoint(tmp_path):
    base = _write(tmp_path, "base.json", [_row("a", 100.0, 0)])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs.regress",
                        "compare", base, base],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "regression gate" in r.stdout
