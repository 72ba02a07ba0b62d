"""``repro_torch/chaos/drill.py`` against ``repro/chaos/drill.py``.

Held, one parametrised case per gauntlet (each side runs
``run_gauntlets`` once, on its own registry): the same fault schedules
(``describe()``), summaries equal under the backend-name map (the port's
``cuda → torch → coo`` for the reference's ``pallas → jnp → coo``; the
dist gauntlet at one part, the reference's ``jax.device_count()`` here),
and every counter equal outside ``TIMING_COUNTERS`` (names mapped the same
way).  Then the CLI: ``python -m repro_torch.chaos.drill --seed 0 --device
cpu`` (the whole drill, twice, with its determinism checks) and
``--gauntlet elastic`` exit 0.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import obs as ref_obs
from repro.chaos import drill as ref_drill
from repro_torch import obs
from repro_torch.chaos import drill

ROOT = Path(__file__).resolve().parents[1]


def _mapped(x):
    """The reference's backend names in a summary or counter key, as the
    port's."""
    if isinstance(x, dict):
        return {_mapped(k): _mapped(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_mapped(v) for v in x]
    if isinstance(x, str):
        for old, new in (("pallas_launch", "\0"), ("pallas", "cuda"),
                         ("jnp", "torch"), ("\0", "pallas_launch")):
            x = x.replace(old, new)
        return x
    return x


@pytest.fixture(autouse=True)
def _exec_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_EXEC_CACHE", str(tmp_path / "exec"))


@pytest.mark.parametrize("gauntlet", drill.GAUNTLETS)
def test_gauntlet_matches_the_reference(gauntlet, tmp_path):
    quiet = lambda *a: None
    ref_obs.reset()
    ref_obs.enable()
    (tmp_path / "ref").mkdir()
    want = ref_drill.run_gauntlets(0, str(tmp_path / "ref"), quiet,
                                   which=(gauntlet,))
    obs.reset()
    obs.enable()
    (tmp_path / "port").mkdir()
    got = drill.run_gauntlets(0, str(tmp_path / "port"), quiet,
                              which=(gauntlet,), device="cpu")
    try:
        assert got["schedules"] == want["schedules"]
        assert got["summary"] == _mapped(want["summary"])
        assert got["counters"] == _mapped(want["counters"])
        assert drill.TIMING_COUNTERS == ref_drill.TIMING_COUNTERS
        assert drill.SCHEDULE_SPEC == ref_drill.SCHEDULE_SPEC
    finally:
        obs.reset()
        obs.disable()
        ref_obs.reset()
        ref_obs.disable()


@pytest.mark.parametrize("args", [[], ["--gauntlet", "elastic"]],
                         ids=["full", "elastic"])
def test_cli_exits_zero_on_the_cpu(args, tmp_path):
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", ""),
           "HOME": os.environ.get("HOME", ""),
           "TMPDIR": os.environ.get("TMPDIR", "/tmp"),
           "REPRO_TORCH_EXEC_CACHE": str(tmp_path / "exec")}
    m = str(tmp_path / "m.jsonl")
    r = subprocess.run([sys.executable, "-m", "repro_torch.chaos.drill",
                        "--seed", "0", "--device", "cpu", "--metrics-out",
                        m, *args], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "chaos drill: PASS" in r.stdout
    from repro_torch.obs import validate
    assert validate.validate_metrics_file(m) == []
