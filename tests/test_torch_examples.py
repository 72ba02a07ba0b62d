"""The port's copies of the reference's examples.

* ``examples/reorder_study_torch.py`` prints the reference's
  ``examples/reorder_study.py`` output line for line (host numpy: the
  graphs, reorders, the G-D cache model and the shared-set plans are
  byte-equal to the reference's);
* ``examples/serve_recsys_torch.py`` holds its ``embedding_bag`` path
  within 1e-4 of the dense lookup on the CPU and prints the reference's
  lines;
* ``examples/train_sage_reddit_torch.py`` saves an asynchronous checkpoint
  at step 100, as the reference's example does.
"""
import importlib.util
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_reorder_study_prints_the_reference_rows(capsys):
    _load("reorder_study").main()
    want = capsys.readouterr().out.splitlines()
    _load("reorder_study_torch").main()
    got = capsys.readouterr().out.splitlines()
    assert len(want) == 13              # the header and 12 rows
    assert got == want


def test_serve_recsys_bag_path_matches_dense(capsys):
    out = _load("serve_recsys_torch").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert out["max_err"] <= 1e-4
    assert "embedding_bag path matches dense lookup" in text
    assert "batch=   64:" in text and "batch=  512:" in text
    assert len(out["top5"]) == 5 and "retrieval top-5 candidates" in text


def test_train_sage_reddit_checkpoints_every_100_steps(monkeypatch, capsys):
    module = _load("train_sage_reddit_torch")
    saved = []

    class Recording(module.AsyncCheckpointer):
        def save(self, step, params, opt_state, extra=None):
            saved.append(step)
            super().save(step, params, opt_state, extra)

    monkeypatch.setattr(module, "AsyncCheckpointer", Recording)
    losses = module.main(["--steps", "101", "--scale", "0.005", "--device",
                          "cpu"])
    assert saved == [100]
    assert len(losses) == 101 and all(np.isfinite(losses))
    assert "final loss" in capsys.readouterr().out
