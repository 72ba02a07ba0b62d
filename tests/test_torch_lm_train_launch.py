"""The launcher's LM path and the bundle's training step against the
reference's (the rest of the LM training parity tests is
``tests/test_torch_lm_train.py``, whose helpers and tolerances this file
takes; split so that pytest-xdist's ``--dist loadfile`` spreads the two
over workers).

* ``launch.train --arch {granite-8b, minitron-8b, mistral-large-123b}
  --steps 10 --device cpu`` from the reference's parameters: losses within
  1e-4 of the reference's ``lm_reduced_driver``; ``--ckpt`` resumes from
  the latest checkpoint.
* ``LMBundle.step_fn("train_4k")`` on a (2, 64) batch within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs.families import LMBundle as RefLMBundle
from repro.launch import train as ref_launch
from repro_torch.configs import granite_8b
from repro_torch.configs.families import LMBundle
from repro_torch.launch import train as train_launcher
from repro_torch.models import transformer as tf
from repro_torch.train import (adam, checkpoint, lm_token_batches,
                               make_train_step, tree_leaves)

from test_torch_lm_train import (ARCHS, LOSS_TOL, TOL, _assert_trees_close,
                                 _close, _port_params, _ref_paths, _tokens,
                                 ref_params)


# -------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", list(ARCHS))
def test_launcher_trains_the_lms_like_the_reference(ref_params, arch,
                                                    monkeypatch, capsys):
    port_params = _port_params(ref_params[arch])
    ref = ref_launch.lm_reduced_driver(arch, 10, None)
    monkeypatch.setattr(train_launcher, "lm_init",
                        lambda gen, cfg, device="cuda": port_params)
    res = train_launcher.main(["--arch", arch, "--steps", "10",
                               "--device", "cpu"])
    assert res.steps == 10 and len(res.losses) == 10
    np.testing.assert_allclose(res.losses, ref.losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert res.losses[-1] < res.losses[0]
    assert f"{arch}: 10 steps, loss" in capsys.readouterr().out


def test_launcher_ckpt_resumes_from_the_latest_step(tmp_path, capsys):
    """``--ckpt``: a 3-step run saves step 2; a 6-step run resumes at step
    3 from that checkpoint (parameters and Adam state: its losses equal
    three more steps of the first run's final state), drawing batches from
    the start of the stream as the reference's loop does; a third run
    finds nothing to do."""
    d = str(tmp_path / "ck")
    argv = ["--arch", "granite-8b", "--device", "cpu", "--ckpt", d]
    first = train_launcher.main(argv + ["--steps", "3"])
    assert checkpoint.available_steps(d) == [2]
    second = train_launcher.main(argv + ["--steps", "6"])
    assert second.steps == 3 and len(second.losses) == 3
    assert checkpoint.available_steps(d) == [5, 2]
    cfg = granite_8b.REDUCED
    t = torch.as_tensor
    step = make_train_step(lambda q, b: tf.lm_loss(
        q, t(b["tokens"]), t(b["targets"]), cfg), adam(1e-3))
    p, state = first.params, first.opt_state
    losses = []
    for _, b in zip(range(3), lm_token_batches(cfg.vocab, 4, 64)):
        p, state, loss = step(p, state, b)
        losses.append(float(loss))
    np.testing.assert_allclose(second.losses, losses, rtol=1e-6)
    third = train_launcher.main(argv + ["--steps", "6"])
    assert third.losses == []
    assert "nothing to train" in capsys.readouterr().out


def test_bundle_train_step_matches_reference(ref_params):
    """One ``train_4k`` step at ``REDUCED`` (the bundle's donated step and
    the functional form of the same step): the loss and the
    new Adam moments within 1e-5; the parameters within 1e-5 of each
    leaf's largest entry wherever the clipped gradient exceeds 100 x eps.
    Adam's first step is -lr g / (|g| + eps), so an entry whose gradient is
    near eps = 1e-8 turns an fp32 rounding of g into a step of up to lr;
    there the parameters are held to lr, the most one step can move them."""
    rc, pc = ARCHS["granite-8b"]
    rp = ref_params["granite-8b"]
    tok, tgt = _tokens(rc.vocab, 2, 64, seed=11)
    ref_bundle, bundle = RefLMBundle(rc), LMBundle(pc)
    rs = ref_bundle.opt().init(rp)
    r_new, r_state, r_loss = ref_bundle.step_fn("train_4k")(
        rp, rs, {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)})
    r_grad = {k: np.abs(np.asarray(m)) / 0.1
              for k, m in _ref_paths(r_state["m"]).items()}
    specs = bundle.input_specs("train_4k", batch=2)
    assert specs == {"tokens": ((2, 4096), torch.int32),
                     "targets": ((2, 4096), torch.int32)}
    lr, eps = 3e-4, 1e-8
    for donate in (True, False):
        p = _port_params(rp)
        ptrs = [t.data_ptr() for t in tree_leaves(p)]
        state = bundle.opt().init(p)
        step = (bundle.step_fn("train_4k") if donate else make_train_step(
            bundle.loss_fn, bundle.opt(), clip_norm=1.0, donate=False))
        new, state, loss = step(p, state, {"tokens": tok, "targets": tgt})
        _close(loss, r_loss, TOL, "loss")
        _assert_trees_close(state, r_state, TOL, f"state (donate={donate})")
        got = dict(checkpoint._paths(new))
        for k, want in _ref_paths(r_new).items():
            want = np.asarray(want)
            err = np.abs(got[k].numpy() - want)
            sharp = r_grad[k] > 100 * eps
            assert err[sharp].max(initial=0) <= TOL * np.abs(want).max(), k
            assert err[~sharp].max(initial=0) <= lr, k
        same = [t.data_ptr() for t in tree_leaves(new)] == ptrs
        assert same == donate


def test_bundle_train_batch_and_opt():
    bundle = LMBundle(granite_8b.REDUCED)
    batch = bundle.make_batch("train_4k", torch.Generator().manual_seed(0),
                              device="cpu", batch=1)
    assert batch["tokens"].shape == batch["targets"].shape == (1, 4096)
    assert batch["tokens"].dtype == torch.int32
    assert int(batch["tokens"].max()) < granite_8b.REDUCED.vocab
    state = LMBundle(granite_8b.REDUCED, moments_dtype=torch.bfloat16
                     ).opt().init({"w": torch.zeros(3)})
    assert state["m"]["w"].dtype == torch.bfloat16
