"""The port's training slice against the reference's.

* ``adam``, ``clip_by_global_norm`` and ``cross_entropy`` against
  ``repro.train`` / ``repro.nn`` on one nested tree, to 1e-6 (fp32
  elementwise arithmetic in the same order);
* full-width gcn-cora on the MinHash-reordered Cora: the port's launcher
  path (``gnn_driver`` with ``--executor fused``: the whole-forward DP's
  plans over the CPU grid) against the reference's ``fit`` over
  ``gcn_loss(executor="segment")`` from the same parameters and batch, 10
  steps, each loss within 1e-4 (fp32 sums in another order over up to 1433
  terms, carried through 10 Adam steps);
* the launcher's command line on the CPU: the default ``auto`` executor and
  ``forward`` tune on a temporary cache and print the verdict and the
  per-layer schedule, a second ``auto`` run reads the cache, and ``fused``
  prints the reference's cold DP schedule.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get as ref_get
from repro.core import minhash_reorder as ref_minhash
from repro.graph import cora_like as ref_cora_like
from repro.nn.layers import cross_entropy as ref_cross_entropy
from repro.train import adam as ref_adam
from repro.train import clip_by_global_norm as ref_clip
from repro.train import fit as ref_fit
from repro_torch.configs import get
from repro_torch.configs.families import GNNBundle
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as train_launcher
from repro_torch.nn.layers import cross_entropy
from repro_torch.train import (adam, apply_updates, clip_by_global_norm,
                               fit, global_norm)

LOSS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    """The launcher tunes into a fresh cache, never the user's."""
    monkeypatch.setenv("REPRO_TORCH_EXEC_CACHE", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_EXEC_CACHE", str(tmp_path / "ref"))


def _tree(seed):
    """A GIN-shaped nested tree: lists of dicts, a 0-d leaf."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"convs": [{"mlp": [{"w": f(5, 4), "b": f(4)},
                               {"w": f(4, 4), "b": f(4)}],
                       "eps": np.float32(rng.standard_normal())}],
            "lin": {"w": f(4, 3), "b": f(3)}}


def _assert_trees_close(port, ref, tol, what=""):
    """Walk both trees by key and index; every leaf within ``tol``."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), what
        for k in port:
            _assert_trees_close(port[k], ref[k], tol, f"{what}.{k}")
    elif isinstance(port, (list, tuple)):
        assert len(port) == len(ref), what
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_trees_close(a, b, tol, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                                   atol=tol, rtol=tol, err_msg=what)


def test_adam_and_clip_match_reference():
    params = _tree(0)
    ref_p = jax.tree_util.tree_map(jnp.asarray, params)
    port_p = params_from_jax(params, device="cpu")
    ref_opt, opt = ref_adam(1e-2), adam(1e-2)
    ref_s, s = ref_opt.init(ref_p), opt.init(port_p)
    for step in range(3):
        grads = _tree(10 + step)
        # scale one step's gradients up so the clip engages
        if step == 1:
            grads = jax.tree_util.tree_map(lambda g: g * 40.0, grads)
        ref_g, ref_norm = ref_clip(jax.tree_util.tree_map(jnp.asarray,
                                                          grads), 1.0)
        g, norm = clip_by_global_norm(params_from_jax(grads, device="cpu"),
                                      1.0)
        np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
        np.testing.assert_allclose(float(global_norm(g)),
                                   min(1.0, float(ref_norm)), rtol=1e-5)
        _assert_trees_close(g, ref_g, 1e-6, "clipped")
        ref_u, ref_s = ref_opt.update(ref_g, ref_s, ref_p)
        u, s = opt.update(g, s, port_p)
        _assert_trees_close(u, ref_u, 1e-6, f"update {step}")
        _assert_trees_close(s["m"], ref_s["m"], 1e-6, "m")
        _assert_trees_close(s["v"], ref_s["v"], 1e-6, "v")
        assert int(s["step"]) == int(ref_s["step"]) == step + 1
        ref_p = jax.tree_util.tree_map(lambda p, d: p + d, ref_p, ref_u)
        port_p = apply_updates(port_p, u)
    _assert_trees_close(port_p, ref_p, 1e-6, "params")


@pytest.mark.parametrize("masked", [True, False])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((50, 7)) * 30).astype(np.float32)
    labels = rng.integers(0, 7, 50).astype(np.int32)
    mask = rng.random(50) < 0.3 if masked else None
    ref = ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None
                            else jnp.asarray(mask, jnp.float32))
    got = cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                        None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_gcn_cora_training_matches_reference(monkeypatch):
    bundle = ref_get("gcn-cora").bundle()
    g = ref_cora_like().permute(ref_minhash(ref_cora_like()))
    ref_params = bundle.init_params(jax.random.PRNGKey(0),
                                    g.node_feat.shape[1])
    # convert first: the reference's fit donates (deletes) its params
    port_params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         ref_params),
                                  device="cpu")
    deg = g.in_degrees().astype(np.float32) + 1.0
    batch = {"src": jnp.asarray(g.src), "dst": jnp.asarray(g.dst),
             "edge_mask": jnp.ones(g.num_edges, bool),
             "labels": jnp.asarray(g.labels % bundle.n_classes),
             "train_mask": jnp.asarray(g.train_mask),
             "x": jnp.asarray(g.node_feat), "deg": jnp.asarray(deg)}
    ref = ref_fit(bundle.loss_fn("full_graph_sm", executor="segment"),
                  ref_adam(1e-2), ref_params, iter(lambda: batch, None),
                  steps=10, log=lambda s: None)

    monkeypatch.setattr(GNNBundle, "init_params",
                        lambda self, gen, d, device="cuda": port_params)
    res = train_launcher.gnn_driver("gcn-cora", 10, executor="fused",
                                    device="cpu")
    assert res.steps == 10
    np.testing.assert_allclose(res.losses, ref.losses, atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert res.losses[-1] < res.losses[0]


def _layer_lines(schedule):
    """The launcher's per-layer lines for a schedule of layer candidates."""
    dims = (1433, 16, 7)
    return [f"layer {i} ({dims[i]}->{dims[i + 1]}): order={c[0]} "
            f"fuse={c[1]} {c[2]} bm={c[3]} compact={c[4]}"
            for i, c in enumerate(schedule)]


def test_launcher_trains_gcn_cora_on_cpu(capsys):
    """``--executor fused`` on the CPU prints the schedule the reference's
    cold whole-forward DP picks over its CPU grid (``jnp`` read as
    ``torch``) and trains."""
    from repro.exec import gcn_chain as ref_gcn_chain
    from repro.exec import plan_forward as ref_plan_forward
    g = ref_cora_like().permute(ref_minhash(ref_cora_like()))
    ref = ref_plan_forward(g, ref_gcn_chain([1433, 16, 7]))
    expected = [tuple({"jnp": "torch"}.get(v, v) if isinstance(v, str)
                      else v for v in c) for c in ref.configs]
    res = train_launcher.main(["--arch", "gcn-cora", "--steps", "3",
                               "--device", "cpu", "--executor", "fused"])
    out = capsys.readouterr().out
    for line in _layer_lines(expected):
        assert line in out
    assert "forward autotune" not in out
    assert "gcn-cora: 3 steps, loss" in out
    assert res.steps == 3 and all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0]


@pytest.mark.parametrize("executor", ["blockell", "segment"])
def test_launcher_other_executors_agree_with_fused(executor):
    """Step 0 sees the same parameters on every executor, so its loss agrees
    to fp32 rounding."""
    fused = train_launcher.main(["--arch", "gcn-cora", "--steps", "1",
                                 "--device", "cpu", "--executor", "fused"])
    other = train_launcher.main(["--arch", "gcn-cora", "--steps", "1",
                                 "--device", "cpu", "--executor", executor])
    np.testing.assert_allclose(other.losses, fused.losses, rtol=1e-5)


@pytest.mark.parametrize("argv,what", [
    ([], None),                          # --executor auto, the default
    (["--executor", "forward"], None),
    (["--dist"], "ROADMAP §1 item 9"),
    (["--ckpt", "CKPT"], None)])
def test_launcher_refuses_what_is_not_ported(argv, what, capsys, tmp_path):
    """``--dist`` raises; ``auto`` and ``forward`` tune the whole forward
    on the CPU grid into the temporary cache, print the verdict and one
    line per layer, and train; a second ``auto`` run reads the verdict from
    the cache and runs no trial.  ``--ckpt`` (ported) trains, saves the
    last step, and the second run resumes past it with nothing left."""
    argv = ["--arch", "gcn-cora", "--steps", "2", "--device", "cpu",
            *[str(tmp_path / "ckpt") if a == "CKPT" else a for a in argv]]
    if what is not None:
        with pytest.raises(NotImplementedError, match=what):
            train_launcher.main(argv)
        return
    res = train_launcher.main(argv)
    out = capsys.readouterr().out
    verdict = [l for l in out.splitlines()
               if l.startswith("forward autotune: schedule=")]
    assert len(verdict) == 1 and "per-layer-greedy" in verdict[0]
    assert "(cached)" not in verdict[0]
    layers = [l for l in out.splitlines() if l.startswith("layer ")]
    assert [l.split(":")[0] for l in layers] == ["layer 0 (1433->16)",
                                                 "layer 1 (16->7)"]
    # the CPU grid: coo and the plain torch engine, never the kernels
    assert all(" coo " in l or " torch " in l for l in layers)
    assert res.losses[-1] < res.losses[0]
    if "--executor" not in argv:
        again = train_launcher.main(argv)
        out2 = capsys.readouterr().out
        assert verdict[0] + " (cached)" in out2
        assert [l for l in out2.splitlines() if l.startswith("layer ")] == \
            layers
        if "--ckpt" in argv:
            from repro_torch.train import checkpoint
            assert checkpoint.available_steps(str(tmp_path / "ckpt")) == [2, 1]
            assert again.losses == [] and "nothing to train" in out2
        else:
            assert again.losses == res.losses


def test_registry_ports_gcn_cora_only():
    """The four GNN archs are ported (``tests/test_torch_gnn_zoo.py``); an
    MoE arch of the reference is an LM spec (``tests/test_torch_lm_moe.py``),
    an unknown arch is a ``KeyError`` and a bundle of an unknown GNN arch
    refuses to build parameters."""
    for arch in ("gcn-cora", "gat-cora", "pna", "nequip"):
        assert get(arch).family == "gnn"
    assert get("granite-moe-3b-a800m").family == "lm"
    with pytest.raises(KeyError):
        get("no-such-arch")
    with pytest.raises(ValueError, match="unknown GNN arch"):
        GNNBundle("gin", {}).init_params(torch.Generator(), 4, device="cpu")


def test_fit_refuses_checkpoints(tmp_path):
    """``fit`` resumes only from a checkpoint of its own tree: one whose
    leaves the parameters lack is unreadable, and ``fit`` raises rather
    than start from the untrained parameters."""
    from repro_torch.train import checkpoint
    checkpoint.save_checkpoint(str(tmp_path), 3, {"v": torch.zeros(2)}, {})
    with pytest.raises(RuntimeError, match="unreadable"):
        fit(lambda p, b: p["w"].sum(), adam(1e-2),
            {"w": torch.zeros(2)}, iter(lambda: None, 0), steps=5,
            ckpt_dir=str(tmp_path))
