"""The full-width half of the GAT / PNA / NequIP parity tests (the rest is
``tests/test_torch_gnn_zoo.py``, whose helpers and tolerances this file
takes; split so that pytest-xdist's ``--dist loadfile`` spreads the two
over workers).

* ``launch.train --arch gat-cora|pna|nequip --device cpu`` at full width on
  the reordered Cora: 10 losses within 1e-4 (relative) of the reference's
  ``gnn_driver`` from the same parameters; a kernel executor raises.
* The launcher's PNA in float64 on both sides (step 0's gradients within
  1e-5, 10 ``fit`` steps within 1e-4), and why: the reference's own fp32
  run parts from its fp64 run by more than 1e-4.  The reference's 10
  float64 steps are computed once for the module.
* Why the card holds GAT's and PNA's fp32 gradients on ``ogb_products`` to
  1e-2: the reference's own fp32 gradients part from its fp64 ones by
  more than 1e-4 there.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get as ref_get
from repro.graph import products_like as ref_products_like
from repro.launch import train as ref_launcher
from repro.train import adam as ref_adam
from repro_torch.configs import get
from repro_torch.configs.families import GNNBundle
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as train_launcher

from test_torch_gnn_zoo import (KEY, LOSS_TOL, TOL, _assert_grads, _close,
                                _leaves, _np)


# ------------------------------------------ fp32 against fp64 on products
def _products_grads(arch, x64):
    """The reference's loss and gradients for ``arch`` on
    ``products_like(0.001)`` at full width, from the port's seed-0
    parameters carried across, in fp64 when ``x64``."""
    ref_bundle = ref_get(arch).bundle()
    g = ref_products_like(scale=0.001)
    arrays = {"src": g.src, "dst": g.dst,
              "edge_mask": np.ones(g.num_edges, bool),
              "labels": (g.labels % ref_bundle.n_classes).astype(np.int32),
              "train_mask": g.train_mask, "x": g.node_feat,
              "deg": g.in_degrees().astype(np.float32) + 1.0}
    port = get(arch).bundle().init_params(torch.Generator().manual_seed(0),
                                          100, device="cpu")
    params = jax.tree_util.tree_map(lambda t: t.numpy(), port)
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), params)
        b = {k: jnp.asarray(v, dt) if v.dtype.kind == "f" else jnp.asarray(v)
             for k, v in arrays.items()}
        loss, grads = jax.value_and_grad(ref_bundle.loss_fn("ogb_products"))(
            p, b)
        return float(loss), [np.asarray(x, np.float64)
                             for x in jax.tree_util.tree_leaves(grads)]


@pytest.mark.parametrize("arch", ["gat-cora", "pna"])
def test_reference_fp32_grads_part_from_fp64_on_products(arch):
    """Why the card holds GAT's and PNA's fp32 gradients on ogb_products to
    1e-2 of each leaf's largest entry against float64, not 1e-4: the
    reference's own fp32 gradients part from its fp64 ones by more than
    1e-4 there (on products_like(0.001), from the port's seed-0 draw).
    GAT: a score at leaky_relu's kink takes the other slope in fp32; PNA:
    ``E[x²] - E[x]²`` cancels in fp32 under ``sqrt(var + 1e-5)``, and
    near-ties at max / min route their gradient to another edge.  The loss
    agrees within 1e-5."""
    l32, g32 = _products_grads(arch, False)
    l64, g64 = _products_grads(arch, True)
    assert abs(l32 - l64) <= 1e-5 * abs(l64)
    gap = max(float(np.abs(a - b).max() / np.abs(b).max())
              for a, b in zip(g32, g64))
    assert 1e-4 < gap < 1e-2, gap


# ---------------------------------------------------------------- launcher
# PNA at full width is chaotic under adam(1e-2) (the loss jumps from 11.5 to
# ~814 on step 1): fp32 rounding alone parts the reference from itself in
# fp64 by more than 1e-4 within 10 steps
# (test_reference_pna_fp32_parts_from_its_fp64_run), so its launcher losses
# are held at step 0 (1e-5) and its 10 steps in float64 on both sides
# (test_full_width_pna_fp64_training_matches_reference); ROADMAP §3.
FP32_STEPS_HELD = {"gat-cora": 10, "nequip": 10, "pna": 1}


@pytest.mark.parametrize("arch", ["gat-cora", "pna", "nequip"])
def test_launcher_trains_like_the_reference(arch, monkeypatch, capsys):
    """``launch.train --arch <arch> --steps 10 --device cpu`` at full width
    (``MODEL_KW``) on the reordered Cora, from the reference's seed-0
    parameters: 10 losses within 1e-4 (relative) of the reference's
    ``gnn_driver`` (PNA: step 0 within 1e-5, the chaos rule above)."""
    ref_bundle = ref_get(arch).bundle()
    ref_params = ref_bundle.init_params(KEY, 1433)
    # convert first: the reference's fit donates (deletes) its params
    port_params = params_from_jax(_np(ref_params), device="cpu")
    ref = ref_launcher.gnn_driver(arch, 10, None)
    monkeypatch.setattr(GNNBundle, "init_params",
                        lambda self, gen, d, device="cuda": port_params)
    res = train_launcher.main(["--arch", arch, "--steps", "10",
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"{arch}: 10 steps, loss" in out
    assert "forward autotune" not in out and "layer 0" not in out
    assert res.steps == 10 and all(np.isfinite(res.losses))
    held = FP32_STEPS_HELD[arch]
    np.testing.assert_allclose(res.losses[:held], ref.losses[:held],
                               rtol=LOSS_TOL if held > 1 else TOL, atol=0)


@functools.lru_cache(maxsize=1)
def _pna_init_numpy():
    """The reference's seed-0 PNA parameters, drawn in fp32 (under x64,
    ``jax.random.normal`` draws another stream)."""
    with jax.enable_x64(False):
        return _np(ref_get("pna").bundle().init_params(KEY, 1433))


def _full_width_pna(dtype):
    """The launcher's PNA problem on both sides in ``dtype``: the reference's
    seed-0 parameters, loss and batch (the reordered Cora)."""
    bundle = get("pna").bundle()
    ref_bundle = ref_get("pna").bundle()
    g = train_launcher.training_graph()
    batch = train_launcher.gnn_batch(g, bundle.n_classes, "cpu")
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
    ref_batch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    ref_params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype=ref_batch["x"].dtype),
        _pna_init_numpy())
    params = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a)), _np(ref_params))
    return (bundle.loss_fn("full_graph_sm"), params, batch,
            ref_bundle.loss_fn("full_graph_sm"), ref_params, ref_batch)


def _ref_fit_losses(loss_fn, params, batch, moments, steps=10):
    from repro.train import fit as ref_fit
    return np.asarray(ref_fit(loss_fn, ref_adam(1e-2, moments_dtype=moments),
                              params, iter(lambda: batch, None), steps=steps,
                              log=lambda s: None).losses)


def test_full_width_pna_step0_grads_match_reference():
    """Step 0's loss and every gradient of the launcher's PNA, in float64 on
    both sides (the cross-entropy is fp32 on both, as the reference takes
    it), within 1e-5.  In fp32 the attenuation scaler of Cora's in-degree-0
    nodes (``2.0 / max(log 1, 1e-5)`` = 2e5 times their std of sqrt(1e-5))
    puts entries of ~630 beside ones of ~1e-3 into the post layer's sums,
    and the two sides' orders of summation part by ~1e-4 of a leaf's
    largest gradient."""
    with jax.enable_x64(True):
        loss_fn, params, batch, ref_loss_fn, ref_params, ref_batch = \
            _full_width_pna(torch.float64)
        ref_loss, ref_grads = jax.value_and_grad(ref_loss_fn)(ref_params,
                                                              ref_batch)
        ref_grads = _np(ref_grads)
    for _, leaf in _leaves(params):
        leaf.requires_grad_()
    loss = loss_fn(params, batch)
    loss.backward()
    _close(loss, ref_loss, "loss")
    _assert_grads(params, ref_grads, "full-width pna")


@pytest.fixture(scope="module")
def pna_fp64_ref_losses():
    """The reference's 10 float64 ``fit`` steps of the launcher's PNA, run
    once for the two tests that hold against them."""
    with jax.enable_x64(True):
        _, _, _, ref_loss_fn, ref_params, ref_batch = _full_width_pna(
            torch.float64)
        return _ref_fit_losses(ref_loss_fn, ref_params, ref_batch,
                               jnp.float64)


def test_reference_pna_fp32_parts_from_its_fp64_run(pna_fp64_ref_losses):
    """Why PNA's 10 launcher steps are held in float64: the reference's own
    fp32 run parts from its fp64 run by more than 1e-4 (relative) within
    them, from the same parameters."""
    runs = {"fp64": pna_fp64_ref_losses}
    with jax.enable_x64(False):
        _, _, _, ref_loss_fn, ref_params, ref_batch = _full_width_pna(
            torch.float32)
        runs["fp32"] = _ref_fit_losses(ref_loss_fn, ref_params, ref_batch,
                                       jnp.float32)
    rel = np.abs(runs["fp32"] - runs["fp64"]) / np.abs(runs["fp64"])
    assert rel[0] < TOL
    assert rel.max() > LOSS_TOL, rel


def test_full_width_pna_fp64_training_matches_reference(
        pna_fp64_ref_losses):
    """10 ``fit`` steps of ``adam(1e-2)`` (float64 moments), clip 1.0, of the
    launcher's PNA in float64 on both sides: within 1e-4 (relative)."""
    from repro_torch.train import adam, fit
    with jax.enable_x64(True):
        loss_fn, params, batch, _, _, _ = _full_width_pna(torch.float64)
    ref = pna_fp64_ref_losses
    res = fit(loss_fn, adam(1e-2, moments_dtype=torch.float64), params,
              iter(lambda: batch, None), steps=10, log=lambda s: None)
    np.testing.assert_allclose(res.losses, ref, rtol=LOSS_TOL, atol=0)


@pytest.mark.parametrize("executor", ["fused", "forward", "blockell"])
def test_launcher_kernel_executor_raises_for_gat(executor):
    """GAT's one kernel executor is ``fused`` (an attention plan over the
    ``gat::`` kernels, their plain versions on the CPU): the launcher's
    losses equal the segment path's at 1e-5.  The others raise."""
    argv = ["--arch", "gat-cora", "--steps", "3", "--device", "cpu"]
    if executor == "fused":
        fused = train_launcher.main(argv + ["--executor", "fused"])
        seg = train_launcher.main(argv + ["--executor", "segment"])
        assert len(fused.losses) == 3
        np.testing.assert_allclose(fused.losses, seg.losses, rtol=1e-5,
                                   atol=0)
        return
    with pytest.raises(ValueError, match="no kernel executor"):
        train_launcher.main(argv + ["--executor", executor])


def test_launcher_segment_executor_is_the_default_path():
    """``auto`` runs the segment path: the same losses, bit for bit.  In
    deterministic mode, since the CPU's accumulating ``index_put_`` (the
    gather's backward) adds in thread order and PNA's chaotic step 1 turns
    that rounding into ~1e-7 of its loss."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        auto = train_launcher.main(["--arch", "pna", "--steps", "2",
                                    "--device", "cpu"])
        seg = train_launcher.main(["--arch", "pna", "--steps", "2",
                                   "--device", "cpu", "--executor",
                                   "segment"])
    finally:
        torch.use_deterministic_algorithms(was)
    assert auto.losses == seg.losses
