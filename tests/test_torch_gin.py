"""The port's GIN against the reference's (``repro/models/sage_gin.py``).

* A small GIN (3 convs) on the three structural graphs: the loss and the
  gradient of every parameter, each conv's ε included, through the port's
  ``fused`` (self-coefficient layer plans on the ``cuda`` backend: on CPU
  tensors the plain version of ``spmm_blockell_update_compact``),
  ``blockell`` and ``segment`` executors, against ``jax.grad`` of the
  reference's ``gin_loss(executor="segment")``.  Held to 1e-5 of the
  largest entry of each compared array (fp32 sums in another order).
* Full-width GIN in the paper's configuration (1433 → 128 × 5 convs → 7) on
  the MinHash-reordered Cora, the schedule the reference's DP picks (conv 1
  update-first, convs 2-5 fused): step 0's loss and gradients against the
  reference to 1e-5 of the largest entry, then 5 ``fit`` steps of
  ``adam(1e-2)``.  Those losses are held to a relative 1e-3, not 1e-4:
  this run is chaotic (the loss jumps from 66 to 2202 on step 1), Adam's
  first steps move every weight by ±lr whatever the size of its gradient,
  and the reference's own fused jnp executor parts from its own segment
  executor by more than 1e-3 relative within those 5 steps from the same
  parameters (``test_reference_executors_part_on_full_width_gin``).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import minhash_reorder as ref_minhash
from repro.exec import build_layer_plan as ref_build_layer_plan
from repro.graph import cora_like as ref_cora_like
from repro.models.sage_gin import gin_init as ref_gin_init
from repro.models.sage_gin import gin_loss as ref_gin_loss
from repro.train import adam as ref_adam
from repro.train import fit as ref_fit
from repro_torch.convert import params_from_jax
from repro_torch.exec import build_layer_plan, build_plan
from repro_torch.models import gin_init, gin_loss
from repro_torch.train import adam, fit

from _torch_parity import GRAPHS, to_port

TOL = 1e-5
FIT_RTOL = 1e-3


def _assert_close_scaled(got, ref, what):
    """|got - ref| <= TOL * max(1, max|ref|) entrywise."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


def _grad_pairs(port, ref, path=""):
    """(path, port grad, reference grad) for every leaf, walked by key."""
    if isinstance(port, dict):
        for k in port:
            yield from _grad_pairs(port[k], ref[k], f"{path}.{k}")
    elif isinstance(port, (list, tuple)):
        for i, (a, b) in enumerate(zip(port, ref)):
            yield from _grad_pairs(a, b, f"{path}[{i}]")
    else:
        yield path, port.grad, ref


def _leaf_params(tree):
    if isinstance(tree, dict):
        return {k: _leaf_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaf_params(v) for v in tree)
    return tree.detach().clone().requires_grad_()


def _layer_plans(g, d_in, d_hidden, n_conv, bm):
    plans, gplan = [], None
    for i in range(n_conv):
        lp = build_layer_plan(g, "sum", d_in=d_in if i == 0 else d_hidden,
                              d_out=d_hidden, order="auto", bm=bm,
                              backend="cuda", gplan=gplan, device="cpu")
        plans.append(lp)
        gplan = lp.gplan
    return plans


def _ref_params(d_in, d_hidden, n_conv, n_classes, eps_seed):
    """The reference's init, with nonzero ε so dc is not taken at ε = 0."""
    p = ref_gin_init(jax.random.PRNGKey(0), d_in, d_hidden, n_conv,
                     n_classes)
    rng = np.random.default_rng(eps_seed)
    for c in p["convs"]:
        c["eps"] = jnp.asarray(rng.uniform(-0.3, 0.3), jnp.float32)
    return p


def _small_inputs(g):
    n = g.num_nodes
    rng = np.random.default_rng(2)
    return (rng.standard_normal((n, 12)).astype(np.float32),
            rng.integers(0, 4, n).astype(np.int32), rng.random(n) < 0.5)


@functools.lru_cache(maxsize=None)
def _small_reference(gname):
    """The reference's loss and gradients on one graph (shared by the
    three executors' tests)."""
    g = GRAPHS[gname]
    x, labels, mask = _small_inputs(g)
    graph = {"src": jnp.asarray(g.src), "dst": jnp.asarray(g.dst)}
    return jax.value_and_grad(ref_gin_loss)(
        _ref_params(12, 16, 3, 4, eps_seed=1), jnp.asarray(x), graph,
        jnp.asarray(labels), jnp.asarray(mask))


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("executor", ["fused", "blockell", "segment"])
def test_small_gin_loss_and_grads_match_reference(gname, executor):
    g = GRAPHS[gname]
    x, labels, mask = _small_inputs(g)
    port_p = _leaf_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray,
                               _ref_params(12, 16, 3, 4, eps_seed=1)),
        device="cpu"))
    ref_loss, ref_grads = _small_reference(gname)

    pg = to_port(g)
    plan = None
    if executor == "fused":
        plan = _layer_plans(pg, 12, 16, 3, bm=32)
        # conv 1 grows 12 -> 16: aggregate-first, so it fuses too
        assert [lp.fuse for lp in plan] == [True, True, True]
    elif executor == "blockell":
        plan = build_plan(pg, "sum", bm=32, backend="cuda", device="cpu")
    t = lambda a: torch.as_tensor(a)
    tgraph = {"src": t(g.src.astype(np.int64)),
              "dst": t(g.dst.astype(np.int64))}
    loss = gin_loss(port_p, t(x), tgraph, t(labels), t(mask),
                    executor=executor, plan=plan)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=TOL)
    for path, got, want in _grad_pairs(port_p, ref_grads):
        _assert_close_scaled(got.numpy(), want, f"d{path}")


def test_gin_init_matches_the_paper_config():
    p = gin_init(torch.Generator().manual_seed(0), 1433, 128, 5, 7,
                 device="cpu")
    assert len(p["convs"]) == 5
    assert p["convs"][0]["mlp"][0]["w"].shape == (1433, 128)
    assert all(c["mlp"][1]["w"].shape == (128, 128) for c in p["convs"])
    assert all(c["eps"].shape == () and float(c["eps"]) == 0.0
               for c in p["convs"])
    assert p["lin1"]["w"].shape == (128, 128)
    assert p["lin2"]["w"].shape == (128, 7)


def _ref_full_width_setup():
    g_ref = ref_cora_like().permute(ref_minhash(ref_cora_like()))
    batch = {"x": jnp.asarray(g_ref.node_feat), "src": jnp.asarray(g_ref.src),
             "dst": jnp.asarray(g_ref.dst),
             "labels": jnp.asarray(g_ref.labels % 7),
             "mask": jnp.asarray(g_ref.train_mask)}

    def ref_loss_fn(p, b, executor="segment", plan=None):
        return ref_gin_loss(p, b["x"], {"src": b["src"], "dst": b["dst"]},
                            b["labels"], b["mask"], executor=executor,
                            plan=plan)
    return g_ref, batch, ref_loss_fn


def test_reference_executors_part_on_full_width_gin():
    """Why the full-width losses are held to 1e-3, not 1e-4: from the same
    parameters the reference's own fused (jnp layer plans) and segment
    executors part by more than 1e-3 relative within 5 Adam steps."""
    g_ref, batch, ref_loss_fn = _ref_full_width_setup()
    plans, gplan = [], None
    for d_in in [1433, 128, 128, 128, 128]:
        lp = ref_build_layer_plan(g_ref, "sum", d_in=d_in, d_out=128, bm=128,
                                  backend="jnp", gplan=gplan)
        plans.append(lp)
        gplan = lp.gplan
    losses = {}
    for executor, plan in (("segment", None), ("fused", plans)):
        p = ref_gin_init(jax.random.PRNGKey(0), 1433, 128, 5, 7)
        losses[executor] = np.asarray(ref_fit(
            lambda p, b: ref_loss_fn(p, b, executor, plan), ref_adam(1e-2),
            p, iter(lambda: batch, None), steps=5, log=lambda s: None).losses)
    rel = np.abs(losses["fused"] - losses["segment"]) / np.abs(
        losses["segment"])
    assert rel[0] < TOL                 # the same parameters at step 0
    assert rel.max() > FIT_RTOL, rel


def test_full_width_gin_training_matches_reference():
    g_ref, batch, ref_loss_fn = _ref_full_width_setup()
    ref_p = ref_gin_init(jax.random.PRNGKey(0), 1433, 128, 5, 7)
    port_p = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_p),
                             device="cpu")
    ref_loss0, ref_grads = jax.value_and_grad(ref_loss_fn)(ref_p, batch)
    ref = ref_fit(ref_loss_fn, ref_adam(1e-2), ref_p,
                  iter(lambda: batch, None), steps=5, log=lambda s: None)

    from repro_torch.core import minhash_reorder
    from repro_torch.graph import cora_like
    g = cora_like().permute(minhash_reorder(cora_like()))
    plans = _layer_plans(g, 1433, 128, 5, bm=128)
    assert [(lp.order, lp.fuse) for lp in plans] == (
        [("update_first", False)] + [("aggregate_first", True)] * 4)
    tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}

    def loss_fn(p, b):
        return gin_loss(p, b["x"], None, b["labels"], b["mask"],
                        executor="fused", plan=plans)

    p0 = _leaf_params(port_p)
    loss0 = loss_fn(p0, tb)
    loss0.backward()
    np.testing.assert_allclose(float(loss0.detach()), float(ref_loss0),
                               rtol=TOL)
    for path, got, want in _grad_pairs(p0, ref_grads):
        _assert_close_scaled(got.numpy(), want, f"d{path}")

    res = fit(loss_fn, adam(1e-2), port_p, iter(lambda: tb, None), steps=5,
              log=lambda s: None)
    assert all(np.isfinite(res.losses))
    np.testing.assert_allclose(res.losses, ref.losses, rtol=FIT_RTOL)
