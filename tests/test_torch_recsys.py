"""The wide & deep slice of the port against the reference's.

Parameters come from the reference's ``widedeep_init`` through
``params_from_jax``, and both sides get the same numpy inputs, at
``REDUCED`` (the launcher's config) and at a narrower test config:

* logits, loss, every gradient, ``user_tower`` and ``retrieval_score``
  against the reference, each within 1e-5 of its array's largest entry
  (fp32 sums of up to 1293 terms in another order), for both lookups:
  ``bag`` (``kernels.ops.embedding_bag``, forward and the table's gradient
  on the transposed bag list) and ``dense`` (the reference model's take +
  segment-sum); ``bag`` against ``dense`` to the same bar;
* ``recsys_batches`` byte-equal for 3 steps; 5 ``fit`` steps within 1e-4
  of the reference's ``fit`` (fp32 rounding carried through Adam); the
  ``RecsysBundle`` step functions against the reference's at all four
  shapes; the launcher on the CPU;
* the serving session: ``features`` byte-equal, ``gather`` within 1e-5 of
  the reference's, and the engine run of the reference's
  ``test_widedeep_session_serves_through_engine`` (oracle below 1e-4,
  cache hits).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.families import RecsysBundle as RefBundle
from repro.configs.wide_deep import REDUCED as REF_REDUCED
from repro.models import recsys as ref_recsys
from repro.serve import make_session as ref_make_session
from repro.train import adam as ref_adam
from repro.train import fit as ref_fit
from repro.train import recsys_batches as ref_recsys_batches
from repro_torch.configs import RECSYS_SHAPES, get
from repro_torch.configs.base import NOT_PORTED
from repro_torch.configs.families import RecsysBundle
from repro_torch.configs.wide_deep import REDUCED
from repro_torch.convert import params_from_jax
from repro_torch.kernels import embedding_bag as kb
from repro_torch.launch import train as train_launcher
from repro_torch.models import recsys
from repro_torch.serve import (EmbeddingCache, MicroBatcher, ServeEngine,
                               WideDeepSession, make_session, zipfian_trace)
from repro_torch.train import adam, fit, recsys_batches, tree_leaves

from _torch_parity import assert_bytes_equal

TOL = 1e-5
NARROW = dict(n_sparse=5, rows_per_field=40, embed_dim=8, n_dense=3,
              mlp_dims=(16, 8))


def _configs(name):
    ref = (REF_REDUCED if name == "reduced"
           else ref_recsys.WideDeepConfig(**NARROW))
    port = recsys.WideDeepConfig(**{
        f.name: getattr(ref, f.name)
        for f in dataclasses.fields(ref) if "dtype" not in f.name})
    return ref, port


def _close(got, ref, what="", tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, f"{what}: {got.shape} != {ref.shape}"
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


@pytest.fixture(scope="module", params=["narrow", "reduced"])
def setup(request):
    ref_cfg, cfg = _configs(request.param)
    ref_params = ref_recsys.widedeep_init(jax.random.PRNGKey(3), ref_cfg)
    rng = np.random.default_rng(7)
    B = 24
    batch = {"sparse": rng.integers(0, cfg.rows_per_field,
                                    (B, cfg.n_sparse)).astype(np.int32),
             "dense": rng.standard_normal((B, cfg.n_dense)
                                          ).astype(np.float32),
             "labels": (rng.random(B) > 0.5).astype(np.float32),
             "cand": rng.standard_normal((100, cfg.mlp_dims[-1])
                                         ).astype(np.float32)}
    return ref_cfg, cfg, ref_params, batch


def _port_params(ref_params, grad=False):
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                        device="cpu")
    if grad:
        for leaf in tree_leaves(p):
            leaf.requires_grad_(True)
    return p


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("lookup", recsys.LOOKUPS)
def test_logits_loss_and_tower_match_reference(setup, lookup):
    ref_cfg, cfg, ref_params, b = setup
    j = {k: jnp.asarray(v) for k, v in b.items()}
    p, t = _port_params(ref_params), _t(b)
    _close(recsys.widedeep_logits(p, t["sparse"], t["dense"], cfg, lookup),
           ref_recsys.widedeep_logits(ref_params, j["sparse"], j["dense"],
                                      ref_cfg), "logits")
    _close(recsys.widedeep_loss(p, t["sparse"], t["dense"], t["labels"], cfg,
                                lookup),
           ref_recsys.widedeep_loss(ref_params, j["sparse"], j["dense"],
                                    j["labels"], ref_cfg), "loss")
    _close(recsys.user_tower(p, t["sparse"], t["dense"], cfg, lookup),
           ref_recsys.user_tower(ref_params, j["sparse"], j["dense"],
                                 ref_cfg), "user_tower")
    _close(recsys.retrieval_score(p, t["sparse"][:1], t["dense"][:1],
                                  t["cand"], cfg, lookup),
           ref_recsys.retrieval_score(ref_params, j["sparse"][:1],
                                      j["dense"][:1], j["cand"], ref_cfg),
           "retrieval_score")


def _paths(tree, prefix=""):
    """{"table": leaf, "deep/0/w": leaf, ...} of a nested dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _port_grads(ref_params, b, cfg, lookup):
    p, t = _port_params(ref_params, grad=True), _t(b)
    loss = recsys.widedeep_loss(p, t["sparse"], t["dense"], t["labels"], cfg,
                                lookup)
    loss.backward()
    return {k: leaf.grad for k, leaf in _paths(p).items()}


@pytest.mark.parametrize("lookup", recsys.LOOKUPS)
def test_gradients_match_jax_grad(setup, lookup):
    ref_cfg, cfg, ref_params, b = setup
    j = {k: jnp.asarray(v) for k, v in b.items()}
    ref_grads = jax.grad(lambda p: ref_recsys.widedeep_loss(
        p, j["sparse"], j["dense"], j["labels"], ref_cfg))(ref_params)
    ref_leaves = _paths(ref_grads)
    got = _port_grads(ref_params, b, cfg, lookup)
    assert set(got) == set(ref_leaves)
    for k, g in got.items():
        _close(g, ref_leaves[k], f"grad {k}")


def test_bag_lookup_matches_dense_lookup(setup):
    _, cfg, ref_params, b = setup
    p, t = _port_params(ref_params), _t(b)
    logits = {lk: recsys.widedeep_logits(p, t["sparse"], t["dense"], cfg, lk)
              for lk in recsys.LOOKUPS}
    _close(logits["bag"], logits["dense"].numpy(), "logits bag vs dense")
    grads = {lk: _port_grads(ref_params, b, cfg, lk)
             for lk in recsys.LOOKUPS}
    for k, g in grads["bag"].items():
        _close(g, grads["dense"][k].numpy(), f"grad {k} bag vs dense")
    with pytest.raises(ValueError, match="unknown lookup"):
        recsys.widedeep_logits(p, t["sparse"], t["dense"], cfg, "sparse")


def test_params_from_jax_carries_the_recsys_tree():
    ref_cfg, cfg = _configs("narrow")
    ref_params = ref_recsys.widedeep_init(jax.random.PRNGKey(0), ref_cfg)
    p = _port_params(ref_params)
    assert set(p) == {"table", "wide", "wide_dense", "deep"}
    assert p["table"].shape == (cfg.total_rows, cfg.embed_dim)
    assert p["wide"].shape == (cfg.total_rows,)
    assert len(p["deep"]) == len(cfg.mlp_dims) + 1
    assert_bytes_equal(p["table"].numpy(), np.asarray(ref_params["table"]))
    assert cfg.param_count() == ref_cfg.param_count() == sum(
        leaf.numel() for leaf in tree_leaves(p))


def test_seeded_init_matches_the_reference_shapes():
    ref_cfg, cfg = _configs("narrow")
    ref_params = ref_recsys.widedeep_init(jax.random.PRNGKey(0), ref_cfg)
    p = RecsysBundle(cfg).init_params(torch.Generator().manual_seed(0),
                                      device="cpu")
    ref_leaves = jax.tree_util.tree_leaves(ref_params)
    assert sorted(tuple(leaf.shape) for leaf in tree_leaves(p)) == sorted(
        tuple(leaf.shape) for leaf in ref_leaves)
    assert abs(float(p["table"].std()) * np.sqrt(cfg.embed_dim) - 1) < 0.1


def test_recsys_batches_are_byte_equal():
    ref_it, it = ref_recsys_batches(REF_REDUCED, 64, seed=5), recsys_batches(
        REDUCED, 64, seed=5)
    for step in range(3):
        a, b = next(ref_it), next(it)
        assert a["step"] == b["step"] == step
        for k in ("sparse", "dense", "labels"):
            assert_bytes_equal(b[k], a[k], f"step {step} {k}")


def test_fit_matches_reference_fit():
    """Five steps of the launcher's training (batch 256, adam(1e-3), clip
    1.0) from the reference's weights."""
    ref_params = ref_recsys.widedeep_init(jax.random.PRNGKey(0), REF_REDUCED)
    params = _port_params(ref_params)     # the reference's fit donates them
    ref_loss = lambda p, b: ref_recsys.widedeep_loss(
        p, jnp.asarray(b["sparse"]), jnp.asarray(b["dense"]),
        jnp.asarray(b["labels"]), REF_REDUCED)
    ref = ref_fit(ref_loss, ref_adam(1e-3), ref_params,
                  ref_recsys_batches(REF_REDUCED, 256), steps=5,
                  log=lambda s: None)
    t = torch.as_tensor
    loss = lambda p, b: recsys.widedeep_loss(
        p, t(b["sparse"]), t(b["dense"]), t(b["labels"]), REDUCED)
    got = fit(loss, adam(1e-3), params,
              recsys_batches(REDUCED, 256), steps=5, log=lambda s: None)
    assert got.steps == 5
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)


@pytest.mark.parametrize("shape", list(RECSYS_SHAPES))
def test_bundle_step_fns_match_reference(shape):
    ref_cfg, cfg = _configs("narrow")
    ref_bundle, bundle = RefBundle(ref_cfg), RecsysBundle(cfg)
    ref_params = ref_recsys.widedeep_init(jax.random.PRNGKey(1), ref_cfg)
    batch = bundle.make_batch(shape, torch.Generator().manual_seed(2),
                              device="cpu")
    specs = bundle.input_specs(shape)
    ref_specs = ref_bundle.input_specs(shape)
    assert set(specs) == set(ref_specs)
    for k, (shp, dtype) in specs.items():
        assert tuple(batch[k].shape) == shp == tuple(ref_specs[k].shape)
        assert str(batch[k].dtype).split(".")[1] == str(ref_specs[k].dtype)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    p = _port_params(ref_params)
    if RECSYS_SHAPES[shape]["kind"] == "train":
        ref_step = ref_bundle.step_fn(shape)
        ref_state = ref_adam(1e-3).init(ref_params)
        ref_new, _, ref_loss = ref_step(ref_params, ref_state, jb)
        new, state, loss = bundle.step_fn(shape)(
            p, bundle.optimizer().init(p), batch)
        _close(loss, ref_loss, "train loss")
        assert int(state["step"]) == 1
        _close(new["table"], ref_new["table"], "updated table")
        _close(new["deep"][0]["w"], ref_new["deep"][0]["w"], "updated w")
    else:
        _close(bundle.step_fn(shape)(p, batch),
               ref_bundle.step_fn(shape)(ref_params, jb), shape)


def test_launcher_trains_wide_deep_on_cpu(capsys):
    res = train_launcher.main(["--arch", "wide-deep", "--steps", "3",
                               "--device", "cpu"])
    assert res.steps == 3 and np.all(np.isfinite(res.losses))
    assert "wide-deep: 3 steps" in capsys.readouterr().out
    assert "wide-deep" not in NOT_PORTED
    assert isinstance(get("wide-deep").bundle(), RecsysBundle)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_launcher.main(["--arch", "wide-deep", "--steps", "1"])


def test_launcher_lookups_agree_on_cpu():
    """The launcher's run on the ``dense`` lookup, as ``chip_smoke.py`` holds
    the card's ``bag`` run to it."""
    runs = {lk: train_launcher.recsys_driver("wide-deep", 3, device="cpu",
                                             lookup=lk).losses
            for lk in recsys.LOOKUPS}
    np.testing.assert_allclose(runs["bag"], runs["dense"], rtol=1e-5)


def _sessions(num_users=256):
    ref = ref_make_session("wide_deep", None, num_users=num_users, seed=0)
    sess = make_session("wide_deep", None, num_users=num_users, device="cpu",
                        params=_port_params(ref.params))
    return ref, sess


def test_session_features_and_gather_match_reference():
    ref, sess = _sessions()
    assert isinstance(sess, WideDeepSession)
    assert sess.num_layers == 0 and sess.layer_dims == ref.layer_dims
    ids = np.array([0, 5, 17, 255, 3, 3, 200], np.int64)
    for a, b in zip(sess.features(ids), ref.features(ids)):
        assert_bytes_equal(a, b, "features")
    _close(sess.gather(ids), ref.gather(ids), "gather")
    _close(sess.layer_values(0), ref.layer_values(0), "layer_values")
    with pytest.raises(ValueError, match="layer 0 only"):
        sess.layer_values(1)


def test_widedeep_session_serves_through_engine():
    """The reference's engine test (``tests/test_serve.py``) on the port."""
    sess = make_session("wide_deep", None, num_users=256, seed=0,
                        device="cpu")
    cache = EmbeddingCache(sess.layer_dims, capacity_bytes=64_000,
                           line_size=1, num_nodes=256)
    eng = ServeEngine(sess, cache, MicroBatcher(max_batch=8, max_wait=1e-3))
    rep = eng.serve(zipfian_trace(256, 120, a=1.3, seed=4))
    assert rep.max_oracle_err < 1e-4
    assert rep.cache.hits > 0
    assert kb.embedding_bag.launches == 0        # CPU: the plain version
