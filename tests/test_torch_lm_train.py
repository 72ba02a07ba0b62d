"""The port's LM training slice against the reference's.

* ``lm_loss`` (chunked cross-entropy over the rematerialised backbone) and
  every gradient against ``jax.value_and_grad`` of the reference's
  ``lm_loss``, on the reference's own ``lm_init`` parameters carried over
  by ``convert.params_from_jax``, at granite-8b's and mistral-large's
  ``REDUCED`` configs: with remat (the port's ``lm_loss``) and without
  (``cross_entropy`` over ``lm_forward(remat=False)``), over a sequence
  length that 8 divides (8 loss chunks) and one it does not (1 chunk); 1e-5
  of each array's largest entry (fp32 sums in another order).  A bf16
  variant at 3e-2, the reference's bf16 bar.
* The optimizers (Adam with weight decay and the cosine warm-up schedule,
  Adam with bf16 moments, SGD, LAMB): 5 updates of the functional form and
  of the in-place form, each against the reference's, parameters and fp32
  states within 1e-6, bf16 states within one bf16 ulp.
* ``lm_token_batches`` byte-equal.

The launcher and the bundle's step are ``tests/test_torch_lm_train_launch.py``,
a file of its own so that pytest-xdist's ``--dist loadfile`` spreads the
two over workers; it takes this file's helpers.  The reference's loss and
gradients at each (arch, sequence length) are computed once for the
module and held against both of the port's paths (with and without
remat).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import granite_8b as ref_granite
from repro.configs import minitron_8b as ref_minitron
from repro.configs import mistral_large_123b as ref_mistral
from repro.models import transformer as ref_tf
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro_torch.configs import granite_8b, minitron_8b, mistral_large_123b
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tf
from repro_torch.nn.layers import cross_entropy
from repro_torch.train import (adam, apply_updates, checkpoint,
                               cosine_warmup_schedule, lamb,
                               lm_token_batches, sgd,
                               tree_leaves)
from repro_torch.train.optimizer import tree_unflatten

TOL = 1e-5
BF16_TOL = 3e-2
OPT_TOL = 1e-6
LOSS_TOL = 1e-4
ARCHS = {"granite-8b": (ref_granite.REDUCED, granite_8b.REDUCED),
         "minitron-8b": (ref_minitron.REDUCED, minitron_8b.REDUCED),
         "mistral-large-123b": (ref_mistral.REDUCED,
                                mistral_large_123b.REDUCED)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, tol, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3g}"


def _ref_paths(tree) -> dict:
    """path -> leaf of a JAX tree, spelled as the checkpoints spell it."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): leaf for path, leaf in flat}


def _assert_trees_close(port, ref, tol, what):
    got = dict(checkpoint._paths(port))
    want = _ref_paths(ref)
    assert set(got) == set(want), what
    for k in want:
        _close(got[k], want[k], tol, f"{what} {k}")


@pytest.fixture(scope="module")
def ref_params():
    return {arch: ref_tf.lm_init(jax.random.PRNGKey(0), rc)
            for arch, (rc, _) in ARCHS.items()}


@pytest.fixture(scope="module")
def ref_loss_grads(ref_params):
    """``(tokens, targets, loss, grads)`` of the reference's ``lm_loss`` at
    (arch, S), computed once for the module."""
    memo = {}

    def get(arch, S):
        if (arch, S) not in memo:
            rc = ARCHS[arch][0]
            tok, tgt = _tokens(rc.vocab, 2, S, seed=S)
            loss, grads = jax.value_and_grad(ref_tf.lm_loss)(
                ref_params[arch], jnp.asarray(tok), jnp.asarray(tgt), rc)
            memo[arch, S] = tok, tgt, loss, grads
        return memo[arch, S]
    return get


def _port_params(ref_tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, ref_tree),
                           device="cpu")


def _tokens(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, S)).astype(np.int32))


def _port_loss_and_grads(params, tok, tgt, cfg, remat):
    live = tree_unflatten(params, [p.detach().requires_grad_()
                                   for p in tree_leaves(params)])
    tok, tgt = torch.as_tensor(tok), torch.as_tensor(tgt)
    if remat:
        loss = tf.lm_loss(live, tok, tgt, cfg)
    else:
        loss = cross_entropy(tf.lm_forward(live, tok, cfg, remat=False)[0],
                             tgt)
    loss.backward()
    grads = tree_unflatten(live, [p.grad for p in tree_leaves(live)])
    return loss.detach(), grads


# --------------------------------------------------------------- lm_loss
@pytest.mark.parametrize("arch", ["granite-8b", "mistral-large-123b"])
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("S", [64, 36])
def test_lm_loss_and_gradients_match_reference(ref_params, ref_loss_grads,
                                               arch, remat, S):
    _, pc = ARCHS[arch]
    rp = ref_params[arch]
    tok, tgt, ref_loss, ref_grads = ref_loss_grads(arch, S)
    loss, grads = _port_loss_and_grads(_port_params(rp), tok, tgt, pc, remat)
    _close(loss, ref_loss, TOL, "loss")
    _assert_trees_close(grads, ref_grads, TOL, "grad")


def test_lm_loss_bf16_matches_reference(ref_params):
    rc = dataclasses.replace(ref_granite.REDUCED, dtype=jnp.bfloat16)
    pc = dataclasses.replace(granite_8b.REDUCED, dtype=torch.bfloat16)
    rp = ref_params["granite-8b"]
    tok, tgt = _tokens(rc.vocab, 2, 64, seed=3)
    ref_loss, ref_grads = jax.value_and_grad(ref_tf.lm_loss)(
        rp, jnp.asarray(tok), jnp.asarray(tgt), rc)
    loss, grads = _port_loss_and_grads(_port_params(rp), tok, tgt, pc, True)
    _close(loss, ref_loss, BF16_TOL, "bf16 loss")
    _assert_trees_close(grads, ref_grads, BF16_TOL, "bf16 grad")


def test_remat_changes_no_number():
    """Remat and the 8 loss chunks recompute the same ops: the loss and
    every gradient equal the plain path's to fp32 rounding."""
    cfg = granite_8b.REDUCED
    params = tf.lm_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    tok, tgt = _tokens(cfg.vocab, 2, 64, seed=5)
    a = _port_loss_and_grads(params, tok, tgt, cfg, True)
    b = _port_loss_and_grads(params, tok, tgt, cfg, False)
    _close(a[0], b[0], 1e-6, "loss")
    for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1])):
        _close(x, y, 1e-6, "grad")


# ------------------------------------------------------------ optimizers
def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"a": {"w": f(5, 4), "b": f(4)}, "z": [f(3, 3), f(7)]}


OPTIMIZERS = {
    "adamw_cosine": lambda m: m.adam(3e-2, weight_decay=0.1,
                                     lr_schedule=m.cosine_warmup_schedule(
                                         2, 5)),
    "adam_bf16_moments": lambda m: m.adam(
        3e-2, moments_dtype=(torch.bfloat16 if m is not ref_opt
                             else jnp.bfloat16)),
    "sgd": lambda m: m.sgd(3e-2),
    "lamb": lambda m: m.lamb(3e-2),
}


class _PortOpt:
    adam, sgd, lamb = staticmethod(adam), staticmethod(sgd), staticmethod(
        lamb)
    cosine_warmup_schedule = staticmethod(cosine_warmup_schedule)


def _state_close(got, want, what):
    g = _np(got) if not isinstance(got, torch.Tensor) else got
    if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16:
        w = np.asarray(want).astype(np.float32)
        ulp = np.abs(w) * 2.0 ** -7 + 1e-30
        err = np.abs(got.to(torch.float32).numpy() - w)
        assert (err <= ulp).all(), f"{what}: off by more than one bf16 ulp"
        return
    _close(g, want, OPT_TOL, what)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
@pytest.mark.parametrize("form", ["functional", "in_place"])
def test_optimizers_match_reference(name, form):
    ref = OPTIMIZERS[name](ref_opt)
    port = OPTIMIZERS[name](_PortOpt)
    params0 = _opt_tree(0)
    rp = jax.tree_util.tree_map(jnp.asarray, params0)
    pp = params_from_jax(params0, device="cpu")
    rs, ps = ref.init(rp), port.init(pp)
    for k in range(5):
        grads = _opt_tree(10 + k)
        rg = jax.tree_util.tree_map(jnp.asarray, grads)
        upd, rs = ref.update(rg, rs, rp)
        rp = ref_opt.apply_updates(rp, upd)
        pg = params_from_jax(grads, device="cpu")
        if form == "functional":
            upd, ps = port.update(pg, ps, pp)
            pp = apply_updates(pp, upd)
        else:
            ps = port.update_(tree_leaves(pg), ps, pp)
    _assert_trees_close(pp, rp, OPT_TOL, f"{name} params")
    assert int(ps["step"]) == int(rs["step"]) == 5
    got, want = dict(checkpoint._paths(ps)), _ref_paths(rs)
    assert set(got) == set(want)
    for k in want:
        _state_close(got[k], want[k], f"{name} state {k}")


def test_cosine_warmup_schedule_matches_reference():
    ref = ref_opt.cosine_warmup_schedule(3, 10, floor=0.2)
    port = cosine_warmup_schedule(3, 10, floor=0.2)
    for s in range(13):
        np.testing.assert_allclose(
            float(port(torch.tensor(s, dtype=torch.int32))),
            float(ref(jnp.asarray(s, jnp.int32))), rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_in_place_and_functional_forms_agree_bitwise(name):
    """On the same gradients the two forms run the same arithmetic: the
    parameters and states of 5 steps are equal bit for bit."""
    opt = OPTIMIZERS[name](_PortOpt)
    pf = params_from_jax(_opt_tree(0), device="cpu")
    pi = params_from_jax(_opt_tree(0), device="cpu")
    sf, si = opt.init(pf), opt.init(pi)
    for k in range(5):
        g = params_from_jax(_opt_tree(20 + k), device="cpu")
        upd, sf = opt.update(g, sf, pf)
        pf = apply_updates(pf, upd)
        si = opt.update_(tree_leaves(g), si, pi)
    for a, b in zip(tree_leaves((pf, sf)), tree_leaves((pi, si))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_in_place_adam_keeps_one_leaf_of_transients():
    """The in-place form updates the caller's tensors (same storage) and
    drops each gradient from the list it was given."""
    p = {"w": torch.randn(4, 3), "b": torch.randn(3)}
    ptrs = [t.data_ptr() for t in tree_leaves(p)]
    opt = adam(1e-2)
    state = opt.init(p)
    grads = [torch.randn(4, 3), torch.randn(3)]
    out = opt.update_(grads, state, p)
    assert out is state and grads == [None, None]
    assert [t.data_ptr() for t in tree_leaves(p)] == ptrs
    assert int(state["step"]) == 1


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("vocab,batch,seq,seed,start", [
    (512, 4, 64, 0, 0), (49152, 1, 4096, 0, 5), (1024, 3, 17, 7, 2)])
def test_lm_token_batches_byte_equal(vocab, batch, seq, seed, start):
    ref = ref_data.lm_token_batches(vocab, batch, seq, seed, start)
    port = lm_token_batches(vocab, batch, seq, seed, start)
    for _ in range(3):
        a, b = next(port), next(ref)
        assert a["step"] == b["step"]
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()
