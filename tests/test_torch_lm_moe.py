"""The port's MoE LMs (granite-moe-3b-a800m, llama4-maverick-400b-a17b)
against the reference's, at their ``REDUCED`` configs (fp32), on the
reference's own ``lm_init`` parameters carried over by
``convert.params_from_jax``:

* ``lm_forward`` logits and aux within 1e-5; ``lm_loss`` (remat, 8 loss
  chunks, the aux at weight 0.01) within 1e-5 and every gradient within
  1e-5, absolute where a leaf's entries are below 1 and of its largest
  entry above (a top-1 gate is p / p: its gradient is a cancellation that
  the two frameworks round differently, ~1e-7 on a router gradient of
  ~1e-2);
* ``lm_prefill`` logits and the whole cache tree (``{"moe"}``, plus
  ``"dense"`` of (n_moe, moe_every - 1, ...) for llama4) within 1e-5 of
  each array's largest entry; 3 ``lm_decode_step``s on ``attn="kernel"``
  (on the CPU the kernel's plain version) and ``"plain"``, logits and
  caches within 1e-5;
* the router's dtype: with ``dtype=bf16`` and fp32 parameters the
  reference's prefill routes with the fp32 router (its ``lm_backbone``
  casts the stacks to bf16, its serving does not); the port's prefill
  routes, with and without ``cast_params``, equal the reference's exactly,
  and ``cast_params`` keeps the routers in fp32;
* ``param_count`` / ``active_param_count`` at ``CONFIG``; ``LMBundle``'s
  ``input_specs`` against the reference's at all four ``LM_SHAPES`` and
  its steps at a cut batch; the serve launcher copying the caches along
  the sequence axis.

The launchers are ``tests/test_torch_lm_moe_launch.py``, a file of its own
so that pytest-xdist's ``--dist loadfile`` spreads the two over workers;
it takes this file's helpers.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import granite_moe_3b_a800m as ref_gmoe
from repro.configs import llama4_maverick_400b_a17b as ref_llama4
from repro.configs.families import LMBundle as RefLMBundle
from repro.models import transformer as ref_tf
from repro.nn import moe as ref_moe
from repro_torch.configs import LM_SHAPES, get
from repro_torch.configs import granite_moe_3b_a800m, llama4_maverick_400b_a17b
from repro_torch.configs.families import LMBundle
from repro_torch.convert import params_from_jax
from repro_torch.kernels import decode_attention as kd
from repro_torch.models import transformer as tf
from repro_torch.nn import moe
from repro_torch.train import checkpoint, tree_leaves
from repro_torch.train.optimizer import tree_unflatten

TOL = 1e-5
LOSS_TOL = 1e-4
ARCHS = {"granite-moe-3b-a800m": (ref_gmoe, granite_moe_3b_a800m),
         "llama4-maverick-400b-a17b": (ref_llama4,
                                       llama4_maverick_400b_a17b)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, tol, what, floor=1e-30):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), floor)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3g}"


def _ref_paths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): leaf for path, leaf in flat}


def _assert_trees_close(port, ref, tol, what, floor=1e-30):
    got, want = dict(checkpoint._paths(port)), _ref_paths(ref)
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k in want:
        _close(got[k], want[k], tol, f"{what} {k}", floor)


def _port(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's seed-0 ``REDUCED`` parameters, the ones its
    launchers draw; drawn once per arch."""
    return ref_tf.lm_init(jax.random.PRNGKey(0), ARCHS[arch][0].REDUCED)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def lm(request):
    ref_mod, mod = ARCHS[request.param]
    ref_params = _ref_params(request.param)
    return (request.param, ref_mod.REDUCED, mod.REDUCED, ref_params,
            _port(ref_params))


def _tokens(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, S)).astype(np.int32))


def test_params_from_jax_carries_the_moe_trees(lm):
    """Both ``REDUCED`` trees (llama4's with its ``shared`` expert and its
    dense stack) carry over leaf for leaf, fp32 bit for bit; cast to bf16
    (llama4 ``CONFIG``'s parameter dtype), bf16 leaves stay bf16 and keep
    their bits."""
    name, _, pc, rp, params = lm
    want = _ref_paths(rp)
    got = dict(checkpoint._paths(params))
    assert set(got) == set(want)
    for k, leaf in want.items():
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), np.asarray(leaf)), k
    bf16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), rp)
    for k, leaf in dict(checkpoint._paths(_port(bf16))).items():
        assert leaf.dtype == torch.bfloat16, k
        assert np.array_equal(leaf.float().numpy(), np.asarray(
            _ref_paths(bf16)[k], np.float32)), k
    if pc.shared_expert:
        assert "moe_layers/moe/shared/wd" in got
        assert "dense_layers/ffn/wg" in got


# ---------------------------------------------------------------- forward
def test_forward_loss_and_gradients_match_reference(lm):
    name, rc, pc, rp, params = lm
    tok, tgt = _tokens(rc.vocab, 2, 32, seed=1)
    r_logits, r_aux = ref_tf.lm_forward(rp, jnp.asarray(tok), rc)
    with torch.inference_mode():
        logits, aux = tf.lm_forward(params, torch.as_tensor(tok), pc)
    _close(logits, r_logits, TOL, f"{name} lm_forward logits")
    assert float(r_aux) > 0
    assert abs(float(aux) - float(r_aux)) <= TOL * float(r_aux)

    r_loss, r_grads = jax.value_and_grad(ref_tf.lm_loss)(
        rp, jnp.asarray(tok), jnp.asarray(tgt), rc)
    leaves = [t.detach().clone().requires_grad_()
              for t in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    loss = tf.lm_loss(live, torch.as_tensor(tok), torch.as_tensor(tgt), pc)
    loss.backward()
    _close(loss, r_loss, TOL, f"{name} lm_loss")
    _assert_trees_close(tree_unflatten(live, [t.grad for t in leaves]),
                        r_grads, TOL, f"{name} grad", floor=1.0)


# ---------------------------------------------------------------- serving
def test_prefill_and_decode_match_reference(lm):
    name, rc, pc, rp, params = lm
    prompt, steps = _tokens(rc.vocab, 2, 12, seed=2)
    steps = steps[:, :3]
    max_seq = 32
    r_logits, r_caches = ref_tf.lm_prefill(rp, jnp.asarray(prompt), rc)

    def pad(c):
        pads = [(0, 0)] * c.ndim
        pads[-3] = (0, max_seq - c.shape[-3])
        return jnp.pad(c, pads)
    r_full = jax.tree_util.tree_map(pad, r_caches)
    step = jax.jit(lambda p, t, c, n: ref_tf.lm_decode_step(
        p, t, c, n, rc, max_seq))
    r_outs = []
    for i in range(steps.shape[1]):
        lg, r_full = step(rp, jnp.asarray(steps[:, i:i + 1]), r_full,
                          jnp.int32(12 + i))
        r_outs.append(lg)

    with torch.inference_mode():
        logits, caches = tf.lm_prefill(params, torch.as_tensor(prompt), pc)
    _close(logits, r_logits, TOL, f"{name} prefill logits")
    kinds = ["moe"] + (["dense"] if pc.moe_every > 1 else [])
    assert sorted(caches) == sorted(r_caches) == sorted(kinds)
    for kind in kinds:
        for i in (0, 1):
            _close(caches[kind][i], r_caches[kind][i], TOL,
                   f"{name} prefill cache {kind} {'kv'[i]}")
    for attn in ("kernel", "plain"):
        before = kd.decode_attention.launches
        with torch.inference_mode():
            full = tf.make_kv_caches(pc, 2, max_seq, device="cpu")
            tf.fill_caches(full, caches)
            outs = [tf.lm_decode_step(params, torch.as_tensor(
                steps[:, i:i + 1]), full, 12 + i, pc, max_seq,
                attn=attn)[0] for i in range(steps.shape[1])]
        assert kd.decode_attention.launches == before   # plain on the CPU
        for i, (a, b) in enumerate(zip(outs, r_outs)):
            _close(a, b, TOL, f"{name} decode step {i} ({attn})")
        for kind in kinds:
            for i in (0, 1):
                _close(full[kind][i], r_full[kind][i], TOL,
                       f"{name} decode caches {kind} {'kv'[i]} ({attn})")


def _record_port_routing(monkeypatch):
    """Each ``moe_routes`` call of the port: (router dtype, x, expert
    ids)."""
    seen = []
    inner = moe.moe_routes

    def recording(p, x, *a, **kw):
        r = inner(p, x, *a, **kw)
        seen.append((p["router"].dtype, x.clone(), r.expert_ids.clone()))
        return r
    monkeypatch.setattr(moe, "moe_routes", recording)
    return seen


def _record_ref_routing(monkeypatch):
    """The reference's ``_moe_apply_impl`` calls: the router dtypes it was
    traced with, and each call's (x, expert ids) through a callback."""
    dtypes, calls = [], []
    inner = ref_moe._moe_apply_impl

    def recording(p, x, top_k, *a, **kw):
        dtypes.append(p["router"].dtype)
        probs = jax.nn.softmax(x.astype(jnp.float32)
                               @ p["router"].astype(jnp.float32), axis=-1)
        jax.debug.callback(
            lambda xx, ids: calls.append((np.asarray(xx, np.float32),
                                          np.asarray(ids))),
            x, jax.lax.top_k(probs, top_k)[1], ordered=True)
        return inner(p, x, top_k, *a, **kw)
    monkeypatch.setattr(ref_moe, "_moe_apply_impl", recording)
    return dtypes, calls


def test_router_dtype_follows_the_reference(monkeypatch):
    """granite-moe ``REDUCED`` with ``dtype=bf16`` and fp32 parameters.
    The reference routes its prefill with the router as stored (fp32) and
    its training backbone with the router cast to bf16 with the stacks.
    The port does the same: its prefill routes with an fp32 router, with
    and without ``cast_params`` (which keeps the routers fp32 and casts
    the rest), and ``lm_backbone`` with a bf16 one.  Given the reference's
    own router inputs, the port's routes equal the reference's exactly;
    a bf16-rounded router gives other probabilities on them.  (The two
    frameworks' bf16 hidden states differ by rounding from the first
    attention on, so their routes are compared on the same inputs.)"""
    rc = dataclasses.replace(ref_gmoe.REDUCED, dtype=jnp.bfloat16)
    pc = dataclasses.replace(granite_moe_3b_a800m.REDUCED,
                             dtype=torch.bfloat16)
    rp = ref_tf.lm_init(jax.random.PRNGKey(5), rc)
    params = _port(rp)
    prompt, _ = _tokens(rc.vocab, 2, 16, seed=4)
    jt, tt = jnp.asarray(prompt), torch.as_tensor(prompt)

    dtypes, calls = _record_ref_routing(monkeypatch)
    r_logits, _ = ref_tf.lm_prefill(rp, jt, rc)
    jax.effects_barrier()
    assert set(dtypes) == {jnp.dtype(jnp.float32)}
    assert len(calls) == rc.n_moe_layers
    prefill_calls = list(calls)
    dtypes.clear()
    ref_tf.lm_backbone(rp, jt, rc)
    assert set(dtypes) == {jnp.dtype(jnp.bfloat16)}

    cast = tf.cast_params(params, pc)
    assert cast["moe_layers"]["moe"]["router"].dtype == torch.float32
    assert cast["moe_layers"]["moe"]["wg"].dtype == torch.bfloat16
    assert cast["moe_layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    logits = {}
    for what, tree in (("fp32 params", params), ("cast_params", cast)):
        seen = _record_port_routing(monkeypatch)
        with torch.inference_mode():
            logits[what], _ = tf.lm_prefill(tree, tt, pc)
        assert [d for d, _, _ in seen] == [torch.float32] * pc.n_moe_layers
        _close(logits[what], r_logits, 3e-2, f"bf16 prefill ({what})")
        for layer, (x, ids) in enumerate(prefill_calls):
            lp = tf._layer(tree, layer, "moe_layers")["moe"]
            xb = torch.as_tensor(x).to(torch.bfloat16)
            r = moe.moe_routes(lp, xb, pc.top_k)
            assert np.array_equal(r.expert_ids.numpy(), ids), (what, layer)
            rounded = tf._compute_cast(lp, torch.bfloat16)
            assert not torch.equal(
                moe.moe_routes(rounded, xb, pc.top_k).probs, r.probs)
    assert torch.equal(logits["fp32 params"], logits["cast_params"])
    seen = _record_port_routing(monkeypatch)
    with torch.inference_mode():
        tf.lm_backbone(params, tt, pc)
    assert [d for d, _, _ in seen] == [torch.bfloat16] * pc.n_moe_layers


def test_param_counts_match_reference_at_config():
    for ref_mod, mod in ARCHS.values():
        for name in ("CONFIG", "REDUCED"):
            rc, pc = getattr(ref_mod, name), getattr(mod, name)
            assert pc.param_count() == rc.param_count()
            assert pc.active_param_count() == rc.active_param_count()
            assert (pc.n_moe_layers, pc.n_dense_layers) == (
                rc.n_moe_layers, rc.n_dense_layers)
            assert pc.kv_bytes_per_token() == (
                rc.n_layers * 2 * rc.n_kv * rc.hd
                * jnp.dtype(rc.dtype).itemsize)
    cfg = granite_moe_3b_a800m.CONFIG
    assert cfg.param_count() == 3_374_195_712
    assert cfg.active_param_count() == 956_310_528
    assert cfg.kv_bytes_per_token() == 65_536
    cut = dataclasses.replace(llama4_maverick_400b_a17b.CONFIG, n_layers=2)
    assert cut.param_count() == 18_553_241_600
    # the reduced trees have the reference's structure and shapes
    for ref_mod, mod in ARCHS.values():
        want = _ref_paths(jax.eval_shape(
            lambda: ref_tf.lm_init(jax.random.PRNGKey(0), ref_mod.REDUCED)))
        got = tf.lm_init(torch.Generator().manual_seed(0), mod.REDUCED,
                         device="cpu")
        assert {k: tuple(v.shape) for k, v in checkpoint._paths(got)} == \
            {k: tuple(v.shape) for k, v in want.items()}


def test_registry_bundles_and_cache_specs():
    """Both MoE archs resolve to LM specs over ``LM_SHAPES``; llama4's
    bundle keeps bf16 parameters and moments; ``input_specs`` equals the
    reference's at all four shapes; each step runs at ``REDUCED`` with a
    cut batch (train and prefill on 64 tokens; decode at the cell's full
    cache length)."""
    assert get("llama4-maverick-400b-a17b").bundle().moments_dtype == \
        torch.bfloat16
    assert get("granite-moe-3b-a800m").bundle().moments_dtype == \
        torch.float32
    assert llama4_maverick_400b_a17b.CONFIG.param_dtype == torch.bfloat16
    for name, (ref_mod, mod) in ARCHS.items():
        spec = get(name)
        assert spec.family == "lm" and spec.shapes == tuple(LM_SHAPES)
        ref_b, b = RefLMBundle(ref_mod.REDUCED), LMBundle(mod.REDUCED)
        for shape in LM_SHAPES:
            want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                    _ref_paths(ref_b.input_specs(shape)).items()}
            assert _spec_paths(b.input_specs(shape)) == want, shape
        gen = torch.Generator().manual_seed(0)
        params = b.init_params(gen, device="cpu")
        for shape in LM_SHAPES:
            batch = b.make_batch(shape, gen, device="cpu", batch=1)
            kind = LM_SHAPES[shape]["kind"]
            if kind == "train":
                batch = {k: v[:, :64] for k, v in batch.items()}
                state = b.opt().init(params)
                _, _, loss = b.step_fn(shape)(params, state, batch)
                assert torch.isfinite(loss)
                continue
            if kind == "prefill":
                batch["tokens"] = batch["tokens"][:, :64]
                logits, caches = b.step_fn(shape)(params, batch)
                assert sorted(caches) == sorted(
                    tf.kv_cache_shapes(mod.REDUCED, 1, 64))
            else:
                S = LM_SHAPES[shape]["seq"]
                logits, caches = b.step_fn(shape)(params, batch)
                for k_stack, _ in caches.values():
                    assert k_stack[..., S - 1, :, :].any()
                    assert not k_stack[..., :S - 1, :, :].any()
            assert logits.shape == (1, 1, mod.REDUCED.vocab)
            assert torch.isfinite(logits).all()


def _spec_paths(tree, prefix="") -> dict:
    """path -> (shape, dtype name) of an ``input_specs`` tree, spelled as
    ``_ref_paths`` spells the reference's."""
    if isinstance(tree, tuple) and isinstance(tree[1], torch.dtype):
        return {prefix: (tuple(tree[0]), str(tree[1]).split(".")[-1])}
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_spec_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out
