"""The port's dense LM serving path against the reference's.

Layers (``rope_freqs`` / ``apply_rope``, ``rmsnorm_apply``,
``linear_apply(dtype=)``, ``swiglu``) at 1e-6; ``flash_attention``
(causal, windowed, several q chunks, GQA) at 1e-5; then, on the
reference's own ``lm_init`` parameters carried over by
``convert.params_from_jax``, granite-8b's and mistral-large's ``REDUCED``
configs: ``lm_forward``, ``lm_prefill`` logits and caches, and 8
``lm_decode_step``s (logits, and the caches they wrote) with the decode
attention on ``attn="kernel"`` (on the CPU: the kernel's plain version)
and on ``attn="plain"``, at 1e-5 of each array's largest entry (fp32 sums
of up to 448 terms in another order, through 2-3 layers); a bf16 variant
at 3e-2 (bf16 rounds at other places in the two frameworks).  Then the
cache structure, the launcher and the registry.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import granite_8b as ref_granite
from repro.configs import mistral_large_123b as ref_mistral
from repro.models import transformer as ref_tf
from repro.nn import attention as ref_attn
from repro.nn import layers as ref_layers
from repro_torch.configs import LM_SHAPES, get
from repro_torch.configs import granite_8b, mistral_large_123b
from repro_torch.configs.families import LMBundle
from repro_torch.convert import params_from_jax
from repro_torch.kernels import decode_attention as kd
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as tf
from repro_torch.nn import attention, layers
from repro_torch.train import tree_map

LAYER_TOL = 1e-6
TOL = 1e-5
BF16_TOL = 3e-2
ARCHS = {"granite-8b": (ref_granite.REDUCED, granite_8b.REDUCED),
         "mistral-large": (ref_mistral.REDUCED, mistral_large_123b.REDUCED)}


def _np(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(got, ref, tol, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3g}"


# ----------------------------------------------------------------- layers
def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    cos, sin = attention.rope_freqs(16, 40, 500000.0, device="cpu")
    rc, rs = ref_attn.rope_freqs(16, 40, 500000.0)
    _close(cos, rc, LAYER_TOL, "cos")
    _close(sin, rs, LAYER_TOL, "sin")
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 40, (2, 5))
    got = attention.apply_rope(torch.as_tensor(x), cos, sin,
                               torch.as_tensor(pos))
    _close(got, ref_attn.apply_rope(jnp.asarray(x), rc, rs, jnp.asarray(pos)),
           LAYER_TOL, "apply_rope")
    cb, _ = attention.rope_freqs(16, 40, device="cpu", dtype=torch.bfloat16)
    assert cb.dtype == torch.bfloat16


def test_rmsnorm_linear_swiglu_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 24)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    _close(layers.rmsnorm_apply({"scale": torch.as_tensor(scale)},
                                torch.as_tensor(x)),
           ref_layers.rmsnorm_apply({"scale": jnp.asarray(scale)},
                                    jnp.asarray(x)), LAYER_TOL, "rmsnorm")
    p = {"w": rng.standard_normal((24, 7)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for dt, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        got = layers.linear_apply(tp, torch.as_tensor(x), dtype=dt)
        ref = ref_layers.linear_apply(jp, jnp.asarray(x), dtype=jdt)
        assert got.dtype == torch.float32 and ref.dtype == jnp.float32
        _close(got, ref, LAYER_TOL, f"linear_apply dtype={dt}")
    xb = torch.as_tensor(x).to(torch.bfloat16)
    assert layers.linear_apply(tp, xb).dtype == torch.bfloat16
    g, u = x, x[::-1].copy()
    _close(layers.swiglu(torch.as_tensor(g), torch.as_tensor(u)),
           ref_layers.swiglu(jnp.asarray(g), jnp.asarray(u)), LAYER_TOL,
           "swiglu")


def test_gqa_and_rmsnorm_init_match_reference_shapes():
    ref = ref_attn.gqa_init(jax.random.PRNGKey(0), 48, 6, 2, 8)
    got = attention.gqa_init(torch.Generator().manual_seed(0), 48, 6, 2, 8,
                             device="cpu")
    assert tree_map(lambda t: tuple(t.shape), got) == \
        jax.tree_util.tree_map(lambda a: a.shape, ref)
    norm = layers.rmsnorm_init(48, device="cpu")
    assert torch.equal(norm["scale"], torch.ones(48))


@pytest.mark.parametrize("Sq,H,KV,q_chunk,kv_chunk,window", [
    (64, 4, 2, 64, 64, None), (64, 4, 2, 16, 32, None),
    (96, 6, 3, 32, 32, 20), (32, 2, 2, 8, 8, None)])
def test_flash_attention_matches_reference(Sq, H, KV, q_chunk, kv_chunk,
                                           window):
    rng = np.random.default_rng(Sq + H)
    D = 16
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, Sq, KV, D)).astype(np.float32)
            for _ in range(2))
    got = attention.flash_attention(
        *(torch.as_tensor(a) for a in (q, k, v)), causal=True,
        q_chunk=q_chunk, kv_chunk=kv_chunk, window=window)
    ref = ref_attn.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, q_chunk=q_chunk,
        kv_chunk=kv_chunk, window=window)
    _close(got, ref, TOL, "flash_attention")
    with pytest.raises(AssertionError):
        attention.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                  q_chunk=Sq // 2 + 1)


# --------------------------------------------------------------------- LM
@pytest.fixture(scope="module", params=sorted(ARCHS))
def lm(request):
    ref_cfg, cfg = ARCHS[request.param]
    ref_params = ref_tf.lm_init(jax.random.PRNGKey(3), ref_cfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             device="cpu")
    return request.param, ref_cfg, cfg, ref_params, params


def _ref_serve(ref_params, ref_cfg, prompt, steps_tokens, max_seq):
    """The reference's prefill, its caches padded to max_seq, and one jitted
    decode step per token of ``steps_tokens`` (B, n)."""
    logits, caches = ref_tf.lm_prefill(ref_params, jnp.asarray(prompt),
                                       ref_cfg)
    P = prompt.shape[1]
    pad = lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, max_seq - P), (0, 0),
                                (0, 0)])
    full = jax.tree_util.tree_map(pad, caches)
    step = jax.jit(lambda p, t, c, n: ref_tf.lm_decode_step(
        p, t, c, n, ref_cfg, max_seq))
    outs = []
    for i in range(steps_tokens.shape[1]):
        lg, full = step(ref_params, jnp.asarray(steps_tokens[:, i:i + 1]),
                        full, jnp.int32(P + i))
        outs.append(lg)
    return logits, caches, outs, full


def _port_serve(params, cfg, prompt, steps_tokens, max_seq, attn):
    with torch.inference_mode():
        logits, caches = tf.lm_prefill(params, torch.as_tensor(prompt), cfg)
        P = prompt.shape[1]
        full = tf.make_kv_caches(cfg, prompt.shape[0], max_seq, device="cpu")
        for buf, c in zip(full["dense"], caches["dense"]):
            buf[:, :, :P] = c
        outs = []
        for i in range(steps_tokens.shape[1]):
            lg, full = tf.lm_decode_step(
                params, torch.as_tensor(steps_tokens[:, i:i + 1]), full,
                P + i, cfg, max_seq, attn=attn)
            outs.append(lg)
    return logits, caches, outs, full


def _tokens(cfg, B=2, P=12, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (B, P)).astype(np.int32),
            rng.integers(0, cfg.vocab, (B, n)).astype(np.int32))


def test_lm_forward_matches_reference(lm):
    _, ref_cfg, cfg, ref_params, params = lm
    prompt, _ = _tokens(cfg)
    ref, _ = ref_tf.lm_forward(ref_params, jnp.asarray(prompt), ref_cfg)
    with torch.inference_mode():
        got, aux = tf.lm_forward(params, torch.as_tensor(prompt), cfg)
    _close(got, ref, TOL, "lm_forward logits")
    assert float(aux) == 0.0


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_prefill_and_decode_match_reference(lm, attn):
    name, ref_cfg, cfg, ref_params, params = lm
    prompt, steps = _tokens(cfg)
    max_seq = 64
    r_logits, r_caches, r_outs, r_full = _ref_serve(ref_params, ref_cfg,
                                                    prompt, steps, max_seq)
    before = kd.decode_attention.launches
    logits, caches, outs, full = _port_serve(params, cfg, prompt, steps,
                                             max_seq, attn)
    assert kd.decode_attention.launches == before        # plain on the CPU
    _close(logits, r_logits, TOL, f"{name} prefill logits")
    for i, (a, b) in enumerate(zip(caches["dense"], r_caches["dense"])):
        _close(a, b, TOL, f"{name} prefill cache {'kv'[i]}")
    assert len(outs) == 8
    for i, (a, b) in enumerate(zip(outs, r_outs)):
        _close(a, b, TOL, f"{name} decode step {i} logits ({attn})")
    for i, (a, b) in enumerate(zip(full["dense"], r_full["dense"])):
        _close(a, b, TOL, f"{name} decode caches {'kv'[i]} ({attn})")


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_bf16_decode_matches_reference(attn):
    ref_cfg = dataclasses.replace(ref_granite.REDUCED, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(granite_8b.REDUCED, dtype=torch.bfloat16)
    ref_params = ref_tf.lm_init(jax.random.PRNGKey(4), ref_cfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             device="cpu")
    prompt, steps = _tokens(cfg, n=4, seed=1)
    r_logits, _, r_outs, _ = _ref_serve(ref_params, ref_cfg, prompt, steps,
                                        64)
    logits, _, outs, full = _port_serve(params, cfg, prompt, steps, 64, attn)
    assert logits.dtype == torch.bfloat16
    assert full["dense"][0].dtype == torch.bfloat16
    _close(logits, r_logits, BF16_TOL, "bf16 prefill logits")
    for i, (a, b) in enumerate(zip(outs, r_outs)):
        _close(a, b, BF16_TOL, f"bf16 decode step {i} ({attn})")
    # the serving cast of the parameters gives the per-use casts' numbers
    cast = tf.cast_params(params, cfg)
    assert cast["dense_layers"]["ffn"]["wg"].dtype == torch.bfloat16
    _, _, outs_cast, _ = _port_serve(cast, cfg, prompt, steps, 64, attn)
    for a, b in zip(outs_cast, outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pos", [4, 7, -1, -2])
def test_insert_kv_raises_outside_the_cache(pos):
    """The reference's dynamic slice clamps a position past the end (and
    wraps -1 to L - 1); the port refuses it instead of overwriting a cached
    token, and leaves the cache untouched."""
    cache = torch.zeros(2, 4, 1, 3)
    with pytest.raises(IndexError, match="outside the cache"):
        attention.insert_kv(cache, torch.ones(2, 1, 1, 3), pos)
    assert not cache.any()
    attention.insert_kv(cache, torch.ones(2, 1, 1, 3), 3)
    assert cache[:, 3].all() and not cache[:, :3].any()


def _edge_of_cache(attn, cache_len, B=2, max_seq=8):
    """granite-8b ``REDUCED`` on the reference's ``lm_init`` parameters,
    caches drawn from ``default_rng(0)``: one decode step at ``cache_len``
    on both sides; returns (port logits, port caches, reference logits,
    reference caches), the reference's None where the port raised."""
    ref_cfg, cfg = ref_granite.REDUCED, granite_8b.REDUCED
    ref_params = ref_tf.lm_init(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             device="cpu")
    rng = np.random.default_rng(0)
    shape = (cfg.n_layers, B, max_seq, cfg.n_kv, cfg.hd)
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    token = np.ones((B, 1), np.int32)
    caches = {"dense": tuple(torch.as_tensor(a.copy()) for a in kv)}
    with torch.inference_mode():
        logits, caches = tf.lm_decode_step(params, torch.as_tensor(token),
                                           caches, cache_len, cfg, max_seq,
                                           attn=attn)
    r_logits, r_caches = ref_tf.lm_decode_step(
        ref_params, jnp.asarray(token),
        {"dense": tuple(jnp.asarray(a) for a in kv)}, jnp.int32(cache_len),
        ref_cfg, max_seq)
    return logits, caches, r_logits, r_caches


@pytest.mark.parametrize("attn", ["kernel", "plain"])
@pytest.mark.parametrize("cache_len", [8, -1])
def test_decode_step_raises_outside_the_cache(attn, cache_len):
    """``lm_decode_step`` at ``cache_len = max_seq`` (or -1) raises on both
    attention paths, where the reference would write row L - 1 and return
    other logits with no error."""
    with pytest.raises(IndexError, match="outside the cache"):
        _edge_of_cache(attn, cache_len)


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_decode_step_at_the_last_cache_row_matches_reference(attn):
    """At ``cache_len = max_seq - 1`` the step writes the last row and
    still matches the reference: logits and both caches within 1e-5."""
    logits, caches, r_logits, r_caches = _edge_of_cache(attn, 7)
    _close(logits, r_logits, TOL, f"logits at the last row ({attn})")
    for i, (a, b) in enumerate(zip(caches["dense"], r_caches["dense"])):
        _close(a, b, TOL, f"cache {'kv'[i]} at the last row ({attn})")


def test_kv_cache_structure_matches_reference():
    for ref_cfg, cfg in ARCHS.values():
        ref = ref_tf.make_kv_caches(ref_cfg, 3, 40)
        got = tf.make_kv_caches(cfg, 3, 40, device="cpu")
        assert list(got) == list(ref) == ["dense"]
        assert isinstance(got["dense"], tuple) and len(got["dense"]) == 2
        for a, b in zip(got["dense"], ref["dense"]):
            assert tuple(a.shape) == b.shape and not a.any()
    # a carried-over cache tree keeps its tuples, bf16 as bf16
    ref = ref_tf.make_kv_caches(dataclasses.replace(
        ref_granite.REDUCED, dtype=jnp.bfloat16), 1, 8)
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, ref),
                          device="cpu")
    assert isinstance(got["dense"], tuple)
    assert got["dense"][0].dtype == torch.bfloat16


def test_param_tree_and_count_match_reference():
    for ref_cfg, cfg in ARCHS.values():
        shapes = jax.tree_util.tree_map(
            lambda a: tuple(a.shape),
            jax.eval_shape(lambda: ref_tf.lm_init(jax.random.PRNGKey(0),
                                                  ref_cfg)))
        params = tf.lm_init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
        got = tree_map(lambda t: tuple(t.shape), params)
        assert got == shapes
        assert cfg.param_count() == ref_cfg.param_count()
    full = get("granite-8b").bundle().cfg
    assert full.param_count() == ref_granite.CONFIG.param_count()
    assert full.kv_bytes_per_token() == 147_456
    bf16 = tf.lm_init(torch.Generator().manual_seed(0), granite_8b.REDUCED,
                      device="cpu", dtype=torch.bfloat16)
    assert bf16["dense_layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16


# ----------------------------------------------------- launcher, registry
def test_launcher_serves_the_lm_on_cpu(capsys):
    before = kd.decode_attention.launches
    res = launch_serve.main(["--arch", "granite-8b", "--tokens", "6",
                             "--device", "cpu"])
    assert isinstance(res, launch_serve.LMServeResult)
    assert tuple(res.tokens.shape) == (2, 7)
    assert tuple(res.logits.shape) == (6, 2, granite_8b.REDUCED.vocab)
    assert torch.isfinite(res.logits).all()
    assert kd.decode_attention.launches == before
    out = capsys.readouterr().out
    assert "generated:" in out and "tok/s on CPU" in out
    # the greedy tokens are the argmax of each step's logits
    assert torch.equal(res.tokens[:, 1:].T,
                       res.logits.argmax(-1).to(torch.int32))
    plain = launch_serve.serve_lm(launch_serve.parse_args(
        ["--arch", "granite-8b", "--tokens", "6", "--device", "cpu"]),
        attn="plain")
    torch.testing.assert_close(plain.logits, res.logits, rtol=0, atol=1e-5)


def test_graph_flag_defaults_to_none():
    args = launch_serve.parse_args([])
    assert args.graph is None and args.arch == "granite-8b"
    assert (args.tokens, args.batch, args.prompt_len) == (16, 2, 16)


def test_registry_ports_the_dense_lms_only():
    for arch in ("granite-8b", "minitron-8b", "mistral-large-123b"):
        spec = get(arch)
        assert spec.family == "lm" and spec.shapes == tuple(LM_SHAPES)
    for arch in ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b"):
        with pytest.raises(NotImplementedError, match="item 8"):
            get(arch)
    with pytest.raises(NotImplementedError, match="LM training"):
        LMBundle(granite_8b.REDUCED).step_fn("train_4k")


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_bundle_steps_run_at_a_cut_batch(shape):
    """``LMBundle``'s specs and batches at ``REDUCED`` with the batch cut
    to 1; the decode step writes the last position of its 32,768-long
    caches, the prefill returns the caches of its 32,768 tokens (cut to
    256 by slicing the batch's tokens)."""
    bundle = LMBundle(granite_8b.REDUCED)
    gen = torch.Generator().manual_seed(0)
    params = bundle.init_params(gen, device="cpu")
    batch = bundle.make_batch(shape, gen, device="cpu", batch=1)
    specs = bundle.input_specs(shape, batch=1)
    if shape == "prefill_32k":
        assert tuple(batch["tokens"].shape) == specs["tokens"][0]
        batch["tokens"] = batch["tokens"][:, :256]
        logits, caches = bundle.step_fn(shape)(params, batch)
        assert caches["dense"][0].shape[2] == 256
    else:
        assert tuple(batch["caches"]["dense"][0].shape) == \
            specs["caches"]["dense"][0][0]
        assert batch["cache_len"] == 32767
        logits, caches = bundle.step_fn(shape)(params, batch)
        assert caches["dense"][0][:, :, 32767].any()
        assert not caches["dense"][0][:, :, :32767].any()
    assert logits.shape == (1, 1, granite_8b.REDUCED.vocab)
    assert torch.isfinite(logits).all()
