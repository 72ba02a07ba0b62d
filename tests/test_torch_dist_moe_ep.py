"""The MoE LMs' mesh path where ``models.transformer._moe_ffn``'s
shard-local branch does not apply (a batch that does not divide the data
axes, a data axis of one rank, a model axis that does not divide d_ff):
each model rank runs only its E / model whole experts
(``nn.moe.moe_apply(ep_axis="model")``), or its F-slice of every expert
where E does not divide the axis (``tp_axis="model"``), as GSPMD runs the
reference's ``moe_apply`` under its ``maybe_shard`` layout hints.

Module fixtures spawn 4 and 8 gloo ranks (bodies in the jax-free
``tests/_torch_moe_ep_ranks.py``), each on a (2, world / 2) and a (1,
world) data x model mesh; at the same time the reference runs the same
steps in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` on the same meshes
(``with mesh:``).  The variants: ``REDUCED`` granite-moe and llama4 (8
experts: the rank's experts on every model axis), granite-moe with 6
experts (F-slices on 4 and 8), llama4 with d_ff 66 (its shared expert and
dense FFN held whole; on (2, 4) its training takes the branch, the batch
cut over data and gathered for the dispatch).

Held, each rank's block against the same block of the reference's output
(of the largest |entry|), all within 1e-5: a decode step of 3 rows (every
row on every rank, the caches' sequence over every axis): logits and the
updated caches; ``lm_forward``'s logits and ``aux``; ``lm_loss`` and every
gradient; a prefill of one row: logits and caches.  Every ``moe_apply``
of those steps ran in the layout the rank holds, on E / model experts or
d_ff / model columns, never every expert whole.  On fake process groups
(``launch.dryrun.fake_world``): ``roofline.count`` of ``moe_apply`` takes
exactly (model - 1) / model of the experts' FLOPs off a rank; a model
axis that divides neither E nor d_ff raises; a (1, 1) mesh decodes bit
for bit as no mesh.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from repro.models.transformer import lm_init as ref_lm_init
from repro_torch import convert
from repro_torch.dist.sharding import AbstractMesh, broadcast_specs, leaves
from repro_torch.models.transformer import kv_cache_shapes

import _torch_dist_ranks as dist_ranks
import _torch_moe_ep_ranks as ranks
from _torch_lm_mesh_ranks import flatten, unflatten

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
B, S, PROMPT = 4, 16, 8
VARIANTS = tuple(ranks.VARIANTS)
# inside the child, before jax initialises (as tests/test_dist_integration.py)
REF = r"""
import json, os, sys
tmp, world = sys.argv[1], int(sys.argv[2])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={world}"
import numpy as np, jax, jax.numpy as jnp
from repro.configs.families import LMBundle
from repro.models.transformer import (lm_forward, lm_loss, lm_prefill,
                                      lm_decode_step)
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from _torch_moe_ep_ranks import (CACHE_LEN, MAX_SEQ, TRAIN_2D, VARIANTS,
                                 meshes, variant_config)
from _torch_lm_mesh_ranks import flatten, unflatten
inp = np.load(os.path.join(tmp, "inputs.npz"))
out = {}
for name in VARIANTS:
    cfg = variant_config(name, "repro")
    cn = LMBundle(cfg).make_constrain()
    params = jax.tree_util.tree_map(jnp.asarray,
                                    unflatten(inp, f"{name}/params/"))
    tok = jnp.asarray(inp[f"{name}/tokens"])
    tgt = jnp.asarray(inp[f"{name}/targets"])
    grad = jax.jit(jax.value_and_grad(
        lambda p, t, g: lm_loss(p, t, g, cfg, constrain=cn)))
    for mk, shape in meshes(world).items():
        key = f"{name}/{mk}"
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        with mesh:
            if mk == "2d":
                caches = jax.tree_util.tree_map(
                    jnp.asarray, unflatten(inp, f"{name}/caches3/"))
                dl, new = jax.jit(lambda p, t, c: lm_decode_step(
                    p, t, c, jnp.int32(CACHE_LEN), cfg, MAX_SEQ,
                    constrain=cn))(params, jnp.asarray(inp[f"{name}/next3"]),
                                   caches)
                out[f"{key}/decode3_logits"] = dl
                out.update(flatten(new, f"{key}/decode3_caches/"))
                if name in TRAIN_2D and cfg.d_ff % shape[1]:
                    loss, grads = grad(params, tok, tgt)
                    out[f"{key}/loss"] = loss
                    out.update(flatten(grads, f"{key}/grads/"))
            else:
                lg, aux = jax.jit(lambda p, t: lm_forward(
                    p, t, cfg, constrain=cn))(params, tok)
                out[f"{key}/logits"], out[f"{key}/aux"] = lg, aux
                pl, pc = jax.jit(lambda p, t: lm_prefill(
                    p, t, cfg, constrain=cn))(
                        params, jnp.asarray(inp[f"{name}/prompt1"]))
                out[f"{key}/prefill1_logits"] = pl
                out.update(flatten(pc, f"{key}/prefill1_caches/"))
                loss, grads = grad(params, tok, tgt)
                out[f"{key}/loss"] = loss
                out.update(flatten(grads, f"{key}/grads/"))
out = {k: np.asarray(v, np.float32) for k, v in out.items()}
np.savez(os.path.join(tmp, "ref.npz"), **out)
print("REF_OK")
"""
_SUBPROC_ENV = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", ""),
                "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", ""),
                "TMPDIR": os.environ.get("TMPDIR", "/tmp")}


def _close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, f"{what}: {got.shape} != {ref.shape}"
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3g}"


def _inputs():
    inputs = {}
    for i, name in enumerate(VARIANTS):
        cfg = ranks.variant_config(name, "repro")
        params = jax.tree_util.tree_map(
            np.asarray, ref_lm_init(jax.random.PRNGKey(30 + i), cfg))
        inputs.update(flatten(params, f"{name}/params/"))
        rng = np.random.default_rng(30 + i)
        draw = lambda *shape: rng.integers(0, cfg.vocab, shape).astype(
            np.int32)
        inputs[f"{name}/tokens"] = draw(B, S)
        inputs[f"{name}/targets"] = draw(B, S)
        inputs[f"{name}/prompt1"] = draw(1, PROMPT)
        inputs[f"{name}/next3"] = draw(3, 1)
        # caches of 3 rows filled to CACHE_LEN positions, zero beyond
        for kind, shape in kv_cache_shapes(ranks.variant_config(name), 3,
                                           ranks.MAX_SEQ).items():
            for j in range(2):
                c = rng.standard_normal(shape).astype(np.float32)
                c[..., ranks.CACHE_LEN:, :, :] = 0
                inputs[f"{name}/caches3/{kind}/{j}"] = c
    return inputs


@pytest.fixture(scope="module", params=[4, 8], ids=["4 ranks", "8 ranks"])
def runs(request, tmp_path_factory):
    world = request.param
    tmp = str(tmp_path_factory.mktemp(f"moe_ep{world}"))
    inputs = _inputs()
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    ref = subprocess.Popen([sys.executable, "-c", REF, tmp, str(world)],
                           cwd=ROOT, env=_SUBPROC_ENV,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        dist_ranks.spawn(ranks.moe_suite, world, tmp, timeout_s=600.0)
        log, _ = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert "REF_OK" in log, log
    arrays = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
              for r in range(world)]
    infos = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
             for r in range(world)]
    return world, arrays, infos, dict(np.load(os.path.join(tmp, "ref.npz")))


def _vocab_block(ref, m: int, coords):
    """The rank's vocabulary block of logits (the head is cut over model:
    512 divides every model axis here)."""
    v = ref.shape[-1] // m
    return ref[..., coords["model"] * v:(coords["model"] + 1) * v]


def _grads(name, mk, world, ref, arrays, infos):
    """Each rank's gradients against its block of the reference's, under
    the rank's layout of the parameters."""
    shape = ranks.meshes(world)[mk]
    mesh = AbstractMesh(shape, ("data", "model"))
    cfg = ranks.variant_config(name)
    key = f"{name}/{mk}"
    for a, info in zip(arrays, infos):
        coords = info["coords"][mk]
        _close(a[f"{key}/loss"], ref[f"{key}/loss"], what=f"{key} loss")
        specs = convert.param_specs(cfg, mesh, info["zero"][key])
        tree = unflatten(ref, f"{key}/grads/")
        for (leaf, r), spec in zip(flatten(tree).items(),
                                   leaves(broadcast_specs(specs, tree))):
            want = convert.local_block(r, spec, mesh, coords)
            _close(a[f"{key}/grads/{leaf}"], want,
                   what=f"{key} grad {leaf} at {coords}")


@pytest.mark.parametrize("name", VARIANTS)
def test_decode_of_rows_below_the_data_axis_matches_the_reference(runs,
                                                                  name):
    world, arrays, infos, ref = runs
    key, m = f"{name}/2d", world // 2
    for a, info in zip(arrays, infos):
        c = info["coords"]["2d"]
        _close(a[f"{key}/decode3_logits"],
               _vocab_block(ref[f"{key}/decode3_logits"], m, c),
               what=f"{key} decode logits at {c}")
        win = ranks.MAX_SEQ // world
        lo = (c["data"] * m + c["model"]) * win
        for k in ref:
            if k.startswith(f"{key}/decode3_caches/"):
                _close(a[k], ref[k][..., lo:lo + win, :, :],
                       what=f"{k} at {c}")


@pytest.mark.parametrize("name", VARIANTS)
def test_forward_and_aux_match_the_reference_on_a_model_only_mesh(runs,
                                                                  name):
    world, arrays, infos, ref = runs
    key = f"{name}/1d"
    for a, info in zip(arrays, infos):
        c = info["coords"]["1d"]
        _close(a[f"{key}/logits"], _vocab_block(ref[f"{key}/logits"],
                                                world, c),
               what=f"{key} logits at {c}")
        _close(a[f"{key}/aux"], ref[f"{key}/aux"], what=f"{key} aux")


@pytest.mark.parametrize("name", VARIANTS)
def test_prefill_of_one_row_matches_the_reference(runs, name):
    world, arrays, infos, ref = runs
    key = f"{name}/1d"
    for a, info in zip(arrays, infos):
        c = info["coords"]["1d"]
        _close(a[f"{key}/prefill1_logits"],
               _vocab_block(ref[f"{key}/prefill1_logits"], world, c),
               what=f"{key} prefill logits at {c}")
        for k in ref:
            if k.startswith(f"{key}/prefill1_caches/"):
                _close(a[k], ref[k], what=f"{k} at {c}")


@pytest.mark.parametrize("name", VARIANTS)
def test_loss_and_gradients_match_the_reference_through_the_branch(runs,
                                                                   name):
    world, arrays, infos, ref = runs
    _grads(name, "1d", world, ref, arrays, infos)
    trained_2d = f"{name}/2d/loss" in ref
    assert trained_2d == (name in ranks.TRAIN_2D and world == 8)
    if trained_2d:
        _grads(name, "2d", world, ref, arrays, infos)


@pytest.mark.parametrize("name", VARIANTS)
def test_each_model_rank_runs_only_its_experts(runs, name):
    """Every ``moe_apply`` call of those steps took the branch that is not
    shard-local, in the layout of ``_model_only_moe_specs``: E / model
    whole experts a rank where E divides the axis, else d_ff / model
    columns of every expert."""
    world, _, infos, _ = runs
    cfg = ranks.variant_config(name)
    for mk, (_, m) in ranks.meshes(world).items():
        if cfg.n_experts % m == 0:
            want = ["ep", cfg.n_experts // m, cfg.d_ff]
        else:
            want = ["tp", cfg.n_experts, cfg.d_ff // m]
        for info in infos:
            calls = info["calls"][f"{name}/{mk}"]
            # a decode step; or a forward, a prefill and a loss (its
            # backward's recomputes call again)
            assert len(calls) >= cfg.n_moe_layers * (1 if mk == "2d"
                                                     else 3), (mk, calls)
            assert all(c == want for c in calls), (mk, m, calls)


def _fake_mesh(shape):
    from repro_torch.dist.sharding import as_mesh
    from repro_torch.launch.mesh import make_debug_mesh
    return as_mesh(make_debug_mesh(shape, device="cpu"))


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("name", ["granite_moe", "llama4",
                                  "granite_moe_e6"])
def test_expert_flops_fall_by_the_model_axis(name, m):
    """``roofline.count`` of ``moe_apply`` on 24 tokens of a fake (1, m)
    mesh in the rank's layout, against no mesh on every expert: exactly
    (m - 1) / m of the experts' FLOPs (and of the shared expert's) come
    off the rank; the router's stay."""
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.models.transformer import (_MeshLM,
                                                _model_only_moe_specs)
    from repro_torch.nn.moe import capacity, moe_apply
    from repro_torch.roofline.count import count_step
    cfg = ranks.variant_config(name)
    E, D, F, k, T = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.top_k, 24
    meta = lambda *shape: torch.empty(shape, device="meta")
    whole = {"router": meta(D, E), "wg": meta(E, D, F), "wu": meta(E, D, F),
             "wd": meta(E, F, D)}
    if cfg.shared_expert:
        whole["shared"] = {"wg": meta(D, F), "wu": meta(D, F),
                           "wd": meta(F, D)}
    x = meta(T, D)
    plain = count_step(lambda p, x: moe_apply(p, x, k), (whole, x))["flops"]
    with fake_world(m):
        mesh = _fake_mesh((1, m))
        layout = _MeshLM.of(cfg, mesh).expert_layout
        local = convert.shard_tree(
            {n: (np.zeros(t.shape, np.float32) if n != "shared" else
                 {s: np.zeros(u.shape, np.float32) for s, u in t.items()})
             for n, t in whole.items()},
            _model_only_moe_specs(whole, mesh), mesh, "cpu")
        with use_mesh(mesh):
            cut = count_step(lambda p, x: moe_apply(p, x, k, **layout),
                             (local, x))["flops"]
    assert ("ep_axis" in layout) == (E % m == 0)
    C = capacity(T, k, E)
    experts = 3 * 2 * E * C * D * F
    shared = 3 * 2 * T * D * F if cfg.shared_expert else 0
    assert plain - cut == (experts + shared) * (m - 1) // m


def test_a_model_axis_dividing_neither_experts_nor_width_raises():
    """8 experts of d_ff 64 on a model axis of 3: the weights are held
    whole on every rank, and the branch raises rather than run them."""
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models import transformer as tf
    cfg = ranks.variant_config("granite_moe")
    mesh = AbstractMesh((1, 3), ("data", "model"))
    assert tf._MeshLM.of(cfg, mesh).expert_layout is None
    lp = {"ln2": {"scale": torch.ones(cfg.d_model)}, "moe": {}}
    with use_mesh(mesh), pytest.raises(ValueError, match="neither divides"):
        tf._moe_ffn(lp, torch.zeros(1, 2, cfg.d_model), cfg)


@pytest.mark.parametrize("name", ["granite_moe", "llama4"])
def test_one_rank_mesh_decodes_bit_for_bit_as_no_mesh(name):
    """A (1, 1) mesh (every collective skipped) runs the branch with every
    expert on the one model rank: a decode step of 3 rows gives the
    no-mesh logits and caches bit for bit, as on the card
    (``chip_smoke.moe_ep_mesh_phase``)."""
    from repro_torch.configs.families import LMBundle
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.models import transformer as tf
    cfg = ranks.variant_config(name)
    gen = torch.Generator().manual_seed(30)
    params = LMBundle(cfg).init_params(gen, "cpu")
    tok = torch.randint(0, cfg.vocab, (3, 1), generator=gen)

    def caches():
        g = torch.Generator().manual_seed(31)
        return {n: tuple(torch.randn(s, generator=g) for _ in range(2))
                for n, s in kv_cache_shapes(cfg, 3, ranks.MAX_SEQ).items()}
    with torch.no_grad():
        want, want_c = tf.lm_decode_step(params, tok, caches(),
                                         ranks.CACHE_LEN, cfg,
                                         ranks.MAX_SEQ, attn="plain")
        with fake_world(1):
            mesh = _fake_mesh((1, 1))
            assert tf._MeshLM.of(cfg, mesh).expert_layout["ep_axis"] == \
                "model"
            with use_mesh(mesh):
                got, got_c = tf.lm_decode_step(params, tok, caches(),
                                               ranks.CACHE_LEN, cfg,
                                               ranks.MAX_SEQ, attn="plain")
    assert torch.equal(got, want)
    for n in want_c:
        for a, b in zip(got_c[n], want_c[n]):
            assert torch.equal(a, b)
