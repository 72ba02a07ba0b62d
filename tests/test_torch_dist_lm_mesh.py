"""The LM half of distributed over gloo ranks on the CPU
(``repro_torch/dist/{sharding,spmd}.py``, the mesh path of
``models/transformer.py`` and ``nn/moe.py``'s ``tp_axis``,
``convert.shard_params``) against the reference under its own mesh.

Module fixtures spawn 4 ranks on a (2, 2) data x model mesh and 8 on
(2, 4), each rank's body in the jax-free ``tests/_torch_lm_mesh_ranks.py``;
at the same time the reference runs the same steps in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` on ``with mesh:``
(its MoE branch is shard-local over the data axes there: its own oracle,
not the unsharded path).  The archs: ``REDUCED`` granite-8b, granite-moe
and llama4, fp32 compute, the reference's weights.

Held, each rank's block against the same block of the reference's output
(of the largest |entry|): ``lm_forward``'s logits and the MoE ``aux``,
``lm_loss`` and every gradient, ``lm_prefill``'s logits and caches, one
decode step from the prefill's caches padded to 64 positions and cut as
``LMBundle._cache_spec`` lays them out (and of 3 rows, which do not divide
the data axis: every row on every rank, the sequence over every axis),
all within 1e-5; one donated
train step (the clip's norm over the mesh): its loss within 1e-5, Adam's
``m`` (the clipped gradients) within 1e-6, and each parameter's update
within 1e-6 of Adam's arithmetic on the rank's own ``m`` and ``v``.  The
parameters are not held to the reference's directly: a first Adam step
maps g to about g / (|g| + 1e-8), so where a gradient is 1e-8 the
gradients' fp32 rounding (1e-9 at the largest, another summation order
here) moves its update by a few percent of the 3e-4 step.  llama4's Adam
moments are stored in bf16: ``m`` is held within one bf16 ulp (plus
1e-6), and the
update, computed from the fp32 moments before they were stored, within
3e-4 x 2^-7 of the arithmetic on the stored ones;
the MoE branch's drops of each data shard equal.  llama4's one-layer stacks do not divide the
data axis: ``shard_params`` raises there, as the reference's
``shard_shape`` does, and the ranks hold the stacks whole.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
from repro.configs import granite_8b as ref_granite_8b
from repro.configs import granite_moe_3b_a800m as ref_granite_moe
from repro.configs import llama4_maverick_400b_a17b as ref_llama4
from repro.models.transformer import lm_init as ref_lm_init
from repro_torch import convert
from repro_torch.configs import granite_8b, granite_moe_3b_a800m
from repro_torch.configs import llama4_maverick_400b_a17b
from repro_torch.dist.sharding import AbstractMesh

import _torch_dist_ranks as dist_ranks
import _torch_lm_mesh_ranks as ranks

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
STEP_TOL = 1e-6
B, S, PROMPT = 4, 16, 8
REF_MODS = {"granite_8b": ref_granite_8b,
            "granite_moe_3b_a800m": ref_granite_moe,
            "llama4_maverick_400b_a17b": ref_llama4}
PORT_MODS = {"granite_8b": granite_8b,
             "granite_moe_3b_a800m": granite_moe_3b_a800m,
             "llama4_maverick_400b_a17b": llama4_maverick_400b_a17b}
# inside the child, before jax initialises (as tests/test_dist_integration.py)
REF = r"""
import importlib, os, sys
tmp, world = sys.argv[1], int(sys.argv[2])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={world}"
import math
import numpy as np, jax, jax.numpy as jnp
import repro.nn.moe as rmoe
from repro.configs.families import LMBundle
from repro.models.transformer import (lm_forward, lm_loss, lm_prefill,
                                      lm_decode_step)
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from _torch_lm_mesh_ranks import ARCHS, MAX_SEQ, flatten, unflatten
inp = np.load(os.path.join(tmp, "inputs.npz"))
mesh = jax.make_mesh((2, world // 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out, drops = {}, {}
orig = rmoe._segment_cumcount
for arch in ARCHS:
    mod = importlib.import_module(f"repro.configs.{arch}")
    cfg = mod.REDUCED
    bundle = LMBundle(cfg, moments_dtype=mod.SPEC.bundle().moments_dtype)
    cn = bundle.make_constrain()
    params = jax.tree_util.tree_map(jnp.asarray,
                                    unflatten(inp, f"{arch}/params/"))
    tok = jnp.asarray(inp[f"{arch}/tokens"])
    tgt = jnp.asarray(inp[f"{arch}/targets"])
    prompt = jnp.asarray(inp[f"{arch}/prompt"])
    rec = drops.setdefault(arch, [])

    def counted(seg_ids, num_segments):
        rank = orig(seg_ids, num_segments)
        T = seg_ids.shape[0] // cfg.top_k
        C = max(int(math.ceil(T * cfg.top_k / num_segments * 1.25)),
                min(cfg.top_k, T))
        jax.debug.callback(lambda i, d: rec.append([int(i), int(d)]),
                           jax.lax.axis_index("data"), jnp.sum(rank >= C))
        return rank
    with mesh:
        if cfg.n_experts:
            rmoe._segment_cumcount = counted
        lo, aux = jax.jit(lambda p, t: lm_forward(p, t, cfg, constrain=cn)
                          )(params, tok)
        jax.block_until_ready(lo)
        jax.effects_barrier()
        rmoe._segment_cumcount = orig
        out[f"{arch}/logits"], out[f"{arch}/aux"] = lo, aux
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: lm_loss(p, tok, tgt, cfg, constrain=cn)))(params)
        out[f"{arch}/loss"] = loss
        out.update(flatten(grads, f"{arch}/grads/"))
        pl, caches = jax.jit(lambda p, t: lm_prefill(p, t, cfg,
                                                     constrain=cn))(params,
                                                                    prompt)
        out[f"{arch}/prefill_logits"] = pl
        out.update(flatten(caches, f"{arch}/prefill_caches/"))
        pad = lambda c: jnp.pad(c, [(0, 0)] * (c.ndim - 3)
                                + [(0, MAX_SEQ - c.shape[-3]), (0, 0),
                                   (0, 0)])
        full = jax.tree_util.tree_map(pad, caches)
        dl, _ = jax.jit(lambda p, t, c: lm_decode_step(
            p, t, c, jnp.int32(prompt.shape[1]), cfg, MAX_SEQ,
            constrain=cn))(params, jnp.asarray(inp[f"{arch}/next"]), full)
        out[f"{arch}/decode_logits"] = dl
        dl3, _ = jax.jit(lambda p, t, c: lm_decode_step(
            p, t, c, jnp.int32(prompt.shape[1]), cfg, MAX_SEQ,
            constrain=cn))(params, jnp.asarray(inp[f"{arch}/next"][:3]),
                           jax.tree_util.tree_map(
                               lambda c: c[..., :3, :, :, :], full))
        out[f"{arch}/decode3_logits"] = dl3
        step = jax.jit(bundle.step_fn("train_4k"))
        p2, s2, l2 = step(params, bundle.opt().init(params),
                          {"tokens": tok, "targets": tgt})
        out[f"{arch}/step_loss"] = l2
        out.update(flatten(p2, f"{arch}/step_params/"))
        out.update(flatten(s2["m"], f"{arch}/step_m/"))
out = {k: np.asarray(v, np.float32) for k, v in out.items()}
np.savez(os.path.join(tmp, "ref.npz"), **out)
with open(os.path.join(tmp, "ref_drops.json"), "w") as f:
    json = __import__("json")
    json.dump(drops, f)
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
    for i, (arch, mod) in enumerate(REF_MODS.items()):
        cfg = mod.REDUCED
        params = jax.tree_util.tree_map(
            np.asarray, ref_lm_init(jax.random.PRNGKey(i), cfg))
        inputs.update(ranks.flatten(params, f"{arch}/params/"))
        rng = np.random.default_rng(10 + i)
        draw = lambda *shape: rng.integers(0, cfg.vocab, shape).astype(
            np.int32)
        inputs[f"{arch}/tokens"] = draw(B, S)
        inputs[f"{arch}/targets"] = draw(B, S)
        inputs[f"{arch}/prompt"] = draw(B, PROMPT)
        inputs[f"{arch}/next"] = draw(B, 1)
    return inputs


@pytest.fixture(scope="module", params=[4, 8], ids=["2x2", "2x4"])
def runs(request, tmp_path_factory):
    world = request.param
    tmp = str(tmp_path_factory.mktemp(f"lm{world}"))
    inputs = _inputs()
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    ref = subprocess.Popen([sys.executable, "-c", REF, tmp, str(world)],
                           cwd=ROOT, env=_SUBPROC_ENV,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        dist_ranks.spawn(ranks.lm_suite, world, tmp, timeout_s=600.0)
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
    with open(os.path.join(tmp, "ref_drops.json")) as f:
        drops = json.load(f)
    return (world, inputs, arrays, infos,
            dict(np.load(os.path.join(tmp, "ref.npz"))), drops)


def _mesh(world):
    return AbstractMesh((2, world // 2), ("data", "model"))


def _block(a, spec, world, coords):
    return convert.local_block(a, spec, _mesh(world), coords)


def _params_blocks(arch, tree_prefix, ref, arrays, infos, world, tol,
                   ulp=False):
    """Each rank's leaves under ``tree_prefix`` against the block of the
    reference's leaf under the rank's layout of the parameters (``ulp``:
    within one bf16 ulp of each entry, plus ``tol``)."""
    cfg = PORT_MODS[arch].REDUCED
    for a, info in zip(arrays, infos):
        specs = convert.param_specs(cfg, _mesh(world), info[f"{arch}/zero"])
        tree = ranks.unflatten(ref, f"{arch}/{tree_prefix}/")
        from repro_torch.dist.sharding import broadcast_specs, leaves
        flat = ranks.flatten(tree)
        for (key, r), spec in zip(flat.items(), leaves(broadcast_specs(
                specs, tree))):
            got = a[f"{arch}/{tree_prefix}/{key}"]
            want = _block(r, spec, world, info["coords"])
            what = f"{arch} {tree_prefix} {key} at {info['coords']}"
            if ulp:
                err = np.abs(got - want)
                assert (err <= np.abs(want) * 2.0 ** -7 + tol).all(), what
            else:
                _close(got, want, tol, what=what)


def _rows_vocab(ref, world, coords, vocab_cut=True):
    """The rank's batch rows and, where the head is vocabulary-cut, its
    vocabulary block of (B, S, V) logits."""
    nm = world // 2
    k = ref.shape[0] // 2
    out = ref[coords["data"] * k:(coords["data"] + 1) * k]
    if vocab_cut and nm > 1:
        v = ref.shape[-1] // nm
        out = out[..., coords["model"] * v:(coords["model"] + 1) * v]
    return out


ARCHS = tuple(REF_MODS)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_the_reference_mesh(runs, arch):
    world, _, arrays, infos, ref, _ = runs
    for a, info in zip(arrays, infos):
        _close(a[f"{arch}/logits"],
               _rows_vocab(ref[f"{arch}/logits"], world, info["coords"]),
               what=f"{arch} logits at {info['coords']}")
        _close(a[f"{arch}/aux"], ref[f"{arch}/aux"], what=f"{arch} aux")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference_mesh(runs, arch):
    world, _, arrays, infos, ref, _ = runs
    for a in arrays:
        _close(a[f"{arch}/loss"], ref[f"{arch}/loss"], what=f"{arch} loss")
    _params_blocks(arch, "grads", ref, arrays, infos, world, TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference_mesh(runs, arch):
    world, _, arrays, infos, ref, _ = runs
    for a, info in zip(arrays, infos):
        c = info["coords"]
        _close(a[f"{arch}/prefill_logits"],
               _rows_vocab(ref[f"{arch}/prefill_logits"], world, c),
               what=f"{arch} prefill logits")
        _close(a[f"{arch}/decode_logits"],
               _rows_vocab(ref[f"{arch}/decode_logits"], world, c),
               what=f"{arch} decode logits")
        # 3 rows: every row on every rank, the vocabulary still cut
        r3 = ref[f"{arch}/decode3_logits"]
        v = r3.shape[-1] // (world // 2)
        _close(a[f"{arch}/decode3_logits"],
               r3[..., c["model"] * v:(c["model"] + 1) * v],
               what=f"{arch} decode of 3 rows (sequence over every axis)")
        for key in ref:
            if key.startswith(f"{arch}/prefill_caches/"):
                r = ref[key]
                # (lead..., B, S, KV, hd): the rank's rows, whole otherwise
                k = r.shape[-4] // 2
                want = r[..., c["data"] * k:(c["data"] + 1) * k, :, :, :]
                _close(a[key], want, what=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_donated_train_step_matches_the_reference_mesh(runs, arch):
    world, inputs, arrays, infos, ref, _ = runs
    for a in arrays:
        _close(a[f"{arch}/step_loss"], ref[f"{arch}/step_loss"],
               what=f"{arch} step loss")
    bf16 = PORT_MODS[arch].SPEC.bundle().moments_dtype != np.float32 and \
        str(PORT_MODS[arch].SPEC.bundle().moments_dtype) == "torch.bfloat16"
    _params_blocks(arch, "step_m", ref, arrays, infos, world, STEP_TOL,
                   ulp=bf16)
    # the update each rank applied in place: Adam(3e-4)'s first step
    params = {k: v for k, v in inputs.items()
              if k.startswith(f"{arch}/params/")}
    _params_blocks(arch, "params", params, [
        {f"{arch}/params/{k[len(f'{arch}/step_params/'):]}": (
            a[k] + 3e-4 * (a[k.replace("step_params", "step_m")] / 0.1)
            / (np.sqrt(a[k.replace("step_params", "step_v")] / 1e-3)
               + 1e-8))
         for k in a if k.startswith(f"{arch}/step_params/")}
        for a in arrays], infos, world, 3e-4 * 2.0 ** -7 if bf16 else STEP_TOL)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m",
                                  "llama4_maverick_400b_a17b"])
def test_moe_drops_of_each_data_shard_match(runs, arch):
    world, _, _, infos, _, drops = runs
    got = sorted([info["coords"]["data"], d] for info in infos
                 for d in info[f"{arch}/drops"])
    assert got == sorted(drops[arch])
    assert len(got) == world * PORT_MODS[arch].REDUCED.n_moe_layers


def test_llama4_stacks_raise_where_the_reference_raises(runs):
    """One-layer stacks on a data axis of 2: ``shard_params`` raises
    (trap 1 of the reference's ZeRO entry) and the ranks hold them
    whole; the two-layer stacks of the other archs are ZeRO-cut."""
    _, _, _, infos, _, _ = runs
    for info in infos:
        assert info["llama4_maverick_400b_a17b/zero"] is False
        assert info["granite_8b/zero"] is True
        assert info["granite_moe_3b_a800m/zero"] is True
