"""The mesh path's cut attention core and its remat
(``nn.attention.core_cut`` / ``tp_prefill_attention``, the checkpointed
units of ``models.transformer._mesh_backbone`` and ``_mesh_loss``).

* ``flash_attention(q_offset=...)``: the rows of a longer sequence attend
  as they do within it, against the reference's flash core (1e-6).
* Module fixture: 4 gloo ranks (bodies in the jax-free
  ``tests/_torch_lm_cut_ranks.py``).  Each case of its ``CASES`` cuts the
  core on a (1, 4) mesh (by heads: two ranks on one KV head, whole GQA
  groups, heads straddling two groups; by query rows, with and without a
  window) and runs it whole on the same weights: the output, the caches
  and every gradient of the cut core equal the whole core's within 1e-6
  of the largest entry, and the whole core the reference's
  ``prefill_attention`` on the gathered weights within 1e-5.
* The remat'ed mesh loss of ``REDUCED`` granite-8b and granite-moe on a
  (2, 2) mesh, its backward run from a ``threading.Thread`` that has no
  ambient mesh (a checkpoint's recompute runs in autograd's thread: on
  CUDA a device thread, where the caller's context variables are not
  set), gives the loss and gradients of the no-remat loss, bit for bit;
  so do ``moe_apply``'s checkpointed token chunks (the same trap).
* ``roofline.count`` of a mesh train step at depth L and 2L on a fake (2,
  4) mesh: the peak grows by no more than L sequence-cut carries plus the
  state the added layers bring; a layer's activations do not show up.
  And of a prefill there: the cut takes 3/4 of the core's FLOPs off a
  rank, by heads and by rows.
"""
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from repro.configs import granite_8b as ref_granite_8b
from repro.configs import granite_moe_3b_a800m as ref_granite_moe
from repro.models.transformer import lm_init as ref_lm_init
from repro.nn import attention as ref_attention

import _torch_dist_ranks as dist_ranks
import _torch_lm_cut_ranks as ranks
from _torch_lm_mesh_ranks import flatten

CUT_TOL = 1e-6
REF_TOL = 1e-5
WORLD = 4
LM_B, LM_S = 4, 16


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, f"{what}: {got.shape} != {ref.shape}"
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3g}"


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("lo, rows", [(0, 8), (8, 8), (12, 4)])
def test_flash_q_offset_rows_attend_as_within_the_sequence(lo, rows, window):
    from repro_torch.nn.attention import flash_attention
    rng = np.random.default_rng(lo + rows)
    q = rng.standard_normal((2, 16, 6, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
            for _ in range(2))
    ref = np.asarray(ref_attention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window))
    got = flash_attention(torch.as_tensor(q[:, lo:lo + rows]),
                          torch.as_tensor(k), torch.as_tensor(v),
                          window=window, q_offset=lo).numpy()
    _close(got, ref[:, lo:lo + rows], CUT_TOL, f"rows {lo}:{lo + rows}")


def _inputs():
    rng = np.random.default_rng(28)
    inputs = {}
    for name, (H, KV, _, _) in ranks.CASES.items():
        D, HD = ranks.D, ranks.HD
        for w, shape in (("wq", (D, H * HD)), ("wk", (D, KV * HD)),
                         ("wv", (D, KV * HD)), ("wo", (H * HD, D))):
            inputs[f"{name}/{w}"] = (rng.standard_normal(shape)
                                     / np.sqrt(shape[0])).astype(np.float32)
        inputs[f"{name}/x"] = rng.standard_normal(
            (ranks.B, ranks.S, D)).astype(np.float32)
        inputs[f"{name}/r"] = rng.standard_normal(
            (ranks.B, ranks.S, D)).astype(np.float32)
    for i, (arch, mod) in enumerate((("granite_8b", ref_granite_8b),
                                     ("granite_moe_3b_a800m",
                                      ref_granite_moe))):
        cfg = mod.REDUCED
        params = jax.tree_util.tree_map(
            np.asarray, ref_lm_init(jax.random.PRNGKey(20 + i), cfg))
        inputs.update(flatten(params, f"{arch}/params/"))
        for n in ("tokens", "targets"):
            inputs[f"{arch}/{n}"] = rng.integers(
                0, cfg.vocab, (LM_B, LM_S)).astype(np.int32)
    E, d, F = 4, 8, 8
    for k, shape in (("router", (d, E)), ("wg", (E, d, F)), ("wu", (E, d, F)),
                     ("wd", (E, F, d)), ("x", (16, d)), ("r", (16, d))):
        inputs[f"moe/{k}"] = rng.standard_normal(shape).astype(np.float32)
    return inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cut"))
    inputs = _inputs()
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    dist_ranks.spawn(ranks.cut_suite, WORLD, tmp, timeout_s=600.0)
    arrays = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
              for r in range(WORLD)]
    infos = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
             for r in range(WORLD)]
    return inputs, arrays, infos


def _reference(inputs, name):
    """The reference's prefill attention on the whole weights: the output,
    the caches, and the gradients of ``sum(out * r)`` (x, then the weights
    in name order)."""
    H, KV, _, window = ranks.CASES[name]
    cos, sin = ref_attention.rope_freqs(ranks.HD, ranks.S)
    w = {k: jnp.asarray(inputs[f"{name}/{k}"]) for k in ("wo", "wq", "wv",
                                                        "wk")}
    x, r = (jnp.asarray(inputs[f"{name}/{k}"]) for k in ("x", "r"))

    def f(x, w):
        p = {k: {"w": v} for k, v in w.items()}
        out, kv = ref_attention.prefill_attention(p, x, H, KV, ranks.HD, cos,
                                                  sin, window=window)
        return jnp.sum(out * r), (out, kv)
    (_, (out, (k, v))), (gx, gw) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(x, w)
    return out, k, v, gx, gw


@pytest.mark.parametrize("name", list(ranks.CASES))
def test_cut_core_equals_the_whole_core(runs, name):
    inputs, arrays, infos = runs
    keys = ["out", "k", "v", "grad_x", "grad_wk", "grad_wo", "grad_wq",
            "grad_wv"]
    for a, info in zip(arrays, infos):
        for key in keys:
            _close(a[f"{name}/cut/{key}"], a[f"{name}/whole/{key}"], CUT_TOL,
                   f"{name} {key} at model {info['coords']['cut']}")
    out, k, v, gx, gw = _reference(inputs, name)
    for a, info in zip(arrays, infos):
        i = info["coords"]["cut"]
        _close(a[f"{name}/whole/out"], out, REF_TOL, f"{name} out")
        _close(a[f"{name}/whole/k"], k, REF_TOL, f"{name} k cache")
        _close(a[f"{name}/whole/v"], v, REF_TOL, f"{name} v cache")
        _close(a[f"{name}/whole/grad_x"], gx, REF_TOL, f"{name} grad x")
        for n, g in gw.items():
            _close(a[f"{name}/whole/grad_{n}"],
                   ranks._block(np.asarray(g), 0 if n == "wo" else 1, i,
                                ranks.MODEL), REF_TOL, f"{name} grad {n}")


@pytest.mark.parametrize("arch, cut", [("granite_8b", "heads"),
                                       ("granite_moe_3b_a800m", "heads")])
def test_remat_backward_from_a_thread_without_the_mesh(runs, arch, cut):
    _, arrays, infos = runs
    for a, info in zip(arrays, infos):
        assert info[f"{arch}/cut"] == cut
        assert info[f"{arch}/thread_saw_mesh"] is False
        np.testing.assert_array_equal(a[f"{arch}/remat/loss"],
                                      a[f"{arch}/plain/loss"])
        for n in range(info[f"{arch}/n_grads"]):
            np.testing.assert_array_equal(
                a[f"{arch}/remat/grad{n}"], a[f"{arch}/plain/grad{n}"],
                err_msg=f"{arch} gradient {n} at {info['coords']}")


def test_moe_token_chunks_recompute_from_a_thread_without_the_mesh(runs):
    """``moe_apply``'s token chunks run under checkpoints of their own
    inside a unit: their recompute, too, finds the mesh it ran under."""
    _, arrays, _ = runs
    for a in arrays:
        keys = [k for k in a if k.startswith("moe/caller/")]
        assert len(keys) == 6
        for key in keys:
            np.testing.assert_array_equal(
                a[key.replace("/caller/", "/thread/")], a[key], err_msg=key)


def _count(cfg, mesh, batch):
    from repro_torch.configs.families import LMBundle
    from repro_torch.dist.sharding import leaves, use_mesh
    from repro_torch.launch.dryrun import _local
    from repro_torch.roofline.count import count_step
    bundle = LMBundle(cfg)
    state = bundle.abstract_state("train_4k")
    arg_sh, _ = bundle.shardings(mesh, "train_4k")
    args, arg_bytes = _local(
        (state[0], state[1], bundle.input_specs("train_4k", batch=batch)),
        arg_sh)
    with use_mesh(mesh):
        counts = count_step(bundle.step_fn("train_4k"), args, donate=(0, 1))
    params = sum(t.numel() * t.element_size() for t in leaves(args[0]))
    return counts["memory"], arg_bytes, params


def test_mesh_train_peak_grows_by_carries_not_activations():
    from repro_torch.dist.sharding import as_mesh
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import LMConfig
    L, batch, S = 2, 4, 4096
    out = {}
    with fake_world(8):
        mesh = as_mesh(make_debug_mesh((2, 4), device="cpu"))
        for depth in (L, 2 * L):
            cfg = LMConfig("depth", n_layers=depth, d_model=64, n_heads=8,
                           n_kv=2, d_ff=128, vocab=512)
            out[depth] = _count(cfg, mesh, batch)
    (m1, a1, p1), (m2, a2, p2) = out[L], out[2 * L]
    esize = torch.empty((), dtype=cfg.dtype).element_size()
    carry = (batch // 2) * (S // 4) * cfg.d_model * esize
    # the added layers' state: their parameters and Adam moments (the
    # step's arguments), and a gradient of each added parameter
    allowed = L * carry + (a2 - a1) + (p2 - p1)
    growth = (m2["peak_gb_per_device"] - m1["peak_gb_per_device"]) * 1e9
    assert growth <= allowed + 1, (growth, allowed)
    # a layer's activations (its recompute's working set) dwarf that
    assert m1["temp_gb_per_device"] * 1e9 > 100 * allowed


@pytest.mark.parametrize("n_heads, cut", [(8, "heads"), (6, "rows")])
def test_prefill_core_flops_fall_by_the_model_axis(monkeypatch, n_heads,
                                                   cut):
    """``roofline.count`` of a prefill on a fake (2, 4) mesh: cutting the
    core takes exactly 3/4 of its FLOPs off each rank (the flash core
    computes every (q, kv) chunk pair, masked or not: 2 einsums of 2 S^2 hd
    a head and sequence), and nothing else changes."""
    from repro_torch.configs.families import LMBundle
    from repro_torch.dist.sharding import as_mesh, use_mesh
    from repro_torch.launch.dryrun import _local, fake_world
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import LMConfig
    from repro_torch.nn import attention
    from repro_torch.roofline.count import count_step
    cfg = LMConfig("cut", n_layers=2, d_model=96, n_heads=n_heads, n_kv=2,
                   head_dim=16, d_ff=128, vocab=512)
    bundle = LMBundle(cfg)
    batch, S = 4, 32768
    flops = {}
    with fake_world(8):
        mesh = as_mesh(make_debug_mesh((2, 4), device="cpu"))
        args, _ = _local((bundle.abstract_params(),
                          bundle.input_specs("prefill_32k", batch=batch)),
                         bundle.shardings(mesh, "prefill_32k")[0])
        assert attention.core_cut(n_heads, S, mesh, True, True) == cut
        for how in (cut, "whole"):
            monkeypatch.setattr(attention, "core_cut",
                                lambda *a, how=how, **k: how)
            with use_mesh(mesh):
                flops[how] = count_step(bundle.step_fn("prefill_32k"),
                                        args)["flops"]
    core = cfg.n_layers * (batch // 2) * n_heads * 2 * 2 * S * S * cfg.hd
    assert flops["whole"] - flops[cut] == core * 3 / 4


def test_mesh_depth_example_gives_the_no_mesh_loss(capsys):
    """``examples/lm_mesh_depth_torch.py --device cpu --reduced``: the
    (1, 1) gloo mesh step's loss, bit for bit the no-mesh step's on the
    same seed."""
    import importlib.util
    from pathlib import Path
    from repro_torch.configs.families import LMBundle
    from repro_torch.configs.granite_8b import REDUCED
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "lm_mesh_depth_torch.py"
    spec = importlib.util.spec_from_file_location("lm_mesh_depth", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu", "--reduced", "--layers", "2"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    bundle = LMBundle(REDUCED)
    gen = torch.Generator().manual_seed(27)
    params = bundle.init_params(gen, "cpu")
    _, _, loss = bundle.step_fn("train_4k")(
        params, bundle.opt().init(params),
        bundle.make_batch("train_4k", gen, "cpu", batch=1))
    assert got == {"layers": 2, "loss": float(loss)}
