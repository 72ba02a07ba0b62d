"""Rank bodies for ``tests/test_torch_dist_moe_ep.py``: gloo ranks spawned
by ``_torch_dist_ranks.spawn``, each reading the test's inputs from
``inputs.npz`` under its temporary directory and writing its blocks of
every output to ``rank<r>.npz`` / ``rank<r>.json`` there.

The MoE LMs through the branch of ``models.transformer._moe_ffn`` that is
not shard-local, for each variant of ``VARIANTS`` (``REDUCED`` configs,
some with another expert count or width, so that every layout of the
experts is reached), on two meshes of the world's ranks:

* (2, world / 2) data x model: one ``lm_decode_step`` of 3 rows, which do
  not divide the data axis (every row on every rank, the caches' sequence
  cut over every axis, ``LMBundle._cache_spec``'s other layout): its
  logits and the rank's window of the updated caches; with ``TRAIN_2D``
  variants also ``lm_loss`` and its gradients, the batch cut over data
  (their d_ff does not divide the model axis, so training takes the
  branch too);
* (1, world): ``lm_forward`` (logits, aux), ``lm_loss`` and its gradients,
  and a prefill of one row (logits, caches).

Every ``moe_apply`` call of ``_moe_ffn`` is recorded: its layout keyword
(``ep_axis`` / ``tp_axis``, or ``local`` for the shard-local branch), and
the rank's expert count and expert width.  Imports torch and the port
only (no jax): a spawned rank imports this module afresh.
"""
import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_dist_ranks import _init
from _torch_lm_mesh_ranks import flatten, unflatten

# name -> (config module, LMConfig overrides): E = 8 divides every model
# axis here (the rank's experts); E = 6 divides only 2 (F-slices on 4 and
# 8); d_ff = 66 divides no model axis above 2, so its shared expert and
# dense FFN are held whole and its training takes the branch on (2, 4)
VARIANTS = {
    "granite_moe": ("granite_moe_3b_a800m", {}),
    "llama4": ("llama4_maverick_400b_a17b", {}),
    "granite_moe_e6": ("granite_moe_3b_a800m", {"n_experts": 6}),
    "llama4_f66": ("llama4_maverick_400b_a17b", {"d_ff": 66}),
}
TRAIN_2D = ("llama4_f66",)
MAX_SEQ = 64
CACHE_LEN = 40


def variant_config(name: str, package: str = "repro_torch"):
    """The variant's ``LMConfig`` from ``package``'s configs."""
    import importlib
    mod, over = VARIANTS[name]
    cfg = importlib.import_module(f"{package}.configs.{mod}").REDUCED
    return dataclasses.replace(cfg, **over)


def meshes(world: int) -> dict:
    return {"2d": (2, world // 2), "1d": (1, world)}


def moe_suite(rank: int, world: int, tmp: str) -> None:
    _init(rank, world, tmp)
    try:
        from repro_torch import convert
        from repro_torch.configs.families import LMBundle
        from repro_torch.dist.sharding import as_mesh, use_mesh
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models import transformer as tf
        from repro_torch.train.optimizer import tree_leaves, tree_unflatten

        inp = np.load(os.path.join(tmp, "inputs.npz"))
        made = {k: as_mesh(make_debug_mesh(s, device="cpu"))
                for k, s in meshes(world).items()}
        out, info = {}, {"calls": {}, "zero": {}, "coords": {}}
        calls = []
        apply = tf.moe_apply

        def recording(p, x, top_k, **kw):
            kind = ("local" if "token_chunks" in kw else
                    "ep" if "ep_axis" in kw else "tp")
            calls.append([kind, int(p["wg"].shape[0]),
                          int(p["wg"].shape[-1])])
            return apply(p, x, top_k, **kw)
        tf.moe_apply = recording

        def grads_of(local, cfg, tok, tgt, cn):
            live = [t.detach().requires_grad_(True)
                    for t in tree_leaves(local)]
            loss = tf.lm_loss(tree_unflatten(local, live), tok, tgt, cfg,
                              constrain=cn)
            return loss, torch.autograd.grad(loss, live)

        for name in VARIANTS:
            cfg = variant_config(name)
            cn = LMBundle(cfg).make_constrain()
            full = unflatten(inp, f"{name}/params/")
            for mk, mesh in made.items():
                key = f"{name}/{mk}"
                info["coords"][mk] = {a: mesh.coord(a)
                                      for a in mesh.axis_names}
                try:
                    local = convert.shard_params(full, cfg, mesh, "cpu")
                    info["zero"][key] = True
                except ValueError:
                    # a stack the data axis does not divide: held whole,
                    # where the reference's ZeRO entry raises
                    local = convert.shard_params(full, cfg, mesh, "cpu",
                                                 zero=False)
                    info["zero"][key] = False
                calls.clear()
                with use_mesh(mesh):
                    if mk == "2d":
                        win = MAX_SEQ // mesh.size
                        lo = mesh.index(mesh.axis_names) * win
                        caches = {k: tuple(torch.as_tensor(
                            np.ascontiguousarray(c[..., lo:lo + win, :, :]))
                            for c in pair) for k, pair in unflatten(
                                inp, f"{name}/caches3/").items()}
                        with torch.no_grad():
                            dl, new = tf.lm_decode_step(
                                local, torch.as_tensor(inp[f"{name}/next3"]),
                                caches, CACHE_LEN, cfg, MAX_SEQ,
                                attn="plain", constrain=cn)
                        out[f"{key}/decode3_logits"] = dl.numpy()
                        out.update(flatten(new, f"{key}/decode3_caches/"))
                        if name in TRAIN_2D and \
                                cfg.d_ff % mesh.shape["model"]:
                            i, n = mesh.coord("data"), mesh.shape["data"]
                            tok, tgt = (torch.as_tensor(np.array_split(
                                inp[f"{name}/{t}"], n)[i])
                                for t in ("tokens", "targets"))
                            loss, grads = grads_of(local, cfg, tok, tgt, cn)
                            out[f"{key}/loss"] = loss.detach().numpy()
                            out.update(flatten(tree_unflatten(local, grads),
                                               f"{key}/grads/"))
                    else:
                        tok = torch.as_tensor(inp[f"{name}/tokens"])
                        tgt = torch.as_tensor(inp[f"{name}/targets"])
                        with torch.no_grad():
                            lg, aux = tf.lm_forward(local, tok, cfg,
                                                    constrain=cn)
                            pl, pc = tf.lm_prefill(
                                local, torch.as_tensor(inp[f"{name}/prompt1"]),
                                cfg, constrain=cn)
                        out[f"{key}/logits"] = lg.numpy()
                        out[f"{key}/aux"] = aux.numpy()
                        out[f"{key}/prefill1_logits"] = pl.numpy()
                        out.update(flatten(pc, f"{key}/prefill1_caches/"))
                        loss, grads = grads_of(local, cfg, tok, tgt, cn)
                        out[f"{key}/loss"] = loss.detach().numpy()
                        out.update(flatten(tree_unflatten(local, grads),
                                           f"{key}/grads/"))
                info["calls"][key] = [list(c) for c in calls]
        tf.moe_apply = apply
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    finally:
        dist.destroy_process_group()
