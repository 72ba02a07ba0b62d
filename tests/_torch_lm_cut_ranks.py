"""Rank bodies for ``tests/test_torch_lm_mesh_cut.py``: gloo ranks spawned
by ``_torch_dist_ranks.spawn``, each reading the test's inputs from
``inputs.npz`` under its temporary directory and writing its results to
``rank<r>.npz`` / ``rank<r>.json`` there.

* The cut attention cores: for each case of ``CASES``,
  ``nn.attention.tp_prefill_attention`` on a (1, 4) data x model mesh with
  the core cut as the case says and with it whole (``core_cut`` replaced
  for the call), on the same weights
  (the rank's column blocks of ``wq`` / ``wk`` / ``wv``, its row block of
  ``wo``) and the same whole ``x``: the output, the caches, and the
  gradients of ``sum(out * r)`` with respect to ``x`` and the rank's
  weight blocks.
* The remat'ed mesh loss, its backward run from a ``threading.Thread``
  that has no ambient mesh, on a (2, 2) mesh for each arch of ``ARCHS`` at
  ``REDUCED``: its loss and gradients beside the no-remat loss's; and
  ``moe_apply`` over checkpointed token chunks, its backward run from such
  a thread and from the caller's.

Imports torch and the port only (no jax): a spawned rank imports this
module afresh.
"""
import json
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from _torch_dist_ranks import _init

# name -> (n_heads, n_kv, cut, window) at d_model 32, head_dim 8 on a
# model axis of 4: the head cut with 2 ranks on one KV head (n_kv < model),
# with whole GQA groups a rank, with a rank's heads straddling two groups;
# the row cut (6 heads do not divide 4) with and without a window
CASES = {
    "heads_shared_kv": (8, 2, "heads", None),
    "heads_whole_groups": (8, 4, "heads", None),
    "heads_straddling": (12, 6, "heads", None),
    "rows": (6, 2, "rows", None),
    "rows_window": (6, 2, "rows", 5),
}
D, HD, B, S, MODEL = 32, 8, 2, 16, 4
ARCHS = ("granite_8b", "granite_moe_3b_a800m")


def _block(a, dim: int, i: int, n: int) -> np.ndarray:
    k = a.shape[dim] // n
    return np.take(a, np.arange(i * k, (i + 1) * k), axis=dim)


def _cut_cases(mesh, inp) -> dict:
    from repro_torch.nn import attention
    from repro_torch.nn.attention import (core_cut, rope_freqs,
                                          tp_prefill_attention)
    i = mesh.coord("model")
    cos, sin = rope_freqs(HD, S, dtype=torch.float32, device="cpu")
    out = {}
    for name, (H, KV, cut, window) in CASES.items():
        full = {k: inp[f"{name}/{k}"] for k in ("wq", "wk", "wv", "wo")}
        assert core_cut(H, S, mesh, True, True) == cut
        for how in (cut, "whole"):
            p = {k: {"w": torch.tensor(_block(w, 0 if k == "wo" else 1, i,
                                              MODEL), requires_grad=True)}
                 for k, w in full.items()}
            x = torch.tensor(inp[f"{name}/x"], requires_grad=True)
            attention.core_cut = lambda *a, how=how, **kw: how
            try:
                y, (k, v) = tp_prefill_attention(
                    p, x, H, KV, HD, cos, sin, mesh, True, True, True,
                    window=window)
            finally:
                attention.core_cut = core_cut
            r = torch.as_tensor(inp[f"{name}/r"])
            grads = torch.autograd.grad((y * r).sum(),
                                        [x] + [p[n]["w"] for n in sorted(p)])
            tag = f"{name}/{how if how == 'whole' else 'cut'}"
            out[f"{tag}/out"] = y.detach().numpy()
            out[f"{tag}/k"] = k.detach().numpy()
            out[f"{tag}/v"] = v.detach().numpy()
            out[f"{tag}/grad_x"] = grads[0].numpy()
            for n, g in zip(sorted(p), grads[1:]):
                out[f"{tag}/grad_{n}"] = g.numpy()
    return out


def _thread_backward(mesh, inp) -> tuple:
    import importlib
    from repro_torch import convert
    from repro_torch.configs.families import LMBundle
    from repro_torch.dist.sharding import ambient_mesh, use_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.nn import attention
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    from _torch_lm_mesh_ranks import unflatten

    out, info = {}, {}
    i = mesh.coord("data")
    for arch in ARCHS:
        cfg = importlib.import_module(f"repro_torch.configs.{arch}").REDUCED
        cn = LMBundle(cfg).make_constrain()
        local = convert.shard_params(unflatten(inp, f"{arch}/params/"), cfg,
                                     mesh, "cpu")
        tok, tgt = (torch.as_tensor(inp[f"{arch}/{n}"]) for n in
                    ("tokens", "targets"))
        k = tok.shape[0] // mesh.shape["data"]
        tok, tgt = tok[i * k:(i + 1) * k], tgt[i * k:(i + 1) * k]
        info[f"{arch}/cut"] = attention.core_cut(
            cfg.n_heads, tok.shape[1], mesh, True, True)
        runs = {}
        remat = tf._remat
        for rematted in (True, False):
            live = [p.detach().requires_grad_(True)
                    for p in tree_leaves(local)]
            # the no-remat loss: the checkpoints replaced by plain calls
            tf._remat = remat if rematted else (lambda fn, *a: fn(*a))
            try:
                with use_mesh(mesh):
                    loss = tf.lm_loss(tree_unflatten(local, live), tok, tgt,
                                      cfg, constrain=cn)
            finally:
                tf._remat = remat
            seen = {}

            def backward():
                seen["mesh"] = ambient_mesh()
                seen["grads"] = torch.autograd.grad(loss, live)
            if rematted:
                th = threading.Thread(target=backward)
                th.start()
                th.join()
                info[f"{arch}/thread_saw_mesh"] = seen["mesh"] is not None
            else:
                backward()
            runs[rematted] = (loss.detach(), seen["grads"])
        for rematted, (loss, grads) in runs.items():
            tag = f"{arch}/{'remat' if rematted else 'plain'}"
            out[f"{tag}/loss"] = loss.numpy()
            for n, g in enumerate(grads):
                out[f"{tag}/grad{n}"] = g.numpy()
        info[f"{arch}/n_grads"] = len(runs[True][1])
    out.update(_moe_chunks(mesh, inp, ambient_mesh, use_mesh))
    return out, info


def _moe_chunks(mesh, inp, ambient_mesh, use_mesh) -> dict:
    """``moe_apply`` over token chunks, each under a checkpoint of its own,
    with the rank's F-slices on ``model``: its gradients with the backward
    run from a thread that has no ambient mesh, and from this one."""
    from repro_torch.nn.moe import moe_apply
    i, n = mesh.coord("model"), mesh.shape["model"]
    whole = {k: inp[f"moe/{k}"] for k in ("router", "wg", "wu", "wd")}
    out = {}
    for where in ("thread", "caller"):
        p = {k: torch.tensor(w if k == "router" else _block(
                 w, 1 if k == "wd" else 2, i, n), requires_grad=True)
             for k, w in whole.items()}
        x = torch.tensor(inp["moe/x"], requires_grad=True)
        with use_mesh(mesh):
            y, aux = moe_apply(p, x, 2, tp_axis="model", token_chunks=2)
        leaves = [x] + [p[k] for k in sorted(p)]
        seen = {}

        def backward():
            seen["mesh"] = ambient_mesh()
            seen["grads"] = torch.autograd.grad(
                (y * torch.as_tensor(inp["moe/r"])).sum() + aux, leaves)
        if where == "thread":
            th = threading.Thread(target=backward)
            th.start()
            th.join()
            assert seen["mesh"] is None
        else:
            backward()
        out[f"moe/{where}/out"] = y.detach().numpy()
        for k, g in zip(["x"] + sorted(p), seen["grads"]):
            out[f"moe/{where}/grad_{k}"] = g.numpy()
    return out


def cut_suite(rank: int, world: int, tmp: str) -> None:
    _init(rank, world, tmp)
    try:
        from repro_torch.dist.sharding import as_mesh
        from repro_torch.launch.mesh import make_debug_mesh

        inp = np.load(os.path.join(tmp, "inputs.npz"))
        cut_mesh = as_mesh(make_debug_mesh((1, MODEL), device="cpu"))
        out = _cut_cases(cut_mesh, inp)
        lm_mesh = as_mesh(make_debug_mesh((2, 2), device="cpu"))
        more, info = _thread_backward(lm_mesh, inp)
        out.update(more)
        info["coords"] = {"cut": cut_mesh.coord("model"),
                          "data": lm_mesh.coord("data"),
                          "model": lm_mesh.coord("model")}
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    finally:
        dist.destroy_process_group()
