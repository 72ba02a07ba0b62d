"""Rank bodies for ``tests/test_torch_dist_lm_mesh.py``: gloo ranks spawned
by ``_torch_dist_ranks.spawn``, each reading the test's inputs from
``inputs.npz`` under its temporary directory and writing its blocks of
every output to ``rank<r>.npz`` / ``rank<r>.json`` there.

The LM mesh path on a (2, world / 2) data x model mesh, for each arch of
``ARCHS`` at ``REDUCED``: ``lm_forward`` (logits, aux, the MoE drops of
every routing call), ``lm_loss`` and its gradients, ``lm_prefill``, one
``lm_decode_step`` from the prefill's caches padded to ``MAX_SEQ`` and cut
as ``LMBundle._cache_spec`` lays them out, then one donated train step of
``LMBundle.step_fn("train_4k")``.  Imports torch and the port only (no
jax): a spawned rank imports this module afresh.
"""
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_dist_ranks import _init

ARCHS = ("granite_8b", "granite_moe_3b_a800m", "llama4_maverick_400b_a17b")
MAX_SEQ = 64


def flatten(tree, prefix="") -> dict:
    """``a/b/0``-keyed arrays of a nested dict / list / tuple tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().to(torch.float32).numpy()
    return {prefix[:-1]: np.asarray(tree)}


def unflatten(arrays, prefix: str) -> dict:
    """The tree under ``prefix`` of ``flatten``'s keys (numeric keys make
    tuples)."""
    tree: dict = {}
    for key in arrays.files if hasattr(arrays, "files") else arrays:
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arrays[key]

    def fix(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return tuple(fix(t[str(i)]) for i in range(len(t)))
        return {k: fix(v) for k, v in t.items()}
    return fix(tree)


def _rows(a, mesh, n: int):
    """The rank's rows of a batch of ``n`` rows (the batch over ``data``)."""
    i, k = mesh.coord("data"), n // mesh.shape["data"]
    return a[i * k:(i + 1) * k]


def lm_suite(rank: int, world: int, tmp: str) -> None:
    _init(rank, world, tmp)
    try:
        import importlib
        from repro_torch import convert
        from repro_torch.configs.families import LMBundle
        from repro_torch.dist.sharding import as_mesh, use_mesh
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models import transformer as tf
        from repro_torch.nn import moe
        from repro_torch.train.optimizer import (tree_leaves,
                                                 tree_unflatten)

        mesh = as_mesh(make_debug_mesh((2, world // 2), device="cpu"))
        inp = np.load(os.path.join(tmp, "inputs.npz"))
        out, info = {}, {}
        drops = []
        routes = moe.moe_routes

        def recording(*a, **kw):
            r = routes(*a, **kw)
            drops.append(int((~r.keep).sum()))
            return r
        for arch in ARCHS:
            mod = importlib.import_module(f"repro_torch.configs.{arch}")
            cfg = mod.REDUCED
            bundle = LMBundle(cfg, moments_dtype=mod.SPEC.bundle()
                              .moments_dtype)
            full = unflatten(inp, f"{arch}/params/")
            try:
                local = convert.shard_params(full, cfg, mesh, "cpu")
                zero = True
            except ValueError:
                # the ZeRO entry does not divide the stack (the
                # reference's shard_shape raises there too): held whole
                local = convert.shard_params(full, cfg, mesh, "cpu",
                                             zero=False)
                zero = False
            B = inp[f"{arch}/tokens"].shape[0]
            tok = torch.as_tensor(_rows(inp[f"{arch}/tokens"], mesh, B))
            tgt = torch.as_tensor(_rows(inp[f"{arch}/targets"], mesh, B))
            prompt = torch.as_tensor(_rows(inp[f"{arch}/prompt"], mesh, B))
            cn = bundle.make_constrain()
            with use_mesh(mesh):
                moe.moe_routes = recording
                drops.clear()
                logits, aux = tf.lm_forward(local, tok, cfg, constrain=cn)
                moe.moe_routes = routes
                out[f"{arch}/logits"] = logits.detach().numpy()
                out[f"{arch}/aux"] = aux.detach().numpy()
                info[f"{arch}/drops"] = list(drops)

                live = [p.detach().requires_grad_(True)
                        for p in tree_leaves(local)]
                loss = tf.lm_loss(tree_unflatten(local, live), tok, tgt,
                                  cfg, constrain=cn)
                grads = torch.autograd.grad(loss, live)
                out[f"{arch}/loss"] = loss.detach().numpy()
                out.update(flatten(tree_unflatten(local, grads),
                                   f"{arch}/grads/"))

                with torch.no_grad():
                    pl, caches = tf.lm_prefill(local, prompt, cfg,
                                               constrain=cn)
                    out[f"{arch}/prefill_logits"] = pl.numpy()
                    out.update(flatten(caches, f"{arch}/prefill_caches/"))
                    # pad to MAX_SEQ, then the rank's window of the sequence
                    # (LMBundle._cache_spec at this batch: seq over model)
                    spec = bundle._cache_spec(mesh, B)
                    nm = mesh.shape["model"]
                    win = MAX_SEQ // nm
                    lo = mesh.coord("model") * win
                    padded = {}
                    for name, pair in caches.items():
                        bufs = []
                        for c in pair:
                            sh = list(c.shape)
                            sh[-3] = MAX_SEQ
                            z = torch.zeros(sh, dtype=c.dtype)
                            z.narrow(-3, 0, c.shape[-3]).copy_(c)
                            assert spec(z.dim())[-3] == "model"
                            bufs.append(z.narrow(-3, lo, win).clone())
                        padded[name] = tuple(bufs)
                    P_len = prompt.shape[1]
                    nxt = torch.as_tensor(_rows(inp[f"{arch}/next"], mesh,
                                                B))
                    dl, _ = tf.lm_decode_step(local, nxt, padded, P_len,
                                              cfg, MAX_SEQ, attn="plain",
                                              constrain=cn)
                    out[f"{arch}/decode_logits"] = dl.numpy()
                    # a batch of 3 rows does not divide the data axis: the
                    # caches hold every row, the sequence cut over every
                    # axis (LMBundle._cache_spec's other layout)
                    B3 = 3
                    spec3 = bundle._cache_spec(mesh, B3)
                    win3 = MAX_SEQ // mesh.size
                    lo3 = mesh.index(mesh.axis_names) * win3
                    whole = {}
                    for name, pair in caches.items():
                        bufs = []
                        for c in pair:
                            parts = [torch.empty_like(c) for _ in
                                     range(mesh.shape["data"])]
                            dist.all_gather(parts, c.contiguous(),
                                            group=mesh.group(("data",)))
                            rows = torch.cat(parts, dim=-4).narrow(-4, 0, B3)
                            sh = list(rows.shape)
                            sh[-3] = MAX_SEQ
                            z = torch.zeros(sh, dtype=rows.dtype)
                            z.narrow(-3, 0, rows.shape[-3]).copy_(rows)
                            assert spec3(z.dim())[-4] is None
                            bufs.append(z.narrow(-3, lo3, win3).clone())
                        whole[name] = tuple(bufs)
                    nxt3 = torch.as_tensor(inp[f"{arch}/next"][:B3])
                    dl3, _ = tf.lm_decode_step(local, nxt3, whole, P_len,
                                               cfg, MAX_SEQ, attn="plain",
                                               constrain=cn)
                    out[f"{arch}/decode3_logits"] = dl3.numpy()

                step = bundle.step_fn("train_4k")
                state = bundle.opt().init(local)
                p2, s2, l2 = step(local, state, {"tokens": tok,
                                                 "targets": tgt})
                out[f"{arch}/step_loss"] = l2.numpy()
                out.update(flatten(p2, f"{arch}/step_params/"))
                out.update(flatten(s2["m"], f"{arch}/step_m/"))
                out.update(flatten(s2["v"], f"{arch}/step_v/"))
            info[f"{arch}/zero"] = zero
        info["coords"] = {a: mesh.coord(a) for a in mesh.axis_names}
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    finally:
        dist.destroy_process_group()
