"""Rank bodies for ``tests/test_torch_dist_gnn_mesh.py`` and
``tests/test_torch_dist_recsys_mesh.py``: gloo ranks spawned by
``_torch_dist_ranks.spawn``, each reading the test's inputs from
``inputs.npz`` (and the mesh's shape from ``mesh.json``) under its
temporary directory and writing its outputs to ``rank<r>.npz`` /
``rank<r>.json`` there.

The mesh path of ``GNNBundle`` (gcn, gat, pna with and without ``remat``,
nequip at their ``REDUCED`` widths) and of ``RecsysBundle`` (a small
``WideDeepConfig``) on the rank's blocks of the bundles' ``shardings``:
nodes and edges over every axis; the tables' rows over ``model``, the
batch over ``data`` where it reaches it, the candidates over every axis.
``one_rank_suite`` runs every step with no mesh and on a (1, 1) mesh.
``run_ranks`` (the tests' side) spawns the ranks beside the reference's
subprocess.  Imports torch and the port only (no jax): a spawned rank
imports this module afresh.
"""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from _torch_dist_ranks import _init, spawn
from _torch_lm_mesh_ranks import flatten, unflatten

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
_SUBPROC_ENV = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", ""),
                "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", ""),
                "TMPDIR": os.environ.get("TMPDIR", "/tmp")}

SHAPE = "full_graph_sm"
# case -> (config module, remat)
GNN_CASES = {"gcn": ("gcn_cora", False), "gat": ("gat_cora", False),
             "pna": ("pna", False), "pna_remat": ("pna", True),
             "nequip": ("nequip", False)}
LOOKUPS = ("dense", "bag")
REC_SHAPES = ("train_batch", "serve_p99", "retrieval_cand")


def gnn_bundle(case: str):
    """The port's ``GNNBundle`` of ``case`` at its config's ``REDUCED``
    widths, and whether its loss remats."""
    from repro_torch.configs.families import GNNBundle
    mod_name, remat = GNN_CASES[case]
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    kw = {k: v for k, v in mod.REDUCED.items() if k != "classes"}
    arch = mod.SPEC.bundle().arch
    return GNNBundle(arch, kw, n_classes=mod.REDUCED.get("classes", 16)), \
        remat


def rec_config(inp):
    from repro_torch.models.recsys import WideDeepConfig
    return WideDeepConfig(rows_per_field=int(inp["rec/rows_per_field"]),
                          mlp_dims=tuple(int(v) for v in
                                         inp["rec/mlp_dims"]))


def _tensor(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def _params(inp, prefix: str):
    from repro_torch.convert import params_from_jax
    return params_from_jax(unflatten(inp, prefix), device="cpu")


def _mesh(tmp: str):
    from repro_torch.dist.sharding import as_mesh
    from repro_torch.launch.mesh import make_debug_mesh
    with open(os.path.join(tmp, "mesh.json")) as f:
        shape = tuple(json.load(f)["shape"])
    return as_mesh(make_debug_mesh(shape, device="cpu"))


def _block(a: torch.Tensor, i: int, n: int) -> torch.Tensor:
    k = a.shape[0] // n
    return a[i * k:(i + 1) * k]


def gnn_batch(inp, case: str, mesh=None) -> dict:
    """``case``'s batch, or the rank's blocks of it on ``mesh`` (nodes and
    edges over every axis)."""
    out = {}
    for key in inp.files:
        if key.startswith(f"gnn/{case}/batch/"):
            a = _tensor(inp[key])
            if mesh is not None and a.dim():
                a = _block(a, mesh.index(mesh.axis_names), mesh.size)
            out[key.rsplit("/", 1)[1]] = a
    return out


def gnn_outputs(inp, case: str, mesh) -> dict:
    """Loss and gradients of the bundle's ``loss_fn``, then one donated
    ``step_fn`` step (its loss and Adam's ``m``), each under ``mesh``
    (None: no mesh) on the batch's blocks."""
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    bundle, remat = gnn_bundle(case)
    batch = gnn_batch(inp, case, mesh)
    out = {}
    with use_mesh(mesh):
        params = _params(inp, f"gnn/{case}/params/")
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = bundle.loss_fn(SHAPE, remat=remat)(
            tree_unflatten(params, live), batch)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            live, torch.autograd.grad(loss, live, allow_unused=True))]
        out["loss"] = loss.detach().numpy()
        out.update(flatten(tree_unflatten(params, grads), "grads/"))
        if not remat:
            params = _params(inp, f"gnn/{case}/params/")
            p2, s2, l2 = bundle.step_fn(SHAPE)(
                params, bundle.opt().init(params), batch)
            out["step_loss"] = l2.numpy()
            out.update(flatten(s2["m"], "step_m/"))
            out.update(flatten(p2, "step_params/"))
    return out


def rec_batch(inp, bundle, shape: str, mesh=None) -> dict:
    """The batch of ``shape``, or the rank's blocks of it on ``mesh``: its
    rows over ``data`` where :meth:`RecsysBundle.batch_axes` cuts them, the
    candidates over every axis."""
    out = {}
    for key in inp.files:
        if key.startswith(f"rec/{shape}/"):
            a = _tensor(inp[key])
            name = key.rsplit("/", 1)[1]
            if mesh is not None and name == "candidates":
                a = _block(a, mesh.index(mesh.axis_names), mesh.size)
            elif mesh is not None and bundle.batch_axes(mesh, shape):
                a = _block(a, mesh.coord("data"), mesh.shape["data"])
            out[name] = a
    return out


def rec_params(inp, mesh=None):
    """The wide & deep parameters, ``table`` and ``wide`` cut to the rank's
    rows over ``model`` on ``mesh``."""
    params = _params(inp, "rec/params/")
    if mesh is not None:
        for k in ("table", "wide"):
            params[k] = _block(params[k], mesh.coord("model"),
                               mesh.shape["model"]).clone()
    return params


def rec_outputs(inp, lookup: str, mesh) -> dict:
    """One donated ``train_batch`` step (loss, Adam's ``m``, the updated
    parameters), ``serve_p99``'s logits and ``retrieval_cand``'s scores of
    the bundle's steps under ``mesh`` (None: no mesh)."""
    from repro_torch.configs.families import RecsysBundle
    from repro_torch.dist.sharding import use_mesh
    bundle = RecsysBundle(rec_config(inp))
    out = {}
    with use_mesh(mesh):
        params = rec_params(inp, mesh)
        p2, s2, loss = bundle.step_fn("train_batch", lookup)(
            params, bundle.optimizer().init(params),
            rec_batch(inp, bundle, "train_batch", mesh))
        out["train_loss"] = loss.numpy()
        out.update(flatten(s2["m"], "m/"))
        out.update(flatten(p2, "params/"))
        params = rec_params(inp, mesh)
        for shape in REC_SHAPES[1:]:
            out[shape] = bundle.step_fn(shape, lookup)(
                params, rec_batch(inp, bundle, shape, mesh)).numpy()
    return out


def _prefixed(tree: dict, prefix: str) -> dict:
    return {f"{prefix}{k}": v for k, v in tree.items()}


def _save(tmp: str, rank: int, out: dict, mesh) -> None:
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump({"coords": {a: mesh.coord(a) for a in mesh.axis_names},
                   "index": mesh.index(mesh.axis_names)}, f)


def gnn_suite(rank: int, world: int, tmp: str) -> None:
    _init(rank, world, tmp)
    try:
        mesh = _mesh(tmp)
        inp = np.load(os.path.join(tmp, "inputs.npz"))
        out = {}
        for case in GNN_CASES:
            out.update(_prefixed(gnn_outputs(inp, case, mesh), f"{case}/"))
        _save(tmp, rank, out, mesh)
    finally:
        dist.destroy_process_group()


def recsys_suite(rank: int, world: int, tmp: str) -> None:
    _init(rank, world, tmp)
    try:
        mesh = _mesh(tmp)
        inp = np.load(os.path.join(tmp, "inputs.npz"))
        out = {}
        for lookup in LOOKUPS:
            out.update(_prefixed(rec_outputs(inp, lookup, mesh),
                                 f"{lookup}/"))
        _save(tmp, rank, out, mesh)
    finally:
        dist.destroy_process_group()


def one_rank_suite(rank: int, world: int, tmp: str) -> None:
    """Every output above with no mesh (``none/``) and on a (1, 1) mesh of
    this one rank (``mesh/``), for whichever of ``gnn/`` and ``rec/`` the
    inputs hold."""
    _init(rank, world, tmp)
    try:
        mesh = _mesh(tmp)
        inp = np.load(os.path.join(tmp, "inputs.npz"))
        out = {}
        for tag, m in (("none", None), ("mesh", mesh)):
            if any(k.startswith("gnn/") for k in inp.files):
                for case in GNN_CASES:
                    out.update(_prefixed(gnn_outputs(inp, case, m),
                                         f"{tag}/{case}/"))
            if any(k.startswith("rec/") for k in inp.files):
                for lookup in LOOKUPS:
                    out.update(_prefixed(rec_outputs(inp, lookup, m),
                                         f"{tag}/{lookup}/"))
        _save(tmp, rank, out, mesh)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------- the tests' side
def close(got, ref, tol=TOL, what=""):
    """``got`` within ``tol`` of the largest |entry| of ``ref`` (at least
    1)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, f"{what}: {got.shape} != {ref.shape}"
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3g}"


def run_ranks(fn, shape, inputs, tmp, ref_script=None):
    """``fn`` on the ranks of a mesh of ``shape`` (and ``ref_script`` in a
    subprocess at the same time, given ``tmp`` and the shape); returns each
    rank's arrays and info, and the reference's arrays."""
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    with open(os.path.join(tmp, "mesh.json"), "w") as f:
        json.dump({"shape": list(shape)}, f)
    world = shape[0] * shape[1]
    ref = None
    if ref_script is not None:
        ref = subprocess.Popen(
            [sys.executable, "-c", ref_script, tmp, *map(str, shape)],
            cwd=ROOT, env=_SUBPROC_ENV, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    try:
        spawn(fn, world, tmp, timeout_s=600.0)
        if ref is not None:
            log, _ = ref.communicate(timeout=600)
            assert "REF_OK" in log, log[-5000:]
    finally:
        if ref is not None and ref.poll() is None:
            ref.kill()
            ref.wait()
    arrays = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
              for r in range(world)]
    infos = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            infos.append(json.load(f))
    want = (dict(np.load(os.path.join(tmp, "ref.npz")))
            if ref is not None else None)
    return arrays, infos, want
