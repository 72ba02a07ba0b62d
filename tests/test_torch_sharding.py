"""``repro_torch/dist/sharding.py`` and the bundles' dry-run surface
(``abstract_state`` / ``shardings``) against the reference.

Held: ``lm_param_specs`` equal to the reference's, entry for entry, for
every LM arch of ``ALL_ARCHS`` on nine meshes (the reference's on
``jax.sharding.AbstractMesh``); every leaf's ``shard_shape`` equal, and
raising on the same leaves (the reference's ZeRO entry on a stack its
batch axes do not divide); ``abstract_state``'s shapes and dtypes equal to
``jax.eval_shape``'s for every arch and cell; ``shardings(mesh, shape)``
equal for every LM, GNN and recsys cell (the reference's recsys bundle
reads ``mesh.devices``, so it runs in a subprocess on host devices, as
``launch/dryrun.py`` does); each rank's parameter bytes on (2, 4); and
with no mesh every helper returns its argument itself.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh as RefAbstractMesh
from jax.sharding import NamedSharding as RefNamedSharding
from repro.configs import get as ref_get
from repro.dist.sharding import lm_param_specs as ref_lm_param_specs
from repro_torch import convert
from repro_torch.configs import all_archs, get
from repro_torch.configs.registry import ALL_ARCHS
from repro_torch.dist import sharding as sh

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(1, 1), (1, 4), (2, 2), (4, 1), (1, 8), (2, 4), (8, 1), (16, 16),
          (2, 16, 16)]
LM_ARCHS = [a for a in ALL_ARCHS if get(a).family == "lm"]
DTYPES = {jnp.dtype("float32"): torch.float32,
          jnp.dtype("bfloat16"): torch.bfloat16,
          jnp.dtype("int32"): torch.int32}


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _spec(p):
    """A spec as a plain tuple of entries (tuples of names stay tuples)."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


def _spec_tree(t):
    if isinstance(t, dict):
        return {k: _spec_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_spec_tree(v) for v in t]
    return _spec(t)


def _sharding_tree(t):
    """A tree of NamedShardings (either side) -> its specs."""
    if isinstance(t, dict):
        return {k: _sharding_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_sharding_tree(v) for v in t) \
            if not isinstance(t, sh.P) else _spec(t)
    if t is None:
        return None
    return _spec(t.spec)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_specs_equal_the_reference(arch, shape):
    cfg = ref_get(arch).bundle().cfg
    port_cfg = get(arch).bundle().cfg
    ref = ref_lm_param_specs(cfg, RefAbstractMesh(shape, _names(shape)))
    got = sh.lm_param_specs(port_cfg, sh.AbstractMesh(shape, _names(shape)))
    assert _spec_tree(got) == _spec_tree(ref)


def _leaves_with_specs(spec_tree, tree, is_leaf):
    """(path, spec, leaf) for every leaf of ``tree``, the spec tree's
    single-P leaves broadcast over the sub-trees under them."""
    out = []

    def walk(spec, t, path):
        if is_leaf(t):
            out.append((path, spec, t))
            return
        for k in t:
            walk(spec if not isinstance(spec, dict) else spec[k], t[k],
                 path + (k,))
    walk(spec_tree, tree, ())
    return out


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_shard_shapes_equal_and_raise_alike(arch, shape):
    """Per leaf: the port's ``shard_shape`` equals JAX's, and raises
    ``ValueError`` exactly where JAX's raises."""
    ref_mesh = RefAbstractMesh(shape, _names(shape))
    mesh = sh.AbstractMesh(shape, _names(shape))
    bundle = ref_get(arch).bundle()
    params = bundle.abstract_params()
    specs = ref_lm_param_specs(bundle.cfg, ref_mesh)
    is_leaf = lambda t: isinstance(t, jax.ShapeDtypeStruct)
    raised = 0
    for path, spec, leaf in _leaves_with_specs(specs, params, is_leaf):
        try:
            want = RefNamedSharding(ref_mesh, spec).shard_shape(leaf.shape)
        except ValueError:
            want = None
            raised += 1
        port = sh.NamedSharding(mesh, sh.P(*_spec(spec)))
        if want is None:
            with pytest.raises(ValueError):
                port.shard_shape(leaf.shape)
        else:
            assert port.shard_shape(leaf.shape) == tuple(want), path
    depth = bundle.cfg.n_layers
    n_batch = math.prod(shape[:-1])
    if depth % n_batch and bundle.cfg.n_experts == 0:
        assert raised > 0     # trap 1: the dense stack's ZeRO entry


def test_zero_entry_raises_for_granite_8b_on_the_production_mesh():
    """granite-8b's 36-layer stack on (16, 16): the reference's
    ``NamedSharding(..., P("data", None)).shard_shape((36, 4096))`` raises,
    and so do the port's and ``convert.shard_params`` (no padding, no
    dropped axis)."""
    mesh = sh.AbstractMesh((16, 16), ("data", "model"))
    with pytest.raises(ValueError):
        RefNamedSharding(RefAbstractMesh((16, 16), ("data", "model")),
                         jax.sharding.PartitionSpec("data", None)
                         ).shard_shape((36, 4096))
    with pytest.raises(ValueError):
        sh.NamedSharding(mesh, sh.P("data", None)).shard_shape((36, 4096))
    cfg = get("granite-8b").bundle().cfg
    tiny = {"ln": np.zeros((36, 8), np.float32)}
    with pytest.raises(ValueError):
        convert.shard_tree(tiny, {"ln": sh.P("data", None)}, mesh, "cpu",
                           coords={"data": 0, "model": 0})
    assert sh.lm_param_specs(cfg, mesh)["dense_layers"]["ln1"] == \
        sh.P("data", None)


def _cells():
    return [(name, shape) for name, spec in sorted(all_archs().items())
            for shape in spec.shapes]


def _assert_same_abstract(got, want, what):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), what
        for k in want:
            _assert_same_abstract(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_abstract(g, w, f"{what}/{i}")
    elif want is None:
        assert got is None, what
    else:
        assert tuple(got.shape) == tuple(want.shape), what
        assert got.dtype == DTYPES[jnp.dtype(want.dtype)], what
        assert got.device.type == "meta", what


@pytest.mark.parametrize("arch,shape", _cells())
def test_abstract_state_equals_eval_shape(arch, shape):
    got = get(arch).bundle().abstract_state(shape)
    want = ref_get(arch).bundle().abstract_state(shape)
    _assert_same_abstract(got, want, f"{arch} {shape}")


@pytest.mark.parametrize("mesh_shape", [(2, 4), (16, 16)], ids=str)
@pytest.mark.parametrize("arch,shape",
                         [c for c in _cells() if c[0] != "wide-deep"])
def test_shardings_equal_the_reference(arch, shape, mesh_shape):
    names = _names(mesh_shape)
    got = get(arch).bundle().shardings(sh.AbstractMesh(mesh_shape, names),
                                       shape)
    want = ref_get(arch).bundle().shardings(
        RefAbstractMesh(mesh_shape, names), shape)
    assert _sharding_tree(got) == _sharding_tree(want)


REF_RECSYS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import get
b = get("wide-deep").bundle()
mesh = jax.make_mesh((2, 4), ("data", "model"))

def specs(t):
    if isinstance(t, dict):
        return {k: specs(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [specs(v) for v in t]
    if t is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in t.spec]
print(json.dumps({s: specs(b.shardings(mesh, s)) for s in b.shapes}))
"""


@pytest.fixture(scope="module")
def ref_recsys_shardings():
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", ""),
           "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", ""),
           "TMPDIR": os.environ.get("TMPDIR", "/tmp")}
    r = subprocess.run([sys.executable, "-c", REF_RECSYS], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def _jsonish(t):
    if isinstance(t, dict):
        return {k: _jsonish(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)) and not isinstance(t, sh.NamedSharding):
        return [_jsonish(v) for v in t]
    if t is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in t.spec]


@pytest.mark.parametrize("shape", ["train_batch", "serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_recsys_shardings_equal_the_reference(ref_recsys_shardings, shape):
    got = get("wide-deep").bundle().shardings(
        sh.AbstractMesh((2, 4), ("data", "model")), shape)
    assert _jsonish(got) == ref_recsys_shardings[shape]


RANK_GB = {"granite-8b": 4.3, "mistral-large-123b": 61.7,
           "granite-moe-3b-a800m": 2.2, "llama4-maverick-400b-a17b": 100.0}


def _rank_bytes(shardings, params) -> int:
    total = 0
    for s, p in zip(sh.leaves(shardings), sh.leaves(params)):
        total += math.prod(s.shard_shape(p.shape)) * p.element_size()
    return total


@pytest.mark.parametrize("arch", sorted(RANK_GB))
def test_rank_parameter_bytes_on_2x4(arch):
    """Each rank's parameter bytes under ``shardings`` on (2, 4): the
    reference's arithmetic (its shardings over ``jax.eval_shape``)."""
    mesh = sh.AbstractMesh((2, 4), ("data", "model"))
    bundle = get(arch).bundle()
    (params_sh, _), _ = bundle.shardings(mesh, "prefill_32k")
    got = _rank_bytes(params_sh, bundle.abstract_params())
    rb = ref_get(arch).bundle()
    (ref_sh, _), _ = rb.shardings(RefAbstractMesh((2, 4), ("data", "model")),
                                  "prefill_32k")
    want = sum(math.prod(s.shard_shape(p.shape)) * p.dtype.itemsize
               for s, p in zip(jax.tree_util.tree_leaves(ref_sh),
                               jax.tree_util.tree_leaves(
                                   rb.abstract_params())))
    assert got == want
    assert round(got / 1e9, 1) == RANK_GB[arch]


def test_no_mesh_means_identity():
    x = torch.ones(4, 6, 8)
    assert sh.ambient_mesh() is None
    assert sh.shard_activation(x, ("batch", "model", None)) is x
    assert sh.unshard_activation(x, ("batch", "model", None), x.shape) is x
    assert sh.maybe_shard(x, sh.P("model", None)) is x
    bundle = get("granite-8b").bundle()
    lp = {"attn": {"wq": {"w": x}}}
    assert bundle.make_constrain()("dense", lp) is lp
    mesh = sh.AbstractMesh((2, 2), ("data", "model"))
    with sh.use_mesh(mesh) as m:
        assert sh.ambient_mesh() is m
        with sh.use_mesh(None):
            assert sh.ambient_mesh() is None
        assert sh.ambient_mesh() is m
    assert sh.ambient_mesh() is None


def test_activation_spec_and_batch_axes_follow_the_reference():
    from repro.dist import sharding as ref_sh
    for shape in MESHES:
        names = _names(shape)
        ref_mesh = RefAbstractMesh(shape, names)
        mesh = sh.AbstractMesh(shape, names)
        assert sh.batch_axes(mesh) == ref_sh.batch_axes(ref_mesh)
        for axes, dims in ((("batch", "model", None), (32, 4096, 128)),
                           (("batch", None, "model"), (6, 3, 49155)),
                           ((("data", "model"), None), (512, 7)),
                           (("model",), (5,))):
            assert _spec(sh.activation_spec(mesh, axes, dims)) == _spec(
                ref_sh.activation_spec(ref_mesh, axes, dims))


def test_registry_api_gaps():
    from repro.configs import gcn_cora as ref_gcn_cora
    from repro.configs.registry import ALL_ARCHS as REF_ALL
    from repro_torch.configs import Cell, gcn_cora
    assert ALL_ARCHS == REF_ALL
    assert sorted(all_archs()) == sorted(REF_ALL)
    assert gcn_cora.REDUCED == ref_gcn_cora.REDUCED
    c = Cell("train_4k", "train", {"seq": 4096})
    assert (c.shape_name, c.kind, c.meta) == ("train_4k", "train",
                                              {"seq": 4096})


def test_named_sharding_blocks_and_placements():
    """A rank's block and the DTensor placements of a spec naming two
    axes (the order of the mesh's dims)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = sh.AbstractMesh((2, 4), ("data", "model"))
    ns = sh.NamedSharding(mesh, sh.P("data", None, "model"))
    assert ns.placements == (Shard(0), Shard(2))
    assert sh.NamedSharding(mesh, sh.P()).placements == (Replicate(),
                                                          Replicate())
    assert ns.local_slices((4, 3, 8), {"data": 1, "model": 2}) == (
        slice(2, 4), slice(0, 3), slice(4, 6))
    both = sh.NamedSharding(mesh, sh.P(("data", "model"), None))
    assert both.local_slices((16, 5), {"data": 1, "model": 3}) == (
        slice(14, 16), slice(0, 5))
    a = np.arange(16 * 5).reshape(16, 5)
    np.testing.assert_array_equal(
        convert.local_block(a, both.spec, mesh, {"data": 1, "model": 3}),
        a[14:16])


def test_shard_opt_state_cuts_moments_as_the_parameters():
    """Adam's ``m`` / ``v`` (here the reference's state after a nonzero
    fill) are cut exactly as ``shard_params`` cuts the parameters, on the
    rank at (1, 3) of (2, 4); ``step`` stays whole."""
    from repro.train.optimizer import adam as ref_adam
    mesh = sh.AbstractMesh((2, 4), ("data", "model"))
    cfg = ref_get("granite-moe-3b-a800m").bundle().cfg
    import dataclasses
    small = dataclasses.replace(cfg, n_layers=2, d_model=32, n_heads=4,
                                n_kv=2, head_dim=8, d_ff=16, vocab=64,
                                n_experts=8)
    from repro.models.transformer import lm_init as ref_lm_init
    params = jax.tree_util.tree_map(np.asarray,
                                    ref_lm_init(jax.random.PRNGKey(0), small))
    state = ref_adam(1e-3).init(params)
    state = {"m": jax.tree_util.tree_map(lambda a: np.asarray(a) + 1.5,
                                         state["m"]),
             "v": jax.tree_util.tree_map(lambda a: np.asarray(a) + 2.5,
                                         state["v"]),
             "step": np.asarray(state["step"]) + 7}
    port_cfg = dataclasses.replace(get("granite-moe-3b-a800m").bundle().cfg,
                                   n_layers=2, d_model=32, n_heads=4, n_kv=2,
                                   head_dim=8, d_ff=16, vocab=64, n_experts=8)
    at = {"data": 1, "model": 3}
    got = convert.shard_opt_state(state, port_cfg, mesh, "cpu", coords=at)
    m = convert.shard_params(state["m"], port_cfg, mesh, "cpu", coords=at)
    from repro_torch.train.optimizer import tree_leaves
    for a, b in zip(tree_leaves(got["m"]), tree_leaves(m)):
        assert torch.equal(a, b)
    assert all(float(t.min()) == 2.5 for t in tree_leaves(got["v"]))
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int32
    wg = got["m"]["moe_layers"]["moe"]["wg"]
    assert tuple(wg.shape) == (1, 2, 32, 16)   # ZeRO 2/2 layers, E 8/4
