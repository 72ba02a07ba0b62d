"""The mesh path of ``GNNBundle`` over gloo ranks on the CPU (``dist/spmd.py``'s
graph collectives, the ``mesh`` argument of ``models/{gcn,gat,pna,
nequip}.py``) against the reference's step under its own mesh.

Module fixtures spawn 4 ranks on a (2, 2) data x model mesh and 8 on
(2, 4), each rank's body in the jax-free ``tests/_torch_graph_mesh_ranks.py``;
at the same time the reference runs the same steps in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=N``: the bundle's own
``loss_fn`` and ``step_fn``, jitted with the bundle's own ``shardings``
(nodes and edges over every axis, parameters replicated).  The archs at
their configs' ``REDUCED`` widths (PNA with and without ``remat``) on a
random graph of 64 nodes and 256 edges drawn with numpy from a seed, a
tenth of the edges masked, fp32, the reference's weights.

Held, on every rank, within 1e-5 of the largest |entry| of the
reference's: the loss and every gradient (whole on every rank: the
parameters enter through ``spmd.copy`` over every axis), then one donated
train step's loss and Adam's ``m`` (the clipped gradients); the updated
parameters are equal on every rank.  (They are not held to the
reference's: a first Adam step maps g to about g / (|g| + 1e-8), so a
gradient near 1e-8 summed in another order moves its update by a few
percent of the 1e-3 step.)
PNA's ReLU messages tie at zero across ranks, so its max / min lanes'
gradients split over the ties of every rank.  A (1, 1) mesh of one rank
computes bit for bit what no mesh computes.  On the parent tree (no mesh
path) every rank's step indexes its local rows with global edge ids and
fails.
"""
import numpy as np
import pytest

import jax

import _torch_graph_mesh_ranks as ranks

N_NODES, N_EDGES, D_FEAT = 64, 256, 12
CASES = tuple(ranks.GNN_CASES)
MODS = sorted({m for m, _ in ranks.GNN_CASES.values()})
# inside the child, before jax initialises (as tests/test_dist_integration.py)
REF = r"""
import importlib, os, sys
tmp, a, b = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={a * b}"
import numpy as np, jax, jax.numpy as jnp
from repro.configs.families import GNNBundle
from repro.train.optimizer import adam
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from _torch_graph_mesh_ranks import GNN_CASES, SHAPE
from _torch_lm_mesh_ranks import flatten
inp = np.load(os.path.join(tmp, "inputs.npz"))
mesh = jax.make_mesh((a, b), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)


def keyed(tree, prefix):
    def leaf(path, _):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        return jnp.asarray(inp[prefix + key])
    return jax.tree_util.tree_map_with_path(leaf, tree)


out = {}
for case, (mod_name, remat) in GNN_CASES.items():
    if remat:
        continue                  # the reference's loss has no remat
    R = importlib.import_module(f"repro.configs.{mod_name}")
    kw = {k: v for k, v in R.REDUCED.items() if k != "classes"}
    bundle = GNNBundle(R.SPEC.bundle().arch, kw,
                       n_classes=R.REDUCED.get("classes", 16))
    params = keyed(bundle.init_params(jax.random.PRNGKey(0),
                                      int(inp[f"gnn/{case}/d"])),
                   f"gnn/{case}/params/")
    batch = {k.rsplit("/", 1)[1]: jnp.asarray(inp[k]) for k in inp.files
             if k.startswith(f"gnn/{case}/batch/")}
    (p_sh, o_sh, b_sh), out_sh = bundle.shardings(mesh, SHAPE)
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(bundle.loss_fn(SHAPE)),
                              in_shardings=(p_sh, b_sh))(params, batch)
        out[f"{case}/loss"] = loss
        out.update(flatten(grads, f"{case}/grads/"))
        step = jax.jit(bundle.step_fn(SHAPE), in_shardings=(p_sh, o_sh, b_sh),
                       out_shardings=out_sh)
        p2, s2, l2 = step(params, adam(1e-3).init(params), batch)
        out[f"{case}/step_loss"] = l2
        out.update(flatten(s2["m"], f"{case}/step_m/"))
out = {k: np.asarray(v, np.float32) for k, v in out.items()}
np.savez(os.path.join(tmp, "ref.npz"), **out)
print("REF_OK")
"""
def _graph(rng, arch: str, n_classes: int) -> dict:
    """A random graph of ``N_NODES`` nodes and ``N_EDGES`` edges (both
    multiples of 8), a tenth of the edges masked, half the nodes trained."""
    src = rng.integers(0, N_NODES, N_EDGES).astype(np.int32)
    dst = rng.integers(0, N_NODES, N_EDGES).astype(np.int32)
    out = {"src": src, "dst": dst, "edge_mask": rng.random(N_EDGES) >= 0.1,
           "labels": rng.integers(0, n_classes, N_NODES).astype(np.int32),
           "train_mask": rng.random(N_NODES) < 0.5}
    if arch == "nequip":
        out.update(species=rng.integers(0, 4, N_NODES).astype(np.int32),
                   pos=(1.5 * rng.normal(size=(N_NODES, 3))).astype(
                       np.float32),
                   energy_target=np.float32(-0.7))
    else:
        deg = np.bincount(dst, minlength=N_NODES).astype(np.float32) + 1.0
        out.update(x=rng.normal(size=(N_NODES, D_FEAT)).astype(np.float32),
                   deg=deg)
    return out


def gnn_inputs() -> dict:
    """Every case's reference parameters (``init_params`` at PRNGKey(0))
    and its graph, flattened for the ranks."""
    from repro.configs.families import GNNBundle as RefBundle
    import importlib
    inputs = {}
    for case, (mod_name, _) in ranks.GNN_CASES.items():
        R = importlib.import_module(f"repro.configs.{mod_name}")
        kw = {k: v for k, v in R.REDUCED.items() if k != "classes"}
        n_classes = R.REDUCED.get("classes", 16)
        arch = R.SPEC.bundle().arch
        params = RefBundle(arch, kw, n_classes=n_classes).init_params(
            jax.random.PRNGKey(0), D_FEAT)
        inputs.update(ranks.flatten(jax.tree_util.tree_map(np.asarray,
                                                           params),
                                    f"gnn/{case}/params/"))
        inputs[f"gnn/{case}/d"] = np.int32(D_FEAT)
        # one graph a config: PNA's remat case runs the plain case's
        graph = _graph(np.random.default_rng(100 + MODS.index(mod_name)),
                       arch, n_classes)
        inputs.update({f"gnn/{case}/batch/{k}": v for k, v in graph.items()})
    return inputs


@pytest.fixture(scope="module", params=[(2, 2), (2, 4)], ids=["2x2", "2x4"])
def runs(request, tmp_path_factory):
    shape = request.param
    tmp = str(tmp_path_factory.mktemp("gnn{}x{}".format(*shape)))
    return ranks.run_ranks(ranks.gnn_suite, shape, gnn_inputs(), tmp, REF)


def _ref_case(case: str) -> str:
    """The reference's outputs for ``case`` (its loss has no remat: PNA's
    remat is held to the plain step)."""
    return "pna" if case == "pna_remat" else case


@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradients_match_the_reference_mesh(runs, case):
    arrays, infos, ref = runs
    want = _ref_case(case)
    keys = [k for k in ref if k.startswith(f"{want}/grads/")]
    assert keys
    for a, info in zip(arrays, infos):
        at = info["coords"]
        ranks.close(a[f"{case}/loss"], ref[f"{want}/loss"],
               what=f"{case} loss at {at}")
        for k in keys:
            ranks.close(a[k.replace(want, case, 1)], ref[k], what=f"{k} at {at}")


@pytest.mark.parametrize("case", [c for c in CASES if c != "pna_remat"])
def test_donated_train_step_matches_the_reference_mesh(runs, case):
    arrays, infos, ref = runs
    for a, info in zip(arrays, infos):
        at = info["coords"]
        ranks.close(a[f"{case}/step_loss"], ref[f"{case}/step_loss"],
               what=f"{case} step loss at {at}")
        keys = [k for k in ref if k.startswith(f"{case}/step_m/")]
        assert keys
        for k in keys:
            ranks.close(a[k], ref[k], what=f"{k} at {at}")


def test_every_rank_holds_the_same_step(runs):
    """The parameters leave the step replicated: Adam ran alike on every
    rank, on gradients summed over every axis."""
    arrays, _, _ = runs
    for a in arrays[1:]:
        for k, v in arrays[0].items():
            if "/step_" in k:
                assert np.array_equal(a[k], v), k


def test_one_rank_mesh_is_bit_identical_to_no_mesh(tmp_path):
    arrays, _, _ = ranks.run_ranks(ranks.one_rank_suite, (1, 1), gnn_inputs(),
                             str(tmp_path))
    got = arrays[0]
    keys = [k for k in got if k.startswith("none/")]
    assert len(keys) > 20
    for k in keys:
        assert np.array_equal(got[k], got["mesh/" + k[len("none/"):]]), k
