"""The mesh path of ``RecsysBundle`` (wide & deep) over gloo ranks on the
CPU (``nn/embedding.py``'s ``sharded_take`` / ``sharded_bag``, the ``mesh``
argument of ``models/recsys.py``) against the reference's steps under its
own mesh.

Module fixtures spawn 4 ranks on a (2, 2) data x model mesh and 8 on
(4, 2), each rank's body in the jax-free ``tests/_torch_graph_mesh_ranks.py``;
at the same time the reference runs the bundle's own ``step_fn`` for
``train_batch``, ``serve_p99`` and ``retrieval_cand``, jitted with the
bundle's own ``shardings`` (``table`` and ``wide`` over ``model``, the
batch over ``data``, the candidates over every axis), in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=N``.  A small
``WideDeepConfig`` (50 rows a field, 2,000 in all; MLP 64-32-16), batches
of 256 and 128 rows and 64 candidates drawn with numpy from a seed, the
reference's weights; the port runs both lookups, ``"dense"`` (the
dry-run's) and ``"bag"`` (``ops.embedding_bag``, row 7's plain version on
the CPU).

Held, on every rank, within 1e-5 of the largest |entry| of the
reference's: the training step's loss and Adam's ``m`` (the rank's rows of
the table's and ``wide``'s, the MLP's whole), the served logits (the
rank's rows) and the retrieval scores (the rank's block of candidates).
The updated parameters are equal on the ranks that hold the same block.
A (1, 1) mesh of one rank computes bit for bit what no mesh computes.  On
the parent tree (no mesh path) a rank looks up global rows in its block
of the table and fails.
"""
import numpy as np
import pytest

import jax

import _torch_graph_mesh_ranks as ranks
from _torch_graph_mesh_ranks import close as _close, run_ranks

ROWS_PER_FIELD, MLP_DIMS = 50, (64, 32, 16)
BATCHES = {"train_batch": 256, "serve_p99": 128, "retrieval_cand": 1}
N_CANDIDATES = 64
# inside the child, before jax initialises (as tests/test_dist_integration.py)
REF = r"""
import os, sys
tmp, a, b = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={a * b}"
import numpy as np, jax, jax.numpy as jnp
from repro.configs.families import RecsysBundle
from repro.models.recsys import WideDeepConfig, widedeep_init
from repro.train.optimizer import adam
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from _torch_lm_mesh_ranks import flatten
inp = np.load(os.path.join(tmp, "inputs.npz"))
mesh = jax.make_mesh((a, b), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = WideDeepConfig(rows_per_field=int(inp["rec/rows_per_field"]),
                     mlp_dims=tuple(int(v) for v in inp["rec/mlp_dims"]))


def leaf(path, _):
    key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                   for p in path)
    return jnp.asarray(inp["rec/params/" + key])


params = jax.tree_util.tree_map_with_path(
    leaf, widedeep_init(jax.random.PRNGKey(0), cfg))
bundle = RecsysBundle(cfg)


def batch(shape):
    return {k.rsplit("/", 1)[1]: jnp.asarray(inp[k]) for k in inp.files
            if k.startswith(f"rec/{shape}/")}


out = {}
with mesh:
    (p_sh, o_sh, b_sh), out_sh = bundle.shardings(mesh, "train_batch")
    step = jax.jit(bundle.step_fn("train_batch"),
                   in_shardings=(p_sh, o_sh, b_sh), out_shardings=out_sh)
    _, s2, loss = step(params, adam(1e-3).init(params), batch("train_batch"))
    out["train_loss"] = loss
    out.update(flatten(s2["m"], "m/"))
    for shape in ("serve_p99", "retrieval_cand"):
        (p_sh, b_sh), out_sh = bundle.shardings(mesh, shape)
        kw = {} if out_sh is None else {"out_shardings": out_sh}
        fn = jax.jit(bundle.step_fn(shape), in_shardings=(p_sh, b_sh), **kw)
        out[shape] = fn(params, batch(shape))
out = {k: np.asarray(v, np.float32) for k, v in out.items()}
np.savez(os.path.join(tmp, "ref.npz"), **out)
print("REF_OK")
"""


def rec_inputs() -> dict:
    """The reference's parameters (``widedeep_init`` at PRNGKey(0)) and
    the three cells' batches, flattened for the ranks."""
    from repro.models.recsys import WideDeepConfig, widedeep_init
    cfg = WideDeepConfig(rows_per_field=ROWS_PER_FIELD, mlp_dims=MLP_DIMS)
    params = jax.tree_util.tree_map(
        np.asarray, widedeep_init(jax.random.PRNGKey(0), cfg))
    inputs = ranks.flatten(params, "rec/params/")
    inputs["rec/rows_per_field"] = np.int32(ROWS_PER_FIELD)
    inputs["rec/mlp_dims"] = np.asarray(MLP_DIMS, np.int32)
    rng = np.random.default_rng(7)
    for shape, B in BATCHES.items():
        inputs[f"rec/{shape}/sparse"] = rng.integers(
            0, ROWS_PER_FIELD, (B, cfg.n_sparse)).astype(np.int32)
        inputs[f"rec/{shape}/dense"] = rng.normal(
            size=(B, cfg.n_dense)).astype(np.float32)
    inputs["rec/train_batch/labels"] = rng.integers(
        0, 2, BATCHES["train_batch"]).astype(np.float32)
    inputs["rec/retrieval_cand/candidates"] = rng.normal(
        size=(N_CANDIDATES, MLP_DIMS[-1])).astype(np.float32)
    return inputs


@pytest.fixture(scope="module", params=[(2, 2), (4, 2)], ids=["2x2", "4x2"])
def runs(request, tmp_path_factory):
    shape = request.param
    tmp = str(tmp_path_factory.mktemp("rec{}x{}".format(*shape)))
    return run_ranks(ranks.recsys_suite, shape, rec_inputs(), tmp, REF)


def _rows(a, i, n):
    k = a.shape[0] // n
    return a[i * k:(i + 1) * k]


@pytest.mark.parametrize("lookup", ranks.LOOKUPS)
def test_train_step_matches_the_reference_mesh(runs, lookup):
    arrays, infos, ref = runs
    keys = [k for k in ref if k.startswith("m/")]
    assert {"m/table", "m/wide"} <= set(keys)
    for a, info in zip(arrays, infos):
        at, n_model = info["coords"], len(arrays) // _n_data(infos)
        _close(a[f"{lookup}/train_loss"], ref["train_loss"],
               what=f"{lookup} loss at {at}")
        for k in keys:
            want = ref[k]
            if k in ("m/table", "m/wide"):
                want = _rows(want, at["model"], n_model)
            _close(a[f"{lookup}/{k}"], want, what=f"{lookup} {k} at {at}")


def _n_data(infos) -> int:
    return 1 + max(info["coords"]["data"] for info in infos)


@pytest.mark.parametrize("lookup", ranks.LOOKUPS)
def test_served_logits_and_retrieval_scores_match_the_reference_mesh(
        runs, lookup):
    arrays, infos, ref = runs
    n_data = _n_data(infos)
    for a, info in zip(arrays, infos):
        at = info["coords"]
        _close(a[f"{lookup}/serve_p99"],
               _rows(ref["serve_p99"], at["data"], n_data),
               what=f"{lookup} logits at {at}")
        _close(a[f"{lookup}/retrieval_cand"],
               _rows(ref["retrieval_cand"], info["index"], len(arrays)),
               what=f"{lookup} scores at {at}")


@pytest.mark.parametrize("lookup", ranks.LOOKUPS)
def test_ranks_holding_one_block_hold_the_same_step(runs, lookup):
    """After the step the MLP is equal on every rank, and ``table`` /
    ``wide`` on the ranks of one ``model`` coordinate: the gradients were
    summed over ``data``."""
    arrays, infos, _ = runs
    first = {}
    for a, info in zip(arrays, infos):
        for k, v in a.items():
            if not k.startswith(f"{lookup}/params/"):
                continue
            cut = k.endswith(("/table", "/wide"))
            key = (k, info["coords"]["model"] if cut else None)
            if key in first:
                assert np.array_equal(first[key], v), key
            else:
                first[key] = v
    assert len(first) > 4


def test_one_rank_mesh_is_bit_identical_to_no_mesh(tmp_path):
    arrays, _, _ = run_ranks(ranks.one_rank_suite, (1, 1), rec_inputs(),
                             str(tmp_path))
    got = arrays[0]
    keys = [k for k in got if k.startswith("none/")]
    assert len(keys) > 10
    for k in keys:
        assert np.array_equal(got[k], got["mesh/" + k[len("none/"):]]), k
