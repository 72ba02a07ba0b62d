"""The port's GAT, PNA and NequIP (``repro_torch/models/{gat,pna,nequip}.py``),
their configs, ``GNNBundle`` and the launcher against the reference's.

* ``products_like`` and ``molecules_like`` are byte-equal to the reference's.
* At the configs' ``REDUCED`` widths on a small graph, with and without an
  edge mask: ``edge_softmax``, ``gat_apply``, ``pna_aggregate``,
  ``pna_apply``, ``nequip_apply``, ``nequip_energy`` (per graph of a
  ``pack`` of molecules) and ``nequip_energy_forces`` agree with the
  reference, and so do the gradients of each loss with respect to every
  parameter leaf, all within 1e-5 of the largest entry of each compared
  array (fp32 sums in another order).  A PNA case is built to tie on max /
  min and on zero variance, where the gradient is split among ties.
* NequIP's energy is invariant and its forces equivariant under a seeded
  rotation (1e-5).
* ``GNNBundle.geometry`` equals the reference's for every cell; one
  ``step_fn`` step per arch (``full_graph_sm`` at reduced width) matches
  the reference's at 1e-5.

The full-width half (the launcher, PNA in float64, fp32 against fp64 on
``ogb_products``) is ``tests/test_torch_gnn_zoo_train.py``, a file of its
own so that pytest-xdist's ``--dist loadfile`` spreads the two over
workers; it takes this file's helpers.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get as ref_get
from repro.graph import DatasetSpec as RefSpec
from repro.graph import molecules_like as ref_molecules_like
from repro.graph import pack as ref_pack
from repro.graph import products_like as ref_products_like
from repro.graph import synthesize as ref_synthesize
from repro.models import gat as ref_gat
from repro.models import nequip as ref_nequip
from repro.models import pna as ref_pna
from repro.train import adam as ref_adam
from repro_torch.configs import get
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.configs.families import GNNBundle
from repro_torch.convert import params_from_jax
from repro_torch.graph import molecules_like, products_like
from repro_torch.models import (edge_softmax, gat_apply, gat_init, gat_loss,
                                mean_log_degree, nequip_apply,
                                nequip_energy, nequip_energy_forces,
                                nequip_init, pna_aggregate, pna_apply,
                                pna_init, pna_loss)

from _torch_parity import assert_bytes_equal, to_port

TOL = 1e-5
LOSS_TOL = 1e-4
KEY = jax.random.PRNGKey(0)


def _close(got, ref, what, tol=TOL):
    """|got - ref| <= tol * max(1, max |ref|) entrywise."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _port_params(ref_params):
    port = params_from_jax(_np(ref_params), device="cpu")
    for _, leaf in _leaves(port):
        leaf.requires_grad_()
    return port


def _assert_grads(port_params, ref_grads, what):
    ref = dict(_leaves(_np(ref_grads)))
    seen = 0
    for path, leaf in _leaves(port_params):
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        _close(g, ref[path], f"{what} grad{path}")
        seen += 1
    assert seen == len(ref)


# ---------------------------------------------------------------- datasets
def test_products_like_is_byte_equal():
    a, b = products_like(scale=0.001), ref_products_like(scale=0.001)
    assert a.num_nodes == b.num_nodes == 2449
    for f in dataclasses.fields(b):
        if f.name != "num_nodes":
            assert_bytes_equal(getattr(a, f.name), getattr(b, f.name),
                               f.name)


def test_molecules_like_is_byte_equal():
    port = molecules_like(batch=4, n_nodes=10, n_edges=24, seed=3)
    ref = ref_molecules_like(batch=4, n_nodes=10, n_edges=24, seed=3)
    assert len(port) == len(ref) == 4
    for (g, pos, z), (rg, rpos, rz) in zip(port, ref):
        assert g.num_nodes == rg.num_nodes == 10
        for name in ("src", "dst", "edge_mask"):
            assert_bytes_equal(getattr(g, name), getattr(rg, name), name)
        assert_bytes_equal(pos, rpos, "pos")
        assert_bytes_equal(z, rz, "z")


# ------------------------------------------------------------- small graph
@pytest.fixture(scope="module")
def small():
    """A 300-node graph with 32 features and its inputs on both sides, with
    no mask and with 20% of the edges masked."""
    g = ref_synthesize(RefSpec("zoo", 300, 1500, 32, 4, seed=0))
    mask = np.random.default_rng(1).random(g.num_edges) < 0.8
    return g, mask


def _graphs(small, masked):
    g, mask = small
    mld = mean_log_degree(to_port(g))
    ref = {"src": jnp.asarray(g.src), "dst": jnp.asarray(g.dst),
           "mean_log_deg": mld}
    port = {"src": torch.as_tensor(g.src.astype(np.int64)),
            "dst": torch.as_tensor(g.dst.astype(np.int64)),
            "mean_log_deg": mld}
    if masked:
        ref["edge_mask"] = jnp.asarray(mask)
        port["edge_mask"] = torch.as_tensor(mask)
    return g, ref, port


MASKED = pytest.mark.parametrize("masked", [False, True],
                                 ids=["all-edges", "masked"])


def test_mean_log_degree_matches_reference(small):
    g, _ = small
    assert mean_log_degree(to_port(g)) == ref_pna.mean_log_degree(g)


@MASKED
def test_edge_softmax_matches_reference(small, masked):
    g, ref_graph, graph = _graphs(small, masked)
    rng = np.random.default_rng(2)
    scores = rng.standard_normal((g.num_edges, 3)).astype(np.float32)
    scores[::7] = 0.5          # ties inside many destinations' rows
    cot = rng.standard_normal(scores.shape).astype(np.float32)
    mask = ref_graph.get("edge_mask")

    def ref_fn(s):
        return ref_gat.edge_softmax(s, ref_graph["dst"], g.num_nodes, mask)
    ref_y, vjp = jax.vjp(ref_fn, jnp.asarray(scores))
    s = torch.as_tensor(scores).requires_grad_()
    y = edge_softmax(s, graph["dst"], g.num_nodes, graph.get("edge_mask"))
    y.backward(torch.as_tensor(cot))
    _close(y, ref_y, "alpha")
    _close(s.grad, vjp(jnp.asarray(cot))[0], "d scores")


@MASKED
def test_gat_forward_and_grads_match_reference(small, masked):
    from repro.configs.gat_cora import REDUCED as R
    g, ref_graph, graph = _graphs(small, masked)
    ref_params = ref_gat.gat_init(KEY, 32, R["d_hidden"], R["n_heads"],
                                  R["classes"], R["n_layers"])
    params = _port_params(ref_params)
    x, labels = g.node_feat, (g.labels % R["classes"]).astype(np.int32)
    _close(gat_apply(params, torch.as_tensor(x), graph),
           ref_gat.gat_apply(ref_params, jnp.asarray(x), ref_graph),
           "logits")
    ref_loss, ref_grads = jax.value_and_grad(ref_gat.gat_loss)(
        ref_params, jnp.asarray(x), ref_graph, jnp.asarray(labels),
        jnp.asarray(g.train_mask))
    loss = gat_loss(params, torch.as_tensor(x), graph,
                    torch.as_tensor(labels), torch.as_tensor(g.train_mask))
    loss.backward()
    _close(loss, ref_loss, "loss")
    _assert_grads(params, ref_grads, "gat")


def test_gat_init_shapes_match_reference():
    from repro.configs.gat_cora import MODEL_KW as K
    ref = _np(ref_gat.gat_init(KEY, 1433, K["d_hidden"], K["n_heads"], 7,
                               K["n_layers"]))
    port = gat_init(torch.Generator().manual_seed(0), 1433, K["d_hidden"],
                    K["n_heads"], 7, K["n_layers"], device="cpu")
    assert ({p: tuple(v.shape) for p, v in _leaves(port)}
            == {p: v.shape for p, v in _leaves(ref)})
    w0 = port["layers"][0]["w"]["w"]
    assert abs(float(w0.std()) - 1433 ** -0.5) < 0.05 * 1433 ** -0.5


@MASKED
def test_pna_aggregate_matches_reference(small, masked):
    g, ref_graph, graph = _graphs(small, masked)
    rng = np.random.default_rng(3)
    h = np.maximum(rng.standard_normal((g.num_nodes, 8)), 0).astype(
        np.float32)                                  # ReLU-like: zero ties
    mld = graph["mean_log_deg"]
    ref_y, vjp = jax.vjp(
        lambda v: ref_pna.pna_aggregate(v, ref_graph["src"], ref_graph["dst"],
                                        g.num_nodes, mld,
                                        ref_graph.get("edge_mask")),
        jnp.asarray(h))
    cot = rng.standard_normal(ref_y.shape).astype(np.float32)
    ht = torch.as_tensor(h).requires_grad_()
    y = pna_aggregate(ht, graph["src"], graph["dst"], g.num_nodes, mld,
                      graph.get("edge_mask"))
    y.backward(torch.as_tensor(cot))
    _close(y, ref_y, "aggregate")
    _close(ht.grad, vjp(jnp.asarray(cot))[0], "d h")


def test_pna_ties_split_the_gradient_as_jax():
    """Destinations whose max and min tie (equal messages, zeros from a
    ReLU, duplicate edges) and whose variance is exactly 0 (one incoming
    edge, or all messages equal): the gradient is split among tied inputs
    and at ``max(var, 0)`` as JAX splits it."""
    n = 8
    # 0 <- {1, 2, 3} with equal rows; 4 <- {1} alone; 5 <- {6, 6} (a
    # duplicate edge); 7 <- {0, 3, 6}; nodes 1, 2, 3, 6 get nothing
    src = np.array([1, 2, 3, 1, 6, 6, 0, 3, 6], np.int32)
    dst = np.array([0, 0, 0, 4, 5, 5, 7, 7, 7], np.int32)
    h = np.zeros((n, 4), np.float32)
    h[[1, 2, 3]] = [1.0, 0.0, 2.0, 0.0]
    h[6] = [0.0, 0.0, 3.0, 1.0]
    h[0] = [1.0, 0.0, 2.0, 0.5]
    cot = np.random.default_rng(4).standard_normal((n, 48)).astype(
        np.float32)
    for mask in (None, np.array([1, 1, 1, 1, 1, 0, 1, 1, 1], bool)):
        rm = None if mask is None else jnp.asarray(mask)
        pm = None if mask is None else torch.as_tensor(mask)
        ref_y, vjp = jax.vjp(
            lambda v: ref_pna.pna_aggregate(v, jnp.asarray(src),
                                            jnp.asarray(dst), n, 1.3, rm),
            jnp.asarray(h))
        ht = torch.as_tensor(h).requires_grad_()
        y = pna_aggregate(ht, torch.as_tensor(src).long(),
                          torch.as_tensor(dst).long(), n, 1.3, pm)
        y.backward(torch.as_tensor(cot))
        _close(y, ref_y, "tied aggregate")
        ref_g = np.asarray(vjp(jnp.asarray(cot))[0])
        _close(ht.grad, ref_g, "tied d h")
        assert np.all(np.isfinite(ref_g))


@MASKED
def test_pna_forward_and_grads_match_reference(small, masked):
    from repro.configs.pna import REDUCED as R
    g, ref_graph, graph = _graphs(small, masked)
    ref_params = ref_pna.pna_init(KEY, 32, R["d_hidden"], R["n_layers"],
                                  R["classes"])
    params = _port_params(ref_params)
    x, labels = g.node_feat, (g.labels % R["classes"]).astype(np.int32)
    _close(pna_apply(params, torch.as_tensor(x), graph),
           ref_pna.pna_apply(ref_params, jnp.asarray(x), ref_graph),
           "logits")
    ref_loss, ref_grads = jax.value_and_grad(ref_pna.pna_loss)(
        ref_params, jnp.asarray(x), ref_graph, jnp.asarray(labels),
        jnp.asarray(g.train_mask))
    loss = pna_loss(params, torch.as_tensor(x), graph,
                    torch.as_tensor(labels), torch.as_tensor(g.train_mask))
    loss.backward()
    _close(loss, ref_loss, "loss")
    _assert_grads(params, ref_grads, "pna")


@MASKED
def test_pna_remat_loss_and_grads_match_reference(small, masked):
    """``GNNBundle("pna").loss_fn(remat=True)``, each layer under
    ``torch.utils.checkpoint``: the reference's loss and gradients."""
    from repro.configs.pna import REDUCED as R
    g, ref_graph, _ = _graphs(small, masked)
    ref_graph["mean_log_deg"] = 2.0          # the bundle's normaliser
    ref_params = ref_pna.pna_init(KEY, 32, R["d_hidden"], R["n_layers"],
                                  R["classes"])
    params = _port_params(ref_params)
    labels = (g.labels % R["classes"]).astype(np.int32)
    mask = small[1] if masked else np.ones(g.num_edges, bool)
    ref_graph["edge_mask"] = jnp.asarray(mask)
    ref_loss, ref_grads = jax.value_and_grad(ref_pna.pna_loss)(
        ref_params, jnp.asarray(g.node_feat), ref_graph, jnp.asarray(labels),
        jnp.asarray(g.train_mask))
    batch = {"src": torch.as_tensor(g.src.astype(np.int64)),
             "dst": torch.as_tensor(g.dst.astype(np.int64)),
             "edge_mask": torch.as_tensor(mask),
             "deg": torch.as_tensor(g.in_degrees().astype(np.float32) + 1),
             "x": torch.as_tensor(g.node_feat),
             "labels": torch.as_tensor(labels.astype(np.int64)),
             "train_mask": torch.as_tensor(g.train_mask)}
    bundle = GNNBundle("pna", {}, n_classes=R["classes"])
    loss = bundle.loss_fn("full_graph_sm", remat=True)(params, batch)
    loss.backward()
    _close(loss, ref_loss, "loss")
    _assert_grads(params, ref_grads, "pna remat")


@pytest.mark.parametrize("arch", ["gcn-cora", "gat-cora", "nequip"])
def test_remat_is_pna_only(arch):
    with pytest.raises(ValueError, match="remat"):
        get(arch).bundle().loss_fn("full_graph_sm", remat=True)


def test_pna_init_shapes_match_reference():
    from repro.configs.pna import MODEL_KW as K
    ref = _np(ref_pna.pna_init(KEY, 100, K["d_hidden"], K["n_layers"], 47))
    port = pna_init(torch.Generator().manual_seed(0), 100, K["d_hidden"],
                    K["n_layers"], 47, device="cpu")
    assert ({p: tuple(v.shape) for p, v in _leaves(port)}
            == {p: v.shape for p, v in _leaves(ref)})


# ------------------------------------------------------------------ NequIP
@pytest.fixture(scope="module")
def mols():
    """A pack of 4 molecules (10 atoms, 24 edges each), both sides."""
    ms = ref_molecules_like(batch=4, n_nodes=10, n_edges=24)
    gb, _ = ref_pack([m[0] for m in ms])
    pos = np.concatenate([m[1] for m in ms])
    z = np.concatenate([m[2] for m in ms])
    mask = np.random.default_rng(5).random(gb.src.shape[0]) < 0.8
    return gb, pos, z, mask


@pytest.fixture(scope="module")
def nequip_ref():
    """The reference's seed-0 ``REDUCED`` NequIP parameters, drawn once for
    the module (each test carries its own port copy across: they take
    gradients)."""
    from repro.configs.nequip import REDUCED as R
    return ref_nequip.nequip_init(KEY, channels=R["d_hidden"],
                                  n_layers=R["n_layers"], n_rbf=R["n_rbf"],
                                  cutoff=R["cutoff"])


def _nequip_params(ref):
    return ref, _port_params(ref)


def _mol_args(mols, masked):
    gb, pos, z, mask = mols
    em = mask if masked else gb.edge_mask
    ref = (jnp.asarray(z), jnp.asarray(pos), jnp.asarray(gb.src),
           jnp.asarray(gb.dst))
    port = (torch.as_tensor(z), torch.as_tensor(pos),
            torch.as_tensor(gb.src), torch.as_tensor(gb.dst))
    return (ref, dict(edge_mask=jnp.asarray(em))), \
        (port, dict(edge_mask=torch.as_tensor(em)))


@MASKED
def test_nequip_energy_and_forces_match_reference(mols, masked,
                                                  nequip_ref):
    ref_params, params = _nequip_params(nequip_ref)
    (ra, rkw), (pa, pkw) = _mol_args(mols, masked)
    gb = mols[0]
    node_mask = np.arange(gb.num_nodes) % 7 != 3
    _close(nequip_apply(params, *pa, node_mask=torch.as_tensor(node_mask,
                                                               dtype=torch.float32),
                        **pkw),
           ref_nequip.nequip_apply(ref_params, *ra,
                                   node_mask=jnp.asarray(node_mask,
                                                         jnp.float32),
                                   **rkw),
           "energy per atom")
    gkw = dict(graph_ids=gb.graph_ids, num_graphs=gb.num_graphs)
    _close(nequip_energy(params, *pa, **pkw,
                         graph_ids=torch.as_tensor(gkw["graph_ids"]),
                         num_graphs=4),
           ref_nequip.nequip_energy(ref_params, *ra, **rkw,
                                    graph_ids=jnp.asarray(gkw["graph_ids"]),
                                    num_graphs=4),
           "energy per molecule")
    _close(nequip_energy(params, *pa, **pkw),
           ref_nequip.nequip_energy(ref_params, *ra, **rkw), "energy")
    e, f = nequip_energy_forces(params, *pa, **pkw)
    re, rf = ref_nequip.nequip_energy_forces(ref_params, *ra, **rkw)
    _close(e, re, "energy (forces call)")
    _close(f, rf, "forces")
    assert bool(torch.isfinite(f).all())


@MASKED
def test_nequip_loss_grads_match_reference(mols, masked, nequip_ref):
    """The gradient of the bundle's energy loss (squared error of the total
    energy against a target) with respect to every parameter leaf."""
    ref_params, params = _nequip_params(nequip_ref)
    (ra, rkw), (pa, pkw) = _mol_args(mols, masked)

    def ref_loss(p):
        e = ref_nequip.nequip_energy(p, *ra, **rkw)
        return jnp.mean((jnp.sum(e) - 1.5) ** 2)
    rl, rg = jax.value_and_grad(ref_loss)(ref_params)
    loss = torch.mean((torch.sum(nequip_energy(params, *pa, **pkw)) - 1.5)
                      ** 2)
    loss.backward()
    _close(loss, rl, "loss")
    _assert_grads(params, rg, "nequip")


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_nequip_is_invariant_and_equivariant(mols, seed, nequip_ref):
    _, params = _nequip_params(nequip_ref)
    (_, _), (pa, pkw) = _mol_args(mols, False)
    z, pos, src, dst = pa
    R = torch.as_tensor(_rotation(seed))
    e, f = nequip_energy_forces(params, z, pos, src, dst, **pkw)
    e_r, f_r = nequip_energy_forces(params, z, pos @ R.T, src, dst, **pkw)
    _close(e_r, e, "rotated energy")
    _close(f_r, f @ R.T, "rotated forces")
    # and a translation changes nothing
    e_t, f_t = nequip_energy_forces(params, z, pos + torch.tensor(
        [0.3, -1.0, 2.0]), src, dst, **pkw)
    _close(e_t, e, "translated energy")
    _close(f_t, f, "translated forces")


def test_nequip_zero_length_edge_gives_finite_forces(mols, nequip_ref):
    """An edge with src = dst (r = 0) is where the reference's
    ``jnp.linalg.norm`` gradient is NaN (0 · ∞ in its VJP) and
    ``torch.linalg.vector_norm``'s is 0: the port's forces stay finite,
    the reference's are NaN on that edge's atom alone, and every other
    atom's force agrees (ROADMAP §3)."""
    ref_params, params = _nequip_params(nequip_ref)
    gb, pos, z, _ = mols
    src = np.concatenate([gb.src, [5]]).astype(np.int32)
    dst = np.concatenate([gb.dst, [5]]).astype(np.int32)
    em = np.ones(src.shape[0], bool)
    _, rf = ref_nequip.nequip_energy_forces(
        ref_params, jnp.asarray(z), jnp.asarray(pos), jnp.asarray(src),
        jnp.asarray(dst), edge_mask=jnp.asarray(em))
    rf = np.asarray(rf)
    e, f = nequip_energy_forces(params, torch.as_tensor(z),
                                torch.as_tensor(pos), torch.as_tensor(src),
                                torch.as_tensor(dst),
                                edge_mask=torch.as_tensor(em))
    assert bool(torch.isfinite(f).all())
    bad = ~np.isfinite(rf).all(axis=1)
    assert bad.tolist() == [i == 5 for i in range(gb.num_nodes)]
    _close(f[~torch.as_tensor(bad)], rf[~bad], "forces off the r = 0 atom")


def test_nequip_init_shapes_match_reference():
    from repro.configs.nequip import MODEL_KW as K
    ref = _np(ref_nequip.nequip_init(KEY, channels=K["d_hidden"],
                                     n_layers=K["n_layers"],
                                     n_rbf=K["n_rbf"]))
    port = nequip_init(torch.Generator().manual_seed(0),
                       channels=K["d_hidden"], n_layers=K["n_layers"],
                       n_rbf=K["n_rbf"], device="cpu")
    assert ({p: tuple(v.shape) for p, v in _leaves(port)}
            == {p: v.shape for p, v in _leaves(ref)})


# --------------------------------------------------------- configs, bundle
ARCHS = ["gcn-cora", "gat-cora", "pna", "nequip"]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_geometry_match_reference(arch):
    import importlib
    spec, ref_spec = get(arch), ref_get(arch)
    assert spec.family == ref_spec.family == "gnn"
    assert spec.shapes == ref_spec.shapes == tuple(GNN_SHAPES)
    bundle, ref_bundle = spec.bundle(), ref_spec.bundle()
    assert (bundle.arch, bundle.model_kw, bundle.n_classes) == (
        ref_bundle.arch, ref_bundle.model_kw, ref_bundle.n_classes)
    for shape in GNN_SHAPES:
        assert bundle.geometry(shape) == ref_bundle.geometry(shape), shape
    mod = arch.replace("-", "_")
    if arch != "gcn-cora":
        port_cfg = importlib.import_module(f"repro_torch.configs.{mod}")
        ref_cfg = importlib.import_module(f"repro.configs.{mod}")
        assert port_cfg.MODEL_KW == ref_cfg.MODEL_KW
        assert port_cfg.REDUCED == ref_cfg.REDUCED


def test_every_reference_arch_is_ported():
    """Nothing of the reference's registry is left unported: both MoE
    archs resolve to ``lm`` specs over ``LM_SHAPES``, and the port
    registers exactly the reference's archs."""
    from repro.configs import all_archs
    from repro_torch.configs import LM_SHAPES, REGISTRY
    for name in ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b"):
        spec = get(name)
        assert spec.family == ref_get(name).family == "lm"
        assert spec.shapes == tuple(LM_SHAPES)
    assert set(REGISTRY) == set(all_archs())
    with pytest.raises(KeyError, match="unknown arch"):
        get("no-such-arch")


def _reduced_bundles(arch):
    import importlib
    R = importlib.import_module(
        "repro.configs." + arch.replace("-", "_")).REDUCED
    kw = {k: v for k, v in R.items() if k != "classes"}
    ref_arch = ref_get(arch).bundle().arch
    n_classes = R.get("classes", 16)
    return (GNNBundle(ref_arch, kw, n_classes=n_classes),
            type(ref_get(arch).bundle())(ref_arch, kw, n_classes=n_classes))


def _step_batches(arch, small, mols):
    g, _ = small
    n_classes = _reduced_bundles(arch)[0].n_classes
    if arch == "nequip":
        gb, pos, z, mask = mols
        arrays = {"src": gb.src, "dst": gb.dst, "edge_mask": mask,
                  "labels": np.zeros(gb.num_nodes, np.int32),
                  "train_mask": gb.node_mask, "species": z, "pos": pos,
                  "energy_target": np.float32(-0.7)}
    else:
        arrays = {"src": g.src, "dst": g.dst,
                  "edge_mask": np.ones(g.num_edges, bool),
                  "labels": (g.labels % n_classes).astype(np.int32),
                  "train_mask": g.train_mask, "x": g.node_feat,
                  "deg": g.in_degrees().astype(np.float32) + 1.0}
    ref = {k: jnp.asarray(v) for k, v in arrays.items()}
    port = {k: torch.as_tensor(np.asarray(v)) for k, v in arrays.items()}
    for k in ("src", "dst", "labels", "species"):
        if k in port:
            port[k] = port[k].long()
    return ref, port


@pytest.mark.parametrize("arch", ["gat-cora", "pna", "nequip"])
def test_one_step_fn_step_matches_reference(arch, small, mols):
    """``step_fn("full_graph_sm")`` at the config's ``REDUCED`` widths: the
    loss, and the parameters after one Adam(1e-3) step with the clip at 1.0,
    within 1e-5 of the reference's step from the same parameters."""
    bundle, ref_bundle = _reduced_bundles(arch)
    d = 32
    ref_params = ref_bundle.init_params(KEY, d)
    params = params_from_jax(_np(ref_params), device="cpu")
    ref_batch, batch = _step_batches(arch, small, mols)
    ref_step = ref_bundle.step_fn("full_graph_sm")
    ref_new, _, ref_loss = ref_step(ref_params, ref_adam(1e-3).init(
        ref_params), ref_batch)
    step = bundle.step_fn("full_graph_sm")
    new, state, loss = step(params, bundle.opt().init(params), batch)
    _close(loss, ref_loss, "loss")
    ref_leaves = dict(_leaves(_np(ref_new)))
    for path, leaf in _leaves(new):
        _close(leaf, ref_leaves[path], f"{arch} param{path} after one step")


@pytest.mark.parametrize("arch", ["gat-cora", "pna", "nequip"])
def test_bundle_refuses_kernel_executors(arch):
    """GAT takes ``fused`` with an attention plan alone
    (``tests/test_torch_gat_fused.py``); every other kernel executor is
    refused, and every one for PNA and NequIP."""
    bundle = get(arch).bundle()
    refused = (("blockell", "shared") if arch == "gat-cora"
               else ("blockell", "fused", "shared"))
    for executor in refused:
        with pytest.raises(ValueError, match="no kernel executor"):
            bundle.loss_fn("full_graph_sm", executor=executor,
                           exec_plan=object())
    if arch == "gat-cora":
        with pytest.raises(ValueError, match="needs an attention plan"):
            bundle.loss_fn("full_graph_sm", executor="fused",
                           exec_plan=object())
    with pytest.raises(ValueError, match="unknown GNN arch"):
        GNNBundle("moe", {}).init_params(torch.Generator(), 4, device="cpu")
