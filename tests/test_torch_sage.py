"""The port's GraphSAGE against the reference's (``repro/models/sage_gin.py``),
with the reference's weights carried over by ``params_from_jax`` and inputs
made with numpy from a seed.

* ``sage_apply`` and ``sage_loss`` (with and without a linear head) on the
  three structural graphs through the port's ``segment``, ``blockell`` and
  ``fused`` executors (``fused`` in both orders: aggregate-first is the
  two-W ``spmm_blockell_update_compact`` plan call, update-first one
  ``spmm_blockell_compact``; on CPU tensors both are the kernels' plain
  versions), against the reference's ``segment``: outputs, losses and every
  gradient within 1e-5 of the largest entry of each compared array (fp32
  sums in another order).
* ``sage_block_apply`` on a sampled ``MiniBatch`` (the sampler is byte-equal,
  ``tests/test_torch_graph.py``), and GIN's graph-classification readout on
  a ``pack`` of small synthesized graphs: values and gradients within 1e-5.
* Full width: the paper's GraphSAGE ``[1433, 256, 7]`` on the
  MinHash-reordered Cora, on the schedule the card's cold DP picks, against
  the reference within 1e-4 (sums of 1433 terms in another order).
* ``examples/train_sage_reddit_torch.py`` learns on the CPU.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models.sage_gin import gin_apply as ref_gin_apply
from repro.models.sage_gin import gin_init as ref_gin_init
from repro.models.sage_gin import sage_apply as ref_sage_apply
from repro.models.sage_gin import sage_block_apply as ref_sage_block_apply
from repro.models.sage_gin import sage_init as ref_sage_init
from repro.models.sage_gin import sage_loss as ref_sage_loss
from repro.nn.layers import linear_init as ref_linear_init
from repro_torch.convert import params_from_jax
from repro_torch.exec import build_layer_plan, build_plan
from repro_torch.models import (gin_apply, sage_apply, sage_block_apply,
                                sage_init, sage_loss)

from _torch_parity import GRAPHS, to_port

TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _assert_close_scaled(got, ref, what, tol=TOL):
    """|got - ref| <= tol * max(1, max|ref|) entrywise."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


def _grad_pairs(port, ref, path=""):
    if isinstance(port, dict):
        for k in port:
            yield from _grad_pairs(port[k], ref[k], f"{path}.{k}")
    elif isinstance(port, (list, tuple)):
        for i, (a, b) in enumerate(zip(port, ref)):
            yield from _grad_pairs(a, b, f"{path}[{i}]")
    else:
        yield path, port.grad, ref


def _leaf_params(tree):
    if isinstance(tree, dict):
        return {k: _leaf_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaf_params(v) for v in tree)
    return tree.detach().clone().requires_grad_()


def _carry(tree):
    return _leaf_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu"))


DIMS = [12, 16, 5]


def _ref_params(head: bool):
    key = jax.random.PRNGKey(0)
    sage = ref_sage_init(key, DIMS)
    # nonzero biases, so db is not taken at b = 0
    rng = np.random.default_rng(8)
    for p in sage["layers"]:
        p["b"] = jnp.asarray(rng.standard_normal(p["b"].shape), jnp.float32)
    return sage, (ref_linear_init(jax.random.fold_in(key, 1), DIMS[-1], 4)
                  if head else None)


def _small_inputs(g):
    n = g.num_nodes
    rng = np.random.default_rng(2)
    return (rng.standard_normal((n, DIMS[0])).astype(np.float32),
            rng.integers(0, 4, n).astype(np.int32),
            rng.random(n) < 0.5)


@functools.lru_cache(maxsize=None)
def _small_reference(gname, head):
    g = GRAPHS[gname]
    x, labels, mask = _small_inputs(g)
    graph = {"src": jnp.asarray(g.src), "dst": jnp.asarray(g.dst)}
    sage, hp = _ref_params(head)
    out = ref_sage_apply(sage, jnp.asarray(x), graph)

    def loss(params):
        return ref_sage_loss(params["sage"], jnp.asarray(x), graph,
                             jnp.asarray(labels), jnp.asarray(mask),
                             head=params.get("head"))
    params = {"sage": sage, **({"head": hp} if head else {})}
    return out, jax.value_and_grad(loss)(params), params


def _port_plan(pg, executor, order):
    if executor == "blockell":
        return build_plan(pg, "mean", bm=32, backend="cuda", device="cpu")
    if executor != "fused":
        return None
    plans, gplan = [], None
    for d_in, d_out in zip(DIMS[:-1], DIMS[1:]):
        lp = build_layer_plan(pg, "mean", d_in=d_in, d_out=d_out, order=order,
                              bm=32, backend="cuda", gplan=gplan,
                              device="cpu")
        plans.append(lp)
        gplan = lp.gplan
    assert all(lp.fuse == (order == "aggregate_first") for lp in plans)
    return plans


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("executor,order", [
    ("fused", "aggregate_first"), ("fused", "update_first"),
    ("blockell", None), ("segment", None)])
@pytest.mark.parametrize("head", [False, True])
def test_small_sage_matches_reference(gname, executor, order, head):
    g = GRAPHS[gname]
    x, labels, mask = _small_inputs(g)
    ref_out, (ref_loss, ref_grads), ref_params = _small_reference(gname,
                                                                  head)
    params = _carry(ref_params)
    plan = _port_plan(to_port(g), executor, order)
    t = torch.as_tensor
    tgraph = {"src": t(g.src.astype(np.int64)),
              "dst": t(g.dst.astype(np.int64))}
    with torch.no_grad():
        out = sage_apply(params["sage"], t(x), tgraph, executor, plan)
    _assert_close_scaled(out.numpy(), ref_out, "sage_apply")
    # every row is L2-normalized (no row of these inputs is all zero)
    np.testing.assert_allclose(torch.linalg.vector_norm(out, dim=-1).numpy(),
                               1.0, rtol=1e-5)
    loss = sage_loss(params["sage"], t(x), tgraph, t(labels), t(mask),
                     head=params.get("head"), executor=executor, plan=plan)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=TOL)
    for path, got, want in _grad_pairs(params, ref_grads):
        _assert_close_scaled(got.numpy(), want, f"d{path}")


def test_sage_init_shapes_and_device():
    p = sage_init(torch.Generator().manual_seed(0), [3703, 256, 41],
                  device="cpu")
    assert [tuple(l["w"].shape) for l in p["layers"]] == [(7406, 256),
                                                          (512, 41)]
    assert all(float(l["b"].abs().max()) == 0.0 for l in p["layers"])
    q = sage_init(torch.Generator().manual_seed(0), [3703, 256, 41],
                  device="cpu")
    assert all(torch.equal(a["w"], b["w"])
               for a, b in zip(p["layers"], q["layers"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sage_init(torch.Generator(), [4, 2])


def test_fused_sage_rejects_a_plan_of_another_mode():
    g = to_port(GRAPHS["random"])
    lp = build_layer_plan(g, "sum", d_in=12, d_out=16, bm=32,
                          backend="cuda", device="cpu")
    params = sage_init(torch.Generator().manual_seed(0), DIMS, device="cpu")
    with pytest.raises(ValueError, match="'mean'"):
        sage_apply(params, torch.zeros(g.num_nodes, 12), None, "fused",
                   [lp, lp])


# ------------------------------------------------------- sampled minibatch
@pytest.mark.parametrize("fanouts,seed", [((15, 10), 0), ((4, 3), 5)])
def test_sage_block_apply_matches_reference(fanouts, seed):
    from repro.graph import DatasetSpec, NeighborSampler as RefSampler
    from repro.graph import synthesize
    from repro_torch.graph import NeighborSampler
    from repro_torch.train import minibatch_tensors

    g = synthesize(DatasetSpec("mb", 600, 4000, 10, 4, seed=seed))
    pg = to_port(g)
    mb_ref = RefSampler(g, fanouts, seed=seed).sample(
        np.arange(0, 600, 37, dtype=np.int32))
    mb = NeighborSampler(pg, fanouts, seed=seed).sample(
        np.arange(0, 600, 37, dtype=np.int32))
    key = jax.random.PRNGKey(seed)
    ref_p = {"sage": ref_sage_init(key, [10, 16, 16]),
             "head": ref_linear_init(jax.random.fold_in(key, 1), 16, 4)}
    lut = {int(n): r for r, n in enumerate(mb_ref.input_nodes)}
    ref_batch = {
        "x": jnp.asarray(g.node_feat[mb_ref.input_nodes]),
        "blocks": [{"src": jnp.asarray(s), "dst": jnp.asarray(d)}
                   for s, d in zip(mb_ref.edge_src, mb_ref.edge_dst)],
        "seed_rows": jnp.asarray([lut[int(n)] for n in mb_ref.seeds]),
        "labels": jnp.asarray(g.labels[mb_ref.seeds])}

    def ref_loss(p):
        from repro.nn.layers import cross_entropy, linear_apply
        h = ref_sage_block_apply(p["sage"], ref_batch["x"],
                                 ref_batch["blocks"])
        return cross_entropy(linear_apply(p["head"],
                                          h[ref_batch["seed_rows"]]),
                             ref_batch["labels"])
    ref_out = ref_sage_block_apply(ref_p["sage"], ref_batch["x"],
                                   ref_batch["blocks"])
    ref_l, ref_grads = jax.value_and_grad(ref_loss)(ref_p)

    from repro_torch.nn.layers import cross_entropy, linear_apply
    batch = minibatch_tensors(pg, mb, "cpu")
    np.testing.assert_array_equal(batch["seed_rows"].numpy(),
                                  np.asarray(ref_batch["seed_rows"]))
    params = _carry(ref_p)
    with torch.no_grad():
        out = sage_block_apply(params["sage"], batch["x"], batch["blocks"])
    assert out.shape == (len(mb.input_nodes), 16)
    _assert_close_scaled(out.numpy(), ref_out, "sage_block_apply")
    h = sage_block_apply(params["sage"], batch["x"], batch["blocks"])
    loss = cross_entropy(linear_apply(params["head"], h[batch["seed_rows"]]),
                         batch["labels"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_l), rtol=TOL)
    for path, got, want in _grad_pairs(params, ref_grads):
        _assert_close_scaled(got.numpy(), want, f"d{path}")


# ---------------------------------------------- GIN's graph-level readout
@pytest.mark.parametrize("masked", [False, True])
def test_gin_graph_readout_matches_reference(masked):
    from repro.graph import DatasetSpec, pack as ref_pack, synthesize
    from repro_torch.graph import pack

    graphs = [synthesize(DatasetSpec(f"m{i}", 8 + 3 * i, 20 + 7 * i, 5, 2,
                                     seed=i)) for i in range(4)]
    rb, rfeat = ref_pack(graphs)
    pb, feat = pack([to_port(g) for g in graphs])
    ref_p = ref_gin_init(jax.random.PRNGKey(1), 5, 8, 2, 3)
    nm = rb.node_mask if masked else None

    def ref_logits(p):
        return ref_gin_apply(
            p, jnp.asarray(rfeat),
            {"src": jnp.asarray(rb.src), "dst": jnp.asarray(rb.dst),
             "edge_mask": jnp.asarray(rb.edge_mask)},
            graph_ids=jnp.asarray(rb.graph_ids), num_graphs=rb.num_graphs,
            node_mask=None if nm is None else jnp.asarray(nm))
    want = ref_logits(ref_p)
    ref_grads = jax.grad(lambda p: jnp.sum(ref_logits(p) ** 2))(ref_p)

    t = torch.as_tensor
    params = _carry(ref_p)
    got = gin_apply(params, t(feat),
                    {"src": t(pb.src.astype(np.int64)),
                     "dst": t(pb.dst.astype(np.int64)),
                     "edge_mask": t(pb.edge_mask)},
                    graph_ids=t(pb.graph_ids), num_graphs=pb.num_graphs,
                    node_mask=None if nm is None else t(pb.node_mask))
    assert got.shape == (4, 3)
    _assert_close_scaled(got.detach().numpy(), want, "readout logits")
    torch.sum(got ** 2).backward()
    for path, g_, w_ in _grad_pairs(params, ref_grads):
        _assert_close_scaled(g_.numpy(), w_, f"d{path}")


# ------------------------------------------------------------ full width
def test_full_width_sage_on_cora_matches_reference(tmp_path, monkeypatch):
    """The paper's GraphSAGE (h = 256) on the reordered Cora, on the
    schedule the card's cold DP picks for it, on the kernels' plain
    versions: embeddings, the loss and every gradient within 1e-4."""
    from repro.core import minhash_reorder as ref_minhash
    from repro.graph import cora_like as ref_cora_like
    from repro_torch.core import minhash_reorder
    from repro_torch.exec import build_forward_plan, sage_chain
    from repro_torch.exec.forward import build_cost_oracle, dp_schedule
    from repro_torch.graph import cora_like

    monkeypatch.setenv("REPRO_TORCH_EXEC_CACHE", str(tmp_path))
    dims = [1433, 256, 7]
    g_ref = ref_cora_like().permute(ref_minhash(ref_cora_like()))
    g = cora_like().permute(minhash_reorder(cora_like()))
    specs = sage_chain(dims)
    _, configs = dp_schedule(build_cost_oracle(g, specs, platform="cuda",
                                               use_cache=False))
    assert all(c[2] == "cuda" for c in configs)
    plans = build_forward_plan(g, specs, configs, device="cpu")

    ref_p = ref_sage_init(jax.random.PRNGKey(0), dims)
    graph = {"src": jnp.asarray(g_ref.src), "dst": jnp.asarray(g_ref.dst)}
    x, labels = jnp.asarray(g_ref.node_feat), jnp.asarray(g_ref.labels % 7)
    mask = jnp.asarray(g_ref.train_mask)
    want = ref_sage_apply(ref_p, x, graph)
    ref_l, ref_grads = jax.value_and_grad(ref_sage_loss)(ref_p, x, graph,
                                                        labels, mask)
    params = _carry(ref_p)
    t = lambda a: torch.as_tensor(np.array(a))
    with torch.no_grad():
        got = sage_apply(params, t(x), None, "fused", plans)
    _assert_close_scaled(got.numpy(), want, "embeddings", tol=1e-4)
    loss = sage_loss(params, t(x), None, t(labels), t(mask),
                     executor="fused", plan=plans)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_l), rtol=1e-4)
    for path, got_g, want_g in _grad_pairs(params, ref_grads):
        _assert_close_scaled(got_g.numpy(), want_g, f"d{path}", tol=1e-4)


# --------------------------------------------------------------- example
def test_example_learns_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "train_sage_reddit_torch",
        ROOT / "examples" / "train_sage_reddit_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.main(["--steps", "30", "--scale", "0.005", "--device",
                       "cpu"])
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert "final loss" in capsys.readouterr().out
