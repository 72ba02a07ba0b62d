"""The small API gaps of the port against the reference:
``graph.from_dense`` / ``to_dense`` (byte-equal), ``nn.layers``'
``layernorm_*`` and ``embedding_*`` and ``kernels.ref.spmm_edges_ref``
(1e-6), and the on-line SimHash reorder: ``lsh_order_from_projection``
given the reference's own projection ``r`` returns ``lsh_reorder_jax``'s
order byte for byte, on Cora and on a masked, sampled subgraph.
(``lsh_reorder_torch`` draws its projection from a ``torch.Generator``,
another stream than ``jax.random``'s, so its order differs from the
reference's by design.)
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import reorder as ref_reorder
from repro.graph import cora_like
from repro.graph import structure as ref_structure
from repro.kernels import ref as ref_kernels
from repro.nn import layers as ref_layers
from repro_torch.core import lsh_order_from_projection, lsh_reorder_torch
from repro_torch.graph import from_dense, to_dense
from repro_torch.kernels.ref import spmm_edges_ref
from repro_torch.nn import (embedding_apply, embedding_init, layernorm_apply,
                            layernorm_init)

from _torch_parity import assert_bytes_equal, to_port

TOL = 1e-6


def _close(got, ref, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= TOL * max(1.0, float(np.abs(ref).max())), (what, err)


@pytest.mark.parametrize("n,density,seed", [(40, 0.1, 0), (97, 0.03, 1),
                                            (1, 1.0, 2)])
def test_from_dense_and_to_dense_are_byte_equal(n, density, seed):
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < density).astype(np.float32)
    ref_g = ref_structure.from_dense(adj)
    g = from_dense(adj)
    for f in ("src", "dst"):
        assert_bytes_equal(getattr(g, f), getattr(ref_g, f), f)
    assert g.num_nodes == ref_g.num_nodes == n
    assert_bytes_equal(to_dense(g), ref_structure.to_dense(ref_g), "dense")
    # weighted and masked edges, duplicates summed
    e = max(g.num_edges, 1) * 2
    w = rng.standard_normal(e).astype(np.float32)
    mask = rng.random(e) < 0.7
    ref_w = ref_structure.Graph(src=rng.integers(0, n, e).astype(np.int32),
                                dst=rng.integers(0, n, e).astype(np.int32),
                                num_nodes=n, edge_weight=w, edge_mask=mask)
    assert_bytes_equal(to_dense(to_port(ref_w)), ref_structure.to_dense(ref_w),
                       "weighted dense")


def test_layernorm_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 24)) * 3 + 1).astype(np.float32)
    p = layernorm_init(24, device="cpu")
    ref_p = ref_layers.layernorm_init(24)
    for k in ("scale", "bias"):
        assert_bytes_equal(p[k].numpy(), np.asarray(ref_p[k]), k)
    p = {"scale": torch.as_tensor(rng.uniform(0.5, 1.5, 24).astype(
        np.float32)), "bias": torch.as_tensor(
            rng.standard_normal(24).astype(np.float32))}
    ref_p = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    for eps in (1e-5, 1e-3):
        _close(layernorm_apply(p, torch.as_tensor(x), eps=eps),
               ref_layers.layernorm_apply(ref_p, jnp.asarray(x), eps=eps),
               f"layernorm eps={eps}")


def test_embedding_matches_reference():
    ref_p = ref_layers.embedding_init(jax.random.PRNGKey(0), 50, 12)
    p = embedding_init(torch.Generator().manual_seed(0), 50, 12,
                       device="cpu")
    assert tuple(p["table"].shape) == ref_p["table"].shape
    assert abs(float(p["table"].std()) - 0.02) < 0.005
    table = {"table": torch.as_tensor(np.array(ref_p["table"]))}
    ids = np.random.default_rng(1).integers(0, 50, (4, 7)).astype(np.int32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = embedding_apply(table, torch.as_tensor(ids), dtype=dt)
        ref = ref_layers.embedding_apply(ref_p, jnp.asarray(ids), dtype=jdt)
        assert got.dtype == dt
        _close(got.float(), np.asarray(ref, np.float32), f"embedding {dt}")


@pytest.mark.parametrize("n,e,d", [(30, 200, 5), (2708, 10556, 16)])
def test_spmm_edges_ref_matches_reference(n, e, d):
    rng = np.random.default_rng(n)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = rng.standard_normal(e).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    got = spmm_edges_ref(*(torch.as_tensor(a) for a in (src, dst, w, x)), n)
    ref = ref_kernels.spmm_edges_ref(*(jnp.asarray(a)
                                       for a in (src, dst, w, x)), n)
    _close(got, ref, "spmm_edges_ref")


def _sampled_masked_subgraph(seed=0, n_keep=700, pad=512):
    """Cora's edges among ``n_keep`` sampled nodes, relabelled, then padded
    with ``pad`` masked edges (ids anywhere in the subgraph)."""
    g = cora_like()
    rng = np.random.default_rng(seed)
    keep = np.sort(rng.choice(g.num_nodes, n_keep, replace=False))
    new_id = np.full(g.num_nodes, -1, np.int64)
    new_id[keep] = np.arange(n_keep)
    m = (new_id[g.src] >= 0) & (new_id[g.dst] >= 0)
    src = np.concatenate([new_id[g.src[m]],
                          rng.integers(0, n_keep, pad)]).astype(np.int32)
    dst = np.concatenate([new_id[g.dst[m]],
                          rng.integers(0, n_keep, pad)]).astype(np.int32)
    mask = np.concatenate([np.ones(int(m.sum()), bool), np.zeros(pad, bool)])
    return src, dst, n_keep, mask


@pytest.mark.parametrize("graph", ["cora", "sampled_masked"])
@pytest.mark.parametrize("bits,seed,by_degree", [(16, 0, True),
                                                 (8, 3, False)])
def test_lsh_order_is_the_reference_order_given_its_projection(
        graph, bits, seed, by_degree):
    if graph == "cora":
        g = cora_like()
        src, dst, n, mask = g.src, g.dst, g.num_nodes, None
    else:
        src, dst, n, mask = _sampled_masked_subgraph(seed)
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(ref_reorder.lsh_reorder_jax(
        jnp.asarray(src), jnp.asarray(dst), n, num_bits=bits, seed=seed,
        edge_mask=jmask, weight_by_degree=by_degree))
    r = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, bits),
                                   dtype=jnp.float32))
    got = lsh_order_from_projection(
        torch.as_tensor(src), torch.as_tensor(dst), n, torch.as_tensor(r),
        edge_mask=None if mask is None else torch.as_tensor(mask),
        weight_by_degree=by_degree)
    assert got.dtype == torch.int64
    assert_bytes_equal(got.numpy(), want.astype(np.int64), "lsh order")
    # the order is a permutation, and not the identity
    assert np.array_equal(np.sort(want), np.arange(n))
    assert not np.array_equal(want, np.arange(n))


def test_lsh_reorder_torch_draws_its_own_projection():
    g = cora_like()
    src, dst = torch.as_tensor(g.src), torch.as_tensor(g.dst)
    a = lsh_reorder_torch(src, dst, g.num_nodes, seed=0)
    b = lsh_reorder_torch(src, dst, g.num_nodes, seed=0)
    assert torch.equal(a, b)
    assert torch.equal(torch.sort(a).values, torch.arange(g.num_nodes))
    r = torch.randn((g.num_nodes, 16),
                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, lsh_order_from_projection(src, dst, g.num_nodes, r))
    assert not torch.equal(a, lsh_reorder_torch(src, dst, g.num_nodes,
                                                seed=1))
