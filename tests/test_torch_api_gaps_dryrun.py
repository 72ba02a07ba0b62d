"""The last API gaps of the port against the reference, the dry-run's
surface among them: ``core.blocksparse.choose_block_shape`` (equal over a
grid of widths, budgets and element sizes; at d = 16 under the card's
shared-memory budget, the bucketed plans' hub tile), ``Graph.pad_edges``
(byte-equal), ``EmbeddingCache.num_layers`` / ``capacity_entries`` /
``reset_stats``, and ``GNNBundle.input_specs`` (shapes and dtypes equal to
the reference's ``ShapeDtypeStruct``s for the four GNN archs on the four
graph cells).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import get as ref_get
from repro.core.blocksparse import choose_block_shape as ref_choose
from repro.serve.cache import EmbeddingCache as RefCache
from repro_torch.configs import get
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.core import choose_block_shape
from repro_torch.roofline import hw
from repro_torch.serve.cache import EmbeddingCache

from _torch_parity import GRAPHS, assert_bytes_equal, to_port

DTYPES = {jnp.dtype("float32"): torch.float32,
          jnp.dtype("int32"): torch.int32, jnp.dtype("bool"): torch.bool}


@pytest.mark.parametrize("bytes_per_el", [1, 2, 4])
def test_choose_block_shape_equals_the_reference(bytes_per_el):
    budgets = [2 ** k for k in range(12, 25)] + [hw.SMEM_BYTES_PER_BLOCK,
                                                 8 * 2 ** 20, 3 * 10 ** 5]
    for d in [1, 7, 16, 41, 64, 128, 256, 602, 1433, 4096]:
        for budget in budgets:
            got = choose_block_shape(d, budget, bytes_per_el)
            want = ref_choose(d, budget, bytes_per_el)
            assert got == tuple(want), (d, budget, bytes_per_el)
            assert all(isinstance(x, int) for x in got)
    assert choose_block_shape(64) == tuple(ref_choose(64))


def test_choose_block_shape_under_the_cards_budget_is_the_hub_tile():
    assert choose_block_shape(16, hw.SMEM_BYTES_PER_BLOCK) == (256, 128)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pad_edges_is_byte_equal(name, masked):
    ref = GRAPHS[name].with_sym_norm()
    if masked:
        mask = np.arange(ref.num_edges) % 3 != 0
        ref = dataclasses.replace(ref, edge_mask=mask).with_sym_norm()
    port = dataclasses.replace(to_port(ref), edge_mask=ref.edge_mask,
                               edge_weight=ref.edge_weight)
    for cap in (ref.num_edges, ref.num_edges + 1, ref.num_edges + 777):
        a, b = port.pad_edges(cap), ref.pad_edges(cap)
        for field in ("src", "dst", "edge_mask", "edge_weight"):
            assert_bytes_equal(getattr(a, field), getattr(b, field),
                               f"{name} {cap} {field}")
        assert a.num_nodes == b.num_nodes and a.num_edges == cap
    no_weight = dataclasses.replace(port, edge_weight=None)
    assert no_weight.pad_edges(ref.num_edges + 3).edge_weight is None
    with pytest.raises(ValueError, match="exceeds capacity"):
        port.pad_edges(ref.num_edges - 1)
    with pytest.raises(ValueError, match="exceeds capacity"):
        ref.pad_edges(ref.num_edges - 1)


@pytest.mark.parametrize("line_size", [1, 16])
def test_cache_layers_capacity_and_reset_stats(line_size):
    rng = np.random.default_rng(0)
    n, dims = 500, [48, 16, 8]
    order = rng.permutation(n)
    feats = rng.standard_normal((n, dims[0])).astype(np.float32)
    h1 = rng.standard_normal((n, dims[1])).astype(np.float32)
    caches = [cls(dims, 64 * 1024, order=order, line_size=line_size)
              for cls in (EmbeddingCache, RefCache)]
    probes = [rng.integers(0, n, 40) for _ in range(3)]
    for c in caches:
        for ids in probes:
            c.fetch_base(ids, lambda i: feats[i])
            c.lookup(1, ids)
            c.put_many(1, ids, h1[ids])
    port, ref = caches
    assert port.num_layers == ref.num_layers == len(dims)
    for layer in range(len(dims)):
        assert port.capacity_entries(layer) == ref.capacity_entries(layer)
    assert port.stats().hits == ref.stats().hits > 0
    assert port.stats().per_layer == ref.stats().per_layer
    entries = [len(lru) for lru in port.layers]
    for c in caches:
        c.reset_stats()
    for c in caches:
        s = c.stats()
        assert (s.hits, s.misses, s.evictions) == (0, 0, 0)
    # the entries stay: a repeated probe hits
    assert [len(lru) for lru in port.layers] == entries
    ids = np.asarray(list(port.layers[1].store)[:5])
    mask, _ = port.lookup(1, ids)
    assert mask.all() and port.stats().hits == 5


@pytest.mark.parametrize("shape", list(GNN_SHAPES))
@pytest.mark.parametrize("arch", ["gcn-cora", "gat-cora", "pna", "nequip"])
def test_gnn_input_specs_equal_the_reference(arch, shape):
    got = get(arch).bundle().input_specs(shape)
    want = ref_get(arch).bundle().input_specs(shape)
    assert list(got) == list(want)
    for name, sds in want.items():
        assert got[name] == (tuple(sds.shape), DTYPES[sds.dtype]), name
