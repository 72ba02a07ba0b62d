"""The port's host-side graph compilers produce byte-equal arrays to the
reference: the Cora-shaped generator, MinHash reordering, block-ELL tiling
and its slot compaction (rows / cols / blocks / row_active / row_offsets)."""
import dataclasses

import numpy as np
import pytest

from repro.core import (build_blockell as ref_build_blockell,
                        minhash_reorder as ref_minhash,
                        traffic_model as ref_traffic_model)
from repro.graph import (DatasetSpec as RefSpec, cora_like as ref_cora,
                         synthesize as ref_synthesize)
from repro_torch.core import (build_blockell, identity_order, minhash_reorder,
                              traffic_model)
from repro_torch.graph import DatasetSpec, cora_like, synthesize

from _torch_parity import GRAPHS, assert_bytes_equal, to_port

GRAPH_FIELDS = ("src", "dst", "edge_mask", "edge_weight", "node_feat",
                "labels", "train_mask")


def _assert_graphs_equal(ref, port):
    assert ref.num_nodes == port.num_nodes
    for f in GRAPH_FIELDS:
        assert_bytes_equal(getattr(ref, f), getattr(port, f), f)


@pytest.fixture(scope="module")
def coras():
    return ref_cora(seed=0), cora_like(seed=0)


def test_cora_like_byte_equal(coras):
    ref, port = coras
    _assert_graphs_equal(ref, port)
    assert port.num_nodes == 2708 and port.num_edges == 10556
    assert port.node_feat.shape == (2708, 1433)


@pytest.mark.parametrize("spec", [
    dict(name="t", num_nodes=400, num_edges=2500, feat_dim=16,
         num_classes=4, community=0.9, num_communities=6, seed=4),
    dict(name="t", num_nodes=512, num_edges=6000, feat_dim=8,
         num_classes=3, community=0.0, seed=7),
    dict(name="t", num_nodes=64, num_edges=300, feat_dim=5,
         num_classes=2, seed=11),
])
def test_synthesize_byte_equal(spec):
    _assert_graphs_equal(ref_synthesize(RefSpec(**spec)),
                         synthesize(DatasetSpec(**spec)))


@pytest.mark.parametrize("num_hashes,seed", [(8, 0), (4, 3)])
def test_minhash_reorder_byte_equal(coras, num_hashes, seed):
    ref, port = coras
    assert_bytes_equal(ref_minhash(ref, num_hashes=num_hashes, seed=seed),
                       minhash_reorder(port, num_hashes=num_hashes,
                                       seed=seed), "perm")


def test_minhash_reorder_on_masked_graph():
    g = GRAPHS["random"]
    g = dataclasses.replace(g, edge_mask=np.arange(g.num_edges) % 3 != 0)
    assert_bytes_equal(ref_minhash(g), minhash_reorder(to_port(g)), "perm")


def test_identity_order(coras):
    _, port = coras
    assert_bytes_equal(identity_order(port), np.arange(2708, dtype=np.int64))


def _graph(name, coras):
    if name == "cora":
        return coras
    g = GRAPHS[name]
    return g, to_port(g)


@pytest.mark.parametrize("gname,bm", [("cora", 128), ("cora", 32),
                                      ("random", 32), ("skewed", 64),
                                      ("skewed", 16), ("empty_rows", 32)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_compaction_byte_equal(coras, gname, bm, dtype):
    ref_g, port_g = _graph(gname, coras)
    ref_ell = ref_build_blockell(ref_g, bm=bm, bk=bm, storage="auto")
    ell = build_blockell(port_g, bm=bm, bk=bm, storage="auto")
    assert_bytes_equal(ref_ell.block_cols, ell.block_cols, "block_cols")
    assert_bytes_equal(ref_ell.packed, ell.packed, "packed")
    assert_bytes_equal(ref_ell.blocks, ell.blocks, "blocks")
    ref_c, c = ref_ell.compact(dtype), ell.compact(dtype)
    for f in ("rows", "cols", "blocks", "row_active", "row_offsets"):
        assert_bytes_equal(getattr(ref_c, f), getattr(c, f), f)
    # the offsets the kernel walks agree with the row-major slot list
    assert c.row_offsets[-1] == c.n_active
    np.testing.assert_array_equal(
        np.repeat(np.arange(ell.n_row_blocks), np.diff(c.row_offsets)),
        c.rows)


def test_cora_serving_plan_geometry(coras):
    """The plan the serving session builds: R = C = 22, 481 active tiles."""
    _, port = coras
    ell = build_blockell(port, bm=128, bk=128, storage="auto")
    assert ell.implicit and ell.n_row_blocks == 22
    assert ell.n_active == 481


@pytest.mark.parametrize("storage", ["dense", "auto"])
def test_weighted_tiles_and_traffic_model_equal(storage):
    rng = np.random.default_rng(5)
    g = dataclasses.replace(GRAPHS["random"],
                            edge_weight=rng.random(2000).astype(np.float32))
    ref_ell = ref_build_blockell(g, bm=32, bk=32, storage=storage)
    ell = build_blockell(to_port(g), bm=32, bk=32, storage=storage)
    assert_bytes_equal(ref_ell.blocks, ell.blocks, "blocks")
    assert ref_traffic_model(ref_ell, 64) == traffic_model(ell, 64)
