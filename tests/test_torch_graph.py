"""The port's host-side graph compilers produce byte-equal arrays to the
reference: the Cora-shaped generator and the paper's Table I stand-ins
(``spec_for_paper``, ``citeseer_s_like``, ``reddit_like``), MinHash
reordering, block-ELL tiling and its slot compaction (rows / cols / blocks
/ row_active / row_offsets), the neighbor sampler's minibatches (every
field of ``MiniBatch`` and ``SampledBlock``, ``gnn_epoch_batches``,
``static_block_shapes``) and small-graph packing (``pack``)."""
import dataclasses

import numpy as np
import pytest

from repro.core import (build_blockell as ref_build_blockell,
                        minhash_reorder as ref_minhash,
                        traffic_model as ref_traffic_model)
from repro.graph import (DatasetSpec as RefSpec, Graph as RefGraph,
                         cora_like as ref_cora,
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


# ----------------------------------------------------- the paper's datasets
@pytest.mark.parametrize("name", ["COLLAB", "BZR", "IMDB-BINARY", "DD",
                                  "CITESEER-S", "REDDIT"])
@pytest.mark.parametrize("scale", [1.0, 0.005])
def test_spec_for_paper_equal(name, scale):
    import dataclasses as dc
    from repro.graph import PAPER_TABLE_I as REF_TABLE
    from repro.graph import spec_for_paper as ref_spec_for_paper
    from repro_torch.graph import PAPER_TABLE_I, spec_for_paper

    assert PAPER_TABLE_I[name] == REF_TABLE[name]
    assert dc.asdict(spec_for_paper(name, scale, seed=3)) == \
        dc.asdict(ref_spec_for_paper(name, scale, seed=3))


@pytest.mark.parametrize("which,scale,seed", [("citeseer_s_like", 0.005, 0),
                                              ("citeseer_s_like", 0.01, 2),
                                              ("reddit_like", 0.002, 0),
                                              ("reddit_like", 0.005, 1)])
def test_paper_stand_ins_byte_equal(which, scale, seed):
    import repro.graph as ref_graph
    import repro_torch.graph as port_graph
    ref = getattr(ref_graph, which)(scale=scale, seed=seed)
    port = getattr(port_graph, which)(scale=scale, seed=seed)
    _assert_graphs_equal(ref, port)


# ----------------------------------------------------------- the sampler
@pytest.fixture(scope="module")
def sampled_graph():
    """A graph with isolated nodes (they sample themselves)."""
    g = ref_synthesize(RefSpec("s", 500, 2400, 6, 3, num_communities=5,
                               seed=9))
    keep = g.dst < 480                   # nodes 480.. get no in-edge
    g = dataclasses.replace(g, src=g.src[keep], dst=g.dst[keep])
    return g, to_port(g)


def _assert_minibatches_equal(ref, port):
    for f in ("seeds", "input_nodes"):
        assert_bytes_equal(getattr(ref, f), getattr(port, f), f)
    assert ref.layer_sizes == port.layer_sizes
    assert len(ref.blocks) == len(port.blocks)
    for i, (rb, pb) in enumerate(zip(ref.blocks, port.blocks)):
        assert rb.fanout == pb.fanout and rb.num_dst == pb.num_dst
        assert_bytes_equal(rb.dst_nodes, pb.dst_nodes, f"block {i} dst")
        assert_bytes_equal(rb.src_nodes, pb.src_nodes, f"block {i} src")
        assert_bytes_equal(ref.edge_src[i], port.edge_src[i], f"edge_src {i}")
        assert_bytes_equal(ref.edge_dst[i], port.edge_dst[i], f"edge_dst {i}")


@pytest.mark.parametrize("fanouts,seed", [((15, 10), 0), ((5,), 3),
                                          ((4, 3, 2), 7), ((25, 10), 11)])
def test_sampler_batches_byte_equal(sampled_graph, fanouts, seed):
    from repro.graph import NeighborSampler as RefSampler
    from repro_torch.graph import NeighborSampler

    ref_g, g = sampled_graph
    ref = RefSampler(ref_g, fanouts, seed=seed)
    port = NeighborSampler(g, fanouts, seed=seed)
    for batch_nodes in (64, 700):        # 700 > 500 nodes: with replacement
        for rmb, pmb in zip(ref.batches(batch_nodes, 3),
                            port.batches(batch_nodes, 3)):
            _assert_minibatches_equal(rmb, pmb)
    # the generators stayed in step: direct samples (isolated seeds too)
    seeds = np.array([3, 481, 17, 499, 3], np.int32)
    _assert_minibatches_equal(ref.sample(seeds), port.sample(seeds))
    assert_bytes_equal(ref.expand(seeds)[0], port.expand(seeds)[0], "expand")


def test_gnn_epoch_batches_byte_equal(sampled_graph):
    from repro.graph import NeighborSampler as RefSampler
    from repro.train.data import gnn_epoch_batches as ref_epoch
    from repro_torch.graph import NeighborSampler
    from repro_torch.train import gnn_epoch_batches

    ref_g, g = sampled_graph
    got = list(gnn_epoch_batches(NeighborSampler(g, (6, 4), seed=5), 32, 4))
    want = list(ref_epoch(RefSampler(ref_g, (6, 4), seed=5), 32, 4))
    assert len(got) == len(want) == 4
    for rmb, pmb in zip(want, got):
        _assert_minibatches_equal(rmb, pmb)


@pytest.mark.parametrize("batch_nodes,fanouts,feat_dim",
                         [(512, (15, 10), 602), (8, (3,), 5),
                          (100, (4, 3, 2), 3703)])
def test_static_block_shapes_equal(batch_nodes, fanouts, feat_dim):
    from repro.graph import static_block_shapes as ref_shapes
    from repro_torch.graph import static_block_shapes
    assert static_block_shapes(batch_nodes, fanouts, feat_dim) == \
        ref_shapes(batch_nodes, fanouts, feat_dim)


# ------------------------------------------------------ small-graph packing
def _small_graphs(feats=True):
    rng = np.random.default_rng(4)
    out = []
    for i in range(5):
        n, e = int(rng.integers(3, 12)), int(rng.integers(2, 30))
        out.append(RefGraph(
            src=rng.integers(0, n, e).astype(np.int32),
            dst=rng.integers(0, n, e).astype(np.int32), num_nodes=n,
            edge_mask=(rng.random(e) < 0.8) if i % 2 else None,
            node_feat=(rng.standard_normal((n, 6)).astype(np.float32)
                       if feats else None)))
    return out


@pytest.mark.parametrize("feats,caps", [(True, (None, None)),
                                        (True, (16, 40)),
                                        (False, (None, None))])
def test_pack_byte_equal(feats, caps):
    from repro.graph import pack as ref_pack
    from repro.graph.batching import readout_segments as ref_readout
    from repro_torch.graph import pack, readout_segments

    graphs = _small_graphs(feats)
    rb, rfeat = ref_pack(graphs, *caps)
    pb, pfeat = pack([to_port(g) for g in graphs], *caps)
    for f in ("src", "dst", "edge_mask", "node_mask", "graph_ids"):
        assert_bytes_equal(getattr(rb, f), getattr(pb, f), f)
    assert (rb.num_graphs, rb.nodes_per_graph, rb.edges_per_graph,
            rb.num_nodes) == (pb.num_graphs, pb.nodes_per_graph,
                              pb.edges_per_graph, pb.num_nodes)
    assert_bytes_equal(rfeat, pfeat, "feat")
    assert_bytes_equal(ref_readout(rb), readout_segments(pb), "readout")


def test_pack_refuses_an_overfull_graph():
    from repro_torch.graph import pack
    with pytest.raises(ValueError, match="capacity"):
        pack([to_port(g) for g in _small_graphs()], nodes_per_graph=2)
