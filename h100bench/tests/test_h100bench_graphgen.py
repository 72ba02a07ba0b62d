"""The benchmark's generator: one graph for every seed; one seed gives
one set of features, two seeds two."""
import numpy as np
import torch

from ._small import small_config
from h100bench.harness import graphgen

GRAPH = small_config("sage-citeseer-s.full")["graph"]


def _same(a, b):
    return all(np.array_equal(a[k], b[k])
               for k in ("src", "dst", "labels", "train_mask"))


def test_same_seed_same_inputs():
    seed = 2 ** 31 + 77
    a, b = graphgen.synthesize(GRAPH), graphgen.synthesize(GRAPH)
    assert _same(a, b)
    labels = torch.as_tensor(a["labels"])
    xa = graphgen.make_features(GRAPH, labels, seed, torch.device("cpu"))
    xb = graphgen.make_features(GRAPH, labels, seed, torch.device("cpu"))
    assert torch.equal(xa, xb)


def test_two_seeds_two_feature_sets_on_one_graph():
    g = graphgen.synthesize(GRAPH)
    labels = torch.as_tensor(g["labels"])
    xa = graphgen.make_features(GRAPH, labels, 5, torch.device("cpu"))
    xb = graphgen.make_features(GRAPH, labels, 6, torch.device("cpu"))
    assert not torch.equal(xa, xb)
    # another size is another graph
    other = dict(GRAPH, num_edges=GRAPH["num_edges"] - 100)
    assert graphgen.synthesize(other)["src"].shape[0] == other["num_edges"]


def test_shape_of_the_graph():
    g = graphgen.synthesize(GRAPH)
    n, m = GRAPH["num_nodes"], GRAPH["num_edges"]
    assert g["src"].shape == (m,) and g["dst"].shape == (m,)
    assert (g["src"] != g["dst"]).all()
    assert len(np.unique(g["src"].astype(np.int64) * n + g["dst"])) == m
    assert 0.6 < g["train_mask"].mean() < 0.8
    assert g["labels"].max() < GRAPH["num_classes"]
    # most edges stay inside a community, and labels follow communities
    same = (g["labels"][g["src"]] == g["labels"][g["dst"]]).mean()
    assert same > 0.7
    # ids are shuffled: a node's neighbours are not its id's neighbours
    assert np.median(np.abs(g["src"].astype(np.int64) - g["dst"])) > n / 10


def test_streams_apart():
    assert graphgen.stream_seed(1, 1) != graphgen.stream_seed(1, 2)
    assert graphgen.stream_seed(1, 1) != graphgen.stream_seed(2, 1)
    assert 0 <= graphgen.stream_seed(2 ** 40, 1) < 2 ** 63
    assert 0 <= graphgen.stream_seed(-12345, 1) < 2 ** 63   # any whole number
