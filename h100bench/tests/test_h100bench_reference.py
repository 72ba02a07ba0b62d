"""The plain reference against the port's ``torch`` backend (its plain
block products) on a small CITESEER-S-shaped graph, in index order."""
import pytest
import torch

from ._small import small_config
from h100bench.drivers.gnn_full import make_params
from h100bench.harness import graphgen
from h100bench.reference import gnn_full as reference


def _setup(workload, seed=21):
    cfg = small_config(workload)
    topo = graphgen.synthesize(cfg["graph"])
    dev = torch.device("cpu")
    labels = torch.as_tensor(topo["labels"])
    mask = torch.as_tensor(topo["train_mask"])
    x = graphgen.make_features(cfg["graph"], labels, seed, dev)
    return cfg, topo, x, labels, mask


def _port_loss_and_grads(cfg, topo, x, labels, mask, params):
    from repro_torch.exec import build_layer_plan
    from repro_torch.graph.structure import Graph
    from repro_torch.models import gcn_loss, sage_loss

    g = Graph(src=topo["src"], dst=topo["dst"], num_nodes=topo["num_nodes"])
    mode = "gcn" if cfg["model"] == "gcn" else "mean"
    dims = cfg["dims"]
    plans = [build_layer_plan(g, mode, d_in=a, d_out=b, backend="torch",
                              bm=32, device="cpu")
             for a, b in zip(dims[:-1], dims[1:])]
    leaves = [t.clone().requires_grad_(True) for p in params["layers"]
              for t in (p["w"], p["b"])]
    tree = {"layers": [{"w": leaves[i], "b": leaves[i + 1]}
                       for i in range(0, len(leaves), 2)]}
    if cfg["model"] == "gcn":
        loss = gcn_loss(tree, x, None, labels, mask, executor="fused",
                        plans=plans)
    else:
        loss = sage_loss(tree, x, None, labels, mask, executor="fused",
                         plan=plans)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("workload", ["sage-citeseer-s.full",
                                      "gcn-citeseer-s.full"])
def test_reference_matches_the_port(workload):
    cfg, topo, x, labels, mask = _setup(workload)
    params = make_params(cfg, 21, torch.device("cpu"))
    loss, grads = _port_loss_and_grads(cfg, topo, x, labels, mask, params)

    graph = reference.Graph(topo["src"], topo["dst"], topo["num_nodes"],
                            torch.device("cpu"))
    prod = reference._Products("fp32", torch.device("cpu"))
    x_agg = graph.mean(x) if cfg["model"] == "sage" else None
    leaves = [t.clone().requires_grad_(True) for p in params["layers"]
              for t in (p["w"], p["b"])]
    layers = [{"w": leaves[i], "b": leaves[i + 1]}
              for i in range(0, len(leaves), 2)]
    ref_loss = reference.forward_loss(cfg["model"], layers, graph, x_agg, x,
                                      labels, mask, prod)
    ref_grads = torch.autograd.grad(ref_loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                 rel=1e-5)
    for g, r in zip(grads, ref_grads):
        assert torch.allclose(g, r, rtol=0, atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("workload", ["sage-citeseer-s.full",
                                      "gcn-citeseer-s.full"])
def test_reference_training_steps(workload):
    """The reference's own three steps: losses fall, the first gradient is
    clipped to the configured norm, and the change matches Adam's first
    step (lr times the sign) in its first step."""
    cfg, topo, x, labels, mask = _setup(workload)
    params = make_params(cfg, 21, torch.device("cpu"))["layers"]
    graph = reference.Graph(topo["src"], topo["dst"], topo["num_nodes"],
                            torch.device("cpu"))
    out1 = reference.train(cfg["model"], params, graph, x, labels, mask, 1,
                           cfg["train"])
    norm = torch.sqrt(sum(torch.sum(g * g) for g in out1["grad"]))
    assert float(norm) <= cfg["train"]["clip_norm"] * (1 + 1e-5)
    lr = cfg["train"]["lr"]
    for d, g in zip(out1["change"], out1["grad"]):
        big = g.abs() > 1e-4          # eps (1e-8) negligible
        assert torch.allclose(d[big], -lr * torch.sign(g[big]), rtol=1e-3)
    out3 = reference.train(cfg["model"], params, graph, x, labels, mask, 3,
                           cfg["train"])
    assert out3["losses"][0] == out1["losses"][0]
    assert out3["losses"][2] < out3["losses"][0]


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11,
                      -1.0 - 3 * 2 ** -11])
    r = reference._tf32_round(t)
    assert r.tolist() == [1.0, 1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                          -1.0 - 2 ** -9]
