"""The port's mesh path over gloo ranks on the CPU (``repro_torch/dist/
{halo,resilient,gnn,attention,compress}.py``, ``launch/mesh.py``,
``train.fault.elastic_mesh``, ``launch.train --dist``) against the
reference.

Ranks are spawned (``torch.multiprocessing``, spawn) by module fixtures,
one group per configuration, each rank joining a ``FileStore`` under the
fixture's temporary directory with one torch thread and timeouts on the
group's init and on the join; the rank bodies are in
``tests/_torch_dist_ranks.py`` (no jax there).  The reference runs as its
own tests run it: single-device oracles in this process, and its 4-device
train step under ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` in
a subprocess that writes an ``.npz``.

Held: ``halo`` / ``allgather`` / ``resilient`` aggregates and their
gradients at 4 and 8 ranks within 1e-5 of the reference's
``segment_aggregate`` (of the largest |entry|: fp32 sums in another
order); every drill takes the same path on every rank; the 4-rank train
step's first loss and gradients within 1e-5 of the reference's 4-device
step (gradients of each leaf's largest entry), 10 losses within 1e-4 (the
three aggregators within 1e-5 of each other); the (2, 2)-mesh decode within
1e-4 of ``decode_attention_ref`` (the reference's bar); the int8 all-reduce
within 1e-6 of the reference's arithmetic; ``--dist --device cpu --parts
4``'s ``dist[...]`` line equal to the reference's.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import minhash_reorder as ref_minhash_reorder
from repro.core import segment_aggregate as ref_segment_aggregate
from repro.dist import build_send_plan as ref_build_send_plan
from repro.dist import collective_bytes_estimate as ref_estimate
from repro.dist import compress as ref_compress
from repro.dist.gnn import dist_gnn_init as ref_dist_gnn_init
from repro.dist.gnn import pad_graph_nodes as ref_pad_graph_nodes
from repro.graph import DatasetSpec as RefSpec
from repro.graph import build_halo_plan as ref_build_halo_plan
from repro.graph import cora_like as ref_cora_like
from repro.graph import synthesize as ref_synthesize
from repro.kernels.ref import decode_attention_ref as ref_decode_attention
from repro_torch.dist import train_distributed
from repro_torch.launch.mesh import make_halo_debug_mesh

import _torch_dist_ranks as ranks

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
LOSS_TOL = 1e-4
AGGREGATORS = ("halo", "allgather", "resilient")
# inside the child, before jax initialises (as tests/test_dist_integration.py)
REF_TRAIN = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.graph import Graph, build_halo_plan
from repro.dist import build_send_plan, make_dist_train_step
from repro.dist.gnn import dist_gnn_loss
from repro.train.optimizer import adam
tmp = sys.argv[1]
inp = np.load(os.path.join(tmp, "inputs.npz"))
g = Graph(src=inp["src"], dst=inp["dst"], num_nodes=int(inp["num_nodes"]))
plan = build_halo_plan(g, 4)
send = build_send_plan(plan)
n = g.num_nodes // 4
mesh = jax.make_mesh((4,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
batch = {"x": jnp.asarray(inp["feat"]),
         "labels": jnp.asarray(inp["labels"].astype(np.int32)),
         "train_mask": jnp.asarray(inp["train_mask"]),
         "deg": jnp.asarray(inp["deg"])}
names = ("w_self", "w_neigh", "b")
params = [{k: jnp.asarray(inp[f"{k}_{i}"]) for k in names}
          for i in range(int(inp["n_layers"]))]
out = {}
with mesh:
    loss, grads = jax.value_and_grad(
        lambda p: dist_gnn_loss(mesh, p, batch, plan, send, n))(params)
    out["loss0"] = np.asarray(loss)
    for i, lp in enumerate(grads):
        for k in names:
            out[f"grad_{k}_{i}"] = np.asarray(lp[k])
    opt = adam(1e-2)
    step = make_dist_train_step(mesh, plan, send, n, opt)
    p = jax.tree_util.tree_map(jnp.array, params)
    s = opt.init(p)
    losses = []
    for _ in range(10):
        p, s, l = step(p, s, batch)
        losses.append(float(l))
out["losses"] = np.asarray(losses)
np.savez(os.path.join(tmp, "ref.npz"), **out)
print("REF_OK")
"""
_SUBPROC_ENV = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", ""),
                "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", ""),
                "TMPDIR": os.environ.get("TMPDIR", "/tmp")}


def _close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3g}"


def _graph():
    g = ref_synthesize(RefSpec("t", 1024, 16000, 16, 4, community=0.9,
                               num_communities=8, seed=5))
    return g.permute(ref_minhash_reorder(g))


@pytest.fixture(scope="module")
def graph():
    return _graph()


def _results(tmp, world):
    arrays = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
              for r in range(world)]
    infos = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
             for r in range(world)]
    return arrays, infos


def _oracle(g, x, r):
    """The reference's single-device aggregate and ``r``'s pull-back."""
    y, vjp = jax.vjp(lambda a: ref_segment_aggregate(
        a, jnp.asarray(g.src), jnp.asarray(g.dst), g.num_nodes),
        jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(r))[0])


@pytest.fixture(scope="module", params=[4, 8], ids=["4ranks", "8ranks"])
def aggregates(request, graph, tmp_path_factory):
    world = request.param
    tmp = str(tmp_path_factory.mktemp(f"agg{world}"))
    rng = np.random.default_rng(world)
    x = rng.standard_normal((graph.num_nodes, 32)).astype(np.float32)
    r = rng.standard_normal((graph.num_nodes, 32)).astype(np.float32)
    np.savez(os.path.join(tmp, "inputs.npz"), src=graph.src, dst=graph.dst,
             num_nodes=graph.num_nodes, x=x, r=r)
    ranks.spawn(ranks.aggregate_suite, world, tmp)
    arrays, infos = _results(tmp, world)
    y, gx = _oracle(graph, x, r)
    return world, arrays, infos, y, gx


def _gathered(arrays, key):
    return np.concatenate([a[key] for a in arrays], axis=0)


@pytest.mark.parametrize("name", AGGREGATORS)
def test_aggregate_matches_segment_aggregate(aggregates, name):
    world, arrays, _, y, _ = aggregates
    _close(_gathered(arrays, name), y, what=f"{name} at {world} ranks")


@pytest.mark.parametrize("name", AGGREGATORS)
def test_aggregate_gradient_matches_the_reference(aggregates, name):
    """The backward through the exchange (the reverse all_to_all, or the
    all-gather's all-reduced window) against ``jax.vjp`` of the oracle."""
    world, arrays, _, _, gx = aggregates
    _close(_gathered(arrays, name + "_grad"), gx,
           what=f"{name} gradient at {world} ranks")


@pytest.mark.parametrize("drill,counters,fired", [
    ("transient", {"dist.halo_retry{kind=shard_loss}": 1}, 1),
    ("persistent", {"dist.halo_retry{kind=shard_loss}": 2,
                    "dist.halo_fallback{reason=shard_loss}": 1}, 3),
    ("budget", {"dist.halo_fallback{reason=straggler}": 1}, 1),
    ("exchange_error", {"dist.halo_fallback{reason=exchange_error}": 1},
     None)])
def test_drill_takes_the_same_path_on_every_rank(aggregates, drill, counters,
                                                 fired):
    world, arrays, infos, y, _ = aggregates
    for info in infos:
        assert info[drill]["counters"] == counters
        if fired is not None:
            assert info[drill]["fired"] == fired
    clocks = {info[drill].get("clock") for info in infos}
    assert len(clocks) == 1
    if drill == "transient":
        assert clocks.pop() > 0.0
    _close(_gathered(arrays, "drill_" + drill), y, what=drill)


# ------------------------------------------------------------ train step
@pytest.fixture(scope="module")
def trained(graph, tmp_path_factory):
    """4 gloo ranks and, at the same time, the reference's 4-device step in
    a subprocess, on the same inputs and the reference's weights."""
    tmp = str(tmp_path_factory.mktemp("train"))
    n_classes = int(graph.labels.max()) + 1
    dims = [graph.node_feat.shape[1], 16, n_classes]
    params = ref_dist_gnn_init(jax.random.PRNGKey(0), dims)
    rng = np.random.default_rng(1)
    B, S, H, d = 4, 256, 8, 64
    inputs = dict(
        src=graph.src, dst=graph.dst, num_nodes=graph.num_nodes,
        feat=graph.node_feat, labels=graph.labels,
        train_mask=graph.train_mask,
        deg=graph.in_degrees().astype(np.float32), n_layers=len(params),
        q=rng.standard_normal((B, H, d)).astype(np.float32),
        k=rng.standard_normal((B, S, H, d)).astype(np.float32),
        v=rng.standard_normal((B, S, H, d)).astype(np.float32),
        cache_lens=np.array([100, 256, 64, 200]),
        gvec=rng.standard_normal((64, 32)).astype(np.float32))
    for i, lp in enumerate(params):
        for k, a in lp.items():
            inputs[f"{k}_{i}"] = np.asarray(a)
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    ref = subprocess.Popen([sys.executable, "-c", REF_TRAIN, tmp], cwd=ROOT,
                           env=_SUBPROC_ENV, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        ranks.spawn(ranks.train_suite, 4, tmp)
        log, _ = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert "REF_OK" in log, log
    arrays, infos = _results(tmp, 4)
    return inputs, params, arrays, infos, dict(np.load(os.path.join(
        tmp, "ref.npz")))


def test_first_step_loss_and_gradients_match_the_reference(trained):
    _, params, arrays, _, ref = trained
    for a in arrays:
        _close(a["loss0"], ref["loss0"], what="loss")
        i = 0
        for layer, lp in enumerate(params):
            for k in ("w_self", "w_neigh", "b"):
                _close(a[f"grad_{i}"], ref[f"grad_{k}_{layer}"],
                       what=f"grad {k} {layer}")
                i += 1


def test_ten_steps_match_the_reference(trained):
    _, _, arrays, _, ref = trained
    for a in arrays:
        np.testing.assert_allclose(a["losses_halo"], ref["losses"], rtol=0,
                                   atol=LOSS_TOL)
        assert a["losses_halo"][-1] < a["losses_halo"][0]


def test_parameters_stay_replicated_and_aggregators_agree(trained):
    _, _, arrays, _, _ = trained
    for agg in AGGREGATORS:
        for a in arrays[1:]:
            assert np.array_equal(a[f"final_{agg}"], arrays[0][f"final_{agg}"])
            assert np.array_equal(a[f"losses_{agg}"],
                                  arrays[0][f"losses_{agg}"])
        _close(arrays[0][f"losses_{agg}"], arrays[0]["losses_halo"],
               what=f"{agg} losses")


def test_elastic_mesh_halves_the_data_axis(trained):
    _, _, _, infos, _ = trained
    for info in infos:
        em = info["elastic_mesh"]
        assert em["(8, 1)"] == [4, 1]
        assert em["(16, 2)"] == [2, 2]
        assert em["(1, 4)"] == [1, 4]
        assert em["(1, 8)"] == "not enough devices: need 8, have 4"


def test_decode_attention_on_a_2x2_mesh(trained):
    inputs, _, arrays, infos, _ = trained
    ref = np.asarray(ref_decode_attention(
        jnp.asarray(inputs["q"]), jnp.asarray(inputs["k"]),
        jnp.asarray(inputs["v"]), jnp.asarray(inputs["cache_lens"])))
    for a, info in zip(arrays, infos):
        lo, hi = info["decode_rows"]
        np.testing.assert_allclose(a["decode"], ref[lo:hi], atol=1e-4)


def test_int8_allreduce_matches_the_reference_arithmetic(trained):
    inputs, _, arrays, _, _ = trained
    want = sum(np.asarray(ref_compress.dequantize_int8(
        *ref_compress.quantize_int8(jnp.asarray(inputs["gvec"] * (r + 1)))))
        for r in range(4))
    for a in arrays:
        _close(a["int8_psum"], want, tol=1e-6, what="int8 all-reduce")
        # each rank's codes are off by at most half a step, absmax_r / 254
        bound = 10 * np.abs(inputs["gvec"]).max(-1, keepdims=True) / 254
        assert (np.abs(a["int8_psum"] - 10 * inputs["gvec"])
                <= bound + 1e-6).all()


# --------------------------------------------------------------- launcher
def test_launcher_dist_cpu_prints_the_reference_line(tmp_path):
    """Also rank 0's telemetry files and the buddy-mirrored checkpoint."""
    from repro_torch.obs import validate
    m, t, ckpt = (str(tmp_path / f) for f in ("m.jsonl", "t.json", "ckpt"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gcn-cora", "--dist", "--parts", "4", "--device", "cpu",
         "--steps", "10", "--metrics-out", m, "--trace", t, "--ckpt", ckpt],
        cwd=ROOT, env=_SUBPROC_ENV, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    g = ref_cora_like()
    g = ref_pad_graph_nodes(g.permute(ref_minhash_reorder(g)), 4)
    plan = ref_build_halo_plan(g, 4)
    est = ref_estimate(plan, ref_build_send_plan(plan), d=g.node_feat.shape[1])
    want = (f"dist[gcn-cora] parts=4 cut={est['cut_edge_fraction']:.3f} "
            f"halo={est['halo_bytes_per_chip_real'] / 1e3:.1f}kB/chip "
            f"vs allgather={est['allgather_bytes_per_chip'] / 1e3:.1f}"
            "kB/chip")
    lines = r.stdout.splitlines()
    assert lines[0] == want
    assert "dist backend=gloo ranks=4 device=cpu" in lines
    m_ = re.search(r"gcn-cora \[dist\]: 10 steps, loss ([\d.]+) -> ([\d.]+)",
                   r.stdout)
    assert m_ and float(m_.group(2)) < float(m_.group(1))
    assert validate.validate_metrics_file(m) == []
    assert validate.validate_trace_file(t) == []
    records = [json.loads(line) for line in open(m)]
    names = {rec.get("name") for rec in records}
    assert {"dist.parts", "dist.steps", "dist.step_seconds"} <= names
    spans = [e for e in json.load(open(t))["traceEvents"]
             if e.get("name") == "dist.step"]
    assert len(spans) == 10
    assert os.path.isfile(os.path.join(ckpt, "step_00000010.json"))
    for shard in range(4):
        assert os.path.isfile(os.path.join(ckpt, f"shard_{shard:02d}",
                                           "step_00000010.npz"))


def test_launcher_refuses_non_gnn_and_unported_archs():
    from repro_torch.launch import train
    with pytest.raises(SystemExit) as err:
        train.main(["--arch", "wide-deep", "--dist", "--device", "cpu"])
    assert err.value.code == 2
    with pytest.raises(ValueError, match="gat-cora"):
        train_distributed("gat-cora", device="cpu")


def test_mesh_needs_the_ranks_it_spans():
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_halo_debug_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_halo_debug_mesh(1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 2 devices, have 0"):
            make_halo_debug_mesh(2, device="cuda")
