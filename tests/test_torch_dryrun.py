"""``repro_torch.launch.dryrun`` against the reference's dry-run.

The port's cells run in this process as rank 0 of a fake process group
(``launch.dryrun.fake_world``); the reference's in subprocesses on forced
host devices, as its own module does.  Held: ``lower_cell`` on the
reference's own slow test cells (gcn-cora ``molecule``, wide & deep
``serve_p99``) on a (4, 4) mesh gives the reference's
``argument_gb_per_device`` (exactly: these cells' steps read every
argument); granite-8b on (16, 16) raises ``ValueError`` at its ZeRO entry
in both packages; one full-width LM cell (minitron-8b ``decode_32k`` on
(16, 16)) traces, with the reference's result keys and argument bytes; both
CLIs' JSON (an OK cell and a failed one) have the same keys, and the port's
exits 1 on a failed cell as the reference's does; importing the module
starts no process group.  Every family traces its mesh step: the (4, 4)
cells count collectives (wide & deep ``serve_p99``'s within 5% of the
reference's ``collective_bytes`` from the same child), and so do the 20
single-pod GNN and wide & deep cells of ``roofline_run`` against the
reference's own ``roofline_run`` (wide & deep within 5%, the GNNs within
0.25-4x).  granite-moe ``long_500k`` (B = 1: the MoE layers' branch that
is not shard-local) runs its experts model-parallel: on (16, 16) each
rank's F-slices, its FLOPs below every expert whole, its collective bytes
within 0.998-1.116x of the reference's less two all-gathers of a whole
cache layer; on (32, 8) each rank's 5 whole experts, within 0.99-1.116x
of the reference's collectives.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.configs import get
from repro_torch.dist.sharding import as_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

ROOT = Path(__file__).resolve().parents[1]

REFERENCE = r"""
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import jax
jax.devices()                      # the backend, before dryrun's own flag
import numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import get
from repro.launch.dryrun import lower_cell
from repro.launch.mesh import make_production_mesh
from repro.roofline.hlo import collective_bytes, parse_collectives

small = Mesh(np.asarray(jax.devices()[:16]).reshape(4, 4),
             ("data", "model"), axis_types=(AxisType.Auto,) * 2)
big = make_production_mesh()
ep = Mesh(np.asarray(jax.devices()).reshape(32, 8), ("data", "model"),
          axis_types=(AxisType.Auto,) * 2)
out = {}
for arch, shape, mesh, name in [("gcn-cora", "molecule", small, "4x4"),
                                ("wide-deep", "serve_p99", small, "4x4"),
                                ("minitron-8b", "decode_32k", big, "16x16"),
                                ("granite-8b", "train_4k", big, "16x16"),
                                ("granite-moe-3b-a800m", "long_500k", big,
                                 "16x16"),
                                ("granite-moe-3b-a800m", "long_500k", ep,
                                 "32x8")]:
    spec = get(arch)
    try:
        res, _, compiled = lower_cell(spec.bundle(), spec, shape, mesh)
        out[f"{arch}/{shape}/{name}"] = res
        text = compiled.as_text()
        out[f"{arch}/{shape}/{name}/collective_bytes"] = collective_bytes(
            text)["total"]
        # all-gathers of a whole cache layer (524,288 positions)
        out[f"{arch}/{shape}/{name}/cache_gathers"] = sum(
            op.bytes for op in parse_collectives(text)
            if op.kind == "all-gather" and re.search(
                r"\[[\d,]*\b524288\b", op.line.split(" all-gather")[0]))
    except Exception as e:
        out[f"{arch}/{shape}/{name}"] = {"error": type(e).__name__}
print(json.dumps(out))
"""

MESH_ARCHS = ("gcn-cora", "gat-cora", "pna", "nequip", "wide-deep")
LM_FAILING = {"granite-8b", "mistral-large-123b", "llama4-maverick-400b-a17b"}
CLI_ARGS = ["--arch", "gcn-cora", "--arch", "granite-8b", "--shape",
            "molecule", "--shape", "decode_32k", "--single-pod-only"]


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The reference's cells and both CLIs, started together; each entry
    waits for its process when first read."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, "-c", REFERENCE], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE),
        "ref_cli": subprocess.Popen(
            [sys.executable, "-m", "repro.launch.dryrun", *CLI_ARGS,
             "--json", str(tmp / "ref.json")], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE),
        "ref_roofline": subprocess.Popen(
            [sys.executable, "-m", "repro.launch.roofline_run",
             *(a for arch in MESH_ARCHS for a in ("--arch", arch)),
             "--json", str(tmp / "ref_roofline.json")], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE),
        "port_cli": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *CLI_ARGS,
             "--json", str(tmp / "port.json")], env=env,
            text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE),
    }
    done = {}

    def read(name):
        if name not in done:
            out, err = procs[name].communicate(timeout=300)
            done[name] = (procs[name].returncode, out, err)
        return done[name]
    yield read, tmp
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _reference(children):
    read, _ = children
    rc, out, err = read("reference")
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", [("gcn-cora", "molecule"),
                                        ("wide-deep", "serve_p99")])
def test_small_cells_argument_bytes_equal_the_reference(children, arch,
                                                        shape):
    spec = get(arch)
    with dryrun.fake_world(16):
        res, trace, counts = dryrun.lower_cell(
            spec.bundle(), spec, shape, make_debug_mesh((4, 4),
                                                        device="cpu"))
    assert not dist.is_initialized()
    want = _reference(children)[f"{arch}/{shape}/4x4"]
    assert res["mesh"] == want["mesh"] == "4x4"
    assert set(res) == set(want)
    assert set(res["memory"]) == set(want["memory"])
    assert set(res["cost"]) == set(want["cost"])
    got_arg = res["memory"]["argument_gb_per_device"]
    want_arg = want["memory"]["argument_gb_per_device"]
    assert abs(got_arg - want_arg) <= 0.01 * want_arg
    assert got_arg == pytest.approx(want_arg, rel=1e-12)
    mem = res["memory"]
    assert mem["peak_gb_per_device"] == pytest.approx(
        mem["argument_gb_per_device"] + max(
            mem["output_gb_per_device"]
            - counts["memory"]["alias_gb_per_device"], 0)
        + mem["temp_gb_per_device"], rel=1e-12)
    assert res["cost"]["flops_per_device"] > 0
    # the mesh path: the collectives GSPMD inserts in the reference's
    assert counts["collectives"]["total"] > 0
    if (arch, shape) == ("wide-deep", "serve_p99"):
        want_coll = _reference(children)[f"{arch}/{shape}/4x4/collective_bytes"]
        assert counts["collectives"]["total"] == pytest.approx(want_coll,
                                                               rel=0.05)


def test_production_mesh_cells(children):
    ref = _reference(children)
    assert ref["granite-8b/train_4k/16x16"] == {"error": "ValueError"}
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        spec = get("granite-8b")
        with pytest.raises(ValueError, match="partitioned 16 times"):
            dryrun.lower_cell(spec.bundle(), spec, "train_4k", mesh)
        spec = get("minitron-8b")
        res, trace, counts = dryrun.lower_cell(spec.bundle(), spec,
                                               "decode_32k", mesh)
    want = ref["minitron-8b/decode_32k/16x16"]
    assert set(res) == set(want) and res["mesh"] == "16x16"
    assert res["memory"]["argument_gb_per_device"] == pytest.approx(
        want["memory"]["argument_gb_per_device"], rel=1e-12)
    # the rank's decode step: caches written in place, the ZeRO layer
    # gathers broadcast from their owners, the heads' all-reduces
    assert counts["memory"]["alias_gb_per_device"] > 0
    assert counts["collectives"]["broadcast"] > 0
    assert counts["collectives"]["all-reduce"] > 0
    assert res["cost"]["flops_per_device"] > 0
    from repro_torch.train.optimizer import tree_leaves
    leaves = tree_leaves(trace["args"])
    assert trace["args"][1]["cache_len"] == 32767   # decode takes an int
    assert all(a.device.type == "meta" for a in leaves
               if not isinstance(a, int))


def test_cli_json_matches_the_reference(children):
    read, tmp = children
    ref_rc, _, ref_err = read("ref_cli")
    port_rc, port_out, port_err = read("port_cli")
    assert ref_rc == 1, ref_err[-3000:]
    assert port_rc == 1, port_err[-3000:]
    assert "1 cells OK, 1 failed" in port_out
    ref = json.loads((tmp / "ref.json").read_text())
    port = json.loads((tmp / "port.json").read_text())
    for doc in (ref, port):
        assert [(r["arch"], r["shape"]) for r in doc["results"]] == [
            ("gcn-cora", "molecule")]
        assert [(f["arch"], f["shape"]) for f in doc["failures"]] == [
            ("granite-8b", "decode_32k")]
    r, p = ref["results"][0], port["results"][0]
    assert set(p) == set(r)
    assert set(p["memory"]) == set(r["memory"])
    assert set(p["cost"]) == set(r["cost"])
    assert p["mesh_name"] == r["mesh_name"] == "1-pod(16x16)"
    assert set(port["failures"][0]) == set(ref["failures"][0])
    assert "ValueError" in port["failures"][0]["traceback"]
    assert p["memory"]["argument_gb_per_device"] == pytest.approx(
        r["memory"]["argument_gb_per_device"], rel=1e-12)


def test_import_starts_no_process_group():
    code = ("import sys, torch.distributed as dist; "
            "import repro_torch.launch.dryrun, repro_torch.launch."
            "roofline_run; print(dist.is_initialized(), 'torch.testing."
            "_internal.distributed.fake_pg' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], text=True,
                          capture_output=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "False"]
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="already initialised"):
            with dryrun.fake_world(4):
                pass
    assert not dist.is_initialized()


def test_graph_and_recsys_cells_count_the_reference_collectives(children):
    """The 20 single-pod GNN and wide & deep cells trace their mesh steps
    (``roofline_run``'s records): each counts collectives, wide & deep's
    within 5% of the reference's ``collective_bytes``, the GNNs' within
    0.25-4x; the single-pod pass / fail sets stay 28 / 12 (the failing
    cells raise at their ZeRO entry, when lowered)."""
    from repro_torch.configs.registry import ALL_ARCHS
    from repro_torch.launch import roofline_run
    jobs = [(a, shape) for a in MESH_ARCHS for shape in get(a).shapes]
    got = dict(zip(jobs, dryrun.map_cells(roofline_run._analyze, jobs,
                                          False)))
    read, tmp = children
    rc, _, err = read("ref_roofline")
    assert rc == 0, err[-3000:]
    ref = {(r["arch"], r["shape"]): r["coll_bytes_per_chip"]
           for r in json.loads((tmp / "ref_roofline.json").read_text())}
    assert len(jobs) == 20 and set(ref) == set(jobs)
    for job, (_, rec, error) in got.items():
        assert error is None, error
        coll, want = rec["coll_bytes_per_chip"], ref[job]
        assert coll > 0, job
        if job[0] == "wide-deep":
            assert coll == pytest.approx(want, rel=0.05), job
        else:
            assert 0.25 * want <= coll <= 4 * want, (job, coll, want)
    results, failures = dryrun.run(list(ALL_ARCHS), None,
                                   multi_pod_too=False, compile_=False,
                                   log=lambda *a: None)
    assert (len(results), len(failures)) == (28, 12)
    assert {f["arch"] for f in failures} == LM_FAILING


def test_moe_long_500k_runs_its_experts_model_parallel(children):
    """granite-moe ``long_500k`` (B = 1) on (16, 16) takes ``_moe_ffn``'s
    branch that is not shard-local: each model rank runs its F-slice of
    every expert (40 experts do not divide 16) instead of gathering all
    40 whole.  Its per-rank FLOPs are below what every expert whole takes
    alone and, with its peak, within PR 29's 0.25-4x of the reference's;
    its collective bytes are the reference's, less the reference's two
    fp32 all-gathers of a whole 524,288-position cache layer (GSPMD's
    involuntary rematerialization, which the port's sequence-cut decode
    attention does not need), within 0.998-1.116x."""
    ref = _reference(children)
    key = "granite-moe-3b-a800m/long_500k/16x16"
    spec = get("granite-moe-3b-a800m")
    cfg = spec.bundle().cfg
    with dryrun.fake_world(256):
        res, _, counts = dryrun.lower_cell(
            spec.bundle(), spec, "long_500k",
            make_production_mesh(device="cpu"))
    want = ref[key]
    flops = res["cost"]["flops_per_device"]
    whole_experts = cfg.n_moe_layers * cfg.n_experts * 3 * 2 * \
        cfg.d_model * cfg.d_ff      # B = 1: one capacity slot an expert
    assert flops < whole_experts
    assert 0.25 <= flops / want["cost"]["flops_per_device"] <= 4
    peak = res["memory"]["peak_gb_per_device"]
    assert 0.25 <= peak / want["memory"]["peak_gb_per_device"] <= 4
    coll = counts["collectives"]["total"]
    ref_coll = ref[f"{key}/collective_bytes"] - ref[f"{key}/cache_gathers"]
    assert ref[f"{key}/cache_gathers"] > 0
    assert 0.998 <= coll / ref_coll <= 1.116, (coll, ref_coll)


def test_moe_long_500k_on_a_model_axis_dividing_the_experts(children):
    """The same cell on a (32, 8) mesh, where 40 experts divide the model
    axis: each rank runs its 5 whole experts (``moe_apply(ep_axis=
    "model")``) and all-gathers the (E·C, d) expert output; its collective
    bytes are within 0.99-1.116x of the reference's (whose GSPMD
    all-reduces the (T·k, d) gathered rows instead), its per-rank FLOPs
    and peak within 0.25-4x."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import _MeshLM
    ref = _reference(children)
    want = ref["granite-moe-3b-a800m/long_500k/32x8"]
    spec = get("granite-moe-3b-a800m")
    with dryrun.fake_world(256):
        mesh = make_debug_mesh((32, 8), device="cpu")
        res, trace, counts = dryrun.lower_cell(spec.bundle(), spec,
                                               "long_500k", mesh)
        layout = _MeshLM.of(spec.bundle().cfg, as_mesh(mesh)).expert_layout
    assert layout["ep_axis"] == "model"
    assert trace["args"][0]["moe_layers"]["moe"]["wg"].shape[:2] == (1, 5)
    for got, ref_v in ((res["cost"]["flops_per_device"],
                        want["cost"]["flops_per_device"]),
                       (res["memory"]["peak_gb_per_device"],
                        want["memory"]["peak_gb_per_device"])):
        assert 0.25 <= got / ref_v <= 4
    coll = counts["collectives"]["total"]
    ref_coll = ref["granite-moe-3b-a800m/long_500k/32x8/collective_bytes"]
    assert 0.99 <= coll / ref_coll <= 1.116, (coll, ref_coll)
