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
0.25-4x).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.configs import get
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

ROOT = Path(__file__).resolve().parents[1]

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import jax
jax.devices()                      # the backend, before dryrun's own flag
import numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import get
from repro.launch.dryrun import lower_cell
from repro.launch.mesh import make_production_mesh
from repro.roofline.hlo import collective_bytes

small = Mesh(np.asarray(jax.devices()[:16]).reshape(4, 4),
             ("data", "model"), axis_types=(AxisType.Auto,) * 2)
big = make_production_mesh()
out = {}
for arch, shape, mesh, name in [("gcn-cora", "molecule", small, "4x4"),
                                ("wide-deep", "serve_p99", small, "4x4"),
                                ("minitron-8b", "decode_32k", big, "16x16"),
                                ("granite-8b", "train_4k", big, "16x16")]:
    spec = get(arch)
    try:
        res, _, compiled = lower_cell(spec.bundle(), spec, shape, mesh)
        out[f"{arch}/{shape}/{name}"] = res
        out[f"{arch}/{shape}/{name}/collective_bytes"] = collective_bytes(
            compiled.as_text())["total"]
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
