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
starts no process group.
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
        res, _, _ = lower_cell(spec.bundle(), spec, shape, mesh)
        out[f"{arch}/{shape}/{name}"] = res
    except Exception as e:
        out[f"{arch}/{shape}/{name}"] = {"error": type(e).__name__}
print(json.dumps(out))
"""

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
    assert counts["collectives"]["total"] == 0   # no mesh path: no wire


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
