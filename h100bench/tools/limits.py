"""The readings that a cell's limits are set from, at the cell's own size.

    python h100bench/tools/limits.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 3] [--out FILE]

For each seed: the program's set-up and checked steps, exactly as a run
takes them, then the reference, and the program's readings against it.
For the first ``--control-seeds`` seeds also the control (the reference
in the program's place with every dense product in TF32, the precision
below the configuration's fp32 with TF32 off) and one planted fault
(half of the training rows left out of the loss, the mean taken over the
rest), each read against the reference.  A step that returns its state
unchanged reads 1 on ``grad_gap`` and ``change_gap`` by their definition
and needs no run.  Besides the compared numbers each line holds the worst
leaf's norm of the difference and, for the program and the control, each
leaf's and each step's gap, for the look behind a reading.  One JSON line
a seed.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def per_leaf(a: dict, b: dict) -> dict:
    """Each leaf's norm gap (first gradient, change) over the reference's
    norm of that leaf, its median entry's gap, each step's relative loss
    gap, and the reference's norms, for the look behind a reading."""
    import torch

    from h100bench.harness.check import _entry_gap
    out = {"loss": [abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                         b["losses"])]}
    for key in ("grad", "change"):
        ref = [float(torch.linalg.vector_norm(t.double())) for t in b[key]]
        got = [float(torch.linalg.vector_norm(t.double())) for t in a[key]]
        out[f"{key}_ref_norm"] = ref
        out[f"{key}_gap"] = [abs(g - r) / r if r else None
                             for g, r in zip(got, ref)]
        out[f"{key}_entry_gap"] = [_entry_gap(x, y)
                                   for x, y in zip(a[key], b[key])]
    return out


def diff_norms(a: dict, b: dict) -> dict:
    """The worst leaf's ``|a - b| / max(|b|, median |b|)``, of the first
    gradient and of the change."""
    import torch
    out = {}
    for key in ("grad", "change"):
        ref = [float(torch.linalg.vector_norm(t.double())) for t in b[key]]
        floor = statistics.median(ref)
        out[f"{key}_diff"] = max(
            float(torch.linalg.vector_norm((x - y).double())) / max(r, floor)
            for x, y, r in zip(a[key], b[key], ref))
    return out


def seed_readings(spec: dict, seed: int, device, control: bool) -> dict:
    """One seed's readings (see the module's docstring)."""
    from h100bench.drivers.gnn_full import half_batch
    from h100bench.harness import manifest
    from h100bench.harness.check import training_readings

    driver = manifest.driver(spec["config"]["driver"])
    t0 = time.perf_counter()
    s = driver.Session(spec, seed, device,
                       lambda m: print(m, file=sys.stderr, flush=True))
    s.setup()
    t_setup = time.perf_counter() - t0
    s.release()
    t0 = time.perf_counter()
    ref = s.reference("fp32")
    line = {"workload": spec["workload"]["name"], "seed": seed,
            "setup_s": t_setup, "reference_s": time.perf_counter() - t0,
            "losses": s.prog["losses"], "ref_losses": ref["losses"],
            "program": {**training_readings(s.prog, ref),
                        **diff_norms(s.prog, ref)},
            "program_leaves": per_leaf(s.prog, ref)}
    if control:
        ctrl = s.reference("tf32")
        line["control"] = {**training_readings(ctrl, ref),
                           **diff_norms(ctrl, ref)}
        line["control_leaves"] = per_leaf(ctrl, ref)
        fault = s.reference("fp32", mask_fn=half_batch)
        line["half_batch"] = {**training_readings(fault, ref),
                              **diff_norms(fault, ref)}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100bench import run as bench_run
    bench_run.set_up_environment(ROOT)
    import torch

    from h100bench.harness import manifest

    bench = manifest.load_benchmark(ROOT)
    spec = manifest.cell_spec(bench, args.workload, ROOT)
    dev = torch.device("cuda")
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        line = seed_readings(spec, seed, dev, i < args.control_seeds)
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
