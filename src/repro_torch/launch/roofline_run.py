"""Roofline baseline for all 40 cells (single-pod, per the brief; port of
``repro/launch/roofline_run.py``): each cell's step traced at full depth on
rank 0 of a fake (16, 16) process group (``launch.dryrun``), its three
terms over the H100's constants (``roofline.hw``).  A model from the data
sheet's peaks, not a measurement.

  PYTHONPATH=src python -m repro_torch.launch.roofline_run --json roofline.json
"""
import argparse
import json
import traceback

from ..configs import get
from ..configs.registry import ALL_ARCHS
from ..roofline.analysis import MD_HEADER, analyze_cell, markdown_row
from . import dryrun


def _record(r) -> dict:
    return {
        "arch": r.arch, "shape": r.shape,
        "flops_per_chip": r.flops_per_chip,
        "bytes_per_chip": r.bytes_per_chip,
        "coll_bytes_per_chip": r.coll_bytes_per_chip,
        "t_compute": r.t_compute, "t_memory": r.t_memory,
        "t_collective": r.t_collective, "dominant": r.dominant,
        "model_flops": r.model_flops_global,
        "useful_ratio": r.useful_ratio,
        "roofline_fraction": r.roofline_fraction,
        "peak_gb": r.peak_gb, "suggestion": r.suggestion(),
    }


def _analyze(job):
    """One cell on the worker's mesh: ``(row, record, None)`` or ``(None,
    None, error text)``."""
    name, shape = job
    try:
        r = analyze_cell(name, shape, dryrun.production_mesh(), "16x16")
        return markdown_row(r), _record(r), None
    except Exception as e:
        return None, None, (f"{type(e).__name__}: {e}\n"
                            + traceback.format_exc())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--md", default=None)
    args = ap.parse_args(argv)
    rows = []
    records = []
    archs = args.arch or list(ALL_ARCHS)
    jobs = [(name, shape) for name in archs for shape in get(name).shapes
            if not args.shape or shape in args.shape]
    for (name, shape), (row, rec, err) in zip(
            jobs, dryrun.map_cells(_analyze, jobs, False)):
        if err is not None:
            print(f"FAIL {name} {shape}: {err}")
            continue
        rows.append(row)
        records.append(rec)
        print(f"{name:28s} {shape:14s} dominant={rec['dominant']:10s} "
              f"frac={rec['roofline_fraction']:.2%} "
              f"peak={rec['peak_gb']:.1f}GB")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    if args.md:
        with open(args.md, "w") as f:
            f.write(MD_HEADER + "\n" + "\n".join(rows) + "\n")
    print(f"\n{len(records)} cells analyzed")


if __name__ == "__main__":
    main()
