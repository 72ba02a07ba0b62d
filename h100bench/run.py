#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python h100bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic
mix and its metrics are found by name from ``BENCHMARK.json``.  The run
sets the program up (timed as ``setup_s``), drives its step for
``--seconds``, with ``--trace 1`` profiles a few more steps, frees the
program's state, runs the plain reference and compares, and prints one
JSON line last on standard output: the end-to-end metrics with
``--trace 0``, the per-layer ones with ``--trace 1``.  Each number
compared is printed beside its limit, last on standard error and under
``checks``, the result's last key.

It exits 2 and prints no result where CUDA is not available or the
machine has fewer cards than the cell asks for, and 3 where a module of
JAX or of the JAX package ``repro`` was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _since_process_start() -> float:
    """Seconds from the process's start to ``T0`` (0 where /proc has no
    answer)."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK")
                   - (time.perf_counter() - T0))
    except (OSError, ValueError, IndexError):
        return 0.0


PROCESS_START = T0 - _since_process_start()


@dataclass
class Context:
    """What the metric readers read."""
    shape: dict
    readings: dict
    step_times: list
    window_s: float
    setup_s: float
    peak_bytes: int
    trace: Optional[object] = None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package, compared whole."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def set_up_environment(root: Path) -> str:
    """Caches inside the checkout, at fixed paths; the tuning cache fresh
    under ``TMPDIR``, so that the cold schedule picks the plans.  Returns
    the tuning cache's directory."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    tune = tempfile.mkdtemp(prefix="h100bench-exec-")
    os.environ["REPRO_TORCH_EXEC_CACHE"] = tune
    for path in (root / "src", root):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    return tune


def run(args, *, device: str = "cuda", config: Optional[dict] = None,
        log: Callable[[str], None] = None, root: Path = ROOT) -> int:
    """One run; ``device="cpu"`` and ``config`` serve the CPU tests."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    tune = set_up_environment(root)
    try:
        return _run(args, device, config, log, root)
    finally:
        shutil.rmtree(tune, ignore_errors=True)


def _run(args, device, config, log, root) -> int:
    import torch

    from h100bench.harness import devtrace, manifest

    bench = manifest.load_benchmark(root)
    cell = manifest.cell(bench, args.workload)
    if device == "cuda":
        if not torch.cuda.is_available():
            log("CUDA is not available: no run")
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            log(f"the cell asks for {cell['chips']} cards, the machine has "
                f"{torch.cuda.device_count()}: no run")
            return 2
    dev = torch.device(device)
    spec = manifest.cell_spec(bench, args.workload, root, config)
    driver = manifest.driver(spec["config"]["driver"])
    session = driver.Session(spec, args.seed, dev, log)
    session.setup()

    setup_s = time.perf_counter() - PROCESS_START
    times, losses = [], []
    start = time.perf_counter()
    deadline = start + args.seconds
    end = start
    while end < deadline:
        t0 = time.perf_counter()
        losses.append(session.step())
        end = time.perf_counter()
        times.append(end - t0)
    window_s = end - start
    trace = None
    if args.trace:
        trace = devtrace.profile_steps(session.step,
                                       spec["traffic"]["trace_steps"])
    peak = torch.cuda.max_memory_allocated(dev) if device == "cuda" else 0
    shape = session.shape()
    session.release()

    checks = session.check()
    limits = spec["limits"]["limits"]
    failed = sum(1 for x in losses if not math.isfinite(x))
    correct = (failed == 0 and bool(times) and set(checks) == set(limits)
               and all(checks[k] <= limits[k] for k in limits))

    ctx = Context(shape=shape, readings=dict(session.readings),
                  step_times=times, window_s=window_s, setup_s=setup_s,
                  peak_bytes=peak, trace=trace)
    metrics = {}
    for m in manifest.metrics_for(bench, args.workload, bool(args.trace)):
        value = manifest.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or of the JAX package were loaded: {bad}")
        return 3

    if device == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": cell["chips"], "memory_peak_bytes": int(peak),
                "power_limit_w": power_limit_w()}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace is not None:
        info.update(busy_s=trace.busy_s(), window_s=trace.window_s)
    result = {"correct": correct, "attempted": len(times), "failed": failed,
              "metrics": metrics, "device": info}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.top_ops(10),
                               "idle_gaps": trace.idle_gaps(10)}
    log(f"window {window_s:.3f} s, {len(times)} steps; set-up readings "
        f"{json.dumps(session.readings)}")
    result["checks"] = {k: {"value": _number(checks.get(k)),
                            "limit": limits[k]} for k in limits}
    print(json.dumps(result), flush=True)
    for k in limits:
        print(f"check {k} {_number(checks.get(k))} limit {limits[k]}",
              file=sys.stderr, flush=True)
    return 0


def _number(x):
    """A reading as JSON can hold it: a non-finite one as its name."""
    if x is None or math.isfinite(x):
        return x
    return repr(float(x))


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
