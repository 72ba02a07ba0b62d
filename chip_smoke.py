#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and fails without a
   CUDA device.
2. Builds every kernel from ``src/repro_torch/csrc`` with nvcc into
   ``build/`` and prints the build time and ptxas's register report.
3. Kernel phase: on the GCN serving plan of ``cora_like(seed=0)`` at
   bm = 128, runs each kernel against its plain PyTorch version on the card
   (tolerance below), and times the kernel, the plain version and one
   PyTorch yardstick (``torch.sparse.mm`` on a CSR of D^-1/2 (A+I) D^-1/2)
   with CUDA events.
4. Serving phase: runs ``repro_torch.launch.serve`` (Cora, GCN dims
   [1433, 64, 16], 200 requests) with every kernel's launch count set to 0
   just before and read just after; the launcher itself exits 1 unless the
   online answers match the kernel-computed oracle within 1e-4.
5. Prints one JSON line with every kernel's numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; no phase is caught and swallowed.
It imports nothing of JAX and nothing of the JAX package.
"""
import json
import statistics
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BM = 128
# fp32 sums of at most 22 slots x 128 terms, taken in another order
KERNEL_TOL = 1e-5
ORACLE_TOL = 1e-4
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
SOURCE = "src/repro_torch/csrc/spmm_blockell_compact.cu"
REPLACES = "src/repro/kernels/spmm_blockell.py:229"


def gpu_ms(fn, n_inner: int = 20, reps: int = 25, warmup: int = 3) -> float:
    """Median over ``reps`` CUDA-event windows of ``n_inner`` back-to-back
    calls, per call (back-to-back launches hide the host's launch cost as
    long as one call takes longer than its launch)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n_inner)
    return statistics.median(times)


def kernel_phase(torch, dev):
    import numpy as np
    from repro_torch.exec import build_plan
    from repro_torch.graph import cora_like
    from repro_torch.kernels import spmm_blockell as sk
    from repro_torch.kernels.ref import spmm_blockell_compact_ref

    g = cora_like(seed=0)
    plan = build_plan(g, "gcn", bm=BM, backend="cuda", device=dev)
    a = plan._fwd
    n = g.num_nodes
    R = a["row_offsets"].numel() - 1
    n_active = a["cols"].numel()
    nnz = int(plan.ell.density_stats()["nnz"])
    print(f"plan: n={n} R={R} n_active={n_active} nnz={nnz} "
          f"tile_fill={nnz / (n_active * BM * BM):.4%}")
    active = a["node_active"]

    # the yardstick: one library call for the same GCN aggregation
    deg = torch.as_tensor(g.in_degrees().astype(np.float32) + 1.0).to(dev)
    s = torch.rsqrt(deg)
    src = torch.as_tensor(g.src.astype(np.int64)).to(dev)
    dst = torch.as_tensor(g.dst.astype(np.int64)).to(dev)
    loops = torch.arange(n, device=dev)
    idx = torch.stack([torch.cat([dst, loops]), torch.cat([src, loops])])
    val = s[idx[0]] * s[idx[1]]
    with warnings.catch_warnings():      # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a_hat = torch.sparse_coo_tensor(idx, val, (n, n),
                                        check_invariants=True
                                        ).coalesce().to_sparse_csr()

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for d, add_diag, tiles, override in [(64, True, "u8", False),
                                         (16, True, "u8", False),
                                         (64, False, "u8", False),
                                         (16, False, "u8", False),
                                         (64, True, "u8", True),
                                         (64, True, "f32", False)]:
        x = torch.randn((n, d), generator=gen, device=dev)
        blocks = (a["blocks"] if tiles == "u8"
                  else a["blocks"].to(torch.float32))
        xd = sd = None
        if override:
            xd = torch.randn((n, d), generator=gen, device=dev)
            sd = torch.rand((n,), generator=gen, device=dev)
        args = (a["row_offsets"], a["cols"], blocks, x, a["s_in"], a["s_out"],
                xd, sd)
        kw = dict(bm=BM, bk=BM, add_diag=add_diag)
        y = sk.spmm_blockell_compact(*args, **kw)
        ref = spmm_blockell_compact_ref(*args, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(y[active]).all():
            raise AssertionError(f"kernel output not finite (d={d})")
        err = float((y - ref)[active].abs().max())
        name = (f"d={d} add_diag={add_diag} tiles={tiles}"
                + (" x_diag/s_in_diag" if override else ""))
        if err > KERNEL_TOL:
            raise AssertionError(f"kernel vs plain {name}: max_abs_err "
                                 f"{err:.3e} > {KERNEL_TOL}")

        # time the raw launch (no Python checks) and the plain version
        fn = sk._kernel_fn()
        stream = torch.cuda.current_stream(dev).cuda_stream
        xd_, sd_ = (xd, sd) if override else (x, a["s_in"])
        raw = (a["row_offsets"].data_ptr(), a["cols"].data_ptr(),
               blocks.data_ptr(), x.data_ptr(), a["s_in"].data_ptr(),
               a["s_out"].data_ptr(), xd_.data_ptr(), sd_.data_ptr(),
               y.data_ptr(), int(tiles == "u8"), R, n, n, BM, BM, d,
               int(add_diag), stream)

        def launch():
            if fn(*raw):
                raise RuntimeError("launch failed")

        ms = gpu_ms(launch)
        plain_ms = gpu_ms(lambda: spmm_blockell_compact_ref(*args, **kw))

        # what the data needs: inputs read once, outputs written once
        rows_out = int(active.sum())
        nbytes = (blocks.numel() * blocks.element_size() + x.numel() * 4
                  + 4 * n * 2 + 4 * (R + 1) + 4 * n_active
                  + rows_out * d * 4 + (n * d * 4 + 4 * n if override else 0))
        ops = 2 * nnz * d + 2 * n * d + (2 * n * d if add_diag else 0)
        dense_ops = 2 * n_active * BM * BM * d
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        case = {"case": name, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bytes": nbytes, "ops": ops,
                "bound_bytes_ms": t_bytes,
                "bound_ops_ms": ops / PEAK_FP32_FLOPS * 1e3,
                "dense_tile_ops_ms": dense_ops / PEAK_FP32_FLOPS * 1e3,
                "library_ms": None}
        if add_diag and not override and tiles == "u8":
            # the main path's shapes: hold the plan's patched output against
            # the library call too, and time it
            y_plan = plan.apply(x)
            y_lib = torch.sparse.mm(a_hat, x)
            lib_err = float((y_plan - y_lib).abs().max())
            if lib_err > KERNEL_TOL:
                raise AssertionError(f"plan vs torch.sparse.mm {name}: "
                                     f"{lib_err:.3e} > {KERNEL_TOL}")
            case["plan_vs_library_err"] = lib_err
            case["library_ms"] = gpu_ms(lambda: torch.sparse.mm(a_hat, x))
            case["main_path"] = True
        print("case " + json.dumps(case))
        cases.append(case)
    return cases


def serving_phase(torch, dev):
    from repro_torch.kernels import spmm_blockell as sk
    from repro_torch.launch import serve

    argv = ["--graph", "cora", "--model", "gcn", "--requests", "200",
            "--cache-kb", "500", "--warm", "reorder", "--device", "cuda"]
    sk.spmm_blockell_compact.launches = 0
    rep = serve.main(argv)
    torch.cuda.synchronize()
    launches = sk.spmm_blockell_compact.launches
    print(f"serving: launches={launches} max_oracle_err="
          f"{rep.max_oracle_err:.3e} hit_rate={rep.hit_rate:.3f} "
          f"p50={rep.p50_ms:.3f}ms p99={rep.p99_ms:.3f}ms "
          f"req/s={rep.req_per_s:.1f}")
    if rep.max_oracle_err >= ORACLE_TOL:
        raise AssertionError(f"oracle max_err {rep.max_oracle_err} >= "
                             f"{ORACLE_TOL}")
    if rep.num_requests != 200:
        raise AssertionError(f"served {rep.num_requests} of 200 requests")
    if launches < 2:
        raise AssertionError(f"spmm_blockell_compact launched {launches} "
                             "times on the main path; expected >= 2 (one "
                             "per GCN layer)")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    _build.build("spmm_blockell_compact")
    for name, info in _build.BUILD_LOG.items():
        print(f"build {name}: {info['seconds']:.1f}s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())

    cases = kernel_phase(torch, dev)
    launches = serving_phase(torch, dev)

    main_cases = [c for c in cases if c.get("main_path")]
    t_bytes = sum(c["bound_bytes_ms"] for c in main_cases)
    t_ops = sum(c["bound_ops_ms"] for c in main_cases)
    kernels = [{
        "name": "spmm_blockell_compact", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        # one main-path forward: the d=64 launch plus the d=16 launch
        "work": "one GCN serving forward on Cora: d=64 then d=16, bm=128",
        "ms": sum(c["ms"] for c in main_cases),
        "plain_ms": sum(c["plain_ms"] for c in main_cases),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(c["library_ms"] for c in main_cases),
        "peaks": "H100 SXM data sheet: 67 TFLOP/s fp32, 3.35 TB/s",
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
