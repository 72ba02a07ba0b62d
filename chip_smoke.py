#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and fails without a
   CUDA device.
2. Builds every kernel from ``src/repro_torch/csrc`` with nvcc into
   ``build/`` (one nvcc per source, all started together) and prints the
   build time and ptxas's register and spill report.
3. GAT at the benchmark cell ``gat-reddit.full``'s shapes first
   (``gat_phases``): the cell's graph (``h100bench/configs/gat-reddit.json``
   through the benchmark's generator, MinHash's order, 58,241 nodes, about
   27.9 M edges plus a self loop a node) and its attention plan (hubs both
   ways); ``gat_attention`` and ``gat_attention_bwd`` at (4 heads, 256)
   and (6, 6) against ``gat_attention_ref`` / ``gat_attention_bwd_ref`` in
   float64, run by blocks of rows (out, lse, dz, ds_src and ds_dst within
   ``KERNEL_TOL`` of each output's largest entry), reruns bit-identical,
   each entry point timed beside a bound from its lists and rows; then one
   training step of the cell's model through ``gat_loss(executor="fused")``
   and ``make_train_step`` with every launch count zeroed just before it
   (exactly 3 of each GAT kernel and no other), and the step's ms, busy
   share and ``gat::`` device time.
   Then kernel phases (``sddmm``, ``embedding_bag`` and
   ``decode_attention`` in 5, 7 and 8; the block-ELL kernels at
   GraphSAGE's shapes in 6), each kernel
   against its plain PyTorch version on the card
   (tolerances below), timed with CUDA events beside its bound:
   ``spmm_blockell_compact`` on the GCN serving plan of ``cora_like(seed=0)``
   (with ``torch.sparse.mm`` as its yardstick) and at the training shapes
   (forward and transpose plans of the MinHash-reordered Cora);
   ``spmm_blockell_update_compact`` in four cases on the reordered Cora,
   with a bit-identical rerun of the main-path case (the update kernels
   also beside ``composed_update``, two PyTorch calls); both compact kernels
   at the bucketed tiles (bm 256 and 512, with the destination overrides);
   the padded kernels ``spmm_blockell_fused`` (gcn-cora's padded plans at
   bm 128, forward and transposed, and bm 256), ``spmm_blockell`` (the same
   ELL at d = 64) and ``spmm_blockell_update`` (the GIN conv at bm 128, and
   once at d_in = 1433).
4. Serving phase: ``repro_torch.launch.serve`` (Cora, GCN [1433, 64, 16],
   200 requests); the launcher exits 1 unless the online answers match the
   kernel-computed oracle within 1e-4.
5. The autotune path: ``repro_torch.launch.train --arch gcn-cora`` at its
   default ``--executor auto`` on a fresh tuning cache (20 steps): every
   layer's trial table and the raced schedules are printed, every candidate
   must have been measured (a missing one is rebuilt and run outside any
   ``try`` so its error surfaces), the kernels must have launched during
   tuning, the winning schedule's training is held against the same
   schedule on the plain backend, a rerun must read the cache, run no trial
   and launch exactly the kernels the winner's ``cuda`` layers need, and
   ``--executor fused`` on a fresh cache must give the cold DP's schedule,
   launch its 4 compact kernels a step and hold against the plain backend.  Then GIN at its paper width (1433 -> 128 x 5 convs -> 7, 20
   steps of ``fit``) on the port's cold ``plan_forward`` schedule, held
   against the plain backend.  ``kernels.ops.spmm`` (the entry point of
   ``spmm_blockell``) and ``kernels.ops.sddmm`` run as paths of their own.
   Then the paper's reuse layer on Cora: ``examples/quickstart_torch.py``
   on the card (the reference quickstart's lines, no launch); GCN [1433,
   16, 7] with ``executor="blockell"`` over the bare adjacency's
   ``BlockEll`` (``core.blockell_aggregate``: exactly 3 ``spmm_blockell``
   launches a step, 10 steps held against the plain path on the CPU, and
   ``spmm_blockell`` at the step's three launches, d = 1433 among them,
   against its plain version and ``torch.sparse.mm``); GIN with
   ``executor="shared"`` against ``"segment"`` (fp32 and fp64, no launch).
   Then the fallback chain (``exec.fallback.ResilientPlan``) on the
   reordered Cora with a quarantine directory of its own: healthy compact,
   padded and bucketed gcn plans answer on ``cuda`` (1, 1 and 2 launches)
   within 1e-5 of ``torch``; weighted ``sum`` plans (seeded weights,
   float32 tiles) at d = 64 and 1433 through rows 3 and 2, each held
   against its plain version and timed beside its bound and
   ``torch.sparse.mm`` of the weighted adjacency; the ``kernel_launch``
   and ``nan_backend`` drills at ``exec.pallas_launch`` /
   ``exec.kernel_result`` demote to ``torch``, quarantine ``cuda`` under
   the card's device signature, and the cost oracle drops it; an armed
   fused layer (row 5) propagates its ``InjectedFault``.
   Then the graph half of distributed (``dist_phases``): the elastic state
   machine (``dist.ElasticAggregator``) over the reordered Cora in 4
   shards, each shard's weighted ``sum`` plan through
   ``spmm_blockell_compact`` (on 0/1 uint8 tiles, Cora's edges weighing 1,
   and on float32 tiles for the symmetric-normalised Cora: aggregates at
   d = 16 and 1433 within 1e-5 of the segment-sum oracle and the
   ``torch`` backend; row 3 at each shard's d = 1433 forward against its
   plain version and ``torch.sparse.mm``), ``train_elastic`` at [1433, 16, 7] for 12 steps
   (rerun bit-identical under deterministic algorithms, losses within
   1e-4 of the ``torch`` backend, the launches of every step counted
   exactly), the evict / rejoin drill (persistent ``shard_loss`` on shard
   3: the trail and bar of the reference's recovery test) and the step's
   ms on both paths; then ``launch.train --arch gcn-cora --dist`` as
   subprocesses for each aggregator on NCCL at ``parts`` = the card count
   (losses within 1e-4 of the gloo run at the same parts, the aggregators
   within 1e-5 of each other) and ``--parts`` one above the card count
   (exits non-zero: "need N devices, have M"); and one NCCL rank in this
   process: the exchanges and their gradients at d = 1433 against the
   segment-sum oracle, each aggregator's step ms, the resilient drill
   through ``train_distributed`` (exactly one
   ``dist.halo_fallback{reason=shard_loss}``, losses within 1e-5 of the
   no-fault run), ``distributed_decode_attention`` on a (1, 1) mesh at
   granite-8b's decode shape in bf16 (row by row, 3e-2) and
   ``int8_allreduce_psum``.
   Then observability (``obs_phase``): ``launch.serve`` on Cora under
   ``--metrics-out --trace --summary`` (exactly 2 compact launches; both
   files valid under ``repro_torch.obs.validate``, stamped ``cuda``, the
   card's name and the power limit printed at the top; 200 requests, as
   many ``serve.request`` instants, ``serve.batches`` equal to the
   ``serve.batch`` spans, the per-layer hit-rate gauges); ``launch.train
   --executor auto`` on a fresh cache under ``--metrics-out --trace``
   (measured trial spans equal ``exec.autotune.trials``, one
   ``exec.forward.verdict{source}``, 10 ``train.steps``) and two cached
   reruns, with the flags and without, whose losses must be bit-identical
   (deterministic algorithms when the verdict holds a ``coo`` layer);
   10 traced ``fit`` steps on the fused plan, each ``train.step`` span no
   shorter than its step's CUDA-event time; ``python -m
   repro_torch.obs.audit`` writing the card's calibration table
   (``n_obs`` equal to the cache's measured rows; the trace's audit the
   same classes and signature); ``--executor fused`` cold without and with
   that table (launches counted a step, the calibrated run's losses within
   1e-4 of the plain path); the fused step's ms with telemetry off / on /
   on / off.
   Every path runs with each kernel's launch count set to 0 just before it
   and read just after, and fails if a kernel it needs was not launched.
6. GraphSAGE on the paper's CITESEER-S stand-in at Table I's size
   (227,320 nodes, 814,134 edges, 3,703 features, 41 classes; synthesized
   once): ``launch.serve --graph citeseer-s --scale 1.0 --model sage_gin``
   (200 Zipf(1.1) requests, 500 KB cache; exactly 2 compact launches build
   the offline forward, answers within 1e-4 of it); the paper's width
   [3703, 256, 41] trained full-graph on the MinHash-reordered graph
   through the cold ``plan_forward(sage_chain)`` plans (4 compact launches
   a step), held against the segment executor (step 0 and 10 losses
   within 1e-4), with ms per step, busy share and peak memory; the compact
   kernel at that step's four launches against its plain version (run by
   pieces of destination blocks) and ``torch.sparse.mm``; sampled
   minibatches at [3703, 256, 256] (fanouts (15, 10), 512 seeds, 20
   steps, no kernel); ``launch.serve --graph reddit --model sage_gin`` at
   its default ``--scale 0.02`` (1 update and 1 compact launch) and the
   update kernel at its two-W layer 1 beside ``composed_update``.  And the
   paper's LR&CR schedule on the reordered CITESEER-S: the cache model's
   Index / LR / LR&CR off-chip totals (64 PEs, 64 + 64 KB, d = 3703; host
   seconds), the level-1 shared-set plan, and [3703, 256, 41] trained with
   ``executor="shared"`` (no launch) against ``"segment"`` (step 0 and 10
   losses within 1e-4), with ms per step, busy share and peak memory of
   both.
7. Wide & deep (``embedding_bag``): ``launch.serve --model wide_deep`` and
   ``launch.train --arch wide-deep`` (``REDUCED``; 20 losses held against
   ``lookup="dense"`` within 1e-4, 4 launches a step); then ``CONFIG``
   (40 fields x 1 M rows, embed 32, MLP 1024-512-256; 5.3 GB of params
   drawn on the card): the kernel against its plain version and
   ``F.embedding_bag`` at the deep lookup (``serve_p99``, ``train_batch``),
   the wide lookup and both backwards over 40 M bags (with the mapping each
   took); ``zero_`` of the 5.12 GB table gradient and ``torch.take`` of
   the wide lookup's 2.6 M random floats (the access patterns' floors);
   ``ops.embedding_bag`` forward + backward at ``train_batch`` as the step
   calls it; 200 requests through
   ``ServeEngine``; ``serve_p99`` / ``serve_bulk`` / ``retrieval_cand``
   scoring; step 0's loss and gradients at B = 65,536 and 7 train steps
   (ms per step, busy share, peak memory).  Every ``CONFIG`` result is held
   against ``lookup="dense"`` on the same params within 1e-5 of its largest
   entry.
8. LM serving (``decode_attention``), once the wide & deep phases have
   freed the card: the kernel against its plain version (fp32 1e-4, bf16
   3e-2) and ``F.scaled_dot_product_attention`` at the reference's test
   shapes, granite-8b's ``decode_32k`` layer (B = 8), one ``long_500k``
   layer and ragged lengths with G = 1, 4, 12; ``launch.serve --arch
   granite-8b --tokens 16`` (``REDUCED``; exactly 32 launches, logits within
   1e-4 of ``attn="plain"``, tokens equal to its and to the CPU run's);
   then ``CONFIG`` (36 layers, 16.5 GB of bf16
   params drawn on the card): a B = 8 x 512 prefill, a 32,768-long cache,
   one step on the kernel and the plain path (logits within 3e-2 of the
   largest), 32 greedy steps (36 launches each; ms per step, tokens/s,
   busy share, decode_attention's share, peak memory).
9. LM training (no kernel: the reference trains with plain attention),
   once the serving weights and cache are freed: ``launch.train --arch
   granite-8b --steps 10`` (``REDUCED``) on the card and with ``--device
   cpu`` (losses within 1e-4); the crash drill (a ``train.step`` crash at
   step 5 of 6 with ``ckpt_every=2``, a resumed run within 1e-6 of the
   uninterrupted one) and the corrupt-file drill (restore falls back to
   step 4, one ``train.ckpt_fallback``); then granite-8b ``train_4k`` at
   full width, cut to 12 of 36 layers and batch 1 (fp32 master params and
   Adam moments, bf16 compute, the donated step): at 2 layers the
   remat/chunked ``lm_loss`` against the plain cross-entropy (1e-3 / 3e-2)
   and 3 donated steps against 3 functional ones (1e-6); at 12, 1 warm-up
   and 4 timed steps (ms a step, tokens/s, busy share, device time by
   kind, one step timed in pieces), peak memory beside the 48.3 GB of
   state, the bf16 FLOP share.
10. The MoE LMs, once the LM training state is freed:
   ``decode_attention`` at granite-moe-3b-a800m's (G = 3, d = 64, B = 24)
   and llama4-maverick-400b-a17b's (G = 5, d = 128, B = 64) decode_32k
   layers against its plain version and SDPA; ``launch.serve`` and
   ``launch.train`` for both at ``REDUCED`` (exactly 32 launches a serve
   run, the kernel path's tokens equal to ``attn="plain"``'s and the CPU
   run's, 10 training losses within 1e-4 of ``--device cpu``); each
   ``CONFIG`` served at full width (llama4 cut to one superblock, 2 of 48
   layers): a B x 512 prefill, one decode step rerun bit-identical, the
   teacher-forced hold of every layer's attention (3e-2), the free-running
   plain step's route agreement, flips and drop share, then 32 greedy
   steps (32 / 2 launches each; ms a step, tokens/s, busy share,
   decode_attention's share, peak memory); and granite-moe ``train_4k``
   at full depth, B = 2 (ms a step, busy share, peak beside 53.99 GB of
   state, the bf16 FLOP share of the active FLOPs; two 3-step runs from
   one seed bit-identical; no kernel).  Inside granite-moe's ``CONFIG``
   phase, on the same weights and caches (``lm_mesh_phase``): the decode
   step again through ``dist.sharding.use_mesh`` on a (1, 1) data x model
   mesh of a one-rank NCCL group (the LM mesh path of ``models.
   transformer``), bit-identical to the no-mesh step with the same 32
   ``decode_attention`` launches; then the step at B = 1 on the first row
   of those caches (``moe_ep_mesh_phase``), with no mesh and on a (1, 1)
   NCCL mesh, where it runs ``_moe_ffn``'s branch that is not shard-local
   (``moe_apply(ep_axis="model")``, every expert on the one model rank):
   6 steps each, all bit-identical, 32 ``decode_attention`` launches a
   step, ms a step of both beside the card's name and power limit; then
   each rank's state bytes of the cells cut to fit one card (granite-8b ``train_4k`` at 36 layers, mistral-
   large-123b and llama4 at 48 layers) on (2, 2), (2, 4) and (1, 8)
   meshes, host arithmetic from ``LMBundle.shardings`` (not measured).
11. GAT, PNA and NequIP (no kernel: the reference runs them on
   ``jax.ops.segment_*``), last: ``launch.train --arch gat-cora|pna|nequip
   --steps 10`` at full width on the card and with ``--device cpu`` (losses
   within 1e-4; PNA, chaotic: step 0 within 1e-5 and 10 steps in float64
   within 1e-4); then GAT (8 heads x 8) and PNA (75 x 4) on
   ``ogb_products`` cut to ``products_like(scale=0.1)`` (244,902 nodes,
   6,185,914 edges) and NequIP (32 channels, 5 layers) on ``molecule``
   (128 molecules, 3,840 atoms, 8,192 edges, padded to 4,096 nodes): one
   fp32 step against the same step in float64 (loss 1e-5; gradients 1e-2
   of a leaf's largest entry for GAT and PNA, 1e-4 for NequIP), NequIP's
   rotation check, then ms a step, busy share, device time by kind and
   peak memory.  Then the chaos drill (``drill_phase``): ``python -m
   repro_torch.chaos.drill --seed 0 --gauntlet full`` on the card, through
   its entry point in this process (its launches counted; the exec,
   serve and elastic gauntlets run row 3; ``cuda`` is demoted only by the
   drill's injected faults), two same-seed runs, failing on a non-zero
   exit.  Then the dry-run and the roofline (``roofline_phase``, no
   kernel): ``roofline.hw`` against the card (an H100 with at least
   ``hw.HBM_BYTES``); ``python -m repro_torch.launch.dryrun
   --single-pod-only`` as a child (exit 1 with exactly the reference's 12
   failed cells and 28 OK) and ``python -m repro_torch.launch.roofline_run``
   (28 records); then two steps counted on the host by
   ``roofline.count.count_step`` and run on the card, gcn-cora
   ``full_graph_sm`` (through ``launch.dryrun.lower_cell`` on a (1, 1)
   mesh over a one-rank fake process group) and granite-8b ``train_4k``
   cut to 12 of 36 layers at B = 1: each step's median of 5 synchronised
   steps may not be below its roofline bound, and the dry-run's peak must
   lie within 10% of the card's.  Then the LM mesh path's training step
   (``lm_mesh_train_phase``, no kernel): the same granite-8b cut, weights,
   batch and fresh donated state, through ``dist.sharding.use_mesh`` on a
   (1, 1) data x model mesh of a one-rank NCCL group (the mesh path's
   remat units and loss chunks), counted and held the same way; its first
   loss must equal the no-mesh step's bit for bit, and its ms a step is
   printed beside the no-mesh step's.  Last, the GNN and wide & deep
   bundles' mesh path (``gnn_recsys_mesh_phase``): 3 donated steps each
   of gcn-cora, gat-cora and pna at ``full_graph_sm``, nequip at
   ``molecule`` and wide & deep ``train_batch`` at ``CONFIG`` (``bag``:
   4 ``embedding_bag`` launches a step), with no mesh and then on a
   (1, 1) NCCL mesh under ``torch.use_deterministic_algorithms``; every
   loss must be bit-identical, and ms a step and the peaks are printed.
12. Writes the full report (every case, trial table and path) to
   ``build/chip_smoke.json``, prints one JSON line with every kernel's
   numbers, then, as the last line, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; no phase is caught and swallowed.
It imports nothing of JAX and nothing of the JAX package.
"""
import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BM = 128
# fp32 sums of at most 22 slots x 128 terms, taken in another order; held
# against the largest entry of the reference (1e-5 absolute where entries
# are at most 1, relative above: unnormalized sum-mode rows reach ~30)
KERNEL_TOL = 1e-5
ORACLE_TOL = 1e-4


def _card_constants():
    """``repro_torch.roofline.hw`` of the checkout beside this script (None
    without one: ``main`` then stops with its own message)."""
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        return None
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    from repro_torch.roofline import hw
    return hw


HW = _card_constants()
# NVIDIA H100 SXM data sheet (roofline.hw): fp32 outside the tensor cores,
# HBM3 rate
PEAK_FP32_FLOPS = HW and HW.PEAK_FLOPS_FP32
PEAK_BYTES_PER_S = HW and HW.HBM_BW
# name -> (source, the TPU kernel it replaces, the wrapper's module)
KERNELS = {
    "spmm_blockell": (
        "src/repro_torch/csrc/spmm_blockell.cu",
        "src/repro/kernels/spmm_blockell.py:95", "spmm_blockell"),
    "spmm_blockell_fused": (
        "src/repro_torch/csrc/spmm_blockell_fused.cu",
        "src/repro/kernels/spmm_blockell.py:154", "spmm_blockell"),
    "spmm_blockell_compact": (
        "src/repro_torch/csrc/spmm_blockell_compact.cu",
        "src/repro/kernels/spmm_blockell.py:229", "spmm_blockell"),
    "spmm_blockell_update": (
        "src/repro_torch/csrc/spmm_blockell_update.cu",
        "src/repro/kernels/spmm_blockell.py:344", "spmm_blockell"),
    "spmm_blockell_update_compact": (
        "src/repro_torch/csrc/spmm_blockell_update_compact.cu",
        "src/repro/kernels/spmm_blockell.py:449", "spmm_blockell"),
    "sddmm": (
        "src/repro_torch/csrc/sddmm.cu",
        "src/repro/kernels/sddmm.py:31", "sddmm"),
    "embedding_bag": (
        "src/repro_torch/csrc/embedding_bag.cu",
        "src/repro/kernels/embedding_bag.py:36", "embedding_bag"),
    "decode_attention": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:59", "decode_attention"),
    # no TPU kernel: the reference's GAT runs jax.ops.segment_*
    "gat_attention": (
        "src/repro_torch/csrc/gat_attention.cu", None, "gat_attention"),
    "gat_attention_bwd": (
        "src/repro_torch/csrc/gat_attention_bwd.cu", None, "gat_attention"),
}
# NVIDIA H100 SXM data sheet (roofline.hw): bf16 on the tensor cores (the
# peak for the decode-attention cases whose inputs are bf16)
PEAK_BF16_FLOPS = HW and HW.PEAK_FLOPS_BF16
# the reference's decode-attention bars (tests/test_kernels.py)
DECODE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# granite-8b at full width: decode_32k's batch cut from 128 to 8 (a 38.65 GB
# cache), a 512-token prompt, then 32 greedy steps at the cache's end
LM_BATCH = 8
LM_PROMPT = 512
LM_STEPS = 32
LM_WARMUP = 2
LM_PROFILED = 4
TRAIN_STEPS = 20
COMPARE_STEPS = 10
# (the training tolerances sit beside each phase)


def plan_bytes(torch, side: dict) -> int:
    """Bytes of one plan direction's arrays."""
    return sum(t.numel() * t.element_size() for t in side.values()
               if torch.is_tensor(t))


def tile_arrays(plan, transposed: bool = False) -> dict:
    """One direction of ``plan`` in tile form, on the plan's device: the
    arrays it holds, or for a list direction its compacted tiles built now
    (not kept), as a tile plan would hold them; so that the tile walk runs
    on the same plan as the list walk."""
    from repro_torch.exec.plan import _tile_arrays, _upload

    meta, a = ((plan.meta_bwd, plan._bwd) if transposed
               else (plan.meta_fwd, plan._fwd))
    if not getattr(meta, "lists", False):
        return a
    host = _tile_arrays(plan.ell_t if transposed else plan.ell,
                        a["s_in"].cpu().numpy(), a["s_out"].cpu().numpy(),
                        plan.backend, plan.compact)
    return _upload(host, plan.device)


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


def bound(nbytes: int, ops: int, peak_ops: float = PEAK_FP32_FLOPS) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_bytes_ms": t_bytes,
            "bound_ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops)}


def wrapper(name):
    """The launching wrapper of kernel ``name``, from its own module."""
    import importlib
    module = importlib.import_module("repro_torch.kernels." + KERNELS[name][2])
    return getattr(module, name)


def reset_launches():
    for name in KERNELS:
        wrapper(name).launches = 0


def read_launches(torch) -> dict:
    torch.cuda.synchronize()
    return {name: wrapper(name).launches for name in KERNELS}


def assert_close_scaled(got, ref, tol: float, what: str,
                        floor: float = 1.0) -> float:
    """max |got - ref| <= tol * max(floor, max |ref|); returns the error."""
    err = float((got - ref).abs().max())
    scale = max(floor, float(ref.abs().max()))
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max_abs_err {err:.3e} > {tol} x "
                             f"{scale:.3g}")
    return err


def assert_close_rows(got, ref, tol: float, what: str) -> tuple:
    """|got - ref| <= tol * max |ref| over the last axis, row by row (a zero
    row must come out exactly zero); returns max |got - ref| and the
    largest error over its row's max |ref|."""
    diff = (got - ref).abs()
    row = ref.abs().amax(-1, keepdim=True)
    worst = float((diff / row.clamp_min(1e-30)).max())
    if not bool((diff <= tol * row).all()):
        raise AssertionError(f"{what}: an error reaches {worst:.3e} x its "
                             f"row's max |ref| (bar {tol})")
    return float(diff.max()), worst


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------
def library_matrix(torch, dev, g, mode, transposed, self_coeff=None,
                   weighted=False):
    """The aggregation one plan side computes, as a CSR matrix for
    ``torch.sparse.mm`` (the yardstick; the port never calls it):
    ``M[v, u] = s_out[v] s_in[u]`` per edge u -> v (times the edge's
    weight when ``weighted``), plus ``s_out s_in`` on the diagonal in gcn
    mode; the transposed side is ``Mᵀ``.  With ``self_coeff`` c, the update
    layer's unscaled self term ``c x_v`` is added on the diagonal (GIN's
    ``(1 + eps) x_v``)."""
    import numpy as np
    from repro_torch.exec.plan import _mode_scales

    s_in, s_out, add_diag = _mode_scales(mode, g)
    n = g.num_nodes
    rows, cols = g.dst.astype(np.int64), g.src.astype(np.int64)
    val = s_out[rows] * s_in[cols]
    if weighted:
        val = val * g.edge_weight
    loops = np.arange(n)
    if add_diag:
        rows, cols = np.concatenate([rows, loops]), np.concatenate([cols,
                                                                    loops])
        val = np.concatenate([val, s_out * s_in])
    if self_coeff is not None:
        rows, cols = np.concatenate([rows, loops]), np.concatenate([cols,
                                                                    loops])
        val = np.concatenate([val, np.full(n, self_coeff)])
    if transposed:
        rows, cols = cols, rows
    idx = torch.as_tensor(np.stack([rows, cols])).to(dev)
    with warnings.catch_warnings():      # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            idx, torch.as_tensor(val.astype(np.float32)).to(dev), (n, n),
            check_invariants=True).coalesce().to_sparse_csr()


COMPOSED = ("two PyTorch calls: torch.sparse.mm over the scaled adjacency "
            "(self terms on its diagonal), then torch.addmm with the bias; "
            "ReLU in place (SAGE's two-W layer: a third call, addmm_ of "
            "x @ w_self)")


def composed_update(torch, matrix, x, w, bias, relu, w_self=None):
    """The update kernels' yardstick (``COMPOSED``; no single PyTorch call
    computes aggregation and W epilogue together, and the port never calls
    this): ``act(M x @ W + b)`` with ``M`` from :func:`library_matrix`, and
    ``+ x @ w_self`` for SAGE's two-W layer."""
    agg = torch.sparse.mm(matrix, x)
    y = agg @ w if bias is None else torch.addmm(bias, agg, w)
    if w_self is not None:
        y.addmm_(x, w_self)
    return y.relu_() if relu else y


def compact_ref_by_row_blocks(torch, a, blocks, x, x_diag, s_in_diag, *,
                              bm, bk, add_diag, max_tiles):
    """``spmm_blockell_compact_ref`` on the side arrays ``a``, run over
    consecutive destination blocks of at most ``max_tiles`` slots each (one
    block more where a single block holds more) and concatenated.  Each
    destination block's sum is its own, so this is the same function; the
    pieces keep the plain version's fp32 tiles and per-slot products, which
    at CITESEER-S scale would take 33 GB and 66 GB at once, within the
    card."""
    from repro_torch.kernels.ref import spmm_blockell_compact_ref

    ro = a["row_offsets"].tolist()
    R, n_dst = len(ro) - 1, a["s_out"].numel()
    xd = x if x_diag is None else x_diag
    sd = a["s_in"] if s_in_diag is None else s_in_diag
    outs, r0 = [], 0
    while r0 < R:
        r1 = r0 + 1
        while r1 < R and ro[r1 + 1] - ro[r0] <= max_tiles:
            r1 += 1
        lo, hi = ro[r0], ro[r1]
        rows = slice(r0 * bm, min(r1 * bm, n_dst))
        outs.append(spmm_blockell_compact_ref(
            a["row_offsets"][r0:r1 + 1] - lo, a["cols"][lo:hi],
            blocks[lo:hi], x, a["s_in"], a["s_out"][rows], xd[rows],
            sd[rows], bm=bm, bk=bk, add_diag=add_diag))
        r0 = r1
    return torch.cat(outs)


def compact_case(torch, dev, a, nnz, d, add_diag, tiles, override, gen,
                 name, weight=0, plan_side=None, library=None,
                 plain_max_tiles=None, n_inner=20, reps=25):
    """One ``spmm_blockell_compact`` case on the side arrays ``a`` of a
    plan: kernel vs plain version, both timed; ``weight`` is how many such
    launches one unit of main-path work makes (0: not on the main path).
    With ``plan_side`` (the plan's patched output) and ``library`` (its CSR
    matrix), the patched output is held against ``torch.sparse.mm`` and the
    library call is timed as the yardstick.  ``plain_max_tiles`` runs the
    plain version by runs of destination blocks
    (:func:`compact_ref_by_row_blocks`); ``n_inner`` and ``reps`` size the
    timing windows of the kernel and the library call (the plain version's
    take one call each, 3 of them, when it runs in pieces)."""
    import functools
    from repro_torch.kernels import spmm_blockell as sk
    from repro_torch.kernels.ref import spmm_blockell_compact_ref

    n = a["s_in"].numel()
    R = a["row_offsets"].numel() - 1
    n_active = a["cols"].numel()
    active = a["node_active"]
    x = torch.randn((n, d), generator=gen, device=dev)
    blocks = a["blocks"] if tiles == "u8" else a["blocks"].to(torch.float32)
    xd = sd = None
    if override:
        xd = torch.randn((n, d), generator=gen, device=dev)
        sd = torch.rand((n,), generator=gen, device=dev)
    args = (a["row_offsets"], a["cols"], blocks, x, a["s_in"], a["s_out"],
            xd, sd)
    kw = dict(bm=BM, bk=BM, add_diag=add_diag)
    plain = functools.partial(spmm_blockell_compact_ref, *args, **kw)
    if plain_max_tiles:
        plain = functools.partial(compact_ref_by_row_blocks, torch, a,
                                  blocks, x, xd, sd, **kw,
                                  max_tiles=plain_max_tiles)
    y = sk.spmm_blockell_compact(*args, **kw)
    ref = plain()
    torch.cuda.synchronize()
    if not torch.isfinite(y[active]).all():
        raise AssertionError(f"kernel output not finite ({name})")
    err = assert_close_scaled(y[active], ref[active], KERNEL_TOL,
                              f"kernel vs plain {name}")
    ref_scale = float(ref[active].abs().max())

    # time the raw launch (no Python checks) and the plain version
    fn = sk._kernel_fn("spmm_blockell_compact")
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

    ms = gpu_ms(launch, n_inner=n_inner, reps=reps)
    plain_ms = (gpu_ms(plain, n_inner=1, reps=3, warmup=1) if plain_max_tiles
                else gpu_ms(plain))
    # what the data needs: inputs read once, outputs written once
    rows_out = int(active.sum())
    nbytes = (blocks.numel() * blocks.element_size() + x.numel() * 4
              + 4 * n * 2 + 4 * (R + 1) + 4 * n_active
              + rows_out * d * 4 + (n * d * 4 + 4 * n if override else 0))
    ops = 2 * nnz * d + 2 * n * d + (2 * n * d if add_diag else 0)
    case = {"kernel": "spmm_blockell_compact", "case": name,
            "max_abs_err": err, "ref_max_abs": ref_scale, "ms": ms,
            "plain_ms": plain_ms, "plain_in_pieces": bool(plain_max_tiles),
            **bound(nbytes, ops),
            "library_ms": None, "ms_over_library": None, "weight": weight}
    if library is not None:
        lib_err = assert_close_scaled(plan_side(x),
                                      torch.sparse.mm(library, x),
                                      KERNEL_TOL,
                                      f"plan vs torch.sparse.mm {name}")
        case["plan_vs_library_err"] = lib_err
        case["library_ms"] = gpu_ms(lambda: torch.sparse.mm(library, x),
                                    n_inner=n_inner, reps=reps)
        case["ms_over_library"] = ms / case["library_ms"]
    print("case " + json.dumps(case))
    return case


def serving_kernel_phase(torch, dev):
    """The compact kernel on the GCN serving plan: its list walk (the main
    path) with the library call for the same aggregation as its
    yardstick, and the tile walk on the same plan's tiles."""
    from repro_torch.exec import build_plan
    from repro_torch.graph import cora_like

    g = cora_like(seed=0)
    plan = build_plan(g, "gcn", bm=BM, backend="cuda", device=dev)
    a = tile_arrays(plan)
    nnz = int(plan.ell.density_stats()["nnz"])
    n_active = a["cols"].numel()
    print(f"serving plan: n={g.num_nodes} R={a['row_offsets'].numel() - 1} "
          f"n_active={n_active} nnz={nnz} "
          f"tile_fill={nnz / (n_active * BM * BM):.4%}")
    a_hat = library_matrix(torch, dev, g, "gcn", transposed=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for d, add_diag, tiles, override in [(64, True, "u8", False),
                                         (16, True, "u8", False),
                                         (64, False, "u8", False),
                                         (16, False, "u8", False),
                                         (64, True, "u8", True),
                                         (64, True, "f32", False)]:
        name = (f"tile walk: serving d={d} add_diag={add_diag} "
                f"tiles={tiles}"
                + (" x_diag/s_in_diag" if override else ""))
        cases.append(compact_case(
            torch, dev, a, nnz, d, add_diag, tiles, override, gen, name))
    # the main path: the plan's list walk, held against the library call
    for d in (64, 16):
        cases.append(list_case(torch, dev, plan, d, gen,
                               f"serving d={d} (lists)", weight=1,
                               library=a_hat))
    return cases


def training_compact_phase(torch, dev, g):
    """The compact kernel at the training shapes: one gcn-cora step's four
    launches (forward d = 16 and 7, transposes at d = 16 and 7) and one GIN
    step's six (forward d = 128 for conv 1, five transposes at d = 128),
    each on the plan's lists (the main path) and on its tiles."""
    from repro_torch.exec import build_plan

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    # (mode, widths, launches a step: forward, transposed)
    for mode, widths, (w_fwd, w_bwd) in (("gcn", (16, 7), (1, 1)),
                                         ("sum", (128,), (1, 5))):
        plan = build_plan(g, mode, bm=BM, backend="cuda", device=dev)
        nnz = int(plan.ell.density_stats()["nnz"])
        print(f"training plan ({mode}): n={g.num_nodes} "
              f"n_active={plan.meta_fwd.n_active} (transposed "
              f"{plan.meta_bwd.n_active}) nnz={nnz}")
        for side, weight, transposed in (("forward", w_fwd, False),
                                         ("transposed", w_bwd, True)):
            a = tile_arrays(plan, transposed)
            lib = library_matrix(torch, dev, g, mode, transposed)
            for d in widths:
                cases.append(list_case(
                    torch, dev, plan, d, gen,
                    f"train {mode} {side} d={d} (lists)", transposed,
                    weight, library=lib))
                cases.append(compact_case(
                    torch, dev, a, nnz, d, plan.add_diag, "u8", False, gen,
                    f"tile walk: train {mode} {side} d={d}"))
    return cases


# (name, plan mode, d_in, d_out, epilogue, bias, relu, add_diag, override,
#  tiles, tolerance, why)
UPDATE_CASES = [
    ("(a) main path: GIN conv, sum 128->128, w_self is w, c = 1 + eps, "
     "bias, ReLU", "sum", 128, 128, "self_coeff", True, True, False, False,
     "u8", 1e-5, "fp32 sums of <= 21 slots x 128 terms, then 128-term "
     "products, in another order"),
    ("(b) gcn add_diag 1433->16, bias, ReLU (d_in chunking)", "gcn", 1433,
     16, "none", True, True, True, False, "u8", 1e-4,
     "sums of 1433-term products after 1433-wide aggregations"),
    ("(c) mean 64->16, separate w_self, no coeff, no ReLU (SAGE's two W)",
     "mean", 64, 16, "two_w", True, False, False, False, "u8", 1e-5,
     "as (a), 64-term products"),
    ("(d) (a) with x_self/x_diag/s_in_diag overrides and f32 tiles", "sum",
     128, 128, "self_coeff", True, True, True, True, "f32", 1e-5,
     "as (a)"),
]


def update_phase(torch, dev, g):
    """``spmm_blockell_update_compact`` against its plain version in the
    four cases above, on the plan's lists (the main path; not (d), whose
    overrides and f32 tiles hold the tile walk) and on its tiles; case
    (a) is the GIN main path (4 launches a step)."""
    from repro_torch.exec import build_plan

    gen = torch.Generator(device=dev).manual_seed(2)
    plans = {}
    cases = []
    for spec in UPDATE_CASES:
        mode = spec[1]
        if mode not in plans:
            plans[mode] = build_plan(g, mode, bm=BM, backend="cuda",
                                     device=dev)
        main = spec[0].startswith("(a)")
        if not spec[8]:                  # overrides: the tile walk alone
            cases.append(update_list_case(torch, dev, g, plans[mode], spec,
                                          gen, weight=4 if main else 0))
        cases.append(update_case(torch, dev, g, plans[mode], spec, gen,
                                 rerun=main))
    return cases


def update_case(torch, dev, g, plan, spec, gen, weight=0, rerun=False):
    """One ``spmm_blockell_update_compact`` case (``spec`` as in
    ``UPDATE_CASES``) on the forward side of ``plan``: kernel vs plain
    version, both timed, beside the two-call yardstick where one matrix
    holds the aggregation (no overrides); ``rerun`` also checks that a
    second launch is bit-identical."""
    from repro_torch.kernels import spmm_blockell as sk
    from repro_torch.kernels.ref import spmm_blockell_update_compact_ref

    (name, mode, d_in, d_out, epi, has_bias, relu, add_diag, override,
     tiles, tol, why) = spec
    n = g.num_nodes
    a = tile_arrays(plan)
    nnz = int(plan.ell.density_stats()["nnz"])
    R = a["row_offsets"].numel() - 1
    n_active = a["cols"].numel()
    active = a["node_active"]
    blocks = (a["blocks"] if tiles == "u8"
              else a["blocks"].to(torch.float32))
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = r(n, d_in)
    w = r(d_in, d_out) / d_in ** 0.5
    b = r(d_out) if has_bias else None
    ws = c = xs = xd = sd = None
    if epi == "two_w":
        ws = r(d_in, d_out) / d_in ** 0.5
    elif epi == "self_coeff":
        ws, c = w, torch.tensor(1.25, device=dev)     # 1 + eps
    if override:
        xs, xd = r(n, d_in), r(n, d_in)
        sd = torch.rand((n,), generator=gen, device=dev)
    args = (a["row_offsets"], a["cols"], blocks, x, a["s_in"],
            a["s_out"], w, b, ws, c, xs, xd, sd)
    kw = dict(bm=BM, bk=BM, add_diag=add_diag, relu=relu)
    y = sk.spmm_blockell_update_compact(*args, **kw)
    ref = spmm_blockell_update_compact_ref(*args, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(y[active]).all():
        raise AssertionError(f"update kernel output not finite {name}")
    err = assert_close_scaled(y[active], ref[active], tol,
                              f"update kernel vs plain {name}")
    ref_scale = float(ref[active].abs().max())
    if rerun:
        again = sk.spmm_blockell_update_compact(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(again[active], y[active]):
            raise AssertionError("update kernel rerun is not "
                                 "bit-identical")

    fn = sk._kernel_fn("spmm_blockell_update_compact")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    xd_, sd_ = (xd, sd) if override else (x, a["s_in"])
    raw = (a["row_offsets"].data_ptr(), a["cols"].data_ptr(),
           blocks.data_ptr(), x.data_ptr(), a["s_in"].data_ptr(),
           a["s_out"].data_ptr(), w.data_ptr(), ptr(b), ptr(ws), ptr(c),
           ptr(xs if xs is not None else (x if ws is not None else None)),
           xd_.data_ptr() if add_diag else None,
           sd_.data_ptr() if add_diag else None, y.data_ptr(),
           int(tiles == "u8"), R, n, n, BM, BM, d_in, d_out,
           int(add_diag), int(relu), stream)

    def launch():
        if fn(*raw):
            raise RuntimeError("launch failed")

    big = d_in > 512
    ms = gpu_ms(launch, n_inner=5 if big else 20)
    plain_ms = gpu_ms(
        lambda: spmm_blockell_update_compact_ref(*args, **kw),
        n_inner=5 if big else 20)
    # the two-call yardstick (three calls for the two-W layer) where one
    # matrix holds the whole aggregation and self term (no overrides)
    composed_ms = composed_err = None
    if not override:
        mat = library_matrix(torch, dev, g, mode, False,
                             None if epi != "self_coeff" else float(c))
        composed = lambda: composed_update(
            torch, mat, x, w, b, relu, ws if epi == "two_w" else None)
        composed_err = assert_close_scaled(
            composed()[active], ref[active], tol,
            f"yardstick vs plain {name}")
        composed_ms = gpu_ms(composed, n_inner=5 if big else 20)
    # what the data needs: each input read once, the output written
    # once; the aggregation's sparse products, the scales, the self
    # term and the dense epilogue product(s) on the written rows
    rows_out = int(active.sum())
    n_w = 2 if epi == "two_w" else 1
    nbytes = (blocks.numel() * blocks.element_size() + 4 * n * d_in
              + 4 * n * 2 + 4 * (R + 1) + 4 * n_active
              + 4 * n_w * d_in * d_out + (4 * d_out if has_bias else 0)
              + (4 if c is not None else 0)
              + (4 * n * d_in if xs is not None else 0)
              + (4 * n * d_in + 4 * n if xd is not None else 0)
              + 4 * rows_out * d_out)
    ops = (2 * nnz * d_in + 2 * n * d_in
           + (2 * n * d_in if add_diag else 0)
           + (2 * n * d_in if ws is not None else 0)
           + 2 * n_w * rows_out * d_in * d_out
           + (rows_out * d_out if has_bias else 0))
    case = {"kernel": "spmm_blockell_update_compact",
            "case": "tile walk: " + name, "tolerance": tol,
            "tolerance_why": why, "max_abs_err": err,
            "ref_max_abs": ref_scale, "ms": ms, "plain_ms": plain_ms,
            **bound(nbytes, ops),
            "library_ms": None, "composed_ms": composed_ms,
            "composed": COMPOSED if composed_ms is not None else None,
            "composed_vs_plain_err": composed_err, "weight": weight}
    print("case " + json.dumps(case))
    return case


LIST_SOURCES = ("spmm_blockell_lists", "spmm_blockell_update_lists")


def list_bytes(torch, lists, d, add_diag, n_src, n_dst) -> int:
    """What a list walk's data needs at width d: the lists (row pointers,
    sources, coefficients, hub rows, order), each x row it gathers (and
    its s_in) once, s_out, the hubs' scratch written and read, and y."""
    nnz = lists.src.numel()
    gathered = torch.zeros(n_src, dtype=torch.bool, device=lists.src.device)
    gathered[lists.src.long()] = True
    if add_diag:
        gathered[:n_dst] = True
    n_x = int(gathered.sum())
    n_hubs = lists.hubs.numel()
    return (4 * (n_dst + 1) + 4 * nnz + (4 * nnz if lists.coef is not None
                                         else 0)
            + 4 * n_hubs + (0 if lists.order is None
                            else 4 * lists.order.numel())
            + n_x * (4 * d + 4) + 4 * n_dst + 2 * 4 * n_hubs * d
            + 4 * n_dst * d)


def list_case(torch, dev, plan, d, gen, name, transposed=False, weight=0,
              library=None, n_inner=20, reps=25):
    """One ``spmm_blockell_compact`` case on the per-row entry lists of a
    list plan (its list walk, ``csrc/spmm_blockell_lists.cu``, is what the
    plan launches): kernel vs ``spmm_blockell_lists_ref``, both timed, a
    rerun bit-identical; the raw entry point (hub pass and walk) is timed.
    With ``library`` (the side's CSR matrix) the plan's output is held
    against ``torch.sparse.mm`` and the library call is timed.  ``weight``
    as in :func:`compact_case`."""
    from repro_torch.kernels import spmm_blockell as sk
    from repro_torch.kernels.ref import spmm_blockell_lists_ref

    a = plan._bwd if transposed else plan._fwd
    lists = sk.Lists.of(a)
    n_src, n_dst = a["s_in"].numel(), a["s_out"].numel()
    add_diag = plan.add_diag
    x = torch.randn((n_src, d), generator=gen, device=dev)
    kw = dict(bm=BM, bk=BM, add_diag=add_diag, lists=lists)

    def walk():
        return sk.spmm_blockell_compact(None, None, None, x, a["s_in"],
                                        a["s_out"], **kw)

    def plain():
        return spmm_blockell_lists_ref(lists.row_ptr, lists.src, lists.coef,
                                       x, a["s_in"], a["s_out"],
                                       add_diag=add_diag)

    y, ref, again = walk(), plain(), walk()
    torch.cuda.synchronize()
    if not torch.isfinite(y).all():
        raise AssertionError(f"list walk output not finite ({name})")
    err = assert_close_scaled(y, ref, KERNEL_TOL,
                              f"list walk vs plain {name}")
    if not torch.equal(again, y):
        raise AssertionError(f"list walk rerun is not bit-identical ({name})")

    fn = sk._kernel_fn("spmm_blockell_lists")
    ptrs, n_hubs, _acc = sk._lists_args(lists, d, order=True)
    diag = ((x.data_ptr(), a["s_in"].data_ptr()) if add_diag
            else (None, None))
    raw = (*ptrs, x.data_ptr(), a["s_in"].data_ptr(), a["s_out"].data_ptr(),
           *diag, y.data_ptr(), n_hubs, n_src, n_dst, d, int(add_diag),
           torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        if fn(*raw):
            raise RuntimeError("launch failed")

    ms = gpu_ms(launch, n_inner=n_inner, reps=reps)
    plain_ms = gpu_ms(plain, n_inner=n_inner, reps=reps)
    nnz = lists.src.numel()
    ops = 2 * nnz * d + 2 * n_dst * d + (2 * n_dst * d if add_diag else 0)
    case = {"kernel": "spmm_blockell_compact", "walk": "lists", "case": name,
            "max_abs_err": err, "ref_max_abs": float(ref.abs().max()),
            "ms": ms, "plain_ms": plain_ms, "hubs": n_hubs,
            **bound(list_bytes(torch, lists, d, add_diag, n_src, n_dst), ops),
            "library_ms": None, "ms_over_library": None, "weight": weight}
    if library is not None:
        apply = plan.raw_apply_t if transposed else plan.raw_apply
        case["plan_vs_library_err"] = assert_close_scaled(
            apply(x), torch.sparse.mm(library, x), KERNEL_TOL,
            f"plan vs torch.sparse.mm {name}")
        case["library_ms"] = gpu_ms(lambda: torch.sparse.mm(library, x),
                                    n_inner=n_inner, reps=reps)
        case["ms_over_library"] = ms / case["library_ms"]
    print("case " + json.dumps(case))
    return case


def update_list_case(torch, dev, g, plan, spec, gen, weight=0):
    """One ``spmm_blockell_update_compact`` case (``spec`` as in
    ``UPDATE_CASES``, its tiles entry unread) on the forward lists of a
    list plan (``csrc/spmm_blockell_update_lists.cu``): kernel vs
    ``spmm_blockell_update_lists_ref``, both timed, a rerun bit-identical,
    beside the two-call yardstick where one matrix holds the aggregation
    (no overrides)."""
    from repro_torch.kernels import spmm_blockell as sk
    from repro_torch.kernels.ref import spmm_blockell_update_lists_ref

    (name, mode, d_in, d_out, epi, has_bias, relu, add_diag, override,
     _tiles, tol, why) = spec
    a = plan._fwd
    lists = sk.Lists.of(a)
    n_src, n_dst = a["s_in"].numel(), a["s_out"].numel()
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = r(n_src, d_in)
    w = r(d_in, d_out) / d_in ** 0.5
    b = r(d_out) if has_bias else None
    ws = c = xs = xd = sd = None
    if epi == "two_w":
        ws = r(d_in, d_out) / d_in ** 0.5
    elif epi == "self_coeff":
        ws, c = w, torch.tensor(1.25, device=dev)     # 1 + eps
    if override:
        xs, xd = r(n_dst, d_in), r(n_dst, d_in)
        sd = torch.rand((n_dst,), generator=gen, device=dev)
    args = (x, a["s_in"], a["s_out"], w, b, ws, c, xs, xd, sd)

    def walk():
        return sk.spmm_blockell_update_compact(
            None, None, None, *args, bm=BM, bk=BM, add_diag=add_diag,
            relu=relu, lists=lists)

    def plain():
        return spmm_blockell_update_lists_ref(
            lists.row_ptr, lists.src, lists.coef, *args, add_diag=add_diag,
            relu=relu)

    y, ref, again = walk(), plain(), walk()
    torch.cuda.synchronize()
    if not torch.isfinite(y).all():
        raise AssertionError(f"update list walk output not finite {name}")
    err = assert_close_scaled(y, ref, tol, f"update list walk vs plain {name}")
    if not torch.equal(again, y):
        raise AssertionError(f"update list walk rerun is not bit-identical "
                             f"({name})")

    fn = sk._kernel_fn("spmm_blockell_update_lists")
    ptrs, n_hubs, _acc = sk._lists_args(lists, d_in, order=False)
    ptr = lambda t: None if t is None else t.data_ptr()
    xs_ = xs if xs is not None else (x if ws is not None else None)
    xd_, sd_ = (xd, sd) if override else (x, a["s_in"])
    raw = (*ptrs, x.data_ptr(), a["s_in"].data_ptr(), a["s_out"].data_ptr(),
           w.data_ptr(), ptr(b), ptr(ws), ptr(c), ptr(xs_),
           xd_.data_ptr() if add_diag else None,
           sd_.data_ptr() if add_diag else None, y.data_ptr(), n_hubs,
           n_src, n_dst, d_in, d_out, int(add_diag), int(relu),
           torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        if fn(*raw):
            raise RuntimeError("launch failed")

    big = d_in > 512
    ms = gpu_ms(launch, n_inner=5 if big else 20)
    plain_ms = gpu_ms(plain, n_inner=5 if big else 20)
    composed_ms = composed_err = None
    if not override:
        mat = library_matrix(torch, dev, g, mode, False,
                             None if epi != "self_coeff" else float(c))
        composed = lambda: composed_update(
            torch, mat, x, w, b, relu, ws if epi == "two_w" else None)
        composed_err = assert_close_scaled(composed(), ref, tol,
                                           f"yardstick vs plain {name}")
        composed_ms = gpu_ms(composed, n_inner=5 if big else 20)
    # the aggregation's bytes (list_bytes at d_in, less its y), W, bias,
    # c and the self rows read once, the output written once
    n_w = 2 if epi == "two_w" else 1
    nbytes = (list_bytes(torch, lists, d_in, add_diag, n_src, n_dst)
              - 4 * n_dst * d_in + 4 * n_w * d_in * d_out
              + (4 * d_out if has_bias else 0) + (4 if c is not None else 0)
              + (4 * n_dst * d_in if ws is not None else 0)
              + (4 * n_dst * d_in + 4 * n_dst if xd is not None else 0)
              + 4 * n_dst * d_out)
    nnz = lists.src.numel()
    ops = (2 * nnz * d_in + 2 * n_dst * d_in
           + (2 * n_dst * d_in if add_diag else 0)
           + (2 * n_dst * d_in if ws is not None else 0)
           + 2 * n_w * n_dst * d_in * d_out
           + (n_dst * d_out if has_bias else 0))
    case = {"kernel": "spmm_blockell_update_compact", "walk": "lists",
            "case": name, "tolerance": tol, "tolerance_why": why,
            "max_abs_err": err, "ref_max_abs": float(ref.abs().max()),
            "ms": ms, "plain_ms": plain_ms, "hubs": n_hubs,
            **bound(nbytes, ops), "library_ms": None,
            "composed_ms": composed_ms,
            "composed": COMPOSED if composed_ms is not None else None,
            "composed_vs_plain_err": composed_err, "weight": weight}
    print("case " + json.dumps(case))
    return case


def bucket_tile_phase(torch, dev, g):
    """Both compact kernels at the bucketed candidates' hub tiles (bm 256
    and 512), with the destination operands gathered into bucket order as
    the bucketed plans pass them; held against their plain versions."""
    from repro_torch.exec import build_plan
    from repro_torch.kernels import spmm_blockell as sk
    from repro_torch.kernels.ref import (spmm_blockell_compact_ref,
                                         spmm_blockell_update_compact_ref)

    gen = torch.Generator(device=dev).manual_seed(4)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    compact, update = [], []
    for hub in (256, 512):
        plan = build_plan(g, "gcn", backend="cuda", buckets=f"128@7+{hub}",
                          device=dev)
        a = plan._fwd
        ab = a["buckets"][1]                      # the hub bucket
        n_dst = ab["s_out_sel"].numel()
        x = r(g.num_nodes, 48)
        args = (ab["row_offsets"], ab["cols"], ab["blocks"], x, a["s_in"],
                ab["s_out_sel"], x[ab["idx"]], ab["s_in_diag"])
        kw = dict(bm=hub, bk=hub, add_diag=True)
        y = sk.spmm_blockell_compact(*args, **kw)
        ref = spmm_blockell_compact_ref(*args, **kw)
        torch.cuda.synchronize()
        written = torch.repeat_interleave(
            torch.diff(ab["row_offsets"].long()) > 0, hub)[:n_dst]
        name = f"bucket hub bm={hub} d=48 x_diag/s_in_diag"
        err = assert_close_scaled(y[written], ref[written], KERNEL_TOL,
                                  f"kernel vs plain {name}")
        compact.append({"kernel": "spmm_blockell_compact", "case": name,
                        "max_abs_err": err,
                        "ms": gpu_ms(lambda: sk.spmm_blockell_compact(
                            *args, **kw)),
                        "plain_ms": gpu_ms(lambda: spmm_blockell_compact_ref(
                            *args, **kw)), "weight": 0})
        x = r(g.num_nodes, 128)
        w = r(128, 128) / 128 ** 0.5
        c = torch.tensor(1.25, device=dev)
        xg = x[ab["idx"]]
        uargs = (ab["row_offsets"], ab["cols"], ab["blocks"], x, a["s_in"],
                 ab["s_out_sel"], w, r(128), w, c, xg, xg, ab["s_in_diag"])
        ukw = dict(bm=hub, bk=hub, add_diag=True, relu=True)
        y = sk.spmm_blockell_update_compact(*uargs, **ukw)
        ref = spmm_blockell_update_compact_ref(*uargs, **ukw)
        torch.cuda.synchronize()
        name = (f"bucket hub bm={hub} 128->128 w_self is w, c, bias, ReLU, "
                "x_self/x_diag/s_in_diag")
        err = assert_close_scaled(y[written], ref[written], KERNEL_TOL,
                                  f"update kernel vs plain {name}")
        update.append({"kernel": "spmm_blockell_update_compact",
                       "case": name, "max_abs_err": err,
                       "ms": gpu_ms(lambda: sk.spmm_blockell_update_compact(
                           *uargs, **ukw)),
                       "plain_ms": gpu_ms(
                           lambda: spmm_blockell_update_compact_ref(
                               *uargs, **ukw)), "weight": 0})
        for case in (compact[-1], update[-1]):
            print("case " + json.dumps(case))
    return compact, update


def padded_case(torch, dev, kernel, a, nnz, n_active, d, gen, name, *,
                bm, weight, add_diag=False, plan_side=None, library=None,
                update=None, composed=None, tol=None):
    """One padded-kernel case on the side arrays ``a`` of a padded plan:
    the kernel (raw launch, no Python checks) and its plain version, timed,
    held to each other on every row (the padded kernels write them all).
    ``kernel`` is spmm_blockell (y = A x), spmm_blockell_fused or, with
    ``update = (w, bias, w_self, coeff, relu)``, spmm_blockell_update.
    With ``plan_side`` and ``library`` the plan's output is held against
    ``torch.sparse.mm`` and the library call is timed; with ``composed``
    (a :func:`library_matrix`) the update kernel's two-call yardstick.
    ``tol`` is the bar against the plain version (default 1e-5, 1e-4 past
    d = 512, where the update kernels sum 1433-term products)."""
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels import spmm_blockell as sk

    n = a["s_in"].numel()
    cols, blocks = a["block_cols"], a["blocks"]
    R, W = cols.shape
    x = torch.randn((n, d), generator=gen, device=dev)
    fn = sk._kernel_fn(kernel)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    u8 = int(blocks.dtype == torch.uint8)
    if kernel == "spmm_blockell":
        args, kw = (cols, blocks, x), dict(bm=bm, bk=bm, n_dst=n)
        d_out = d
        y = torch.empty((n, d), device=dev)
        raw = (cols.data_ptr(), blocks.data_ptr(), x.data_ptr(),
               y.data_ptr(), u8, R, W, n, n, bm, bm, d, stream)
        ref_fn = plain.spmm_blockell_ref
    elif kernel == "spmm_blockell_fused":
        args = (cols, blocks, x, a["s_in"], a["s_out"])
        kw = dict(bm=bm, bk=bm, add_diag=add_diag)
        d_out = d
        y = torch.empty((n, d), device=dev)
        raw = (cols.data_ptr(), blocks.data_ptr(), x.data_ptr(),
               a["s_in"].data_ptr(), a["s_out"].data_ptr(), y.data_ptr(), u8,
               R, W, n, n, bm, bm, d, int(add_diag), stream)
        ref_fn = plain.spmm_blockell_fused_ref
    else:
        w, b, ws, c, relu = update
        args = (cols, blocks, x, a["s_in"], a["s_out"], w, b, ws, c)
        kw = dict(bm=bm, bk=bm, add_diag=add_diag, relu=relu)
        d_out = w.shape[1]
        y = torch.empty((n, d_out), device=dev)
        raw = (cols.data_ptr(), blocks.data_ptr(), x.data_ptr(),
               a["s_in"].data_ptr(), a["s_out"].data_ptr(), w.data_ptr(),
               ptr(b), ptr(ws), ptr(c), y.data_ptr(), u8, R, W, n, n, bm, bm,
               d, d_out, int(add_diag), int(relu), stream)
        ref_fn = plain.spmm_blockell_update_ref
    got = getattr(sk, kernel)(*args, **kw)
    ref = ref_fn(*args, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{kernel} output not finite ({name})")
    if tol is None:
        tol = 1e-4 if d > 512 else KERNEL_TOL
    err = assert_close_scaled(got, ref, tol, f"{kernel} vs plain {name}")

    def launch():
        if fn(*raw):
            raise RuntimeError(f"{kernel} launch failed")

    # no atomics: a second run is bit-identical
    if not torch.equal(getattr(sk, kernel)(*args, **kw), got):
        raise AssertionError(f"{kernel} rerun is not bit-identical ({name})")
    big = d > 512
    ms = gpu_ms(launch, n_inner=5 if big else 20)
    plain_ms = gpu_ms(lambda: ref_fn(*args, **kw), n_inner=5 if big else 20)
    # what the data needs: the active tiles, the slot table, x, the scales
    # and the output, each moved once; the edges' products, the scales and
    # self term, and the dense epilogue product on every row
    tile_bytes = n_active * bm * bm * blocks.element_size()
    nbytes = (tile_bytes + 4 * R * W + 4 * n * d + 4 * n * d_out
              + (0 if kernel == "spmm_blockell" else 8 * n))
    ops = 2 * nnz * d
    if kernel != "spmm_blockell":
        ops += 2 * n * d + (2 * n * d if add_diag else 0)
    if update is not None:
        w, b, ws, c, relu = update
        n_w = 1 if ws is None or ws is w else 2
        nbytes += 4 * n_w * d * d_out + (4 * d_out if b is not None else 0)
        ops += (2 * n_w * n * d * d_out + (2 * n * d if ws is not None else 0)
                + (n * d_out if b is not None else 0))
    case = {"kernel": kernel, "case": name, "max_abs_err": err,
            "ref_max_abs": float(ref.abs().max()), "tolerance": tol,
            "ms": ms, "plain_ms": plain_ms, **bound(nbytes, ops),
            "library_ms": None, "ms_over_library": None, "weight": weight}
    if composed is not None:
        w, b, ws, c, relu = update
        fn2 = lambda: composed_update(torch, composed, x, w, b, relu)
        case["composed"] = COMPOSED
        case["composed_vs_plain_err"] = assert_close_scaled(
            fn2(), ref, tol, f"two-call yardstick vs plain {name}")
        case["composed_ms"] = gpu_ms(fn2, n_inner=5 if big else 20)
    if library is not None:
        side = plan_side(x) if plan_side is not None else got
        case["plan_vs_library_err"] = assert_close_scaled(
            side, torch.sparse.mm(library, x), KERNEL_TOL,
            f"{name} vs torch.sparse.mm")
        case["library_ms"] = gpu_ms(lambda: torch.sparse.mm(library, x))
        case["ms_over_library"] = ms / case["library_ms"]
    print("case " + json.dumps(case))
    return case


def padded_phase(torch, dev, g):
    """The padded kernels at the shapes the padded candidates of the
    autotune race give them on the reordered Cora: ``spmm_blockell_fused``
    on gcn-cora's padded plan (forward d = 16 and 7, both transposes; one
    padded gcn-cora step's four launches) and at bm 256; ``spmm_blockell``
    on the same ELL at d = 64 (``torch.sparse.mm`` of the bare adjacency as
    its yardstick); ``spmm_blockell_update`` on the GIN conv at bm 128 and
    once at d_in = 1433 (gcn 1433 -> 16)."""
    from repro_torch.exec import build_plan

    gen = torch.Generator(device=dev).manual_seed(5)
    fused, spmm, update = [], [], []
    for bm in (BM, 256):
        plan = build_plan(g, "gcn", bm=bm, backend="cuda", compact=False,
                          device=dev)
        ell, ell_t = plan.ell, plan.ell_t
        nnz = int(ell.density_stats()["nnz"])
        print(f"padded plan (gcn, bm={bm}): R={ell.n_row_blocks} "
              f"W={ell.width} slots={ell.n_row_blocks * ell.width} "
              f"active={ell.n_active} (transposed W={ell_t.width}, active "
              f"{ell_t.n_active}) tile MB="
              f"{plan._fwd['blocks'].numel() / 1e6:.2f}")
        sides = (("forward", plan._fwd, ell, plan.raw_apply, False),
                 ("transposed", plan._bwd, ell_t, plan.raw_apply_t, True))
        for side, a, e, apply, transposed in sides:
            lib = library_matrix(torch, dev, g, "gcn", transposed)
            for d in ((16, 7) if bm == BM else (16,)):
                fused.append(padded_case(
                    torch, dev, "spmm_blockell_fused", a, nnz, e.n_active, d,
                    gen, f"gcn padded bm={bm} {side} d={d}", bm=bm,
                    weight=int(bm == BM), add_diag=True, plan_side=apply,
                    library=lib))
        if bm == BM:
            spmm.append(padded_case(
                torch, dev, "spmm_blockell", plan._fwd, nnz, ell.n_active,
                64, gen, f"y = A x padded bm={bm} d=64", bm=bm, weight=1,
                library=library_matrix(torch, dev, g, "sum", False)))
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    for mode, d_in, d_out, epi, weight in (("sum", 128, 128, "self_coeff", 1),
                                          ("gcn", 1433, 16, "none", 0)):
        plan = build_plan(g, mode, bm=BM, backend="cuda", compact=False,
                          device=dev)
        nnz = int(plan.ell.density_stats()["nnz"])
        w = r(d_in, d_out) / d_in ** 0.5
        ws, c = ((w, torch.tensor(1.25, device=dev)) if epi == "self_coeff"
                 else (None, None))
        name = (f"{mode} padded bm={BM} {d_in}->{d_out}"
                + (", w_self is w, c = 1 + eps" if ws is not None else "")
                + ", bias, ReLU")
        update.append(padded_case(
            torch, dev, "spmm_blockell_update", plan._fwd, nnz,
            plan.ell.n_active, d_in, gen, name, bm=BM, weight=weight,
            add_diag=plan.add_diag, update=(w, r(d_out), ws, c, True),
            composed=library_matrix(torch, dev, g, mode, False,
                                    None if c is None else float(c))))
    return spmm, fused, update


# ---------------------------------------------------------------------------
# main-path phases
# ---------------------------------------------------------------------------
def serving_phase(torch):
    from repro_torch.launch import serve

    argv = ["--graph", "cora", "--model", "gcn", "--requests", "200",
            "--cache-kb", "500", "--warm", "reorder", "--device", "cuda"]
    reset_launches()
    rep = serve.main(argv)
    launches = read_launches(torch)
    print(f"serving: launches={launches} max_oracle_err="
          f"{rep.max_oracle_err:.3e} hit_rate={rep.hit_rate:.3f} "
          f"p50={rep.p50_ms:.3f}ms p99={rep.p99_ms:.3f}ms "
          f"req/s={rep.req_per_s:.1f}")
    if rep.max_oracle_err >= ORACLE_TOL:
        raise AssertionError(f"oracle max_err {rep.max_oracle_err} >= "
                             f"{ORACLE_TOL}")
    if rep.num_requests != 200:
        raise AssertionError(f"served {rep.num_requests} of 200 requests")
    if launches["spmm_blockell_compact"] < 2:
        raise AssertionError(f"spmm_blockell_compact launched "
                             f"{launches['spmm_blockell_compact']} times on "
                             "the serving path; expected >= 2 (one per GCN "
                             "layer)")
    return launches


def check_curve(losses, what):
    import math
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: last loss {losses[-1]} is not below "
                             f"the first {losses[0]}")


def leaf_copy(tree):
    from repro_torch.train import tree_map
    return tree_map(lambda t: t.detach().clone().requires_grad_(), tree)


def hold_against_plain(torch, what, make, loss_tol_steps, grad_tol,
                       loss_tol, backends=("cuda", "torch")):
    """Step 0's loss and gradients, then ``COMPARE_STEPS`` losses of ``fit``,
    on the kernel backend against the plain backend from the same params
    (or on ``backends[0]`` against ``backends[1]``, e.g. two executors).
    ``make(backend) -> (loss_fn, params, batch)``.  Losses of the first
    ``loss_tol_steps`` steps are held to ``loss_tol`` (relative)."""
    from repro_torch.train import adam, fit, tree_leaves

    out = {}
    for backend in backends:
        loss_fn, params, batch = make(backend)
        p0 = leaf_copy(params)
        loss = loss_fn(p0, batch)
        loss.backward()
        res = fit(loss_fn, adam(1e-2), params, iter(lambda: batch, None),
                  steps=COMPARE_STEPS, clip_norm=1.0, log=lambda s: None)
        out[backend] = (loss.detach(), [p.grad for p in tree_leaves(p0)],
                        res.losses)
    (l_k, g_k, c_k), (l_p, g_p, c_p) = (out[b] for b in backends)
    loss0_err = assert_close_scaled(l_k, l_p, grad_tol, f"{what} step-0 loss")
    grad_err = max(assert_close_scaled(a, b, grad_tol, f"{what} grad {i}")
                   for i, (a, b) in enumerate(zip(g_k, g_p)))
    rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(c_k, c_p)]
    if max(rel[:loss_tol_steps]) > loss_tol:
        raise AssertionError(f"{what}: losses of steps 0-"
                             f"{loss_tol_steps - 1} differ by "
                             f"{max(rel[:loss_tol_steps]):.3e} > {loss_tol} "
                             f"(kernel {c_k}, plain {c_p})")
    report = {"step0_loss_err": loss0_err, "step0_grad_err": grad_err,
              "loss_rel_err": rel, "kernel_losses": c_k, "plain_losses": c_p}
    print(f"{what} ({backends[0]} vs {backends[1]}): " + json.dumps(report))
    return report


def step_breakdown(torch, what, step_fn, params, state, batch, warmup=3,
                   timed=10, n_prof=3, watch=None, kinds=None):
    """Median ms per training step (CUDA events around ``step_fn``, ``timed``
    steps after ``warmup`` steps), then ``torch.profiler`` over ``n_prof``
    more: the device time per step summed over the kernels the profiler
    saw, the busy share it makes of the step, the five kernels that take
    most, and for each ``watch`` label the device time per step of the
    kernels whose name holds its substring (any case).  ``kinds``, an
    ordered list of (label, substrings), puts each kernel in the first kind
    one of whose substrings its name holds ("other" if none) and reports
    the device time per step of each kind.  ``step_fn(params, state,
    batch) -> (params, state, loss)`` as ``make_train_step`` builds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p = params
    times, losses = [], []
    for i in range(warmup + timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p, state, loss = step_fn(p, state, batch)
        end.record()
        end.synchronize()
        losses.append(float(loss))
        if i >= warmup:                 # the first steps warm the allocator
            times.append(start.elapsed_time(end))
    step_ms = statistics.median(times)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            p, state, _ = step_fn(p, state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n_prof
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    report = {"step_ms": step_ms, "step_ms_all": times, "losses": losses,
              "device_ms_per_step": device_ms,
              "busy_share": device_ms / step_ms if device_ms else None,
              "top_kernels_ms_per_step": [
                  [e.key[:60], e.self_device_time_total / 1e3 / n_prof,
                   e.count // n_prof] for e in top]}
    for label, part in (watch or {}).items():
        report[f"{label}_ms_per_step"] = sum(
            e.self_device_time_total for e in kernels
            if part.lower() in e.key.lower()) / 1e3 / n_prof
    if kinds:
        by_kind = {label: 0.0 for label, _ in kinds}
        by_kind["other"] = 0.0
        for e in kernels:
            name = e.key.lower()
            label = next((lb for lb, parts in kinds
                          if any(p in name for p in parts)), "other")
            by_kind[label] += e.self_device_time_total / 1e3 / n_prof
        report["device_ms_by_kind"] = by_kind
    if not device_ms:
        print(f"{what}: the profiler saw no device time; busy share not "
              "measured")
    print(f"{what} step breakdown: " + json.dumps(report))
    return report


@contextlib.contextmanager
def tuning_cache():
    """A fresh, empty autotune cache for the launcher (removed after)."""
    old = os.environ.get("REPRO_TORCH_EXEC_CACHE")
    with tempfile.TemporaryDirectory(prefix="exec-cache-") as d:
        os.environ["REPRO_TORCH_EXEC_CACHE"] = d
        try:
            yield d
        finally:
            if old is None:
                os.environ.pop("REPRO_TORCH_EXEC_CACHE", None)
            else:
                os.environ["REPRO_TORCH_EXEC_CACHE"] = old


def run_launcher(argv):
    """``launch.train.main(argv)`` with its standard output captured and
    echoed; returns (result, printed lines, wall seconds)."""
    from repro_torch.launch import train
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = train.main(argv)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="")
    return res, out.splitlines(), wall


def schedule_of(lines):
    return [l for l in lines if l.startswith("layer ")]


def plain_schedule(configs):
    """The same schedule on the plain backend: ``cuda`` read as ``torch``,
    which never fuses; ``coo`` stays ``coo``."""
    out = []
    for c in configs:
        c = list(c)
        if c[2] == "cuda":
            c[1], c[2] = False, "torch"
        out.append(tuple(c))
    return out


def step_launches(fplan):
    """Kernel launches one training step of a forward plan's ``cuda`` layers
    needs: each layer's forward, and one transpose aggregation in its
    backward, except the first layer in unfused aggregate-first order (its
    dW reuses the forward's aggregation and the features take no gradient).
    A bucketed side launches once per bucket with active slots."""
    from repro_torch.exec.plan import BucketedSideMeta

    def side(meta, fused):
        if isinstance(meta, BucketedSideMeta):
            return (("spmm_blockell_update_compact" if fused
                     else "spmm_blockell_compact"),
                    sum(1 for b in meta.buckets if b.n_rows and b.n_active))
        if fused:
            return ("spmm_blockell_update_compact" if meta.compact
                    else "spmm_blockell_update"), 1
        return ("spmm_blockell_compact" if meta.compact
                else "spmm_blockell_fused"), int(bool(meta.n_active))

    out = dict.fromkeys(KERNELS, 0)
    for i, lp in enumerate(fplan):
        if lp.backend != "cuda":
            continue
        k, n = side(lp.gplan.meta_fwd, lp.fuse)
        out[k] += n
        if not (i == 0 and lp.order == "aggregate_first" and not lp.fuse):
            k, n = side(lp.gplan.meta_bwd, False)
            out[k] += n
    return out


def check_step_launches(launches, fplan, steps, what):
    """The launches of ``steps`` training steps are exactly what the
    schedule's ``cuda`` layers need (:func:`step_launches`)."""
    want = {k: v * steps for k, v in step_launches(fplan).items()}
    if launches != want:
        raise AssertionError(f"{what}: launched {launches} in {steps} "
                             f"steps; the schedule {list(fplan.configs)} "
                             f"needs {want}")


def gcn_make(g, bundle, dims, specs, batch, configs, dev):
    """``make(backend)`` for :func:`hold_against_plain`: gcn-cora on
    ``configs`` (``cuda``), or on the same schedule's plain version."""
    import torch
    from repro_torch.exec import build_forward_plan

    def make(backend):
        cfgs = configs if backend == "cuda" else plain_schedule(configs)
        plans = build_forward_plan(g, specs, cfgs, device=dev)
        params = bundle.init_params(torch.Generator().manual_seed(0),
                                    dims[0], device=dev)
        return (bundle.loss_fn("full_graph_sm", executor="fused",
                               exec_plan=plans), params, batch)
    return make


def trials_counted():
    from repro_torch import obs
    return obs.counter("exec.autotune.trials").value


def gcn_autotune_phase(torch, dev, g):
    """The reference's default training path on the card: the launcher at
    ``--executor auto`` on a fresh cache tunes every layer over the card's
    grid (compact, padded and bucketed plans, fused and unfused, both
    orders, bm 128/256/512, coo), races the schedules whole-chain and trains
    the winner 20 steps.  Checks, in order: every candidate of every layer
    was measured (a missing one is rebuilt and run outside any ``try``);
    the padded and compact kernels launched while tuning; the winner's
    training against the same schedule on the plain backend (step 0 within
    1e-5, 10 losses within 1e-4 relative: fp32 sums over up to 1433 terms in
    another order, through 10 Adam steps); a rerun reads the cache, runs no
    trial, and launches exactly what the winner's ``cuda`` layers need each
    step (forward and transpose); ``--executor fused`` on a fresh cache gives
    the cold DP's schedule, launches its 4 compact kernels a step, and holds
    against its plain version to the same limits."""
    import importlib
    from repro_torch import obs
    from repro_torch.configs import get
    from repro_torch.exec import (bucket_layer_candidates,
                                  build_forward_plan, default_layer_candidates,
                                  gcn_chain, plan_forward)
    from repro_torch.exec.forward import autotune_forward
    from repro_torch.launch.train import gnn_batch
    from repro_torch.train import adam, make_train_step
    at = importlib.import_module("repro_torch.exec.autotune")

    bundle = get("gcn-cora").bundle()
    dims = [g.node_feat.shape[1], *bundle.model_kw["hidden"],
            bundle.n_classes]
    specs = gcn_chain(dims)
    argv = ["--arch", "gcn-cora", "--steps", str(TRAIN_STEPS)]
    obs.enable()
    report = {}
    with tuning_cache():
        reset_launches()
        trials0 = trials_counted()
        res, lines, wall = run_launcher(argv)
        launches = read_launches(torch)
        report["tuning_trials"] = trials_counted() - trials0
        report["launcher_wall_s"] = wall
        check_curve(res.losses, "gcn-cora (autotuned)")
        _, rec = autotune_forward(g, specs, device=dev)     # cached
        if not rec.from_cache:
            raise AssertionError("the launcher's forward verdict was not "
                                 "cached")
        print("raced schedules: " + json.dumps(
            {"table_us": dict(rec.table), "winner": rec.source,
             "schedules": {lab: [list(c) for c in cfgs]
                           for lab, cfgs in rec.schedules}}))
        tables = []
        for i, s in enumerate(specs):
            cands = (default_layer_candidates("cuda", s.d_in, s.d_out)
                     + bucket_layer_candidates(g, "cuda", s.d_in, s.d_out))
            lrec = at.autotune_layer(g, s.d_in, s.d_out, s.mode,
                                     relu=s.relu, bias=s.bias,
                                     candidates=cands, device=dev)
            table = {json.dumps(list(r[:-1])): r[-1] for r in lrec.table}
            print(f"layer {i} trial table (us, fwd+bwd): "
                  + json.dumps(table))
            tables.append({"layer": i, "spec": s.sig,
                           "winner": list(lrec.as_config().values()),
                           "from_cache": lrec.from_cache, "table_us": table})
            if not lrec.from_cache:
                raise AssertionError(f"layer {i}: the launcher's trial "
                                     "table was not cached")
            measured = {tuple(r[:-1]) for r in lrec.table}
            for cand in cands:
                if tuple(cand) in measured:
                    continue
                # the race hid this candidate's failure: run it here, with
                # no try around it, so its error surfaces
                order, fuse, backend, bm, compact, sig = \
                    at.split_layer_cand(cand)
                gp = at.build_plan(g, s.mode, bm=bm, backend=backend,
                                   compact=compact, buckets=sig, device=dev)
                lp = at.build_layer_plan(g, s.mode, d_in=s.d_in,
                                         d_out=s.d_out, order=order,
                                         fuse=fuse, gplan=gp)
                x = torch.randn(g.num_nodes, s.d_in, device=dev)
                w = torch.randn(s.d_in, s.d_out, device=dev)
                at.fwd_bwd(lambda x, w: lp.apply(x, w, relu=s.relu), x, w)
                torch.cuda.synchronize()
                raise AssertionError(f"layer {i}: candidate {cand} has no "
                                     "row in the trial table")
        report["layer_tables"] = tables
        report["verdict"] = {"source": rec.source, "us": rec.us,
                             "configs": [list(c) for c in rec.configs],
                             "table_us": dict(rec.table)}
        for k in ("spmm_blockell_fused", "spmm_blockell_update",
                  "spmm_blockell_compact", "spmm_blockell_update_compact"):
            if not launches[k]:
                raise AssertionError(f"{k} never launched while tuning")
        print(f"gcn-cora autotune: launches={launches} "
              f"trials={report['tuning_trials']} wall={wall:.2f}s; "
              f"losses {res.losses}")

        # the winner against the same schedule on the plain backend
        batch = gnn_batch(g, bundle.n_classes, dev)
        make = gcn_make(g, bundle, dims, specs, batch, rec.configs, dev)
        report["hold"] = hold_against_plain(torch, "gcn-cora (autotuned)",
                                            make, COMPARE_STEPS,
                                            grad_tol=1e-5, loss_tol=1e-4)
        loss_fn, params, _ = make("cuda")
        report["breakdown"] = step_breakdown(
            torch, "gcn-cora (autotuned)",
            make_train_step(loss_fn, adam(1e-2), 1.0), params,
            adam(1e-2).init(params), batch)

        # the rerun reads the cache: no trial, the same schedule
        reset_launches()
        trials0 = trials_counted()
        res2, lines2, wall2 = run_launcher(argv)
        train_launches = read_launches(torch)
        if trials_counted() != trials0:
            raise AssertionError("the cached rerun ran "
                                 f"{trials_counted() - trials0} trials")
        if not any("(cached)" in l for l in lines2):
            raise AssertionError("the rerun did not print (cached)")
        if schedule_of(lines2) != schedule_of(lines):
            raise AssertionError("the cached rerun changed the schedule")
        rel = max(abs(a - b) / max(abs(b), 1e-12)
                  for a, b in zip(res2.losses, res.losses))
        if rel > 1e-4:      # coo's index_add_ sums in another order per run
            raise AssertionError(f"the cached rerun's losses part by {rel}")
        report["cached_wall_s"] = wall2
        report["cached_launches"] = train_launches
        print(f"gcn-cora cached rerun: launches={train_launches} "
              f"wall={wall2:.2f}s")
        check_step_launches(train_launches,
                            build_forward_plan(g, specs, rec.configs,
                                               device=dev),
                            TRAIN_STEPS, "gcn-cora cached rerun")

    # --executor fused: the cold DP, no measuring
    with tuning_cache():
        reset_launches()
        res3, lines3, _ = run_launcher(argv + ["--executor", "fused"])
        fused_launches = read_launches(torch)
        check_curve(res3.losses, "gcn-cora (--executor fused)")
        cold = [f"layer {i} ({s.d_in}->{s.d_out}): order=update_first "
                "fuse=False cuda bm=128 compact=True"
                for i, s in enumerate(specs)]
        if schedule_of(lines3) != cold:
            raise AssertionError(f"--executor fused cold schedule "
                                 f"{schedule_of(lines3)} != {cold}")
        cold_plan = plan_forward(g, specs, device=dev)
        print(f"gcn-cora --executor fused: launches={fused_launches} "
              f"(expected 4 compact a step)")
        check_step_launches(fused_launches, cold_plan, TRAIN_STEPS,
                            "gcn-cora --executor fused")
        if fused_launches["spmm_blockell_compact"] != 4 * TRAIN_STEPS:
            raise AssertionError("--executor fused launched the compact "
                                 f"kernel {fused_launches} times; expected "
                                 f"{4 * TRAIN_STEPS}")
        report["fused_hold"] = hold_against_plain(
            torch, "gcn-cora (--executor fused)",
            gcn_make(g, bundle, dims, specs, batch, cold_plan.configs, dev),
            COMPARE_STEPS, grad_tol=1e-5, loss_tol=1e-4)
    return launches, fused_launches, res.losses, report


def gin_training_phase(torch, dev, g):
    """GIN at its paper width on the port's cold ``plan_forward`` schedule
    (a fresh tuning cache): conv 1 update-first compact, convs 2-5 fused
    compact, so per step 4 ``spmm_blockell_update_compact`` (convs 2-5
    forward) and 6 ``spmm_blockell_compact`` (conv 1 forward, 5
    transposes).  Held against the unfused plain backend: step 0's loss and
    every gradient (ε's included) within 1e-4 of the largest entry (sums of
    up to 1433 terms through 5 convs and a 2-layer head), and the losses of
    steps 0-4 within a relative 1e-3.  Later steps are printed, not held:
    the run is chaotic (its loss jumps from ~40 to ~2000 on step 1), and
    even the reference's own executors part by more than 1e-3 within 5
    steps (``tests/test_torch_gin.py``)."""
    from repro_torch.exec import build_forward_plan, gin_chain, plan_forward
    from repro_torch.launch.train import gnn_batch
    from repro_torch.models.sage_gin import gin_init, gin_loss
    from repro_torch.train import adam, fit, make_train_step

    batch = gnn_batch(g, 7, dev)
    specs = gin_chain(g.node_feat.shape[1], 128, 5)
    with tuning_cache():
        cold = plan_forward(g, specs, device=dev)
    expected = ([("update_first", False, "cuda", 128, True)]
                + [("aggregate_first", True, "cuda", 128, True)] * 4)
    print(f"GIN schedule (cold plan_forward): {list(cold.configs)}")
    if list(cold.configs) != expected:
        raise AssertionError(f"unexpected GIN schedule {cold.configs}")

    def make(backend):
        configs = (cold.configs if backend == "cuda"
                   else plain_schedule(cold.configs))
        plans = build_forward_plan(g, specs, configs, device=dev)

        def loss_fn(p, b):
            return gin_loss(p, b["x"], None, b["labels"], b["train_mask"],
                            executor="fused", plan=plans)
        params = gin_init(torch.Generator().manual_seed(0),
                          specs[0].d_in, 128, 5, 7, device=dev)
        return loss_fn, params, plans

    loss_fn, params, _ = make("cuda")
    reset_launches()
    res = fit(loss_fn, adam(1e-2), params, iter(lambda: batch, None),
              steps=TRAIN_STEPS, clip_norm=1.0, log=lambda s: None)
    launches = read_launches(torch)
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    print(f"GIN training: launches={launches} per step={per_step} "
          f"(expected update 4, compact 6); losses {res.losses}")
    check_curve(res.losses, "GIN")
    if launches["spmm_blockell_update_compact"] < 4 * TRAIN_STEPS:
        raise AssertionError("GIN training launched the update kernel "
                             f"{launches['spmm_blockell_update_compact']} "
                             f"times; expected >= {4 * TRAIN_STEPS}")
    if launches["spmm_blockell_compact"] < 6 * TRAIN_STEPS:
        raise AssertionError("GIN training launched the compact kernel "
                             f"{launches['spmm_blockell_compact']} times; "
                             f"expected >= {6 * TRAIN_STEPS}")

    breakdown = step_breakdown(torch, "GIN",
                               make_train_step(loss_fn, adam(1e-2), 1.0),
                               res.params, adam(1e-2).init(res.params),
                               batch)

    def make_for_compare(backend):
        loss_fn_b, params_b, _ = make(backend)
        return loss_fn_b, params_b, batch

    report = hold_against_plain(torch, "GIN", make_for_compare, 5,
                                grad_tol=1e-4, loss_tol=1e-3)
    report["breakdown"] = breakdown
    return launches, res.losses, breakdown["step_ms"], report


# ---------------------------------------------------------------------------
# observability: the launchers' --metrics-out / --trace / --summary, the
# spans against device time, the audit's calibration from the card's trials
# ---------------------------------------------------------------------------
OBS_STEPS = 10
# nvidia-smi's line (name, power limit) and the limit alone, as printed at
# the top (main sets them)
SMI_POWER_LIMIT = None
SMI_LINE = None


def read_observed(torch, dev, metrics_path, trace_path, what):
    """Both files of an observed run: each valid under the port's
    validator, both stamped with the device the run resolved (``cuda``:
    the card's name and the power limit printed at the top).  Returns
    ``({full metric name: record}, trace doc)``."""
    from repro_torch.obs import validate

    problems = (validate.validate_metrics_file(metrics_path)
                + validate.validate_trace_file(trace_path))
    if problems:
        raise AssertionError(f"{what}: invalid telemetry: {problems}")
    with open(metrics_path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    with open(trace_path) as f:
        doc = json.load(f)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    for where, prov in (("metrics", records[0]),
                        ("trace", doc.get("otherData") or {})):
        if (prov.get("backend"), prov.get("device_kind")) != (dev.type,
                                                               kind):
            raise AssertionError(f"{what}: {where} provenance names "
                                 f"{prov.get('backend')} / "
                                 f"{prov.get('device_kind')}, the run "
                                 f"resolved {dev.type} / {kind}")
        if dev.type == "cuda" and \
                f"{prov.get('power_limit_w')} W" != SMI_POWER_LIMIT:
            raise AssertionError(f"{what}: {where} provenance power limit "
                                 f"{prov.get('power_limit_w')!r}; "
                                 f"nvidia-smi printed {SMI_POWER_LIMIT!r}")
    metrics = {}
    for rec in records[1:]:
        if rec.get("schema") == "repro.obs/metric@1":
            labels = ",".join(f"{k}={v}" for k, v in
                              sorted(rec["labels"].items()))
            metrics[rec["name"] + (f"{{{labels}}}" if labels else "")] = rec
    return metrics, doc


def trace_names(doc, ph):
    return [e["name"] for e in doc["traceEvents"] if e.get("ph") == ph]


def observed_serving(torch, dev, d):
    """``launch.serve`` on Cora under ``--metrics-out --trace --summary``:
    exactly the 2 compact launches of ``serving_phase``, valid files with
    the card's provenance, 200 requests in as many ``serve.request``
    instants, ``serve.batches`` equal to the ``serve.batch`` spans, the
    per-layer hit-rate gauges, the summary printed."""
    from repro_torch import obs
    from repro_torch.launch import serve

    m, t = os.path.join(d, "serve.jsonl"), os.path.join(d, "serve.json")
    argv = ["--graph", "cora", "--model", "gcn", "--requests", "200",
            "--cache-kb", "500", "--warm", "reorder", "--device", "cuda",
            "--metrics-out", m, "--trace", t, "--summary"]
    obs.reset()
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        rep = serve.main(argv)
    launches = read_launches(torch)
    out = buf.getvalue()
    print(out, end="")
    want = dict.fromkeys(KERNELS, 0)
    want["spmm_blockell_compact"] = 2
    if launches != want:
        raise AssertionError(f"observed serving launched {launches}; "
                             f"expected {want}")
    metrics, doc = read_observed(torch, dev, m, t, "observed serving")
    batches = trace_names(doc, "X").count("serve.batch")
    requests = trace_names(doc, "i").count("serve.request")
    got = {"serve.requests": metrics["serve.requests"]["value"],
           "serve.batches": metrics["serve.batches"]["value"],
           "serve.batch spans": batches, "serve.request instants": requests}
    if got != {"serve.requests": 200, "serve.batches": batches,
               "serve.batch spans": batches,
               "serve.request instants": 200} or not batches:
        raise AssertionError(f"observed serving counted {got}")
    layers = sorted(k for k in metrics
                    if k.startswith("serve.cache.hit_rate{layer="))
    if len(layers) != 3:
        raise AssertionError(f"per-layer hit-rate gauges: {layers}")
    if f"=== {m} ===" not in out or f"=== {t} ===" not in out:
        raise AssertionError("the --summary one-pager was not printed")
    if rep.max_oracle_err >= ORACLE_TOL:
        raise AssertionError(f"observed serving oracle {rep.max_oracle_err}")
    return launches, {"counted": got, "hit_rate_gauges": {
        k: metrics[k]["value"] for k in layers},
        "p50_ms": rep.p50_ms, "p99_ms": rep.p99_ms}


def observed_training(torch, dev, d, cache_dir):
    """``launch.train --executor auto`` under ``--metrics-out --trace`` on
    a fresh tuning cache: the measured trial spans equal the
    ``exec.autotune.trials`` counter, one ``exec.forward.verdict{source}``,
    10 ``train.steps``.  Then two cached runs, with the flags and without:
    the same schedule, the same launches, the same losses bit for bit
    (telemetry changes no arithmetic).  A ``coo`` layer's ``index_add_``
    sums with atomics, in another order each run, so when the verdict
    holds one both runs take PyTorch's deterministic algorithms."""
    from repro_torch import obs

    argv = ["--arch", "gcn-cora", "--steps", str(OBS_STEPS)]
    m2, t2 = os.path.join(d, "train.jsonl"), os.path.join(d, "train.json")
    obs.reset()
    reset_launches()
    res, lines, wall = run_launcher(argv + ["--metrics-out", m2,
                                            "--trace", t2])
    launches = read_launches(torch)
    metrics, doc = read_observed(torch, dev, m2, t2, "observed training")
    trials = [e for e in doc["traceEvents"]
              if e.get("name") == "exec.autotune.trial"
              and "us" in (e.get("args") or {})]
    verdicts = {k: v["value"] for k, v in metrics.items()
                if k.startswith("exec.forward.verdict{")}
    counted = {"trial spans": len(trials),
               "exec.autotune.trials":
                   metrics["exec.autotune.trials"]["value"],
               "exec.forward.verdict": verdicts,
               "train.steps": metrics["train.steps"]["value"]}
    if (counted["trial spans"] != counted["exec.autotune.trials"]
            or not trials or sum(verdicts.values()) != 1
            or len(verdicts) != 1 or counted["train.steps"] != OBS_STEPS):
        raise AssertionError(f"observed training counted {counted}")
    schedule = schedule_of(lines)

    # the cached verdict, with the flags and without
    coo = any(" coo " in ln for ln in schedule)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(coo or was, warn_only=True)
    try:
        obs.reset()
        reset_launches()
        res_on, lines_on, _ = run_launcher(
            argv + ["--metrics-out", os.path.join(d, "cached.jsonl"),
                    "--trace", os.path.join(d, "cached.json")])
        cached_on = read_launches(torch)
        with obs.enabled_scope(False):
            obs.reset()
            reset_launches()
            res_off, lines_off, _ = run_launcher(argv)
            cached_off = read_launches(torch)
    finally:
        torch.use_deterministic_algorithms(was)
    for what, ls in (("with the flags", lines_on),
                     ("without the flags", lines_off)):
        if not any("(cached)" in ln for ln in ls):
            raise AssertionError(f"the rerun {what} did not read the cache")
        if schedule_of(ls) != schedule:
            raise AssertionError(f"the rerun {what} changed the schedule")
    if cached_on != cached_off:
        raise AssertionError(f"the cached runs launched {cached_on} and "
                             f"{cached_off}")
    if res_on.losses != res_off.losses:
        raise AssertionError("telemetry changed the arithmetic: losses "
                             f"{res_on.losses} with the flags, "
                             f"{res_off.losses} without")
    print(f"observed gcn-cora: {json.dumps(counted)}; cached losses "
          "bit-identical with and without the flags"
          + (" (deterministic algorithms: a coo layer)" if coo else ""))
    total = {k: launches[k] + cached_on[k] + cached_off[k] for k in KERNELS}
    return total, trials, {
        "counted": counted, "schedule": schedule, "launcher_wall_s": wall,
        "losses": res.losses, "cached_losses_on": res_on.losses,
        "cached_losses_off": res_off.losses, "coo_layer": coo,
        "trace": t2}


def spans_against_events(torch, dev, g):
    """10 ``fit`` steps of gcn-cora on the ``--executor fused`` plan with
    the tracer on and CUDA events around each step (the step function's
    call): each ``train.step`` span must be no shorter than its step's
    event time, i.e. the span ends after the step's device work."""
    from repro_torch import obs
    from repro_torch.configs import get
    from repro_torch.exec import gcn_chain, plan_forward
    from repro_torch.launch.train import gnn_batch
    from repro_torch.train import adam, fit
    from repro_torch.train import loop

    bundle = get("gcn-cora").bundle()
    dims = [g.node_feat.shape[1], *bundle.model_kw["hidden"],
            bundle.n_classes]
    fplan = plan_forward(g, gcn_chain(dims), device=dev)
    loss_fn = bundle.loss_fn("full_graph_sm", executor="fused",
                             exec_plan=fplan)
    params = bundle.init_params(torch.Generator().manual_seed(0), dims[0],
                                device=dev)
    batch = gnn_batch(g, bundle.n_classes, dev)
    events = []
    real = loop.make_train_step

    def timed_step(*args, **kw):
        step = real(*args, **kw)

        def run(p, s, b):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(p, s, b)
            end.record()
            events.append((start, end))
            return out
        return run

    loop.make_train_step = timed_step
    reset_launches()
    try:
        with obs.enabled_scope():
            obs.start_trace()
            try:
                fit(loss_fn, adam(1e-2), params, iter(lambda: batch, None),
                    steps=OBS_STEPS, clip_norm=1.0, log=lambda s: None)
            finally:
                doc = obs.stop_trace()
    finally:
        loop.make_train_step = real
    launches = read_launches(torch)
    check_step_launches(launches, fplan, OBS_STEPS,
                        "traced gcn-cora fit (--executor fused)")
    span_ms = [e["dur"] / 1e3 for e in doc["traceEvents"]
               if e.get("name") == "train.step"]
    event_ms = [s.elapsed_time(e) for s, e in events]
    if len(span_ms) != OBS_STEPS or len(event_ms) != OBS_STEPS:
        raise AssertionError(f"{len(span_ms)} spans, {len(event_ms)} "
                             "event pairs")
    short = [(i, s, e) for i, (s, e) in enumerate(zip(span_ms, event_ms))
             if s < e]
    if short:
        raise AssertionError(f"train.step spans shorter than their steps' "
                             f"device time (step, span ms, event ms): "
                             f"{short}")
    out = {"span_ms": span_ms, "event_ms": event_ms,
           "span_median_ms": statistics.median(span_ms),
           "event_median_ms": statistics.median(event_ms)}
    print(f"train.step spans vs CUDA events: median "
          f"{out['span_median_ms']:.4f} ms span, "
          f"{out['event_median_ms']:.4f} ms device window")
    return launches, out


def audit_on_card(dev, cache_dir, trace_path):
    """``python -m repro_torch.obs.audit --cache-dir DIR`` writes the
    card's table from the trials it measured: ``n_obs`` is the number of
    measured rows in the cache; the trace alone (``--no-write``) gives the
    same classes under the same signature."""
    import importlib
    from repro_torch.obs import audit
    at = importlib.import_module("repro_torch.exec.autotune")

    sig = at.device_sig(dev.type)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.audit", "--cache-dir",
         cache_dir, "--device", dev.type], capture_output=True, text=True,
        env=env, timeout=300)
    print(proc.stdout, end="")
    if proc.returncode != 0:
        raise AssertionError(f"the audit exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    table = audit.load_calibration(sig, cache_dir)
    if table is None:
        raise AssertionError(f"no calibration table under {sig}")
    with open(os.path.join(cache_dir, "autotune.json")) as f:
        entries = json.load(f)
    rows = sum(1 for e in entries.values()
               if e.get("device_sig") == sig and e.get("n")
               for r in e["table"] if r[-1] > 0)
    if table["n_obs"] != rows or not rows:
        raise AssertionError(f"the audit joined {table['n_obs']} rows; the "
                             f"cache holds {rows} measured rows")
    with open(trace_path) as f:
        doc = json.load(f)
    trace_sig = audit.trace_device_sig(doc)
    trace_classes = {o.ckey for o in audit.observations_from_trace(doc)}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = audit.main([trace_path, "--no-write", "--cache-dir", cache_dir,
                         "--device", dev.type])
    if rc != 0 or trace_sig != sig or trace_classes != set(table["classes"]):
        raise AssertionError(f"the trace's audit: rc {rc}, signature "
                             f"{trace_sig} (cache {sig}), classes "
                             f"{sorted(trace_classes)} vs "
                             f"{sorted(table['classes'])}")
    print(f"audit {sig}: n_obs {table['n_obs']}, global ratio "
          f"{table['global_ratio']:.6g} us per byte-equivalent")
    for ck, c in table["classes"].items():
        print(f"  class {ck}: ratio {c['ratio']:.6g} n {c['n']} "
              f"rel_err_p50 {c['rel_err_p50']:.3f}")
    for grp, v in table["groups"].items():
        print(f"  group {grp}: spearman {v['spearman']:+.3f} cands "
              f"{v['n_cands']}")
    return table


def calibrated_cold_dp(torch, dev, g, table):
    """``launch.train --executor fused`` cold (an empty cache), then on a
    cache holding only the audit's calibration table: both schedules
    printed, every step's launches counted against the plan that ran, the
    calibrated run's losses held against the plain path within 1e-4."""
    from repro_torch.configs import get
    from repro_torch.exec import gcn_chain, plan_forward
    from repro_torch.launch.train import gnn_batch
    from repro_torch.obs import audit

    bundle = get("gcn-cora").bundle()
    dims = [g.node_feat.shape[1], *bundle.model_kw["hidden"],
            bundle.n_classes]
    specs = gcn_chain(dims)
    argv = ["--arch", "gcn-cora", "--steps", str(OBS_STEPS), "--executor",
            "fused"]
    out, total = {}, dict.fromkeys(KERNELS, 0)
    for label in ("uncalibrated", "calibrated"):
        with tuning_cache() as d:
            if label == "calibrated":
                audit.save_calibration(table, d)
            reset_launches()
            res, lines, _ = run_launcher(argv)
            launches = read_launches(torch)
            fplan = plan_forward(g, specs, device=dev)
        check_curve(res.losses, f"gcn-cora fused ({label})")
        check_step_launches(launches, fplan, OBS_STEPS,
                            f"gcn-cora fused ({label})")
        for k in KERNELS:
            total[k] += launches[k]
        out[label] = {"schedule": schedule_of(lines),
                      "configs": [list(c) for c in fplan.configs],
                      "launches": launches, "losses": res.losses}
        print(f"gcn-cora fused, {label} cold DP: "
              + "; ".join(schedule_of(lines)))
    batch = gnn_batch(g, bundle.n_classes, dev)
    cal_configs = [tuple(c) for c in out["calibrated"]["configs"]]
    hold = hold_against_plain(
        torch, "gcn-cora fused (calibrated cold DP)",
        gcn_make(g, bundle, dims, specs, batch, cal_configs, dev),
        COMPARE_STEPS, grad_tol=1e-5, loss_tol=1e-4)
    rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in
           zip(out["calibrated"]["losses"], hold["plain_losses"])]
    if max(rel) > 1e-4:
        raise AssertionError(f"the calibrated launcher's losses part from "
                             f"the plain path by {max(rel)}")
    out["hold"] = hold
    out["launcher_vs_plain_rel"] = rel
    out["schedule_changed"] = (out["calibrated"]["schedule"]
                               != out["uncalibrated"]["schedule"])
    print(f"calibration changed the cold schedule: "
          f"{out['schedule_changed']}")
    return total, out


def telemetry_cost(torch, dev, g):
    """gcn-cora ``--executor fused`` ms a step under ``step_breakdown``
    with the registry and tracer off, on, on, off."""
    from repro_torch import obs
    from repro_torch.configs import get
    from repro_torch.exec import gcn_chain, plan_forward
    from repro_torch.launch.train import gnn_batch
    from repro_torch.train import adam, make_train_step

    bundle = get("gcn-cora").bundle()
    dims = [g.node_feat.shape[1], *bundle.model_kw["hidden"],
            bundle.n_classes]
    fplan = plan_forward(g, gcn_chain(dims), device=dev)
    loss_fn = bundle.loss_fn("full_graph_sm", executor="fused",
                             exec_plan=fplan)
    batch = gnn_batch(g, bundle.n_classes, dev)
    runs = []
    for on in (False, True, True, False):
        params = bundle.init_params(torch.Generator().manual_seed(0),
                                    dims[0], device=dev)
        with obs.enabled_scope(on):
            if on:
                obs.start_trace()
            try:
                rep = step_breakdown(
                    torch, f"gcn-cora fused, telemetry {'on' if on else 'off'}",
                    make_train_step(loss_fn, adam(1e-2), 1.0), params,
                    adam(1e-2).init(params), batch)
            finally:
                obs.stop_trace()
        runs.append({"telemetry": on, "step_ms": rep["step_ms"],
                     "busy_share": rep["busy_share"]})
    print("telemetry cost (gcn-cora fused ms a step, off/on/on/off): "
          + json.dumps([r["step_ms"] for r in runs]))
    return runs


def obs_phase(torch, dev):
    """The observability slice on the card (section 5 of the docstring):
    an observed Cora serve, an observed ``--executor auto`` gcn-cora run
    with its cached reruns, ``train.step`` spans against CUDA events, the
    audit writing the card's calibration table from that run's trials, the
    calibrated cold DP, and the cost of telemetry."""
    from repro_torch.launch.train import training_graph

    t0 = time.perf_counter()
    g = training_graph()
    report = {}
    with tempfile.TemporaryDirectory(prefix="obs-") as d:
        serve_launches, report["serving"] = observed_serving(torch, dev, d)
        with tuning_cache() as cache_dir:
            train_launches, trials, report["training"] = observed_training(
                torch, dev, d, cache_dir)
            table = audit_on_card(dev, cache_dir,
                                  report["training"].pop("trace"))
        report["audit"] = {k: table[k] for k in
                           ("device_sig", "n_obs", "global_ratio",
                            "classes", "groups", "misranks")}
        report["trials"] = len(trials)
    span_launches, report["spans"] = spans_against_events(torch, dev, g)
    fused_launches, report["calibrated"] = calibrated_cold_dp(torch, dev, g,
                                                              table)
    report["telemetry_cost"] = telemetry_cost(torch, dev, g)
    launches = {k: serve_launches[k] + train_launches[k] + span_launches[k]
                + fused_launches[k] for k in KERNELS}
    report["launches"] = launches
    report["wall_s"] = time.perf_counter() - t0
    print(f"observability phase: {report['wall_s']:.1f}s, launches "
          f"{launches}")
    return launches, report


# ---------------------------------------------------------------------------
# GraphSAGE on the paper's CITESEER-S and REDDIT stand-ins
# ---------------------------------------------------------------------------
# CITESEER-S at Table I's size (227,320 nodes, 814,134 edges, 3,703
# features, 41 classes), the paper's GraphSAGE width (GRAPHSAGE_DIMS =
# [d_in, 256, classes], repro/core/perf_model.py), minibatches of 512 seeds
# at fanouts (15, 10) as the reference's example samples them
SAGE_SCALE = 1.0
SAGE_HIDDEN = 256
SAGE_MB_STEPS = 20
SAGE_MB_SEEDS = 512
SAGE_FANOUTS = (15, 10)
SAGE_REQUESTS = 200
# the card's cold DP at [3703, 256, 41]: both layers update-first compact
SAGE_COLD_SCHEDULE = [("update_first", False, "cuda", 128, True)] * 2
# the plain compact version runs in pieces of at most this many slots
# (~5 GB of fp32 tiles, gathered x tiles and products at d = 256)
SAGE_PLAIN_TILES = 16384
# reddit's layer 1 at the launcher's default --scale 0.02, as update case
SAGE_REDDIT_UPDATE = (
    "(e) reddit --scale 0.02 sage_gin layer 1: mean 48->64, two W, bias, "
    "ReLU", "mean", 48, 64, "two_w", True, True, False, False, "u8", 1e-5,
    "fp32 means of a row's ~400 edges, then 48-term products, in another "
    "order")


def tile_counts(g, bm=BM) -> tuple:
    """The active (bm, bm) tiles of ``g``'s adjacency in each direction
    (forward, transposed): the slots its compact plan holds."""
    import numpy as np
    C = -(-g.num_nodes // bm)
    count = lambda dst, src: int(np.unique(
        dst.astype(np.int64) // bm * C + src.astype(np.int64) // bm).size)
    return count(g.dst, g.src), count(g.src, g.dst)


def sage_launcher_phase(torch, argv, expect, what):
    """``launch.serve`` (its graph path) on a fresh tuning cache: the
    graph is loaded as the launcher loads it; the offline forward must
    launch exactly ``expect`` (kernel -> count) and nothing else, and the
    served answers match it within 1e-4.  Returns (launches, report,
    graph)."""
    from repro_torch.launch import serve

    args = serve.parse_args(argv)
    t0 = time.perf_counter()
    g = serve.load_graph(args.graph, args.scale)
    load_s = time.perf_counter() - t0
    with tuning_cache():
        reset_launches()
        t0 = time.perf_counter()
        rep = serve.serve_graph(args, g)
        wall = time.perf_counter() - t0
        launches = read_launches(torch)
    want = dict.fromkeys(KERNELS, 0)
    want.update(expect)
    report = {"graph_load_s": load_s, "serve_wall_s": wall,
              "nodes": g.num_nodes, "edges": g.num_edges,
              "features": g.node_feat.shape[1],
              "active_tiles_fwd_bwd": tile_counts(g),
              "max_oracle_err": rep.max_oracle_err, "hit_rate": rep.hit_rate,
              "p50_ms": rep.p50_ms, "p99_ms": rep.p99_ms,
              "req_per_s": rep.req_per_s, "batches": rep.num_batches,
              "launches": launches}
    print(f"{what}: " + json.dumps(report))
    if rep.max_oracle_err >= ORACLE_TOL:
        raise AssertionError(f"{what}: oracle max_err {rep.max_oracle_err} "
                             f">= {ORACLE_TOL}")
    if rep.num_requests != args.requests:
        raise AssertionError(f"{what}: served {rep.num_requests} of "
                             f"{args.requests} requests")
    if launches != want:
        raise AssertionError(f"{what}: launched {launches}; the offline "
                             f"forward needs exactly {want}")
    return launches, report, g


def sage_training_phase(torch, dev, g):
    """The paper's GraphSAGE [3703, 256, 41] on the reordered CITESEER-S,
    trained full-graph through the cold ``plan_forward(sage_chain)`` plans
    (both layers update-first compact: per step 2 forward and 2 transposed
    ``spmm_blockell_compact`` launches), ``sage_loss`` and ``adam(1e-2)``:
    ``COMPARE_STEPS`` steps with their launches counted, then
    ``hold_against_plain`` against the same params on the segment executor
    (step 0's loss and gradients within 1e-4 of the largest entry, every
    loss within 1e-4 relative: fp32 means over a row's edges and 3703-term
    products in another order), and ``step_breakdown`` with the peak
    memory.  Returns (launches, report, forward plan)."""
    import numpy as np
    from repro_torch.exec import plan_forward, sage_chain
    from repro_torch.models import sage_init, sage_loss
    from repro_torch.train import adam, fit, make_train_step

    classes = int(g.labels.max()) + 1
    dims = [g.node_feat.shape[1], SAGE_HIDDEN, classes]
    specs = sage_chain(dims)
    with tuning_cache():
        t0 = time.perf_counter()
        fplan = plan_forward(g, specs, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    gp = fplan[0].gplan
    print(f"SAGE {dims} schedule (cold plan_forward): {list(fplan.configs)}; "
          f"plan built in {build_s:.1f}s: n_active {gp.meta_fwd.n_active} "
          f"(transposed {gp.meta_bwd.n_active}), "
          f"{plan_bytes(torch, gp._fwd) / 1e9:.4f} GB + "
          f"{plan_bytes(torch, gp._bwd) / 1e9:.4f} GB on the card "
          f"(entry lists: {gp.meta_fwd.lists})")
    if list(fplan.configs) != SAGE_COLD_SCHEDULE:
        raise AssertionError(f"unexpected SAGE schedule {fplan.configs}")
    t = lambda a: torch.as_tensor(a).to(dev)
    batch = {"x": t(g.node_feat), "labels": t(g.labels.astype(np.int64)),
             "mask": t(g.train_mask)}
    graph = {"src": t(g.src.astype(np.int64)),
             "dst": t(g.dst.astype(np.int64))}

    def make(backend):
        executor, plan = (("fused", fplan) if backend == "cuda"
                          else ("segment", None))

        def loss_fn(p, b):
            return sage_loss(p, b["x"], graph, b["labels"], b["mask"],
                             executor=executor, plan=plan)
        params = sage_init(torch.Generator().manual_seed(0), dims,
                           device=dev)
        return loss_fn, params, batch

    loss_fn, params, _ = make("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    res = fit(loss_fn, adam(1e-2), params, iter(lambda: batch, None),
              steps=COMPARE_STEPS, clip_norm=1.0, log=lambda s: None)
    launches = read_launches(torch)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    per_step = {k: v / COMPARE_STEPS for k, v in launches.items() if v}
    print(f"SAGE CITESEER-S training: launches={launches} per step="
          f"{per_step} (expected 4 compact: 2 forward, 2 transposed); "
          f"losses {res.losses}")
    check_curve(res.losses, "SAGE CITESEER-S")
    check_step_launches(launches, fplan, COMPARE_STEPS,
                        "SAGE CITESEER-S training")
    torch.cuda.reset_peak_memory_stats(dev)
    report = hold_against_plain(torch, "SAGE CITESEER-S", make,
                                COMPARE_STEPS, grad_tol=1e-4, loss_tol=1e-4)
    # the segment path gathers one feature row per edge (12 GB)
    report["hold_peak_memory_gb"] = (torch.cuda.max_memory_allocated(dev)
                                     / 1e9)
    report["breakdown"] = step_breakdown(
        torch, "SAGE CITESEER-S", make_train_step(loss_fn, adam(1e-2), 1.0),
        res.params, adam(1e-2).init(res.params), batch,
        watch={"spmm_blockell_compact": "blockell"})
    report["peak_memory_gb"] = peak
    report["plan_build_s"] = build_s
    report["launches"] = launches
    report["losses"] = res.losses
    print(f"SAGE CITESEER-S: {report['breakdown']['step_ms']:.3f} ms/step, "
          f"busy share {report['breakdown']['busy_share']}, peak memory "
          f"{peak:.2f} GB (kernel path; {report['hold_peak_memory_gb']:.2f} "
          "GB while held against the segment path)")
    return launches, report, fplan


def sage_kernel_cases(torch, dev, g, fplan):
    """``spmm_blockell_compact`` at one SAGE training step's four launches
    on the reordered CITESEER-S (forward at d = 256 and 41, transposed at
    d = 256 and 41): the plan's list walk (the main path) against its
    plain version, beside ``torch.sparse.mm`` of the same scaled adjacency
    and the bound; then the tile walk on the same plan's 8.4 GB of tiles a
    side, against its plain version run by pieces."""
    gp = fplan[0].gplan
    if not gp.ell.implicit:
        raise AssertionError("CITESEER-S's plan should hold 0/1 tiles")
    nnz = g.num_edges                   # unique unit edges: the bitmask's
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = []
    for side, transposed in (("forward", False), ("transposed", True)):
        lib = library_matrix(torch, dev, g, "mean", transposed)
        for d in (SAGE_HIDDEN, int(g.labels.max()) + 1):
            cases.append(list_case(
                torch, dev, gp, d, gen, f"SAGE CITESEER-S {side} d={d} "
                "(lists)", transposed, weight=1, library=lib))
        del lib
        a = tile_arrays(gp, transposed)
        for d in (SAGE_HIDDEN, int(g.labels.max()) + 1):
            cases.append(compact_case(
                torch, dev, a, nnz, d, False, "u8", False, gen,
                f"tile walk: SAGE CITESEER-S {side} d={d}",
                plain_max_tiles=SAGE_PLAIN_TILES, n_inner=5, reps=5))
        del a
    return cases


# the GCN cell's fused layer 2 on CITESEER-S (the plan's list walk)
GCN_CITESEER_UPDATE = (
    "(f) CITESEER-S GCN layer 2: gcn 16->41, bias", "gcn", 16, 41, "none",
    True, False, True, False, "u8", 1e-5,
    "fp32 sums of a row's ~3.6 edges and its self term, then 16-term "
    "products, in another order")


def gcn_citeseer_cases(torch, dev, g):
    """The GCN [3703, 16, 41] step's aggregations on the reordered
    CITESEER-S, as the benchmark's ``gcn-citeseer-s.full`` cell runs them
    on the plan's lists: forward and transposed at d = 16, transposed at
    d = 41 (each beside ``torch.sparse.mm``), and the fused layer 2 (16 ->
    41) beside its two-call yardstick.  Returns (compact cases, update
    cases)."""
    from repro_torch.exec import build_plan

    plan = build_plan(g, "gcn", bm=BM, backend="cuda", device=dev)
    if not (plan.meta_fwd.lists and plan.meta_bwd.lists):
        raise AssertionError("CITESEER-S's gcn plan should hold lists")
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = []
    for side, transposed, widths in (("forward", False, (16,)),
                                     ("transposed", True, (16, 41))):
        lib = library_matrix(torch, dev, g, "gcn", transposed)
        for d in widths:
            cases.append(list_case(
                torch, dev, plan, d, gen, f"GCN CITESEER-S {side} d={d} "
                "(lists)", transposed, weight=1, library=lib))
        del lib
    update = [update_list_case(torch, dev, g, plan, GCN_CITESEER_UPDATE, gen,
                               weight=1)]
    return cases, update


def sage_minibatch_phase(torch, dev, g):
    """Sampled-minibatch SAGE at full width: ``sage_block_apply`` at
    [3703, 256, 256] plus a linear head to the 41 classes, fanouts (15,
    10), 512 seeds a step, ``adam(1e-3)``, ``SAGE_MB_STEPS`` steps, batches
    made as ``examples/train_sage_reddit_torch.py`` makes them.  Its
    aggregation is ``index_add_`` (the reference's ``segment_sum``, no
    Pallas kernel): no kernel of the port runs, and the phase checks that
    none launched.  The mean of the last 5 losses must be below that of
    the first 5."""
    from repro_torch.graph import NeighborSampler
    from repro_torch.models import sage_block_apply, sage_init
    from repro_torch.nn.layers import cross_entropy, linear_apply, linear_init
    from repro_torch.train import adam, make_train_step, minibatch_tensors

    d, classes = g.node_feat.shape[1], int(g.labels.max()) + 1
    sampler = NeighborSampler(g, SAGE_FANOUTS, seed=0)
    gen = torch.Generator().manual_seed(0)
    params = {"sage": sage_init(gen, [d, SAGE_HIDDEN, SAGE_HIDDEN],
                                device=dev),
              "head": linear_init(gen, SAGE_HIDDEN, classes, device=dev)}

    def loss_fn(p, batch):
        h = sage_block_apply(p["sage"], batch["x"], batch["blocks"])
        return cross_entropy(linear_apply(p["head"], h[batch["seed_rows"]]),
                             batch["labels"])

    opt = adam(1e-3)
    step = make_train_step(loss_fn, opt)
    state = opt.init(params)
    losses, step_ms, host_ms, frontier = [], [], [], []
    reset_launches()
    for mb in sampler.batches(SAGE_MB_SEEDS, SAGE_MB_STEPS):
        t0 = time.perf_counter()
        batch = minibatch_tensors(g, mb, dev)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        frontier.append(mb.layer_sizes[0])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, loss = step(params, state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    launches = read_launches(torch)
    report = {"step_ms": statistics.median(step_ms[2:]),
              "step_ms_all": step_ms,
              "batch_prep_ms": statistics.median(host_ms),
              "frontier_nodes": frontier, "losses": losses,
              "launches": launches}
    print(f"SAGE minibatch (sage_block_apply [{d}, {SAGE_HIDDEN}, "
          f"{SAGE_HIDDEN}] + head to {classes}, fanouts {SAGE_FANOUTS}, "
          f"{SAGE_MB_SEEDS} seeds; index_add_ aggregation, the reference's "
          "segment_sum: no TPU kernel on this path, in the reference "
          "either): " + json.dumps(report))
    import math
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"SAGE minibatch: a loss is not finite {losses}")
    if not statistics.mean(losses[-5:]) < statistics.mean(losses[:5]):
        raise AssertionError(f"SAGE minibatch: the loss did not fall "
                             f"{losses}")
    if any(launches.values()):
        raise AssertionError(f"SAGE minibatch launched {launches}")
    return launches, report


def sage_phases(torch, dev):
    """Every GraphSAGE path: (a) ``launch.serve --graph citeseer-s --scale
    1.0 --model sage_gin`` (2 compact launches build the offline forward);
    (b) paper-width full-graph training on the reordered graph and the
    compact kernel at its four launches, then the GCN cell's aggregations
    on the same graph (:func:`gcn_citeseer_cases`); (c) sampled-minibatch
    training;
    (e) the paper's LR&CR schedule (:func:`sage_lrcr_phase`); (d)
    ``launch.serve --graph reddit --model sage_gin`` at its default
    ``--scale 0.02`` (1 ``spmm_blockell_update_compact`` and 1 compact
    launch) and the update kernel at its layer 1.  CITESEER-S is
    synthesized once, for (a), then reordered for (b), (c) and (e), whose
    Index schedule reads the raw graph's edges; everything is freed at the
    end."""
    import dataclasses
    import gc
    from repro_torch.core import minhash_reorder
    from repro_torch.exec import build_plan

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    paths, report = {}, {}
    argv = ["--graph", "citeseer-s", "--scale", str(SAGE_SCALE), "--model",
            "sage_gin", "--requests", str(SAGE_REQUESTS), "--cache-kb", "500",
            "--device", "cuda"]
    paths["SAGE serving CITESEER-S (launcher)"], report["serving"], raw = \
        sage_launcher_phase(torch, argv, {"spmm_blockell_compact": 2},
                            "SAGE serving CITESEER-S (launcher)")
    report["serving"]["peak_memory_gb"] = \
        torch.cuda.max_memory_allocated(dev) / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = raw.permute(minhash_reorder(raw))
    # the index order's edges, for the cache model's Index schedule
    raw_edges = dataclasses.replace(raw, node_feat=None, labels=None,
                                    train_mask=None)
    del raw
    report["reorder_s"] = time.perf_counter() - t0
    paths["SAGE training CITESEER-S"], report["training"], fplan = \
        sage_training_phase(torch, dev, g)
    torch.cuda.reset_peak_memory_stats(dev)
    cases = sage_kernel_cases(torch, dev, g, fplan)
    del fplan
    gc.collect()
    torch.cuda.empty_cache()
    gcn_cases, update_cases = gcn_citeseer_cases(torch, dev, g)
    cases += gcn_cases
    gc.collect()
    torch.cuda.empty_cache()
    paths["SAGE minibatch training CITESEER-S"], report["minibatch"] = \
        sage_minibatch_phase(torch, dev, g)
    report["cases_and_minibatch_peak_memory_gb"] = \
        torch.cuda.max_memory_allocated(dev) / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    paths["SAGE LR&CR training CITESEER-S"], report["lrcr"] = \
        sage_lrcr_phase(torch, dev, raw_edges, g)
    del g, raw_edges
    gc.collect()
    torch.cuda.empty_cache()

    argv = ["--graph", "reddit", "--model", "sage_gin", "--requests",
            str(SAGE_REQUESTS), "--device", "cuda"]
    paths["SAGE serving reddit (launcher)"], report["reddit"], g_reddit = \
        sage_launcher_phase(torch, argv, {"spmm_blockell_update_compact": 1,
                                          "spmm_blockell_compact": 1},
                            "SAGE serving reddit --scale 0.02 (launcher)")
    plan = build_plan(g_reddit, "mean", bm=BM, backend="cuda", device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    update_cases += [update_list_case(torch, dev, g_reddit, plan,
                                      SAGE_REDDIT_UPDATE, gen, weight=1),
                     update_case(torch, dev, g_reddit, plan,
                                 SAGE_REDDIT_UPDATE, gen)]
    del plan, g_reddit
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev) / 1e9
    report["left_allocated_gb"] = left
    report["peak_memory_gb"] = max(
        report["serving"]["peak_memory_gb"],
        report["training"]["peak_memory_gb"],
        report["training"]["hold_peak_memory_gb"],
        report["cases_and_minibatch_peak_memory_gb"],
        report["lrcr"]["peak_memory_gb"],
        report["lrcr"]["segment_peak_memory_gb"])
    report["wall_s"] = time.perf_counter() - t_start
    print(f"SAGE phases: {report['wall_s']:.1f}s, peak "
          f"{report['peak_memory_gb']:.2f} GB (serving, training, "
          "hold, cases and minibatch, LR&CR; reddit after), "
          f"{left:.2f} GB still allocated")
    if left > 4:
        raise AssertionError(f"{left:.2f} GB left allocated after the SAGE "
                             "phases")
    return cases, update_cases, paths, report


def ops_spmm_phase(torch, dev, g):
    """``kernels.ops.spmm`` — the entry point of ``spmm_blockell`` (the
    reference's ``ops.spmm``; no plan calls it) — on the reordered Cora at
    bm 128, d = 64, held against ``ops.spmm_ref``."""
    from repro_torch.core import build_blockell
    from repro_torch.kernels import ops

    ell = build_blockell(g, bm=BM, bk=BM, storage="auto")
    x = torch.randn(g.num_nodes, 64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    reset_launches()
    y = ops.spmm(ell, x)
    launches = read_launches(torch)
    err = assert_close_scaled(y, ops.spmm_ref(ell, x), KERNEL_TOL,
                              "ops.spmm vs ops.spmm_ref")
    print(f"ops.spmm: launches={launches} max_abs_err={err:.3e}")
    if launches["spmm_blockell"] != 1:
        raise AssertionError(f"ops.spmm launched {launches}")
    return launches


# ---------------------------------------------------------------------------
# the paper's reuse layer: the quickstart, GCN on a bare BlockEll, the
# shared-set (LR&CR) executor
# ---------------------------------------------------------------------------
# the reference quickstart's numbers on Cora (examples/quickstart.py)
QUICKSTART_LINES = (
    "graph: 2708 nodes, 10556 edges",
    "off-chip traffic: index=56.0MB -> LR=43.4MB (22.5% eliminated)",
    "shared-set plan: 1217 shared edges, -4.3% reductions eliminated",
    "CR executor exact: True",
    "block-ELL: 461 active blocks, mean density 0.0014")
GCN_DIMS = [1433, 16, 7]


def quickstart_phase(torch):
    """``examples/quickstart_torch.py`` on the card, run in this process as
    :func:`run_launcher` runs the launcher (its output captured and echoed,
    the launch counters watching): its lines must be the reference
    quickstart's, its asserts (the shared-set executor within 1e-3 of the
    segment one, a falling loss) must pass, and no kernel may launch (the
    reference's quickstart reaches no Pallas kernel either)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = module.main([])
    wall = time.perf_counter() - t0
    launches = read_launches(torch)
    print(buf.getvalue(), end="")
    lines = buf.getvalue().splitlines()
    missing = [l for l in QUICKSTART_LINES if l not in lines]
    if missing:
        raise AssertionError(f"quickstart: missing the lines {missing}")
    check_curve(out["losses"], "quickstart GCN")
    if any(launches.values()):
        raise AssertionError(f"quickstart launched {launches}")
    report = {"wall_s": wall, "losses": out["losses"],
              "feature_loads": [out["index"].feature_loads,
                                out["lr"].feature_loads],
              "launches": launches}
    print("quickstart: " + json.dumps(report))
    return launches, report


@contextlib.contextmanager
def plain_spmm():
    """``kernels.ops.spmm`` replaced by its plain version
    (``ops.spmm_ref``, ``spmm_blockell_ref`` on the same operands) while
    the block lasts; ``core.blockell_aggregate`` looks it up at call time,
    forward and backward."""
    from repro_torch.kernels import ops
    kernel = ops.spmm
    ops.spmm = ops.spmm_ref
    try:
        yield
    finally:
        ops.spmm = kernel


def gcn_blockell_phase(torch, dev, g):
    """GCN [1433, 16, 7] on the reordered Cora with ``executor="blockell"``
    and the bare adjacency's ``BlockEll`` (0/1 tiles, bm 128): each step's
    aggregations through ``core.blockell_aggregate``, 3 ``spmm_blockell``
    launches (2 forward; 1 backward over Aᵀ for layer 2's input, the
    features needing no gradient), ``adam(1e-2)``, ``COMPARE_STEPS`` steps.
    Held against the same model on the plain path on the card (each launch
    replaced by its plain version, :func:`plain_spmm`): step 0's loss and
    every gradient within 1e-5 of the largest entry (fp32 sums of a row's
    edges in another order), every loss within 1e-4 relative.  (An H100
    80GB HBM3 against the plain path on an x86 CPU parts by up to 9.6e-5
    within 10 steps: the CPU's GEMMs round otherwise, and Adam carries
    it.)  Then ``spmm_blockell`` at that step's three launches
    (forward d = 1433 and 16, transposed d = 16) against its plain version
    and ``torch.sparse.mm``.  Returns (launches, report, cases)."""
    from repro_torch.core import build_blockell, transpose_blockell
    from repro_torch.kernels import ops
    from repro_torch.launch.train import gnn_batch
    from repro_torch.models import gcn_init, gcn_loss
    from repro_torch.train import adam, fit, tree_leaves

    ell = build_blockell(g, bm=BM, bk=BM, storage="auto")

    def run():
        """Step 0's loss and gradients, then the launches and losses of
        ``COMPARE_STEPS`` steps of ``fit``."""
        batch = gnn_batch(g, GCN_DIMS[-1], dev)

        def loss_fn(p, b):
            return gcn_loss(p, b["x"], b, b["labels"], b["train_mask"],
                            "blockell", ell)
        params = gcn_init(torch.Generator().manual_seed(0), GCN_DIMS,
                          device=dev)
        p0 = leaf_copy(params)
        loss = loss_fn(p0, batch)
        loss.backward()
        reset_launches()
        res = fit(loss_fn, adam(1e-2), params, iter(lambda: batch, None),
                  steps=COMPARE_STEPS, clip_norm=1.0, log=lambda s: None)
        return (loss.detach().cpu(), [p.grad.cpu() for p in tree_leaves(p0)],
                res.losses, read_launches(torch))

    l_k, g_k, c_k, launches = run()
    with plain_spmm():
        l_p, g_p, c_p, plain_launches = run()
    want = dict.fromkeys(KERNELS, 0)
    want["spmm_blockell"] = 3 * COMPARE_STEPS
    print(f"GCN {GCN_DIMS} blockell + BlockEll: launches={launches} "
          f"(expected {want}); losses {c_k}")
    if launches != want or any(plain_launches.values()):
        raise AssertionError(f"GCN blockell + BlockEll launched {launches} "
                             f"(plain path {plain_launches}); expected "
                             f"{want}")
    check_curve(c_k, "GCN blockell + BlockEll")
    rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(c_k, c_p)]
    report = {
        "step0_loss_err": assert_close_scaled(l_k, l_p, KERNEL_TOL,
                                              "GCN blockell step-0 loss"),
        "step0_grad_err": max(assert_close_scaled(
            a, b, KERNEL_TOL, f"GCN blockell grad {i}")
            for i, (a, b) in enumerate(zip(g_k, g_p))),
        "loss_rel_err": rel, "kernel_losses": c_k, "plain_losses": c_p,
        "ell": {"R": ell.n_row_blocks, "W": ell.width,
                "active": ell.n_active, "implicit": ell.implicit},
        "launches": launches}
    if max(rel) > 1e-4:
        raise AssertionError(f"GCN blockell losses differ by {max(rel):.3e} "
                             f"> 1e-4 (kernel {c_k}, plain {c_p})")
    print("GCN blockell + BlockEll vs plain path: "
          + json.dumps(report))

    gen = torch.Generator(device=dev).manual_seed(13)
    nnz = int(ell.density_stats()["nnz"])
    ones = torch.ones(g.num_nodes, device=dev)
    cases = []
    for side, e, transposed, widths in (
            ("forward", ell, False, (GCN_DIMS[0], GCN_DIMS[1])),
            ("transposed", transpose_blockell(ell), True, (GCN_DIMS[1],))):
        cols, tiles = ops._operands(e, ones)
        a = {"block_cols": cols, "blocks": tiles, "s_in": ones}
        lib = library_matrix(torch, dev, g, "sum", transposed)
        for d in widths:
            cases.append(padded_case(
                torch, dev, "spmm_blockell", a, nnz, e.n_active, d, gen,
                f"GCN blockell step {side} d={d} (bare adjacency BlockEll, "
                f"bm={BM})", bm=BM, weight=1, library=lib))
    return launches, report, cases


def gin_shared_phase(torch, dev, g):
    """GIN at its paper width (1433 -> 128 x 5 convs -> 7) on the reordered
    Cora with ``executor="shared"`` (the level-1 ``SharedSetPlan``): 5 steps
    of ``fit`` with the launches counted (none: the shared executor is
    segment sums, as in the reference), then held against
    ``executor="segment"``: step 0's loss and gradients and the losses of
    steps 0-4 within 1e-3 (of the largest entry; relative), in fp32 and in
    fp64.  GIN at this width is chaotic (``tests/test_torch_gin.py``): the
    shared partials sum a row in another order, five unnormalized sum convs
    carry that fp32 rounding to 1.6e-4 of the largest step-0 gradient on
    the CPU, where Adam then takes the losses 5.1e-2 apart by step 4 (on
    an H100 80GB HBM3: 1.5e-5 and 2.3e-5).  In fp64 the two executors
    agree to 1.4e-14 at step 0 on that card: they compute one function."""
    import math
    from repro_torch.core import build_shared_plan
    from repro_torch.launch.train import gnn_batch
    from repro_torch.models.sage_gin import gin_init, gin_loss
    from repro_torch.train import adam, fit, tree_map

    plan = build_shared_plan(g)

    def make_for(dtype):
        batch = gnn_batch(g, 7, dev)
        batch["x"] = batch["x"].to(dtype)

        def make(executor):
            def loss_fn(p, b):
                return gin_loss(p, b["x"], b, b["labels"], b["train_mask"],
                                executor=executor, plan=plan)
            params = gin_init(torch.Generator().manual_seed(0),
                              g.node_feat.shape[1], 128, 5, 7, device=dev)
            return loss_fn, tree_map(lambda t: t.to(dtype), params), batch
        return make

    make = make_for(torch.float32)
    loss_fn, params, batch = make("shared")
    reset_launches()
    res = fit(loss_fn, adam(1e-2), params, iter(lambda: batch, None),
              steps=5, clip_norm=1.0, log=lambda s: None)
    launches = read_launches(torch)
    print(f"GIN shared: launches={launches}; losses {res.losses}")
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"GIN shared: a loss is not finite "
                             f"{res.losses}")
    if any(launches.values()):
        raise AssertionError(f"GIN shared launched {launches}")
    pair = ("shared", "segment")
    report = {"fp32": hold_against_plain(torch, "GIN shared fp32", make, 5,
                                         grad_tol=1e-3, loss_tol=1e-3,
                                         backends=pair),
              "fp64": hold_against_plain(torch, "GIN shared fp64",
                                         make_for(torch.float64), 5,
                                         grad_tol=1e-3, loss_tol=1e-3,
                                         backends=pair),
              "launches": launches}
    return launches, report


def sage_lrcr_phase(torch, dev, raw_edges, g):
    """The paper's LR&CR schedule at the paper's GraphSAGE width on the
    full CITESEER-S: ``schedule_comparison`` (Index on the raw graph's
    edges, LR and LR&CR on the reordered graph; 64 PEs, 64 + 64 KB a PE,
    d = 3703) and ``build_shared_plan`` (level 1) with their host seconds,
    then [3703, 256, 41] trained with ``executor="shared"``,
    ``adam(1e-2)``, ``COMPARE_STEPS`` steps with the launches counted
    (none), held against ``executor="segment"`` (step 0's loss and
    gradients within 1e-4 of the largest entry, every loss within 1e-4
    relative), and ``step_breakdown`` of both executors with their peak
    memory.  Returns (launches, report)."""
    import dataclasses
    import numpy as np
    from repro_torch.core import build_shared_plan, schedule_comparison
    from repro_torch.models import sage_init, sage_loss
    from repro_torch.train import adam, fit, make_train_step

    d = g.node_feat.shape[1]
    t0 = time.perf_counter()
    plan = build_shared_plan(g, levels=1)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sched = schedule_comparison(
        raw_edges, dataclasses.replace(g, node_feat=None, labels=None,
                                       train_mask=None),
        plan, num_pes=64, feat_dim=d)
    sched_s = time.perf_counter() - t0
    names = ("index", "lr", "lrcr")
    report = {"plan_build_s": plan_s, "shared_edges": plan.shared_edges,
              "residual_edges": int(plan.residual_src.shape[0]),
              "shared_fraction": plan.shared_fraction,
              "reduction_ratio": plan.reduction_ratio,
              "schedule_s": sched_s,
              "offchip_gb": {k: sched[k].offchip_bytes / 1e9 for k in names},
              "feature_loads": {k: sched[k].feature_loads for k in names},
              "gc_hits": sched["lrcr"].pair_hits,
              **{k: sched[k] for k in ("lr_traffic_reduction",
                                       "lrcr_traffic_reduction",
                                       "lrcr_extra_reduction_vs_lr")}}
    print("SAGE CITESEER-S LR&CR, cache model (64 PEs, 64 + 64 KB, d = "
          f"{d}; host): " + json.dumps(report))

    classes = int(g.labels.max()) + 1
    dims = [d, SAGE_HIDDEN, classes]
    t = lambda a: torch.as_tensor(a).to(dev)
    batch = {"x": t(g.node_feat), "labels": t(g.labels.astype(np.int64)),
             "mask": t(g.train_mask)}
    graph = {"src": t(g.src.astype(np.int64)),
             "dst": t(g.dst.astype(np.int64))}

    def make(executor):
        def loss_fn(p, b):
            return sage_loss(p, b["x"], graph, b["labels"], b["mask"],
                             executor=executor, plan=plan)
        params = sage_init(torch.Generator().manual_seed(0), dims,
                           device=dev)
        return loss_fn, params, batch

    loss_fn, params, _ = make("shared")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    res = fit(loss_fn, adam(1e-2), params, iter(lambda: batch, None),
              steps=COMPARE_STEPS, clip_norm=1.0, log=lambda s: None)
    launches = read_launches(torch)
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"SAGE CITESEER-S LR&CR training: launches={launches} (expected "
          f"none); losses {res.losses}")
    check_curve(res.losses, "SAGE CITESEER-S LR&CR")
    if any(launches.values()):
        raise AssertionError(f"SAGE LR&CR launched {launches}")
    report["hold"] = hold_against_plain(
        torch, "SAGE CITESEER-S LR&CR", make, COMPARE_STEPS, grad_tol=1e-4,
        loss_tol=1e-4, backends=("shared", "segment"))
    # device time by kind: the scatter-adds, the row gathers, the GEMMs,
    # the elementwise passes (the shared partials' consume among them)
    watch = {"index_add": "indexFunc", "gather": "index_elementwise",
             "gemm": "gemm", "elementwise": "elementwise_kernel",
             "cat": "CatArray"}
    report["breakdown"] = step_breakdown(
        torch, "SAGE CITESEER-S LR&CR", make_train_step(loss_fn, adam(1e-2),
                                                       1.0),
        res.params, adam(1e-2).init(res.params), batch, watch=watch)
    seg_fn, seg_params, _ = make("segment")
    torch.cuda.reset_peak_memory_stats(dev)
    report["segment_breakdown"] = step_breakdown(
        torch, "SAGE CITESEER-S segment", make_train_step(seg_fn, adam(1e-2),
                                                         1.0),
        seg_params, adam(1e-2).init(seg_params), batch, watch=watch)
    report["segment_peak_memory_gb"] = (torch.cuda.max_memory_allocated(dev)
                                        / 1e9)
    report["launches"] = launches
    report["losses"] = res.losses
    b, sb = report["breakdown"], report["segment_breakdown"]
    print(f"SAGE CITESEER-S LR&CR: {b['step_ms']:.3f} ms/step, busy share "
          f"{b['busy_share']}, peak {report['peak_memory_gb']:.2f} GB; "
          f"segment {sb['step_ms']:.3f} ms/step, busy share "
          f"{sb['busy_share']}, peak "
          f"{report['segment_peak_memory_gb']:.2f} GB")
    return launches, report


# ---------------------------------------------------------------------------
# wide & deep (embedding_bag) and sddmm
# ---------------------------------------------------------------------------
def bag_case(torch, dev, name, ids, bag_ids, weights, table, num_bags,
             weight, big=False):
    """One ``embedding_bag`` case on entries sorted by bag as
    ``ops.embedding_bag`` hands them over: the kernel (raw launch, no Python
    checks) against ``embedding_bag_ref`` (take + ``index_add``) on the same
    inputs, a rerun bit-identical, and ``F.embedding_bag`` (the yardstick;
    the port never calls it; its offsets are built once, untimed) held to
    the plain version; all three timed, and the mapping the kernel took.
    ``weight``: this case's launches in one full-width training step (0:
    not in the step)."""
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels.ref import embedding_bag_ref

    d = table.shape[1]
    L = ids.numel()
    y = kb.embedding_bag(ids, bag_ids, weights, table, num_bags)
    ref = embedding_bag_ref(ids, bag_ids, weights, table, num_bags)
    torch.cuda.synchronize()
    if not torch.isfinite(y).all():
        raise AssertionError(f"embedding_bag output not finite ({name})")
    err = assert_close_scaled(y, ref, KERNEL_TOL,
                              f"embedding_bag vs plain {name}")
    # no atomics: a second run is bit-identical
    if not torch.equal(kb.embedding_bag(ids, bag_ids, weights, table,
                                        num_bags), y):
        raise AssertionError(f"embedding_bag rerun is not bit-identical "
                             f"({name})")
    offsets = torch.searchsorted(
        bag_ids, torch.arange(num_bags, dtype=torch.int32, device=dev),
        out_int32=True)

    def library():
        return F.embedding_bag(ids, table, offsets, mode="sum",
                               per_sample_weights=weights)

    lib_err = assert_close_scaled(library(), ref, KERNEL_TOL,
                                  f"F.embedding_bag vs plain {name}")
    fn = kb._kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    raw = (ids.data_ptr(), bag_ids.data_ptr(), weights.data_ptr(),
           table.data_ptr(), y.data_ptr(), L, num_bags, d, stream)

    def launch():
        if fn(*raw):
            raise RuntimeError("embedding_bag launch failed")

    reps = dict(n_inner=5, reps=10) if big else {}
    ms = gpu_ms(launch, **reps)
    plain_ms = gpu_ms(lambda: embedding_bag_ref(ids, bag_ids, weights, table,
                                                num_bags), **reps)
    library_ms = gpu_ms(library, **reps)
    del offsets
    # what the data needs: each distinct row looked up read once, 12 B of
    # id, bag id and weight per entry, every bag's row written once; an FMA
    # per entry and column.  The kernel's earlier contract took the bags'
    # offsets instead of a bag id per entry: 8 B per entry and
    # 4 (num_bags + 1) B, kept as `bound_ms_offsets` for comparison.
    rows = int(torch.unique(ids).numel())
    nbytes = rows * d * 4 + 12 * L + 4 * num_bags * d
    old_bytes = rows * d * 4 + 8 * L + 4 * (num_bags + 1) + 4 * num_bags * d
    case = {"kernel": "embedding_bag", "case": name, "num_bags": num_bags,
            "entries": L, "d": d, "table_rows": table.shape[0],
            "distinct_rows": rows, "plan": kb.plan(L, num_bags, table, y),
            "max_abs_err": err, "library_vs_plain_err": lib_err,
            "ref_max_abs": float(ref.abs().max()), "ms": ms,
            "plain_ms": plain_ms, **bound(nbytes, 2 * L * d),
            "bound_ms_offsets": bound(old_bytes, 2 * L * d)["bound_ms"],
            "library_ms": library_ms, "weight": weight}
    print("case " + json.dumps(case))
    return case


def embedding_bag_phase(torch, dev, params, cfg, gen):
    """``embedding_bag`` at the shapes the full-width paths give it, over
    the ``CONFIG`` tables (40 M rows): the deep lookup (B·F single-id bags,
    d = 32) at ``serve_p99`` and at ``train_batch``, the wide lookup (B bags
    of F ids, d = 1) at ``train_batch``, and both backwards, the transposed
    entries with one bag per table row.  The entries are sorted by the
    stable argsort ``ops`` runs."""
    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.models.recsys import _flat_ids

    def lookup_cases(what, B, table, per_bag, backward):
        sparse = torch.randint(0, cfg.rows_per_field, (B, cfg.n_sparse),
                               generator=gen, device=dev, dtype=torch.int32)
        ids = _flat_ids(sparse, cfg)
        num_bags = ids.numel() // per_bag
        bag_ids = torch.arange(num_bags, device=dev,
                               dtype=torch.int32).repeat_interleave(per_bag)
        w = torch.ones(ids.numel(), device=dev)
        order = torch.argsort(bag_ids, stable=True)
        ids_s, bags_s, w_s = ids[order], bag_ids[order], w[order]
        out = [bag_case(torch, dev, f"{what} B={B}", ids_s, bags_s, w_s,
                        table, num_bags, int(backward))]
        if backward:
            V, d = table.shape
            order_t = torch.argsort(ids_s, stable=True)
            grad_out = torch.randn((num_bags, d), generator=gen, device=dev)
            out.append(bag_case(
                torch, dev, f"{what} backward B={B} (V={V} bags)",
                bags_s[order_t], ids_s[order_t], w_s[order_t], grad_out, V,
                1, big=True))
        return out

    deep, wide = params["table"], params["wide"][:, None]
    B_serve = RECSYS_SHAPES["serve_p99"]["batch"]
    B_train = RECSYS_SHAPES["train_batch"]["batch"]
    cases = lookup_cases("deep lookup d=32, serve_p99", B_serve, deep, 1,
                         False)
    cases += lookup_cases("deep lookup d=32, train_batch", B_train, deep, 1,
                          True)
    cases += lookup_cases("wide lookup d=1, train_batch", B_train, wide,
                          cfg.n_sparse, True)
    return cases


def bag_floors_phase(torch, dev, params, cfg, gen):
    """What the card does at the backward's and the wide lookup's access
    patterns without the kernel: ``zero_`` of a 40 M x 32 fp32 tensor (the
    deep backward's 5.12 GB of stores, nothing read) and ``torch.take`` of
    2,621,440 random floats of the 40 M-row wide table (the wide lookup's
    gathers, nothing summed)."""
    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.models.recsys import _flat_ids

    B = RECSYS_SHAPES["train_batch"]["batch"]
    sparse = torch.randint(0, cfg.rows_per_field, (B, cfg.n_sparse),
                           generator=gen, device=dev, dtype=torch.int32)
    ids = _flat_ids(sparse, cfg).long()
    grad = torch.empty_like(params["table"])
    wide = params["wide"]
    report = {"zero_table_grad_ms": gpu_ms(grad.zero_, n_inner=5, reps=10),
              "zero_table_grad_gb": grad.numel() * 4 / 1e9,
              "take_wide_ms": gpu_ms(lambda: torch.take(wide, ids)),
              "take_wide_n": ids.numel()}
    print("embedding_bag floors (CONFIG): " + json.dumps(report))
    return report


def ops_bag_train_phase(torch, dev, params, cfg, gen):
    """``ops.embedding_bag`` forward and backward as the training step calls
    it at ``train_batch`` (index checks, stable sorts, both launches),
    timed with CUDA events for the deep and the wide table, held against
    autograd through the plain version."""
    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import embedding_bag_ref
    from repro_torch.models.recsys import _flat_ids

    B, F = RECSYS_SHAPES["train_batch"]["batch"], cfg.n_sparse
    sparse = torch.randint(0, cfg.rows_per_field, (B, F), generator=gen,
                           device=dev, dtype=torch.int32)
    ids = _flat_ids(sparse, cfg)
    report = {}
    for what, table, bags, nb in (
            ("deep", params["table"], torch.arange(B * F, device=dev), B * F),
            ("wide", params["wide"][:, None],
             torch.arange(B, device=dev).repeat_interleave(F), B)):
        V, d = table.shape
        grad = torch.randn((nb, d), generator=gen, device=dev)

        def fwd_bwd(fn):
            t = table.detach().requires_grad_()
            fn(t).backward(grad)
            return t.grad

        got = fwd_bwd(lambda t: ops.embedding_bag(ids, bags, t, nb))
        ref = fwd_bwd(lambda t: embedding_bag_ref(
            ids, bags, torch.ones(ids.numel(), device=dev), t, nb))
        err = assert_close_scaled(got, ref, KERNEL_TOL,
                                  f"ops.embedding_bag table gradient ({what})")
        del got, ref
        ms = gpu_ms(lambda: fwd_bwd(lambda t: ops.embedding_bag(ids, bags, t,
                                                                nb)),
                    n_inner=2, reps=5)
        report[what] = {"num_bags": nb, "V": V, "d": d,
                        "fwd_bwd_ms": ms, "grad_max_abs_err": err}
    print("ops.embedding_bag train_batch forward+backward (CONFIG): "
          + json.dumps(report))
    return report


def sddmm_phase(torch, dev, g):
    """``sddmm`` on the reordered Cora's edges against ``sddmm_ref`` at
    d = 64 (gat-cora's 8 heads x 8; ``ops.sddmm``'s path) and d = 7.  The
    library call is ``torch.sparse.sampled_addmm`` (cuSPARSE's SDDMM) over
    the edges' CSR pattern, built once, untimed; its values, taken back to
    edge order, are held against ``sddmm_ref`` too."""
    import numpy as np
    from repro_torch.kernels import sddmm as ks
    from repro_torch.kernels.ref import sddmm_ref

    gen = torch.Generator(device=dev).manual_seed(8)
    src = torch.as_tensor(g.src.astype(np.int32)).to(dev)
    dst = torch.as_tensor(g.dst.astype(np.int32)).to(dev)
    E, n = src.numel(), g.num_nodes
    # CSR entry of each edge: ``inverse`` (repeated edges share one entry)
    keys, inverse = torch.unique(src.long() * n + dst.long(),
                                 return_inverse=True)
    pattern = torch.sparse_coo_tensor(
        torch.stack([keys // n, keys % n]),
        torch.ones(keys.numel(), device=dev), (n, n)).coalesce()
    pattern = pattern.to_sparse_csr()
    cases = []
    for d, weight in ((64, 1), (7, 0)):
        q = torch.randn((n, d), generator=gen, device=dev)
        k = torch.randn((n, d), generator=gen, device=dev)
        y = ks.sddmm(src, dst, q, k)
        ref = sddmm_ref(src, dst, q, k)
        torch.cuda.synchronize()
        name = f"reordered Cora E={E} d={d}"
        err = assert_close_scaled(y, ref, KERNEL_TOL, f"sddmm vs plain {name}")
        if not torch.equal(ks.sddmm(src, dst, q, k), y):
            raise AssertionError(f"sddmm rerun is not bit-identical ({name})")
        fn = ks._kernel_fn()
        stream = torch.cuda.current_stream(dev).cuda_stream
        raw = (src.data_ptr(), dst.data_ptr(), q.data_ptr(), k.data_ptr(),
               y.data_ptr(), E, d, stream)

        def launch():
            if fn(*raw):
                raise RuntimeError("sddmm launch failed")

        def library():
            return torch.sparse.sampled_addmm(pattern, q, k.t(), beta=0.0)

        lib_err = assert_close_scaled(library().values()[inverse], ref,
                                      KERNEL_TOL,
                                      f"sampled_addmm vs plain {name}")
        rows = int(torch.unique(src).numel() + torch.unique(dst).numel())
        case = {"kernel": "sddmm", "case": name, "max_abs_err": err,
                "ref_max_abs": float(ref.abs().max()), "ms": gpu_ms(launch),
                "plain_ms": gpu_ms(lambda: sddmm_ref(src, dst, q, k)),
                **bound(rows * d * 4 + 12 * E, 2 * E * d),
                "library_ms": gpu_ms(library),
                "library_max_abs_err": lib_err, "weight": weight}
        print("case " + json.dumps(case))
        cases.append(case)
    return cases


def ops_sddmm_phase(torch, dev, g):
    """``kernels.ops.sddmm`` (the entry point of ``sddmm``; no model of
    the reference calls it) on the reordered Cora at d = 64, held against
    ``sddmm_ref``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import sddmm_ref

    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((g.num_nodes, 64), generator=gen, device=dev)
    k = torch.randn((g.num_nodes, 64), generator=gen, device=dev)
    src, dst = (torch.as_tensor(a).to(dev) for a in (g.src, g.dst))
    reset_launches()
    y = ops.sddmm(src, dst, q, k)
    launches = read_launches(torch)
    err = assert_close_scaled(y, sddmm_ref(src, dst, q, k), KERNEL_TOL,
                              "ops.sddmm vs sddmm_ref")
    print(f"ops.sddmm: launches={launches} max_abs_err={err:.3e}")
    if launches["sddmm"] != 1:
        raise AssertionError(f"ops.sddmm launched {launches}")
    return launches


def recsys_serving_launcher_phase(torch):
    """``launch.serve --graph cora --model wide_deep``: the reduced wide &
    deep session, one user per Cora node, warmed along the MinHash order;
    the user tower's lookup launches the kernel (the warm's full forward
    and every oracle check)."""
    from repro_torch.launch import serve

    argv = ["--graph", "cora", "--model", "wide_deep", "--requests", "200",
            "--cache-kb", "500", "--warm", "reorder", "--device", "cuda"]
    reset_launches()
    rep = serve.main(argv)
    launches = read_launches(torch)
    print(f"wide-deep serving (launcher): launches={launches} "
          f"max_oracle_err={rep.max_oracle_err:.3e} "
          f"hit_rate={rep.hit_rate:.3f} p50={rep.p50_ms:.3f}ms "
          f"p99={rep.p99_ms:.3f}ms")
    if rep.max_oracle_err >= ORACLE_TOL or rep.num_requests != 200:
        raise AssertionError(f"wide-deep serving: {rep.num_requests} "
                             f"requests, oracle {rep.max_oracle_err}")
    if launches["embedding_bag"] < 2:
        raise AssertionError(f"embedding_bag launched "
                             f"{launches['embedding_bag']} times on the "
                             "wide-deep serving path; expected the warm's "
                             "forward and the oracle checks")
    return launches


def recsys_launcher_phase(torch, dev):
    """``launch.train --arch wide-deep --steps 20`` (``REDUCED``, batch 256,
    adam(1e-3)): exactly 4 ``embedding_bag`` launches a step (the deep and
    wide lookups and their backwards), the losses held against the same run
    on ``lookup="dense"`` within 1e-4 relative (fp32 sums in another order
    carried through 20 Adam steps)."""
    import math
    from repro_torch.launch import train

    reset_launches()
    res, _, wall = run_launcher(["--arch", "wide-deep", "--steps",
                                 str(TRAIN_STEPS)])
    launches = read_launches(torch)
    dense = train.recsys_driver("wide-deep", TRAIN_STEPS, device=dev,
                                lookup="dense")
    rel = [abs(a - b) / max(abs(b), 1e-12)
           for a, b in zip(res.losses, dense.losses)]
    report = {"launches": launches, "wall_s": wall, "losses": res.losses,
              "dense_losses": dense.losses, "loss_rel_err": max(rel)}
    print("wide-deep training (launcher): " + json.dumps(report))
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"wide-deep: a loss is not finite {res.losses}")
    if max(rel) > 1e-4:
        raise AssertionError(f"wide-deep launcher losses part from the dense "
                             f"lookup's by {max(rel):.3e} > 1e-4")
    if launches["embedding_bag"] != 4 * TRAIN_STEPS:
        raise AssertionError(f"wide-deep training launched embedding_bag "
                             f"{launches['embedding_bag']} times; expected "
                             f"{4 * TRAIN_STEPS}")
    return launches, report


def recsys_full_serving_phase(torch, dev, sess):
    """The ``CONFIG`` session (40 M-row tables) serving 200 Zipf(1.1)
    requests of Cora's 2708 users through ``ServeEngine`` with a cold 500 KB
    cache, so misses run the user tower (and its kernel) on the request
    path; then ``gather`` of every user held against the same params on
    ``lookup="dense"`` within 1e-5 of the largest entry."""
    import numpy as np
    from repro_torch.serve import (EmbeddingCache, MicroBatcher, ServeEngine,
                                   WideDeepSession, zipfian_trace)

    cache = EmbeddingCache(sess.layer_dims, 500 * 1024,
                           num_nodes=sess.num_users)
    eng = ServeEngine(sess, cache, MicroBatcher(max_batch=8, max_wait=1e-3),
                      oracle_check=True)
    reset_launches()
    rep = eng.serve(zipfian_trace(sess.num_users, 200, a=1.1, seed=1))
    launches = read_launches(torch)
    dense = WideDeepSession("wide_deep", sess.num_users, cfg=sess.cfg,
                            device=dev, params=sess.params, lookup="dense")
    ids = np.arange(sess.num_users)
    err = assert_close_scaled(torch.as_tensor(sess.gather(ids)),
                              torch.as_tensor(dense.gather(ids)), 1e-5,
                              "CONFIG gather bag vs dense", floor=0.0)
    report = {"launches": launches, "max_oracle_err": rep.max_oracle_err,
              "hit_rate": rep.hit_rate, "p50_ms": rep.p50_ms,
              "p99_ms": rep.p99_ms, "req_per_s": rep.req_per_s,
              "batches": rep.num_batches, "gather_bag_vs_dense_err": err}
    print("wide-deep serving (CONFIG): " + json.dumps(report))
    if rep.max_oracle_err >= ORACLE_TOL or rep.num_requests != 200:
        raise AssertionError(f"CONFIG serving: {rep.num_requests} requests, "
                             f"oracle {rep.max_oracle_err}")
    if launches["embedding_bag"] < 1:
        raise AssertionError("the CONFIG session served without the "
                             "embedding_bag kernel")
    return launches, report


def recsys_scoring_phase(torch, dev, bundle, params, gen):
    """``RecsysBundle(CONFIG).step_fn`` at ``serve_p99``, ``serve_bulk``
    and ``retrieval_cand``: ``lookup="bag"`` against ``"dense"`` on the same
    batch within 1e-5 of the largest entry, the launches of one call (2:
    both lookups; 1 for retrieval, the tower's deep lookup), and both
    timed (CUDA events around whole calls, host gaps included)."""
    from repro_torch.models.recsys import LOOKUPS

    paths, report = {}, {}
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        batch = bundle.make_batch(shape, gen, dev)
        fns = {lk: bundle.step_fn(shape, lk) for lk in LOOKUPS}
        reset_launches()
        got = fns["bag"](params, batch)
        launches = read_launches(torch)
        err = assert_close_scaled(got, fns["dense"](params, batch), 1e-5,
                                  f"{shape} bag vs dense", floor=0.0)
        want = 1 if shape == "retrieval_cand" else 2
        if launches["embedding_bag"] != want:
            raise AssertionError(f"{shape} launched {launches}; expected "
                                 f"{want} embedding_bag")
        report[shape] = {
            "batch": batch["sparse"].shape[0], "out": list(got.shape),
            "bag_vs_dense_err": err, "max_abs": float(got.abs().max()),
            "launches": launches,
            "bag_ms": gpu_ms(lambda: fns["bag"](params, batch), n_inner=3,
                             reps=5),
            "dense_ms": gpu_ms(lambda: fns["dense"](params, batch),
                               n_inner=3, reps=5)}
        print(f"wide-deep {shape}: " + json.dumps(report[shape]))
        paths[f"wide-deep {shape} (CONFIG)"] = launches
        del batch, got
    return paths, report


def recsys_training_phase(torch, dev, bundle, params, gen):
    """``RecsysBundle(CONFIG).step_fn("train_batch")`` at B = 65,536: step
    0's loss and every gradient on ``bag`` against ``dense`` (1e-5 of each
    array's largest entry), then 5 steps of the train step (ms per step from
    CUDA events, the median of steps 1-4) and 2 profiled ones (busy share),
    4 ``embedding_bag`` launches each, and the peak device memory."""
    import math
    from repro_torch.models.recsys import LOOKUPS, widedeep_loss
    from repro_torch.train import tree_leaves, tree_map

    batch = bundle.make_batch("train_batch", gen, dev)
    step0 = {}
    for lk in LOOKUPS:
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = widedeep_loss(p, batch["sparse"], batch["dense"],
                             batch["labels"], bundle.cfg, lk)
        loss.backward()
        step0[lk] = (loss.detach(), [leaf.grad for leaf in tree_leaves(p)])
        del p, loss
    (l_b, g_b), (l_d, g_d) = step0["bag"], step0["dense"]
    loss_err = assert_close_scaled(l_b, l_d, 1e-5, "CONFIG step-0 loss",
                                   floor=0.0)
    grad_err = max(assert_close_scaled(a, b, 1e-5, f"CONFIG step-0 grad {i}",
                                       floor=0.0)
                   for i, (a, b) in enumerate(zip(g_b, g_d)))
    del step0, g_b, g_d
    step_fn = bundle.step_fn("train_batch")
    state = bundle.optimizer().init(params)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    br = step_breakdown(torch, "wide-deep CONFIG train_batch", step_fn,
                        params, state, batch, warmup=1, timed=4, n_prof=2,
                        watch={"embedding_bag": "embedding_bag",
                               "sort": "sort"})
    launches = read_launches(torch)
    report = {"step0_loss": float(l_d), "step0_loss_err": loss_err,
              "step0_grad_err": grad_err, "launches": launches,
              "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
              "breakdown": br}
    print("wide-deep training (CONFIG): " + json.dumps(
        {k: v for k, v in report.items() if k != "breakdown"}))
    if not all(math.isfinite(v) for v in br["losses"]):
        raise AssertionError(f"CONFIG training: a loss is not finite "
                             f"{br['losses']}")
    if launches["embedding_bag"] != 4 * 7:
        raise AssertionError(f"CONFIG training launched {launches} in 7 "
                             "steps; expected 4 embedding_bag a step")
    del state, batch
    return launches, report


def recsys_phases(torch, dev):
    """Every wide & deep path: the two launchers (``REDUCED``), then the
    ``CONFIG`` session built on the card (its params, drawn with a
    generator on the card, are shared by the kernel cases, the serving,
    scoring and training phases)."""
    from repro_torch.configs.families import RecsysBundle
    from repro_torch.configs.wide_deep import CONFIG
    from repro_torch.serve import make_session

    paths = {"wide-deep serving (launcher)":
             recsys_serving_launcher_phase(torch)}
    report = {}
    paths["wide-deep training (launcher)"], report["launcher"] = \
        recsys_launcher_phase(torch, dev)
    t0 = time.perf_counter()
    sess = make_session("wide_deep", None, num_users=2708, cfg=CONFIG,
                        device=dev)
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    print(f"CONFIG params: {CONFIG.param_count()} "
          f"({CONFIG.param_count() * 4 / 1e9:.2f} GB), drawn on the card in "
          f"{report['init_s']:.2f}s")
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = embedding_bag_phase(torch, dev, sess.params, CONFIG, gen)
    report["bag_floors"] = bag_floors_phase(torch, dev, sess.params, CONFIG,
                                            gen)
    report["ops_train_batch"] = ops_bag_train_phase(torch, dev, sess.params,
                                                    CONFIG, gen)
    paths["wide-deep serving (CONFIG)"], report["serving"] = \
        recsys_full_serving_phase(torch, dev, sess)
    bundle = RecsysBundle(CONFIG)
    score_paths, report["scoring"] = recsys_scoring_phase(
        torch, dev, bundle, sess.params, gen)
    paths.update(score_paths)
    paths["wide-deep training (CONFIG)"], report["training"] = \
        recsys_training_phase(torch, dev, bundle, sess.params, gen)
    return cases, paths, report


# ---------------------------------------------------------------------------
# LM serving (decode_attention)
# ---------------------------------------------------------------------------
def decode_case(torch, dev, name, B, S, KV, G, d, dtype, lengths, gen,
                weight=0, library=True, big=False, plain_rows=None):
    """One ``decode_attention`` case: the kernel (raw launch, no Python
    checks) against ``decode_attention_ref`` on the same inputs (fp32 1e-4,
    bf16 3e-2, each times its (b, h) row's largest |entry|: an output's
    size falls as 1 / sqrt(length), so an absolute bar would pass a lost
    chunk at 32 k positions), a rerun bit-identical, and, where every row
    has a valid position, ``F.scaled_dot_product_attention`` with a
    boolean mask and
    ``enable_gqa`` (the yardstick; the port never calls it) held to the
    plain version; all three timed.  The bound counts the K and V rows
    below each row's length, read once, q read and the output written once;
    4 operations per head, position and column, at the inputs' peak rate.
    ``weight``: this case's launches in one full-width decode step.
    ``plain_rows``: run (and time) the plain version over pieces of that
    many batch rows (its fp32 expansion of the whole cache would not fit
    beside the inputs at llama4's B = 64)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels.ref import decode_attention_ref

    H = KV * G
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(dtype)
    q, k, v = r(B, H, d), r(B, S, KV, d), r(B, S, KV, d)
    cl = torch.tensor(lengths, dtype=torch.int32, device=dev)
    y = kd.decode_attention(q, k, v, cl)
    rows = plain_rows or B

    def plain():
        return torch.cat([decode_attention_ref(q[i:i + rows], k[i:i + rows],
                                               v[i:i + rows], cl[i:i + rows])
                          for i in range(0, B, rows)])
    ref = plain()
    torch.cuda.synchronize()
    if not torch.isfinite(y).all():
        raise AssertionError(f"decode_attention output not finite ({name})")
    tname = str(dtype).split(".")[-1]
    tol = DECODE_TOL[tname]
    err, rel = assert_close_rows(y.float(), ref.float(), tol,
                                 f"decode_attention vs plain {name}")
    if not torch.equal(kd.decode_attention(q, k, v, cl), y):
        raise AssertionError(f"decode_attention rerun is not bit-identical "
                             f"({name})")
    lib_err = lib_rel = lib_fn = None
    if library:
        valid = (torch.arange(S, device=dev)[None, :]
                 < cl[:, None])[:, None, None, :]

        def lib_fn():
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=valid, enable_gqa=True)[:, :, 0]

        lib_err, lib_rel = assert_close_rows(lib_fn().float(), ref.float(),
                                             tol, f"SDPA vs plain {name}")
    del ref
    esize = q.element_size()
    vb = kd._vec_bytes(esize, d, k, v)
    plan = kd.plan(B, S, KV, G, d, dtype, vb, dev)
    ws = torch.empty(plan["ws"], dtype=torch.float32, device=dev)
    fn = kd._kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    raw = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cl.data_ptr(),
           y.data_ptr(), ws.data_ptr(), B, S, H, KV, d, kd._DTYPES[dtype],
           plan["n_split"], plan["chunk"], plan["tile"], vb, *k.stride()[:3],
           *v.stride()[:3], 1.0 / d ** 0.5, stream)

    def launch():
        if fn(*raw):
            raise RuntimeError("decode_attention launch failed")

    reps = dict(n_inner=5, reps=10) if big else {}
    ms = gpu_ms(launch, **reps)
    plain_ms = gpu_ms(plain, n_inner=2, reps=5, warmup=1)
    library_ms = gpu_ms(lib_fn, **reps) if library else None
    n_valid = sum(min(max(n, 0), S) for n in lengths)
    nbytes = (2 * n_valid * KV * d * esize + 2 * B * H * d * esize + 4 * B)
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    case = {"kernel": "decode_attention", "case": name, "B": B, "S": S,
            "kv_heads": KV, "groups": G, "d": d, "dtype": tname,
            "lengths": lengths if len(lengths) <= 8 else
            f"{len(lengths)} rows of {lengths[0]}",
            "plan": {k: plan[k] for k in ("tile", "n_split", "chunk")},
            "vec_bytes": vb, "plain_rows": rows,
            "max_abs_err": err, "max_err_over_row_max": rel,
            "tolerance": tol, "tolerance_of": "each (b, h) row's max |ref|",
            "library_vs_plain_err": lib_err,
            "library_vs_plain_over_row_max": lib_rel, "ms": ms,
            "plain_ms": plain_ms,
            **bound(nbytes, 4 * H * d * n_valid, peak),
            "library_ms": library_ms, "weight": weight}
    print("case " + json.dumps(case))
    return case


def decode_kernel_phase(torch, dev):
    """``decode_attention`` at (a) the reference's test shapes (fp32, one
    query head per KV head, and its bf16 case), (b) granite-8b's layer at
    ``decode_32k`` with B = 8 (q (8, 32, 128), one layer's k/v (8, 32768,
    8, 128) bf16, cache_len 32,767: the full-width decode step's shape,
    36 launches a step), (c) one layer at ``long_500k`` (B = 1, S =
    524,288, 8 KV heads: 2.15 GB), (d) ragged lengths 0 to above S with
    G = 1, 4 and 12."""
    import numpy as np
    from repro_torch.configs import LM_SHAPES
    from repro_torch.configs.granite_8b import CONFIG

    gen = torch.Generator(device=dev).manual_seed(15)
    rng = np.random.default_rng(15)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for B, S, H, d in [(1, 256, 2, 64), (2, 1024, 4, 128), (3, 512, 1, 32)]:
        lengths = rng.integers(1, S + 1, B).tolist()
        cases.append(decode_case(torch, dev, f"reference shape ({B}, {S}, "
                                 f"{H}, {d}) fp32", B, S, H, 1, d, f32,
                                 lengths, gen))
    cases.append(decode_case(torch, dev, "reference bf16 (2, 512, 2, 64)", 2,
                             512, 2, 1, 64, bf16, [300, 512], gen))
    G = CONFIG.n_heads // CONFIG.n_kv
    S = LM_SHAPES["decode_32k"]["seq"]
    cases.append(decode_case(
        torch, dev, f"granite-8b decode_32k layer, B={LM_BATCH}", LM_BATCH,
        S, CONFIG.n_kv, G, CONFIG.hd, bf16, [S - 1] * LM_BATCH, gen,
        weight=CONFIG.n_layers, big=True))
    S = LM_SHAPES["long_500k"]["seq"]
    cases.append(decode_case(
        torch, dev, "granite-8b long_500k layer, B=1", 1, S, CONFIG.n_kv, G,
        CONFIG.hd, bf16, [S - 1], gen, big=True))
    lengths = [0, 1, 1000, 4095, 4096, 5000]
    for g in (1, 4, 12):
        cases.append(decode_case(
            torch, dev, f"ragged lengths {lengths}, G={g}", len(lengths),
            4096, 2, g, 128, bf16, lengths, gen, library=False))
    return cases


def lm_launcher_phase(torch, arch="granite-8b"):
    """``launch.serve --arch ARCH --tokens 16 --batch 2 --prompt-len 16``
    (``REDUCED``, fp32): exactly n_layers x 16 ``decode_attention``
    launches and no other kernel's; its 16 steps' logits within 1e-4 of the
    same run on ``attn="plain"``, and the same greedy tokens as that run
    and as the run with ``--device cpu``."""
    import importlib
    from repro_torch.launch import serve

    cfg = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_")).REDUCED
    argv = ["--arch", arch, "--tokens", "16", "--batch", "2",
            "--prompt-len", "16", "--device", "cuda"]
    reset_launches()
    res = serve.main(argv)
    launches = read_launches(torch)
    plain = serve.serve_lm(serve.parse_args(argv), attn="plain")
    err = assert_close_scaled(res.logits, plain.logits, ORACLE_TOL,
                              f"{arch} launcher kernel vs plain logits")
    report = {"launches": launches, "logits_err": err,
              "max_abs_logit": float(plain.logits.abs().max()),
              "tokens_equal": bool(torch.equal(res.tokens, plain.tokens)),
              "decode_s": res.seconds, "plain_decode_s": plain.seconds,
              "tokens": res.tokens[0].tolist()}
    on_cpu = serve.main(argv[:-1] + ["cpu"])
    report["cpu_tokens_equal"] = bool(torch.equal(res.tokens, on_cpu.tokens))
    print(f"{arch} serving (launcher): " + json.dumps(report))
    if not (report["tokens_equal"] and report["cpu_tokens_equal"]):
        raise AssertionError(f"{arch} launcher: the kernel path generated "
                             "other tokens than the plain or CPU run")
    want = {k: (cfg.n_layers * 16 if k == "decode_attention" else 0)
            for k in KERNELS}
    if launches != want:
        raise AssertionError(f"{arch} launcher launched {launches}; "
                             f"expected {want}")
    return launches, report


def repeat_prefill(caches, pre) -> None:
    """Fill every stack of the padded caches by repeating the prefill's own
    K/V along the sequence axis (-3), whatever the stack's rank: the
    ``dense`` (n_layers, B, S, KV, hd) stack of a dense model, a MoE
    config's ``moe`` stack and its (n_moe, per, B, S, KV, hd) ``dense``
    one."""
    for name, pair in pre.items():
        for buf, c in zip(caches[name], pair):
            *lead, S, KV, hd = buf.shape
            P = c.shape[-3]
            buf.view(*lead, S // P, P, KV, hd).copy_(c.unsqueeze(-4))


def timed_decode(torch, params, tok, caches, cfg, S, what):
    """``LM_STEPS`` greedy ``lm_decode_step``s on the kernel path at the
    cache's end (cache_len S - 1 - LM_STEPS to S - 2), with no host
    synchronisation between steps: ms per step and tokens/s over one
    CUDA-event window around all timed steps after ``LM_WARMUP`` of
    warm-up (each step's own events give the median and spread, an extra
    statistic), and over the last ``LM_PROFILED`` steps, under the
    profiler, the busy share and decode_attention's share (device time
    over the same steps' window); peak memory.  Returns (report, the
    steps' launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tf

    B = tok.shape[0]
    start = S - 1 - LM_STEPS
    timed = LM_STEPS - LM_PROFILED
    tokens = [tok]
    event = lambda: torch.cuda.Event(enable_timing=True)
    marks = [event() for _ in range(timed + 1)]
    reset_launches()
    for i in range(timed):
        marks[i].record()
        lg, caches = tf.lm_decode_step(params, tok, caches, start + i,
                                       cfg, S)
        tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        tokens.append(tok)
    marks[timed].record()
    marks[timed].synchronize()
    times = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    window_ms = marks[LM_WARMUP].elapsed_time(marks[timed])
    p0, p1 = event(), event()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p0.record()
        for i in range(timed, LM_STEPS):
            lg, caches = tf.lm_decode_step(params, tok, caches,
                                           start + i, cfg, S)
            tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
            tokens.append(tok)
        p1.record()
        torch.cuda.synchronize()
    profiled_ms = p0.elapsed_time(p1) / LM_PROFILED
    launches = read_launches(torch)
    if not torch.isfinite(lg).all():
        raise AssertionError(f"{what}: decode logits not finite")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 \
        / LM_PROFILED
    attn_ms = sum(e.self_device_time_total for e in kernels
                  if "decode_split" in e.key
                  or "decode_merge_kernel" in e.key) / 1e3 / LM_PROFILED
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    n_window = timed - LM_WARMUP
    step_ms = window_ms / n_window
    report = {
        "step_ms": step_ms, "window_steps": n_window,
        "window_ms": window_ms, "tokens_per_s": B * n_window / window_ms
        * 1e3, "step_ms_median": statistics.median(times[LM_WARMUP:]),
        "step_ms_all": times,
        "device_ms_per_step": device_ms,
        "profiled_ms_per_step": profiled_ms,
        "busy_share": device_ms / profiled_ms if device_ms else None,
        "decode_attention_ms_per_step": attn_ms,
        "decode_attention_share": attn_ms / profiled_ms if device_ms
        else None,
        "top_kernels_ms_per_step": [
            [e.key[:60], e.self_device_time_total / 1e3 / LM_PROFILED,
             e.count // LM_PROFILED] for e in top],
        "launches": launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated(tok.device) / 1e9,
        "tokens": torch.cat(tokens, dim=1)[0].tolist()}
    if not device_ms:
        print(f"{what}: the profiler saw no device time; busy share not "
              "measured")
    return report, launches


def lm_config_phase(torch, dev):
    """granite-8b's ``CONFIG`` (36 layers, d_model 4096, 32 heads / 8 KV
    heads, 8.25 G params drawn on the card straight into bf16): prefill of
    a B = 8 x 512-token prompt; caches of ``decode_32k``'s 32,768 positions
    (38.65 GB) filled by repeating the prefill's own K/V along the
    sequence (``LMBundle.make_batch("decode_32k", batch=8)``); one decode
    step at cache_len 32,767 through ``LMBundle.step_fn("decode_32k")`` on
    the kernel path and then on the plain path over the same caches (each
    writes position 32,767 first), logits within 3e-2 of the largest; then
    32 greedy steps
    on the kernel path (cache_len 32,735 to 32,766), 36 launches each, with
    no host synchronisation between steps: ms per step and tokens/s over
    one CUDA-event window around all timed steps after 2 of warm-up (each
    step's own events give the median and spread, an extra statistic), and
    over the last 4 steps, under the profiler, the busy share and
    decode_attention's share (device time over the same steps' window);
    peak memory (``timed_decode``)."""
    from repro_torch.configs import LM_SHAPES
    from repro_torch.configs.families import LMBundle
    from repro_torch.configs.granite_8b import CONFIG as cfg
    from repro_torch.models import transformer as tf

    B, P, S = LM_BATCH, LM_PROMPT, LM_SHAPES["decode_32k"]["seq"]
    bundle = LMBundle(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    t0 = time.perf_counter()
    params = bundle.init_params(gen, dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    report = {"params": cfg.param_count(),
              "param_gb": cfg.param_count() * 2 / 1e9,
              "cache_gb": cfg.kv_bytes_per_token() * B * S / 1e9,
              "init_s": time.perf_counter() - t0}
    print(f"granite-8b CONFIG: {report['params']} params "
          f"({report['param_gb']:.2f} GB bf16) drawn on the card in "
          f"{report['init_s']:.2f}s; caches {report['cache_gb']:.2f} GB")
    paths = {}
    with torch.inference_mode():
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                               device=dev)
        reset_launches()
        t0 = time.perf_counter()
        logits, pre = tf.lm_prefill(params, prompt, cfg)
        torch.cuda.synchronize()
        report["prefill_s"] = time.perf_counter() - t0
        paths["granite-8b CONFIG prefill"] = read_launches(torch)
        if not torch.isfinite(logits).all():
            raise AssertionError("CONFIG prefill logits not finite")
        # decode_32k's batch at B = 8: zero caches, cache_len S - 1
        batch = bundle.make_batch("decode_32k", gen, dev, batch=B)
        caches = batch["caches"]
        repeat_prefill(caches, pre)
        del pre
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        batch["token"] = tok
        reset_launches()
        lk, _ = bundle.step_fn("decode_32k")(params, batch)
        check = read_launches(torch)
        paths["granite-8b CONFIG decode (check step)"] = check
        lp, _ = bundle.step_fn("decode_32k", attn="plain")(params, batch)
        err = assert_close_scaled(lk.float(), lp.float(), DECODE_TOL[
            "bfloat16"], "CONFIG decode step kernel vs plain", floor=0.0)
        report.update({
            "check_logits_err": err,
            "check_max_abs_logit": float(lp.float().abs().max()),
            "check_argmax_agree": float((lk.argmax(-1) == lp.argmax(-1))
                                        .float().mean()),
            "check_launches": check})
        del lk, lp
        torch.cuda.synchronize()
        timing, launches = timed_decode(torch, params, tok, caches, cfg, S,
                                        "granite-8b decode")
    paths[f"granite-8b CONFIG decode ({LM_STEPS} steps)"] = launches
    report.update(timing)
    print("granite-8b decode (CONFIG): " + json.dumps(report))
    for what, got, steps in (("check step", check, 1),
                             (f"{LM_STEPS} steps", launches, LM_STEPS)):
        want = {k: (cfg.n_layers * steps if k == "decode_attention" else 0)
                for k in KERNELS}
        if got != want:
            raise AssertionError(f"CONFIG decode {what} launched {got}; "
                                 f"expected {want}")
    del params, caches
    return paths, report


def lm_phases(torch, dev):
    """Every LM path, after the wide & deep phases have freed the card: the
    kernel cases, the launcher (``REDUCED``), then ``CONFIG``."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev) / 1e9
    print(f"LM phases: {left:.2f} GB still allocated")
    if left > 4:
        raise AssertionError(f"{left:.2f} GB left allocated before the LM "
                             "phases; the 38.65 GB cache will not fit")
    cases = decode_kernel_phase(torch, dev)
    torch.cuda.empty_cache()
    paths = {}
    paths["granite-8b serving (launcher)"], report = lm_launcher_phase(torch)
    config_paths, config_report = lm_config_phase(torch, dev)
    paths.update(config_paths)
    return cases, paths, {"launcher": report, "config": config_report}


# ---------------------------------------------------------------------------
# LM training (no kernel of the port: the reference's LM training runs plain
# JAX attention, and the port's plain flash_attention)
# ---------------------------------------------------------------------------
# granite-8b train_4k at full width, cut to 12 of 36 layers and batch 1 of
# 256: 3.02 G parameters, 16 B each of fp32 params, grads and Adam moments
LM_TRAIN_LAYERS = 12
LM_TRAIN_BATCH = 1
LM_TRAIN_SEQ = 4096
LM_TRAIN_WARMUP = 1
LM_TRAIN_TIMED = 4
LM_CHECK_LAYERS = 2
LM_CHECK_STEPS = 3
LM_STATE_BYTES_PER_PARAM = 16


def lm_train_launcher_phase(torch, arch="granite-8b"):
    """``launch.train --arch ARCH --steps 10`` (``REDUCED``) on the card,
    then with ``--device cpu`` in the same process: the 10 losses within
    1e-4 (relative), falling; no kernel launched."""
    reset_launches()
    card, _, card_s = run_launcher(["--arch", arch, "--steps", "10"])
    launches = read_launches(torch)
    cpu, _, cpu_s = run_launcher(["--arch", arch, "--steps", "10",
                                  "--device", "cpu"])
    check_curve(card.losses, f"{arch} launcher (card)")
    rel = [abs(a - b) / max(abs(b), 1e-12)
           for a, b in zip(card.losses, cpu.losses)]
    report = {"card_losses": card.losses, "cpu_losses": cpu.losses,
              "loss_rel_err": max(rel), "card_s": card_s, "cpu_s": cpu_s,
              "launches": launches}
    print(f"{arch} training (launcher, REDUCED): " + json.dumps(report))
    if len(card.losses) != 10 or max(rel) > 1e-4:
        raise AssertionError(f"{arch} launcher: card and CPU losses differ "
                             f"by {max(rel):.3e} > 1e-4")
    if any(launches.values()):
        raise AssertionError(f"{arch} training launched {launches}")
    return launches, report


def _counter(obs, name: str) -> float:
    return sum(v for k, v in obs.snapshot()["counters"].items()
               if k == name or k.startswith(name + "{"))


def _leaf_rel_err(a_tree, b_tree) -> float:
    from repro_torch.train import tree_leaves
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)))


def lm_resilience_phase(torch, dev):
    """The crash and corrupt-file drills at granite-8b ``REDUCED`` on the
    card, as ``tests/test_chaos.py`` runs them: ``Fault("train.step",
    "crash", hit=5)`` over ``fit(..., 6, ckpt_dir, ckpt_every=2)`` raises
    ``InjectedFault`` with step 4 the latest checkpoint; a resumed ``fit``
    over the batches from step 5 gives the uninterrupted run's loss and
    parameters within 1e-6 (relative: the embedding gather's backward
    accumulates in another order from run to run).  Then the newest
    checkpoint garbled by ``corrupt_file``: restore falls back to step 4,
    and ``train.ckpt_fallback`` counts exactly 1 over both drills."""
    from repro_torch import obs
    from repro_torch.chaos import (Fault, FaultPlan, InjectedFault, armed,
                                   corrupt_file)
    from repro_torch.configs.granite_8b import REDUCED as cfg
    from repro_torch.models import lm_init, lm_loss
    from repro_torch.train import (adam, checkpoint, fit, lm_token_batches,
                                   restore_checkpoint)

    params0 = lambda: lm_init(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    t = lambda a: torch.as_tensor(a, device=dev)
    loss_fn = lambda p, b: lm_loss(p, t(b["tokens"]), t(b["targets"]), cfg)
    batches = lambda start: lm_token_batches(cfg.vocab, 4, 64,
                                             start_step=start)
    quiet = dict(ckpt_every=2, log_every=0, log=lambda *a: None)
    obs.reset()
    obs.enable()
    try:
        with tempfile.TemporaryDirectory(prefix="lm-ckpt-") as root:
            ref = fit(loss_fn, adam(1e-3), params0(), batches(0), 6,
                      ckpt_dir=os.path.join(root, "ref"), **quiet)
            crash_dir = os.path.join(root, "crash")
            try:
                with armed(FaultPlan.of(Fault("train.step", "crash",
                                              hit=5))):
                    fit(loss_fn, adam(1e-3), params0(), batches(0), 6,
                        ckpt_dir=crash_dir, **quiet)
            except InjectedFault as e:
                crash = str(e)
            else:
                raise AssertionError("crash drill: the armed fault did not "
                                     "fire")
            for _ in range(250):        # the writer may lag the crash
                if checkpoint.latest_step(crash_dir) == 4:
                    break
                time.sleep(0.02)
            latest = checkpoint.latest_step(crash_dir)
            res = fit(loss_fn, adam(1e-3), params0(), batches(5), 6,
                      ckpt_dir=crash_dir, **quiet)
            loss_rel = abs(res.losses[0] - ref.losses[5]) / abs(ref.losses[5])
            param_rel = _leaf_rel_err(res.params, ref.params)
            after_crash = _counter(obs, "train.ckpt_fallback")
            newest = checkpoint.latest_step(crash_dir)
            corrupt_file(os.path.join(crash_dir, f"step_{newest:08d}.npz"),
                         seed=0, mode="garble")
            template = params0()
            _, _, restored = restore_checkpoint(
                crash_dir, template, adam(1e-3).init(template))
            fallbacks = _counter(obs, "train.ckpt_fallback")
    finally:
        obs.disable()
        obs.reset()
    report = {"crash": crash, "latest_after_crash": latest,
              "resumed_steps": res.steps, "loss_rel_err": loss_rel,
              "param_rel_err": param_rel, "corrupted_step": newest,
              "restored_step": restored,
              "fallbacks_after_crash_drill": after_crash,
              "fallbacks": fallbacks}
    print("granite-8b resilience drills (REDUCED): " + json.dumps(report))
    if latest != 4 or res.steps != 1:
        raise AssertionError(f"crash drill: latest checkpoint {latest}, "
                             f"resumed {res.steps} steps; expected 4 and 1")
    if loss_rel > 1e-6 or param_rel > 1e-6:
        raise AssertionError(f"crash drill: the resumed run differs from "
                             f"the uninterrupted one by {loss_rel:.3e} "
                             f"(loss) / {param_rel:.3e} (params) > 1e-6")
    if (newest, restored, after_crash, fallbacks) != (5, 4, 0, 1):
        raise AssertionError(f"corrupt-file drill: newest {newest}, "
                             f"restored {restored}, fallbacks "
                             f"{after_crash} then {fallbacks}; expected 5, "
                             "4, 0 then 1")
    return report


def lm_train_flops(cfg, B: int, S: int) -> dict:
    """bf16 operations of one ``train_4k`` step as the port computes it:
    6 T N over the matmul parameters a token runs through (the layers and
    the head; a MoE layer's ``top_k`` experts and its shared expert, the
    router not counted, as ``active_param_count``), the layers' remat
    forward (2 T N_layers), the loss chunks' recomputed head (2 T N_head),
    and the flash core's QKᵀ and PV over all S x S positions (no causal
    skip): forward, remat forward and a backward of twice the forward, 16
    B S² H hd a layer.  A MoE layer's expert GEMMs run over E x C slots,
    ``capacity`` / (T k / E) = ~1.25 x the assignments they hold: that
    extra work is not counted."""
    T = B * S
    D, hd = cfg.d_model, cfg.hd
    attn_params = D * cfg.n_heads * hd * 2 + D * cfg.n_kv * hd * 2
    ffn_layers = cfg.n_dense_layers + cfg.n_moe_layers * (
        cfg.top_k + int(cfg.shared_expert))
    n_layers = (cfg.n_layers * attn_params
                + ffn_layers * 3 * D * cfg.d_ff)
    n_head = D * cfg.vocab
    attn = 16 * B * S * S * cfg.n_heads * hd * cfg.n_layers
    parts = {"6TN": 6 * T * (n_layers + n_head), "remat": 2 * T * n_layers,
             "loss_recompute": 2 * T * n_head, "attention": attn}
    return {**parts, "total": sum(parts.values())}


def lm_train_check_phase(torch, dev, cfg, batch, what="granite-8b"):
    """At ``LM_CHECK_LAYERS`` layers of the full width (no remat fits
    there): ``lm_loss`` (remat, 8 chunks) against ``cross_entropy`` over
    ``lm_forward(remat=False)`` plus 0.01 x its aux loss (0 for a dense
    model) on the same params and batch; the loss
    within 1e-3 (relative), every gradient within 3e-2 of its leaf's
    largest entry (the reference's bf16 bar).  Then ``LM_CHECK_STEPS``
    steps of the bundle's train step, donated against functional (the
    functional one fits at this depth): losses and parameters within
    1e-6."""
    import dataclasses
    from repro_torch.configs.families import LMBundle
    from repro_torch.models import lm_forward, lm_init, lm_loss
    from repro_torch.nn.layers import cross_entropy
    from repro_torch.train import make_train_step, tree_leaves, tree_map
    from repro_torch.train.optimizer import tree_unflatten

    small = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS)
    params = lm_init(torch.Generator(device=dev).manual_seed(21), small,
                     device=dev)
    out = {}
    for remat in (True, False):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        if remat:
            loss = lm_loss(p, batch["tokens"], batch["targets"], small)
        else:
            logits, aux = lm_forward(p, batch["tokens"], small,
                                     remat=False)
            loss = cross_entropy(logits, batch["targets"]) + 0.01 * aux
            del logits
        grads = torch.autograd.grad(loss, leaves)
        out[remat] = (float(loss.detach()), grads)
        del loss, leaves, p
    out_loss = {k: v[0] for k, v in out.items()}
    loss_rel = abs(out[True][0] - out[False][0]) / abs(out[False][0])
    gaps = [float((a.float() - b.float()).abs().max())
            / max(float(b.float().abs().max()), 1e-30)
            for a, b in zip(out[True][1], out[False][1])]
    del out
    # the same params through LM_CHECK_STEPS steps of the bundle's train
    # step (donated, in place) and of its functional form: one arithmetic,
    # so the same losses and parameters
    bundle = LMBundle(small)
    steps = {}
    for donate in (False, True):
        p = tree_map(lambda t: t.clone(), params)
        state = bundle.opt().init(p)
        fn = make_train_step(bundle.loss_fn, bundle.opt(), clip_norm=1.0,
                             donate=donate)
        losses = []
        for _ in range(LM_CHECK_STEPS):
            p, state, loss = fn(p, state, batch)
            losses.append(float(loss))
        steps[donate] = (losses, p)
        del state
    form_rel = max(abs(a - b) / abs(b) for a, b in zip(steps[True][0],
                                                       steps[False][0]))
    form_param_rel = _leaf_rel_err(steps[True][1], steps[False][1])
    report = {"layers": LM_CHECK_LAYERS, "loss_remat": out_loss[True],
              "loss_plain": out_loss[False], "loss_rel_err": loss_rel,
              "grad_gap_of_largest": max(gaps), "grad_gaps": gaps,
              "donated_losses": steps[True][0],
              "functional_losses": steps[False][0],
              "donated_vs_functional_loss_rel": form_rel,
              "donated_vs_functional_param_rel": form_param_rel}
    print(f"{what} train_4k remat/chunks vs plain, donated vs "
          f"functional (full width, {LM_CHECK_LAYERS} layers): "
          + json.dumps(report))
    if loss_rel > 1e-3 or max(gaps) > 3e-2:
        raise AssertionError(f"remat/chunked lm_loss vs plain: loss "
                             f"{loss_rel:.3e} (bar 1e-3), gradients "
                             f"{max(gaps):.3e} of the largest (bar 3e-2)")
    if form_rel > 1e-6 or form_param_rel > 1e-6:
        raise AssertionError(f"donated vs functional train step: losses "
                             f"{form_rel:.3e}, params {form_param_rel:.3e} "
                             "(bar 1e-6)")
    del steps, params
    return report


def lm_train_pieces(torch, bundle, params, state, batch) -> dict:
    """One more step, timed in its three pieces with CUDA events: the loss
    and its gradients, the in-place global-norm clip, the in-place Adam."""
    from repro_torch.models import lm_loss
    from repro_torch.train import tree_leaves
    from repro_torch.train.optimizer import (clip_by_global_norm_,
                                             tree_unflatten)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    marks[0].record()
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = lm_loss(tree_unflatten(params, live), batch["tokens"],
                   batch["targets"], bundle.cfg)
    grads = list(torch.autograd.grad(loss, live))
    del live
    marks[1].record()
    with torch.no_grad():
        clip_by_global_norm_(grads, 1.0)
        marks[2].record()
        bundle.opt().update_(grads, state, params)
    marks[3].record()
    marks[3].synchronize()
    names = ("loss_and_grads_ms", "clip_ms", "adam_ms")
    return {n: a.elapsed_time(b)
            for n, a, b in zip(names, marks, marks[1:])}


def lm_train_config_phase(torch, dev):
    """granite-8b ``train_4k`` at full width (d_model 4096, 32 / 8 KV
    heads, head_dim 128, d_ff 14,336, vocab 49,152, seq 4,096), cut to
    ``LM_TRAIN_LAYERS`` of 36 layers and batch ``LM_TRAIN_BATCH`` of 256:
    fp32 master params drawn on the card, fp32 Adam moments, bf16 compute,
    through ``LMBundle(cfg).step_fn("train_4k")`` (donated: in place) on
    ``lm_token_batches(49152, 1, 4096)``.  First the remat/chunking check
    at ``LM_CHECK_LAYERS`` layers; then 1 warm-up and 4 timed steps (ms a
    step from CUDA events, median), one profiled step (busy share, device
    time by kind), one step timed in pieces; tokens/s, peak memory beside
    the predicted state, and the bf16 FLOP share."""
    import dataclasses
    import math
    from repro_torch.configs.families import LMBundle
    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.models import lm_init
    from repro_torch.train import lm_token_batches

    S = LM_TRAIN_SEQ
    cfg = dataclasses.replace(CONFIG, n_layers=LM_TRAIN_LAYERS)
    raw = next(lm_token_batches(cfg.vocab, LM_TRAIN_BATCH, S))
    batch = {k: torch.as_tensor(raw[k], device=dev)
             for k in ("tokens", "targets")}
    check = lm_train_check_phase(torch, dev, CONFIG, batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    bundle = LMBundle(cfg)
    gen = torch.Generator(device=dev).manual_seed(21)
    t0 = time.perf_counter()
    params = bundle.init_params(gen, dev)
    state = bundle.opt().init(params)
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    state_gb = n_params * LM_STATE_BYTES_PER_PARAM / 1e9
    print(f"granite-8b train_4k: {cfg.n_layers} of {CONFIG.n_layers} "
          f"layers, {n_params} params (fp32), predicted state "
          f"{state_gb:.2f} GB (params, grads, m, v); drawn on the card in "
          f"{time.perf_counter() - t0:.2f}s")
    reset_launches()
    br = step_breakdown(torch, "granite-8b train_4k", bundle.step_fn(
        "train_4k"), params, state, batch, warmup=LM_TRAIN_WARMUP,
        timed=LM_TRAIN_TIMED, n_prof=1,
        watch={"gemm": "gemm", "nvjet": "nvjet",
               "elementwise": "elementwise", "reduce": "reduce_kernel"})
    launches = read_launches(torch)
    pieces = lm_train_pieces(torch, bundle, params, state, batch)
    flops = lm_train_flops(cfg, LM_TRAIN_BATCH, S)
    tokens = LM_TRAIN_BATCH * S
    report = {
        "layers": cfg.n_layers, "batch": LM_TRAIN_BATCH, "seq": S,
        "params": n_params, "predicted_state_gb": state_gb,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "step_ms": br["step_ms"], "step_ms_all": br["step_ms_all"],
        "tokens_per_s": tokens / br["step_ms"] * 1e3,
        "busy_share": br["busy_share"],
        "device_ms_per_step": br["device_ms_per_step"],
        "losses": br["losses"], "pieces_ms": pieces, "flops": flops,
        "bf16_flop_share": flops["total"] / (br["step_ms"] / 1e3)
        / PEAK_BF16_FLOPS, "check": check, "launches": launches,
        "breakdown": br}
    print("granite-8b train_4k (12 of 36 layers, B=1): " + json.dumps(
        {k: v for k, v in report.items()
         if k not in ("breakdown", "check", "step_ms_all")}))
    if not all(math.isfinite(v) for v in br["losses"]):
        raise AssertionError(f"train_4k: a loss is not finite "
                             f"{br['losses']}")
    if any(launches.values()):
        raise AssertionError(f"train_4k launched {launches}")
    del params, state, batch
    return launches, report


def lm_training_phases(torch, dev):
    """LM training, after the LM serving phases have freed the card: the
    launcher at ``REDUCED`` (card vs CPU), the resilience drills, then
    ``train_4k`` at full width."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev) / 1e9
    print(f"LM training phases: {left:.2f} GB still allocated")
    if left > 4:
        raise AssertionError(f"{left:.2f} GB left allocated before LM "
                             "training; the 48 GB of train_4k state will "
                             "not fit")
    paths, report = {}, {}
    paths["granite-8b training (launcher, REDUCED)"], report["launcher"] = \
        lm_train_launcher_phase(torch)
    report["drills"] = lm_resilience_phase(torch, dev)
    paths["granite-8b train_4k (12 of 36 layers, B=1)"], report[
        "train_4k"] = lm_train_config_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    return paths, report


# ---------------------------------------------------------------------------
# the MoE LMs (nn/moe and the superblock transformer): decode_attention on
# every layer of a decode step, dense or MoE; the experts are batched
# matmuls and the dispatch plain indexing, as the reference's are XLA ops
# ---------------------------------------------------------------------------
MOE_ARCHS = ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b")
# decode_32k's batch, cut from 128: granite-moe's cache is 65,536 B a token
# (51.5 GB at 24, 68.7 GB at 32 beside 6.75 GB of weights); llama4's, at
# its 2 layers, 8,192 B (17.2 GB at 64; 34.4 GB at 128 leaves no room for
# the prefill beside 37.1 GB of weights)
MOE_DECODE_BATCH = {"granite-moe-3b-a800m": 24,
                    "llama4-maverick-400b-a17b": 64}
# llama4 cut to 2 of 48 layers: one superblock (a dense layer, then a MoE
# layer of 128 experts and the shared expert), 18.55 G parameters; a second
# superblock would need 69.5 GB of bf16 weights
MOE_LAYERS = {"granite-moe-3b-a800m": None, "llama4-maverick-400b-a17b": 2}
# the plain attention's (and decode_attention_ref's) expansion of the cache
# to every query head, at most this many bytes a batch piece
MOE_PLAIN_BYTES = 8e9
# a route that flips between the kernel and the plain path with a top-k
# margin above this (in probability) is a disagreement, not a near-tie
MOE_FLIP_MARGIN = 1e-2
# granite-moe train_4k at full width and depth (32 layers), batch cut from
# 256 to 2: 16 B x 3.374 G parameters of state = 53.99 GB (at B = 4 the
# peak was 76.57 GB, past the 75 GB limit: the plain flash core keeps ~18
# GB for one layer's recompute)
MOE_TRAIN_BATCH = 2
MOE_TRAIN_WARMUP = 1
MOE_TRAIN_TIMED = 2
MOE_RERUN_STEPS = 3


def moe_config(arch):
    """The arch's ``CONFIG``, cut to ``MOE_LAYERS`` layers where set."""
    import dataclasses
    import importlib
    cfg = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_")).CONFIG
    if MOE_LAYERS[arch]:
        cfg = dataclasses.replace(cfg, n_layers=MOE_LAYERS[arch])
    return cfg


def plain_rows(cfg, S, B, esize) -> int:
    """Batch rows a piece of the plain attention takes: its expansion of a
    row's K and V to every query head at ``esize`` bytes an entry."""
    row = 2 * S * cfg.n_heads * cfg.hd * esize
    return max(1, min(B, int(MOE_PLAIN_BYTES // row)))


def moe_decode_kernel_phase(torch, dev):
    """``decode_attention`` at the two MoE archs' GQA shapes at
    ``decode_32k`` (cache_len 32,767) and their serving batches:
    granite-moe (H 24 / KV 8, G = 3, d = 64, B = 24; 32 launches a step)
    and llama4 (H 40 / KV 8, G = 5, d = 128, B = 64; 2 launches a step at
    its 2 layers), each against its plain version (in pieces of batch rows)
    at the reference's bf16 bar and timed beside SDPA and its bound."""
    from repro_torch.configs import LM_SHAPES

    gen = torch.Generator(device=dev).manual_seed(23)
    S = LM_SHAPES["decode_32k"]["seq"]
    cases = []
    for arch in MOE_ARCHS:
        cfg, B = moe_config(arch), MOE_DECODE_BATCH[arch]
        cases.append(decode_case(
            torch, dev, f"{arch} decode_32k layer, B={B}", B, S, cfg.n_kv,
            cfg.n_heads // cfg.n_kv, cfg.hd, torch.bfloat16, [S - 1] * B,
            gen, weight=cfg.n_layers, big=True,
            plain_rows=plain_rows(cfg, S, B, 4)))
        torch.cuda.empty_cache()
    return cases


class RouteRecorder:
    """While entered, ``nn.moe.moe_routes`` (which ``_moe_apply_impl``
    looks up at each call) is wrapped: each call's sorted top-k expert
    set, the router's top-k margin (the k-th largest probability less the
    (k+1)-th) and the share of its assignments within capacity are kept,
    one entry a MoE layer, until ``take``."""

    def __init__(self, torch, moe):
        self.torch, self.moe, self.inner = torch, moe, moe.moe_routes
        self.calls = []

    def __enter__(self):
        self.moe.moe_routes = self._record
        return self

    def __exit__(self, *exc):
        self.moe.moe_routes = self.inner

    def _record(self, p, x, top_k, *args, **kw):
        r = self.inner(p, x, top_k, *args, **kw)
        vals = self.torch.sort(r.probs, dim=-1, descending=True).values
        self.calls.append({
            "ids": self.torch.sort(r.expert_ids, dim=1).values,
            "margin": vals[:, top_k - 1] - vals[:, top_k],
            "kept": float(r.keep.float().mean())})
        return r

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out


def compare_routes(torch, kernel, plain):
    """The share of (token, MoE layer) routes whose expert sets agree, and
    each flip with the kernel path's margin; a token's first flip (its
    earlier layers routed alike, so its inputs differ only by the
    attention's rounding) is marked ``first``: later ones follow from it."""
    agree, flips, flipped = [], [], set()
    for layer, (a, b) in enumerate(zip(kernel, plain)):
        same = (a["ids"] == b["ids"]).all(dim=1)
        agree.append(same)
        for t in (~same).nonzero().flatten().tolist():
            flips.append({"layer": layer, "token": t,
                          "margin": float(a["margin"][t]),
                          "first": t not in flipped})
            flipped.add(t)
    return float(torch.cat(agree).float().mean()), flips


def decode_walk(torch, params, cfg, tok, caches, pos, S, follow, rows,
                hold=False):
    """One decode step at cache_len ``pos``, walked layer by layer with
    the port's own pieces (``layer_schedule``, ``nn.attention.
    decode_attention``, each layer's FFN, dense or MoE): the walk goes on
    with ``follow``'s attention output ("kernel" or "plain"); the plain
    attention runs over pieces of ``rows`` batch rows (its expanded cache
    would not fit whole at llama4's B = 64); with ``hold``, both run at
    every layer on the same hidden state.  Returns (logits, each layer's
    (max |kernel - plain|, max |plain|) under ``hold``)."""
    from repro_torch.models import transformer as tf
    from repro_torch.nn.attention import decode_attention, rope_freqs
    from repro_torch.nn.layers import rmsnorm_apply

    cos, sin = rope_freqs(cfg.hd, S + 1, cfg.rope_theta, dtype=cfg.dtype,
                          device=tok.device)
    B = tok.shape[0]
    h = tf._embed(params, tok, cfg)
    errs = []
    for kind, lp, idx in tf.layer_schedule(params, cfg):
        kc, vc = (t[idx] for t in caches[kind])
        h2 = rmsnorm_apply(lp["ln1"], h)
        args = (cfg.n_heads, cfg.n_kv, cfg.hd, cos, sin)
        att = {}
        if hold or follow == "kernel":
            att["kernel"], _ = decode_attention(lp["attn"], h2, (kc, vc),
                                                pos, *args, attn="kernel")
        if hold or follow == "plain":
            att["plain"] = torch.cat([decode_attention(
                lp["attn"], h2[i:i + rows], (kc[i:i + rows], vc[i:i + rows]),
                pos, *args, attn="plain")[0] for i in range(0, B, rows)])
        if hold:
            a, b = att["kernel"].float(), att["plain"].float()
            errs.append((float((a - b).abs().max()), float(b.abs().max())))
        h = tf._ffn(kind, lp, h + att[follow], cfg)
    h = rmsnorm_apply(params["ln_f"], h)
    return h @ params["head"].to(cfg.dtype), errs


def moe_config_phase(torch, dev, arch):
    """A MoE arch's ``CONFIG`` served at full width (llama4 cut to
    ``MOE_LAYERS`` layers), its bf16 parameters drawn on the card expert by
    expert: a B x 512 prefill (``MOE_DECODE_BATCH``); ``decode_32k``'s
    caches filled by repeating the prefill's K/V along the sequence; at
    cache_len 32,767 one step through ``LMBundle.step_fn("decode_32k")``
    on the kernel path (n_layers launches), rerun bit-identical; the
    teacher-forced hold: the step walked layer by layer, each layer's
    attention on the kernel path's hidden state through both ``attn=
    "kernel"`` and ``"plain"``, outputs within 3e-2 of the largest entry;
    the free-running plain step: the share of (token, layer) routes that
    agree with the kernel path's, each flip with its top-k margin (a
    token's first flip above ``MOE_FLIP_MARGIN`` fails; the logits are
    held at 3e-2 of the largest only if no route flipped), the share of
    assignments dropped by capacity; then 32 greedy steps timed as
    granite-8b's (``timed_decode``), n_layers launches each."""
    from repro_torch.configs import LM_SHAPES
    from repro_torch.configs.families import LMBundle
    from repro_torch.models import transformer as tf
    from repro_torch.nn import moe

    cfg = moe_config(arch)
    B, P, S = (MOE_DECODE_BATCH[arch], LM_PROMPT,
               LM_SHAPES["decode_32k"]["seq"])
    bundle = LMBundle(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    t0 = time.perf_counter()
    params = bundle.init_params(gen, dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    rows = plain_rows(cfg, S, B, 2)
    report = {"layers": cfg.n_layers, "batch": B, "prompt": P, "seq": S,
              "params": cfg.param_count(),
              "active_params": cfg.active_param_count(),
              "param_gb": cfg.param_count() * 2 / 1e9,
              "cache_gb": cfg.kv_bytes_per_token() * B * S / 1e9,
              "capacity": moe.capacity(B, cfg.top_k, cfg.n_experts),
              "plain_rows": rows, "init_s": time.perf_counter() - t0}
    print(f"{arch} CONFIG ({cfg.n_layers} layers): {report['params']} "
          f"params ({report['param_gb']:.2f} GB bf16) drawn on the card in "
          f"{report['init_s']:.2f}s; caches {report['cache_gb']:.2f} GB at "
          f"B={B}; capacity {report['capacity']} slots an expert")
    paths = {}
    with torch.inference_mode():
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                               device=dev)
        reset_launches()
        t0 = time.perf_counter()
        logits, pre = tf.lm_prefill(params, prompt, cfg)
        torch.cuda.synchronize()
        report["prefill_s"] = time.perf_counter() - t0
        paths[f"{arch} CONFIG prefill"] = read_launches(torch)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{arch} CONFIG prefill logits not finite")
        batch = bundle.make_batch("decode_32k", gen, dev, batch=B)
        caches = batch["caches"]
        repeat_prefill(caches, pre)
        del pre
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        batch["token"] = tok
        step = bundle.step_fn("decode_32k")
        with RouteRecorder(torch, moe) as rec:
            reset_launches()
            lk, _ = step(params, batch)
            check = read_launches(torch)
            kernel_routes = rec.take()
            rerun, _ = step(params, batch)
            rec.take()
            if arch == "granite-moe-3b-a800m":
                mesh_launches, report["lm_mesh"] = lm_mesh_phase(
                    torch, dev, step, params, batch, lk, cfg)
                paths[f"{arch} CONFIG decode on a (1, 1) mesh"] = \
                    mesh_launches
                rec.take()
                (paths[f"{arch} CONFIG decode, B=1, no mesh then the "
                       f"expert-parallel branch on a (1, 1) mesh"],
                 report["moe_ep_mesh"]) = moe_ep_mesh_phase(
                    torch, dev, step, params, batch, cfg)
                rec.take()
            walked, errs = decode_walk(torch, params, cfg, tok, caches,
                                       S - 1, S, "kernel", rows, hold=True)
            rec.take()
            lp, _ = decode_walk(torch, params, cfg, tok, caches, S - 1, S,
                                "plain", rows)
            plain_routes = rec.take()
        paths[f"{arch} CONFIG decode (check step)"] = check
        share, flips = compare_routes(torch, kernel_routes, plain_routes)
        kept = [r["kept"] for r in kernel_routes]
        hold = max(e / max(m, 1e-30) for e, m in errs)
        report.update({
            "check_launches": check,
            "rerun_bit_identical": bool(torch.equal(lk, rerun)),
            "walk_equals_step": bool(torch.equal(walked, lk)),
            "teacher_forced_attn_err_of_largest": hold,
            "teacher_forced_attn_errs": errs,
            "logits_err": float((lk.float() - lp.float()).abs().max()),
            "max_abs_logit": float(lp.float().abs().max()),
            "argmax_agree": float((lk.argmax(-1) == lp.argmax(-1))
                                  .float().mean()),
            "route_agree_share": share, "route_flips": flips,
            "drop_share": 1 - sum(kept) / len(kept),
            "drop_share_by_layer": [1 - k for k in kept]})
        del lk, rerun, walked, lp
        torch.cuda.synchronize()
        timing, launches = timed_decode(torch, params, tok, caches, cfg, S,
                                        f"{arch} decode")
    paths[f"{arch} CONFIG decode ({LM_STEPS} steps)"] = launches
    report.update(timing)
    print(f"{arch} decode (CONFIG, {cfg.n_layers} layers, B={B}): "
          + json.dumps(report))
    if not report["rerun_bit_identical"]:
        raise AssertionError(f"{arch} CONFIG: a rerun of the decode step "
                             "is not bit-identical")
    if hold > DECODE_TOL["bfloat16"]:
        raise AssertionError(f"{arch} CONFIG teacher-forced hold: kernel vs "
                             f"plain attention {hold:.3e} of the largest "
                             f"entry > {DECODE_TOL['bfloat16']}")
    bad = [f for f in flips if f["first"] and f["margin"] > MOE_FLIP_MARGIN]
    if bad:
        raise AssertionError(f"{arch} CONFIG: routes flipped between the "
                             f"kernel and plain paths with margins above "
                             f"{MOE_FLIP_MARGIN}: {bad}")
    if not flips:
        if report["logits_err"] > DECODE_TOL["bfloat16"] * \
                report["max_abs_logit"]:
            raise AssertionError(f"{arch} CONFIG decode step kernel vs "
                                 f"plain logits {report['logits_err']:.3e} "
                                 "> 3e-2 of the largest")
    for what, got, steps in (("check step", check, 1),
                             (f"{LM_STEPS} steps", launches, LM_STEPS)):
        want = {k: (cfg.n_layers * steps if k == "decode_attention" else 0)
                for k in KERNELS}
        if got != want:
            raise AssertionError(f"{arch} CONFIG decode {what} launched "
                                 f"{got}; expected {want}")
    del params, caches, batch
    return paths, report


MESH_CUT_CELLS = (("granite-8b", "train_4k"),
                  ("mistral-large-123b", "prefill_32k"),
                  ("llama4-maverick-400b-a17b", "prefill_32k"))
MESH_SHAPES = ((2, 2), (2, 4), (1, 8))


def mesh_state_bytes() -> dict:
    """Each rank's state bytes (parameters, and Adam's state for
    ``train``) of the cells cut to fit one card, on each of
    ``MESH_SHAPES``: ``LMBundle.shardings``' shard shapes over
    ``abstract_state`` (host arithmetic; nothing is allocated)."""
    from repro_torch.configs import get
    from repro_torch.dist.sharding import AbstractMesh, leaves
    out = {}
    for arch, cell in MESH_CUT_CELLS:
        bundle = get(arch).bundle()
        state = [t for t in bundle.abstract_state(cell) if t is not None]
        for shape in MESH_SHAPES:
            args, _ = bundle.shardings(AbstractMesh(shape, ("data",
                                                             "model")), cell)
            total = 0
            for sh_tree, tree in zip(args, state):
                total += sum(math.prod(s.shard_shape(t.shape))
                             * t.element_size()
                             for s, t in zip(leaves(sh_tree), leaves(tree)))
            out[f"{arch} {cell} ({bundle.cfg.n_layers} layers) on "
                f"{shape}"] = total
    return out


@contextlib.contextmanager
def one_rank_group(dev):
    """A one-rank NCCL process group (``FileStore`` in a temporary
    directory) around the block, unless one is initialised already; the
    (1, 1) data x model mesh over it."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh

    own = not dist.is_initialized()
    with tempfile.TemporaryDirectory(prefix="lm-mesh-") as tmp:
        if own:
            dist.init_process_group(
                "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                rank=0, world_size=1,
                timeout=datetime.timedelta(seconds=300))
        try:
            yield make_debug_mesh((1, 1), device=dev)
        finally:
            if own:
                dist.destroy_process_group()


def lm_mesh_phase(torch, dev, step, params, batch, want, cfg):
    """The LM mesh path on the card: ``step`` (``LMBundle.step_fn(
    "decode_32k")``) again on the same weights and caches, through
    ``use_mesh`` on a (1, 1) data x model mesh of a one-rank NCCL group;
    held bit-identical to ``want`` (the no-mesh step's logits) with
    ``cfg.n_layers`` ``decode_attention`` launches and no other.  Then
    :func:`mesh_state_bytes` (not measured).  Returns (launches,
    report)."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import use_mesh

    with one_rank_group(dev) as mesh:
        reset_launches()
        t0 = time.perf_counter()
        with use_mesh(mesh):
            got, _ = step(params, batch)
        torch.cuda.synchronize()
        report = {"backend": dist.get_backend(), "mesh": [1, 1],
                  "step_s_host": time.perf_counter() - t0}
        launches = read_launches(torch)
    report["bit_identical"] = bool(torch.equal(got, want))
    report["launches"] = launches
    report["rank_state_bytes"] = mesh_state_bytes()
    print(f"LM mesh path (1 x 1 NCCL mesh, {cfg.name} decode_32k, B="
          f"{want.shape[0]}): bit-identical to the no-mesh step: "
          f"{report['bit_identical']}; launches {launches}")
    print("rank state bytes of the cut cells (host arithmetic from "
          "LMBundle.shardings, not measured): "
          + json.dumps({k: f"{v / 1e9:.1f} GB"
                        for k, v in report["rank_state_bytes"].items()}))
    if not report["bit_identical"]:
        raise AssertionError("the (1, 1) mesh decode step is not "
                             "bit-identical to the no-mesh step")
    expect = {k: (cfg.n_layers if k == "decode_attention" else 0)
              for k in KERNELS}
    if launches != expect:
        raise AssertionError(f"the (1, 1) mesh decode step launched "
                             f"{launches}; expected {expect}")
    return launches, report


MOE_EP_WARMUP = 1
MOE_EP_TIMED = 5


def moe_ep_mesh_phase(torch, dev, step, params, batch, cfg):
    """The MoE mesh path's branch that is not shard-local on the card
    (``models.transformer._moe_ffn``'s ``moe_apply(ep_axis="model")``, each
    model rank running only its experts): ``step`` (``LMBundle.step_fn(
    "decode_32k")``) on the same weights and the first row of the caches,
    B = 1, the batch of the dry-run's ``long_500k`` cells that take the
    branch (on a (1, 1) mesh every batch takes it: its data axis has one
    rank), with no mesh and then through ``use_mesh`` on a (1, 1) NCCL
    mesh, ``MOE_EP_WARMUP`` + ``MOE_EP_TIMED`` steps each (CUDA events a
    step; ms a step the median of the timed ones).  Held: every step's
    logits bit-identical to the first no-mesh step's, every ``moe_apply``
    of the mesh steps on ``ep_axis`` with all E experts on the one model
    rank, ``cfg.n_layers`` ``decode_attention`` launches a step and no
    other.  Returns (launches, report)."""
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models import transformer as tf

    one = {"token": batch["token"][:1],
           "caches": {k: tuple(c[..., :1, :, :, :].clone() for c in pair)
                      for k, pair in batch["caches"].items()},
           "cache_len": batch["cache_len"]}
    steps = MOE_EP_WARMUP + MOE_EP_TIMED

    def run():
        outs, ms = [], []
        for i in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lg, _ = step(params, one)
            end.record()
            torch.cuda.synchronize()
            outs.append(lg)
            if i >= MOE_EP_WARMUP:
                ms.append(start.elapsed_time(end))
        return outs, statistics.median(ms)

    reset_launches()
    plain, plain_ms = run()
    plain_launches = read_launches(torch)
    calls = []
    apply = tf.moe_apply

    def recording(p, x, top_k, **kw):
        calls.append((kw.get("ep_axis"), int(p["wg"].shape[0])))
        return apply(p, x, top_k, **kw)
    tf.moe_apply = recording
    try:
        with one_rank_group(dev) as mesh, use_mesh(mesh):
            reset_launches()
            got, mesh_ms = run()
            launches = read_launches(torch)
    finally:
        tf.moe_apply = apply
    want = plain[0]
    report = {
        "batch": 1, "steps": steps, "mesh": [1, 1],
        "bit_identical": all(torch.equal(g, want) for g in got + plain),
        "moe_calls": len(calls),
        "expert_parallel": all(c == ("model", cfg.n_experts)
                               for c in calls),
        "mesh_ms": mesh_ms, "no_mesh_ms": plain_ms,
        "launches": launches, "no_mesh_launches": plain_launches,
        "card": SMI_LINE}
    print(f"MoE expert-parallel branch ({cfg.name} decode_32k, B=1, "
          f"{steps} steps; {SMI_LINE}): (1 x 1) NCCL mesh "
          f"{mesh_ms:.3f} ms a step vs no mesh {plain_ms:.3f} (median of "
          f"{MOE_EP_TIMED}, CUDA events); bit-identical "
          f"{report['bit_identical']}; {len(calls)} moe_apply calls on "
          f"ep_axis with {cfg.n_experts} experts: "
          f"{report['expert_parallel']}; decode_attention launches "
          f"{launches['decode_attention']} on the mesh, "
          f"{plain_launches['decode_attention']} without")
    if not report["bit_identical"]:
        raise AssertionError("the (1, 1) mesh decode of one row through the "
                             "expert-parallel branch is not bit-identical "
                             "to the no-mesh step")
    if len(calls) != steps * cfg.n_moe_layers or \
            not report["expert_parallel"]:
        raise AssertionError(f"the (1, 1) mesh decode's moe_apply calls "
                             f"{calls[:4]}... are not {steps} x "
                             f"{cfg.n_moe_layers} on ep_axis")
    expect = {k: (steps * cfg.n_layers if k == "decode_attention" else 0)
              for k in KERNELS}
    for what, got_l in (("mesh", launches), ("no-mesh", plain_launches)):
        if got_l != expect:
            raise AssertionError(f"the B=1 {what} decode steps launched "
                                 f"{got_l}; expected {expect}")
    total = {k: launches[k] + plain_launches[k] for k in KERNELS}
    return total, report


def drill_phase(torch, dev):
    """``python -m repro_torch.chaos.drill --seed 0 --gauntlet full`` on
    the card, through ``drill.main`` in this process (so its kernel
    launches are counted), on a tuning cache of its own; fails on a
    non-zero exit or if row 3 never launched.  Returns (launches,
    report)."""
    from repro_torch import obs
    from repro_torch.chaos import drill

    was_on = obs.enabled()
    reset_launches()
    t0 = time.perf_counter()
    with tuning_cache():
        rc = drill.main(["--seed", "0", "--gauntlet", "full", "--device",
                         str(dev)])
    torch.cuda.synchronize()
    launches = read_launches(torch)
    obs.reset()
    (obs.enable if was_on else obs.disable)()
    report = {"exit": rc, "wall_s": time.perf_counter() - t0,
              "launches": launches}
    print(f"chaos drill (full, two same-seed runs) on {dev}: exit {rc} in "
          f"{report['wall_s']:.1f}s; launches {launches}")
    if rc != 0:
        raise AssertionError(f"the chaos drill exited {rc}")
    if not launches["spmm_blockell_compact"]:
        raise AssertionError("the chaos drill never launched "
                             "spmm_blockell_compact")
    return launches, report


def moe_train_phase(torch, dev):
    """granite-moe-3b-a800m ``train_4k`` at full width and depth (32
    layers, 40 experts top-8), batch ``MOE_TRAIN_BATCH`` of 256: the
    reference's recipe (fp32 master params drawn on the card, fp32 Adam
    moments, bf16 compute, Adam(3e-4), clip 1.0, donated) through
    ``LMBundle(CONFIG).step_fn("train_4k")``.  First the remat/chunking
    check at ``LM_CHECK_LAYERS`` layers (``lm_train_check_phase``); then
    1 warm-up, 2 timed and 1 profiled step (ms a step, tokens/s, busy
    share, device time by kind), peak memory beside the predicted state,
    the bf16 FLOP share against the active FLOPs; then the params drawn
    again from the same seed and 3 more steps, whose losses must equal
    the first 3 bit for bit (the MoE forward is deterministic, so the
    checkpointed recompute routes as the forward did).  No kernel."""
    import gc
    from repro_torch.configs.families import LMBundle
    from repro_torch.configs.granite_moe_3b_a800m import CONFIG as cfg
    from repro_torch.nn.moe import capacity
    from repro_torch.train import lm_token_batches

    arch, B, S = "granite-moe-3b-a800m", MOE_TRAIN_BATCH, LM_TRAIN_SEQ
    raw = next(lm_token_batches(cfg.vocab, B, S))
    batch = {k: torch.as_tensor(raw[k], device=dev)
             for k in ("tokens", "targets")}
    check = lm_train_check_phase(torch, dev, cfg, batch, what=arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    bundle = LMBundle(cfg)

    def fresh():
        params = bundle.init_params(
            torch.Generator(device=dev).manual_seed(21), dev)
        return params, bundle.opt().init(params)

    t0 = time.perf_counter()
    params, state = fresh()
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    state_gb = n_params * LM_STATE_BYTES_PER_PARAM / 1e9
    print(f"{arch} train_4k: {cfg.n_layers} layers, B={B}, {n_params} "
          f"params (fp32), predicted state {state_gb:.2f} GB (params, "
          f"grads, m, v); drawn on the card in "
          f"{time.perf_counter() - t0:.2f}s")
    reset_launches()
    br = step_breakdown(
        torch, f"{arch} train_4k", bundle.step_fn("train_4k"), params,
        state, batch, warmup=MOE_TRAIN_WARMUP, timed=MOE_TRAIN_TIMED,
        n_prof=1, kinds=[("gemm", ("gemm", "nvjet", "cutlass")),
                         ("elementwise", ("elementwise",)),
                         ("reduce", ("reduce_kernel",)),
                         ("sort_scan", ("sort", "scan")),
                         ("index", ("index", "gather", "scatter"))])
    launches = read_launches(torch)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    params, state = fresh()
    step = bundle.step_fn("train_4k")
    rerun = []
    for _ in range(MOE_RERUN_STEPS):
        params, state, loss = step(params, state, batch)
        rerun.append(float(loss))
    first = br["losses"][:MOE_RERUN_STEPS]
    flops = lm_train_flops(cfg, B, S)
    T = B * S
    slots = cfg.n_experts * capacity(T, cfg.top_k, cfg.n_experts)
    report = {
        "layers": cfg.n_layers, "batch": B, "seq": S, "params": n_params,
        "active_params": cfg.active_param_count(),
        "predicted_state_gb": state_gb, "peak_memory_gb": peak_gb,
        "step_ms": br["step_ms"], "step_ms_all": br["step_ms_all"],
        "tokens_per_s": T / br["step_ms"] * 1e3,
        "busy_share": br["busy_share"],
        "device_ms_per_step": br["device_ms_per_step"],
        "device_ms_by_kind": br.get("device_ms_by_kind"),
        "losses": br["losses"], "rerun_losses": rerun,
        "rerun_bit_identical": first == rerun, "flops": flops,
        "bf16_flop_share": flops["total"] / (br["step_ms"] / 1e3)
        / PEAK_BF16_FLOPS,
        "expert_slots_over_assignments": slots / (T * cfg.top_k),
        "check": check, "launches": launches, "breakdown": br}
    print(f"{arch} train_4k ({cfg.n_layers} layers, B={B}): " + json.dumps(
        {k: v for k, v in report.items()
         if k not in ("breakdown", "check", "step_ms_all")}))
    if not all(math.isfinite(v) for v in br["losses"] + rerun):
        raise AssertionError(f"{arch} train_4k: a loss is not finite "
                             f"{br['losses']} {rerun}")
    if first != rerun:
        raise AssertionError(f"{arch} train_4k: two runs of "
                             f"{MOE_RERUN_STEPS} steps from the same seed "
                             f"gave other losses: {first} vs {rerun}")
    if any(launches.values()):
        raise AssertionError(f"{arch} train_4k launched {launches}")
    del params, state, batch
    return (f"{arch} train_4k ({cfg.n_layers} layers, B={B})", launches,
            report)


def moe_phases(torch, dev):
    """The MoE LMs, after the LM training phases have freed the card: the
    ``decode_attention`` cases at their GQA shapes; both archs through
    ``launch.serve`` (against ``attn="plain"`` and the CPU run) and
    ``launch.train`` (against ``--device cpu``) at ``REDUCED``; each
    ``CONFIG`` served at full width; granite-moe ``train_4k`` at full
    depth."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev) / 1e9
    print(f"MoE phases: {left:.2f} GB still allocated")
    if left > 4:
        raise AssertionError(f"{left:.2f} GB left allocated before the MoE "
                             "phases; llama4's 37.1 GB of weights and "
                             "17.2 GB of cache will not fit")
    t0 = time.perf_counter()
    cases = moe_decode_kernel_phase(torch, dev)
    paths, report = {}, {"launcher": {}, "train_launcher": {}}
    for arch in MOE_ARCHS:
        paths[f"{arch} serving (launcher)"], report["launcher"][arch] = \
            lm_launcher_phase(torch, arch)
        (paths[f"{arch} training (launcher, REDUCED)"],
         report["train_launcher"][arch]) = lm_train_launcher_phase(torch,
                                                                   arch)
    for arch in MOE_ARCHS:
        config_paths, report[arch] = moe_config_phase(torch, dev, arch)
        paths.update(config_paths)
        gc.collect()
        torch.cuda.empty_cache()
    what, paths[what], report["train_4k"] = moe_train_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    report["wall_s"] = time.perf_counter() - t0
    print(f"MoE phases: {report['wall_s']:.1f}s")
    return cases, paths, report


# ---------------------------------------------------------------------------
# the kernel fallback chain (exec/fallback.py) and weighted sum plans
# ---------------------------------------------------------------------------
FALLBACK_BUCKETS = "128@7+256"
WEIGHTED_WIDTHS = (64, 1433)


def fallback_phase(torch, dev, g):
    """The fallback chain on the reordered Cora, with a quarantine directory
    of its own, removed after (the tuning cache is not touched, so no
    verdict of the drill reaches a later phase).

    (a) Healthy ``ResilientPlan(g, "gcn")`` (compact, padded, bucketed
    ``128@7+256``) at d = 64: answers on ``cuda``, not degraded, with the
    launches of rows 3 / 2 its plan needs, within 1e-5 of the ``torch``
    plan.  (b) Weighted ``sum`` ResilientPlans (seeded weights in [0, 1),
    float32 tiles; compact and padded) at d = 64 and 1433: the same, and
    each kernel case (row 3 compact, row 2 padded) held against its plain
    version, timed beside its bound and ``torch.sparse.mm`` of the weighted
    adjacency.  (c) The drills: ``kernel_launch`` at ``exec.pallas_launch``
    hit 0 (no launch), then ``nan_backend`` at ``exec.kernel_result`` (one
    launch, its output mangled): each call answers on ``torch`` within 1e-5
    of the healthy answer, its attempts name the fault, the quarantine is
    recorded under the card's device signature, a fresh ResilientPlan on
    that directory starts at ``torch``, ``build_cost_oracle`` keeps no
    ``cuda`` candidate, and ``exec.fallback`` / ``exec.quarantine`` count
    one each.  (d) A real failure, no drill (the compact wrapper rejecting
    a float64 x): it propagates, ``torch`` does not answer, and no verdict
    is written.  (e) A fused layer (row 5) armed once at
    ``exec.pallas_launch``: the ``InjectedFault`` propagates (layer plans
    have no chain), and the layer is healthy after."""
    import dataclasses
    import numpy as np
    from repro_torch import obs
    from repro_torch.chaos import Fault, FaultPlan, InjectedFault, armed
    from repro_torch.exec import (FALLBACK_CHAIN, ResilientPlan,
                                  build_cost_oracle, build_layer_plan,
                                  build_plan, gcn_chain, graph_fingerprint,
                                  quarantined_backends)
    from repro_torch.exec.autotune import device_sig, quarantine_key

    gen = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn((g.num_nodes, 64), generator=gen, device=dev)
    fp = graph_fingerprint(g)
    report = {"device_sig": device_sig("cuda"), "healthy": {},
              "weighted": {}, "drills": {}}
    total = {k: 0 for k in KERNELS}

    def counted(fn, what):
        reset_launches()
        y = fn()
        launches = read_launches(torch)
        for k, v in launches.items():
            total[k] += v
        return y, {k: v for k, v in launches.items() if v}

    def healthy(rp, xin, what, expect):
        y, launches = counted(lambda: rp.apply(xin), what)
        v = rp.verdict
        if v.backend != "cuda" or v.degraded or v.attempts:
            raise AssertionError(f"{what}: a healthy call gave {v}")
        if launches != expect:
            raise AssertionError(f"{what}: launched {launches}, expected "
                                 f"{expect}")
        return y, launches

    compact_cases, fused_cases = [], []
    with tempfile.TemporaryDirectory(prefix="quarantine-") as qdir:
        ref = build_plan(g, "gcn", backend="torch", device=dev).apply(x)
        y_healthy = None
        for name, kw in (("compact", {}), ("padded", {"compact": False}),
                         ("bucketed", {"buckets": FALLBACK_BUCKETS})):
            rp = ResilientPlan(g, "gcn", device=dev, cache_dir=qdir, **kw)
            plan = rp.plan_for("cuda")
            if name == "padded":
                expect = {"spmm_blockell_fused": 1}
            elif name == "bucketed":
                expect = {"spmm_blockell_compact": sum(
                    1 for m in plan.meta_fwd.buckets
                    if m.n_rows and m.n_active)}
            else:
                expect = {"spmm_blockell_compact": 1}
            what = f"ResilientPlan gcn {name}"
            y, launches = healthy(rp, x, what, expect)
            report["healthy"][name] = {
                "chain": rp.chain, "launches": launches,
                "max_abs_err": assert_close_scaled(y, ref, KERNEL_TOL,
                                                   f"{what} vs torch")}
            if name == "compact":
                y_healthy = y

        w = np.random.default_rng(22).random(g.num_edges).astype(np.float32)
        gw = dataclasses.replace(g, edge_weight=w)
        lib = library_matrix(torch, dev, gw, "sum", False, weighted=True)
        for compact, kernel in ((True, "spmm_blockell_compact"),
                                (False, "spmm_blockell_fused")):
            rp = ResilientPlan(gw, "sum", weighted=True, compact=compact,
                               device=dev, cache_dir=qdir)
            plan = rp.plan_for("cuda")
            tiles = tile_arrays(plan)["blocks"].dtype
            if tiles != torch.float32:
                raise AssertionError(f"a weighted plan's tiles are {tiles}")
            plain = build_plan(gw, "sum", weighted=True, compact=compact,
                               backend="torch", device=dev)
            nnz = int(plan.ell.density_stats()["nnz"])
            for d in WEIGHTED_WIDTHS:
                xd = torch.randn((g.num_nodes, d), generator=gen,
                                 device=dev)
                name = (f"weighted sum {'compact' if compact else 'padded'}"
                        f" d={d} (f32 tiles)")
                y, launches = healthy(rp, xd, f"ResilientPlan {name}",
                                      {kernel: 1})
                report["weighted"][name] = {
                    "launches": launches,
                    "max_abs_err": assert_close_scaled(
                        y, plain.apply(xd), KERNEL_TOL,
                        f"ResilientPlan {name} vs torch")}
                if compact:
                    compact_cases.append(list_case(
                        torch, dev, plan, d, gen,
                        name.replace("f32 tiles", "lists, coef"), weight=1,
                        library=lib))
                    compact_cases.append(compact_case(
                        torch, dev, tile_arrays(plan), nnz, d, False, "f32",
                        False, gen, "tile walk: " + name))
                else:
                    fused_cases.append(padded_case(
                        torch, dev, "spmm_blockell_fused", plan._fwd, nnz,
                        plan.ell.n_active, d, gen, name, bm=BM, weight=1,
                        plan_side=plan.raw_apply, library=lib,
                        tol=KERNEL_TOL))

        obs.reset()
        obs.enable()
        try:
            for kind, site, reason, launched in (
                    ("kernel_launch", "exec.pallas_launch", "kernel_launch",
                     {}),
                    ("nan_backend", "exec.kernel_result", "nonfinite_output",
                     {"spmm_blockell_compact": 1})):
                sub = os.path.join(qdir, kind)
                rp = ResilientPlan(g, "gcn", device=dev, cache_dir=sub)
                with armed(FaultPlan.of(Fault(site, kind))) as inj:
                    y, launches = counted(lambda: rp.apply(x), kind)
                v = rp.verdict
                what = f"drill {kind} at {site}"
                if (v.backend != "torch" or not v.degraded
                        or v.attempts != (("cuda", reason),)):
                    raise AssertionError(f"{what}: verdict {v}")
                if launches != launched or len(inj.fired) != 1:
                    raise AssertionError(f"{what}: launched {launches}, "
                                         f"fired {inj.fired}")
                err = assert_close_scaled(y, y_healthy, KERNEL_TOL,
                                          f"{what} vs the healthy answer")
                bad = quarantined_backends(fp, platform="cuda",
                                           cache_dir=sub)
                with open(os.path.join(sub, "autotune.json")) as f:
                    keys = sorted(json.load(f))
                key = quarantine_key(fp, "cuda", "cuda")
                fresh = ResilientPlan(g, "gcn", device=dev, cache_dir=sub)
                oracle = build_cost_oracle(g, gcn_chain(GCN_DIMS),
                                           cache_dir=sub, use_cache=False,
                                           platform="cuda")
                kept = sorted({c[2] for cs in oracle.cands for c in cs})
                report["drills"][kind] = {
                    "site": site, "attempts": v.attempts, "served_by":
                    v.backend, "launches": launches, "max_abs_err": err,
                    "quarantined": sorted(bad), "cache_keys": keys,
                    "fresh_chain": fresh.chain, "oracle_backends": kept}
                print(f"fallback {what}: " + json.dumps(
                    report["drills"][kind]))
                if bad != {"cuda"} or keys != [key]:
                    raise AssertionError(f"{what}: quarantine {bad}, keys "
                                         f"{keys} (expected {key})")
                if fresh.backend != "torch" or "cuda" in fresh.chain:
                    raise AssertionError(f"{what}: a fresh plan's chain is "
                                         f"{fresh.chain}")
                if "cuda" in kept or not kept:
                    raise AssertionError(f"{what}: the cost oracle kept "
                                         f"{kept}")
            counts = {name: _counter(obs, name)
                      for name in ("exec.fallback", "exec.quarantine")}
        finally:
            obs.disable()
            obs.reset()
        report["counters"] = counts
        if counts != {"exec.fallback": 2, "exec.quarantine": 2}:
            raise AssertionError(f"fallback counters {counts}")

        sub = os.path.join(qdir, "real")
        rp = ResilientPlan(g, "gcn", device=dev, cache_dir=sub)
        try:
            rp.apply(x.double())
        except TypeError as err:
            report["real_failure"] = str(err)
        else:
            raise AssertionError("a real kernel failure was served by "
                                 f"{rp.verdict}")
        if (rp.verdict is not None or rp.chain != list(FALLBACK_CHAIN)
                or os.path.exists(os.path.join(sub, "autotune.json"))):
            raise AssertionError(f"a real kernel failure demoted: verdict "
                                 f"{rp.verdict}, chain {rp.chain}")

        lp = build_layer_plan(g, "gcn", d_in=64, d_out=16,
                              order="aggregate_first", backend="cuda",
                              device=dev)
        lp_plain = build_layer_plan(g, "gcn", d_in=64, d_out=16,
                                    order="aggregate_first", backend="torch",
                                    device=dev)
        wt = torch.randn((64, 16), generator=gen, device=dev) / 8
        if not lp.fuse:
            raise AssertionError("the cuda layer plan did not fuse")
        try:
            with armed(FaultPlan.of(Fault("exec.pallas_launch",
                                          "kernel_launch"))):
                counted(lambda: lp.apply(x, wt), "fused layer drill")
        except InjectedFault as err:
            report["fused_layer_fault"] = str(err)
        else:
            raise AssertionError("a launch fault on a fused layer did not "
                                 "propagate")
        y, launches = counted(lambda: lp.apply(x, wt), "fused layer")
        if launches != {"spmm_blockell_update_compact": 1}:
            raise AssertionError(f"fused layer launched {launches}")
        report["fused_layer_max_abs_err"] = assert_close_scaled(
            y, lp_plain.apply(x, wt), KERNEL_TOL, "fused layer vs torch")
    print("fallback phase: " + json.dumps(
        {k: v for k, v in report.items() if k != "drills"}))
    return total, report, compact_cases, fused_cases


# ---------------------------------------------------------------------------
# the graph half of distributed: elastic shards on the card, --dist on NCCL
# ---------------------------------------------------------------------------
DIST_PARTS = 4
DIST_DIMS_HIDDEN = 16               # train_elastic at [1433, 16, 7]
DIST_STEPS = 12
DIST_REJOIN_AT = 7
DIST_WIDTHS = (16, 1433)
# 12 Adam steps whose aggregations sum in another order
DIST_LOSS_TOL = 1e-4
# tests/test_dist_elastic.py::test_train_elastic_recovery_tracks_no_fault_run
DIST_DRILL_RTOL, DIST_DRILL_ATOL = 1e-3, 5e-3
DIST_LAUNCHER_STEPS = 20
DIST_AGGREGATORS = ("halo", "allgather", "resilient")
# the step whose first aggregation outlives the resilient ladder
DIST_DRILL_STEP = 3
# granite-8b's decode shape at decode_32k, B = 8, ragged lengths
DIST_DECODE_SEQ = 32768
DIST_DECODE_LENS = (32767, 32767, 20000, 1, 32767, 5000, 32767, 0)


def shard_launches(topo) -> tuple:
    """(forward, transposed) ``spmm_blockell_compact`` launches of one
    aggregation through every shard of ``topo``: a shard whose side has no
    active slot launches nothing."""
    plans = [s.plan.plan_for(s.plan.backend) for s in topo.shards]
    return (sum(p.meta_fwd.n_active > 0 for p in plans),
            sum(p.meta_bwd.n_active > 0 for p in plans))


def elastic_step_launches(agg, trail) -> list:
    """The row-3 launches each step of ``train_elastic`` needs: on the halo
    path two forward aggregations (x at d = 1433, h at d = 16) and one
    transposed (h's backward; x needs no gradient) through every shard of
    that step's topology; none on the allgather path."""
    by_version = {t.version: t for t in agg._topologies.values()}
    out = []
    for info in trail:
        if info["path"] != "halo":
            out.append(0)
            continue
        fwd, bwd = shard_launches(by_version[info["version"]])
        out.append(2 * fwd + bwd)
    return out


def elastic_phase(torch, dev, g):
    """(a) The elastic state machine on the card: the reordered Cora in 4
    shards, each shard's weighted ``sum`` plan through row 3: on 0/1 uint8
    tiles (Cora's edges weigh 1, and ``storage="auto"`` keeps the exact
    bitmask), and on float32 tiles for the symmetric-normalised Cora.
    ``ElasticAggregator.aggregate`` on both at d = 16 and 1433 against the
    segment-sum oracle on the card and the ``torch`` backend (1e-5 of the
    largest |entry|; one launch a shard); row 3 at each shard's d = 1433
    forward against its plain version and ``torch.sparse.mm``;
    ``train_elastic`` at [1433, 16, 7] for 12 steps under deterministic
    algorithms, rerun bit-identical and held against the ``torch`` backend
    (1e-4), each step's launches counted exactly; the drill (persistent
    ``shard_loss`` on shard 3 from hit 2: two allgather steps, eviction to
    3 parts, ``rejoin_at`` 7 restores 4) against the reference test's trail
    and bar; the step's ms on the halo and allgather paths."""
    import numpy as np
    from repro_torch.chaos import Fault, FaultPlan, armed
    from repro_torch.dist import ElasticAggregator, train_elastic
    from repro_torch.dist.elastic import _local_graph, elastic_step
    from repro_torch.dist.gnn import dist_gnn_init
    from repro_torch.train import adam, tree_leaves

    total = {k: 0 for k in KERNELS}
    report = {"parts": DIST_PARTS, "aggregate": {}, "train": {}}
    cases = []

    def counted(fn):
        reset_launches()
        y = fn()
        launches = read_launches(torch)
        for k, v in launches.items():
            total[k] += v
        return y, {k: v for k, v in launches.items() if v}

    gen = torch.Generator(device=dev).manual_seed(25)
    aggs = {}
    for graph, tiles in ((g, torch.uint8), (g.with_sym_norm(), torch.float32)):
        what = f"elastic {DIST_PARTS} shards ({str(tiles)[6:]} tiles)"
        a = ElasticAggregator(graph, DIST_PARTS, device=dev)
        plain = ElasticAggregator(graph, DIST_PARTS, backend="torch",
                                  device=dev)
        plans = [s.plan.plan_for(s.plan.backend) for s in a.topology.shards]
        got = [(p.backend, tile_arrays(p)["blocks"].dtype)
               for p in plans]
        if got != [("cuda", tiles)] * DIST_PARTS:
            raise AssertionError(f"{what}: the shards' plans are {got}")
        if not all(p.meta_fwd.lists for p in plans):
            raise AssertionError(f"{what}: a shard's plan holds no lists")
        fwd, _ = shard_launches(a.topology)
        oracle = a.aggregate_fn("allgather")
        report["aggregate"][what] = holds = {}
        for d in DIST_WIDTHS:
            x = torch.randn((g.num_nodes, d), generator=gen, device=dev)
            y, launches = counted(lambda: a.aggregate(x, step=0))
            if launches != {"spmm_blockell_compact": fwd}:
                raise AssertionError(f"{what} d={d} launched {launches}, "
                                     f"expected {fwd} compact")
            holds[d] = [assert_close_scaled(y, oracle(x), KERNEL_TOL,
                                            f"{what} d={d} vs segment_sum"),
                        assert_close_scaled(y, plain.aggregate(x, step=0),
                                            KERNEL_TOL,
                                            f"{what} d={d} vs torch")]
        aggs[tiles] = a
    topo = aggs[torch.uint8].topology
    plans = [s.plan.plan_for(s.plan.backend) for s in topo.shards]
    report["shards"] = [{"window": [s.lo, s.hi],
                         "halo_rows": int(s.halo_ids.shape[0]),
                         "n_active": [p.meta_fwd.n_active,
                                      p.meta_bwd.n_active]}
                        for s, p in zip(topo.shards, plans)]
    # each shard's forward at d = 1433 on its lists (an elastic train step
    # runs the u8 shards' once each; the f32 ones, coefficients, held
    # beside) and on its tiles
    for tiles, a in aggs.items():
        kind = str(tiles)[6:]
        for p, s in enumerate(a.topology.shards):
            plan = s.plan.plan_for(s.plan.backend)
            lg, _ = _local_graph(a.topology.halo, p)
            what = f"elastic shard {p}/{DIST_PARTS} forward d=1433"
            cases.append(list_case(
                torch, dev, plan, 1433, gen,
                f"{what} (lists, as {kind} tiles)",
                weight=int(tiles == torch.uint8),
                library=library_matrix(torch, dev, lg, "sum", False,
                                       weighted=True), n_inner=5))
            cases.append(compact_case(
                torch, dev, tile_arrays(plan),
                int(plan.ell.density_stats()["nnz"]), 1433, False,
                "u8" if tiles == torch.uint8 else "f32", False, gen,
                f"tile walk: {what} ({kind} tiles)"))

    def run(what, backend=None, fault=None, **kw):
        steps = []

        def log(_line):
            launches = read_launches(torch)
            steps.append(launches["spmm_blockell_compact"])
            for k, v in launches.items():
                total[k] += v
            reset_launches()
        reset_launches()
        with armed(fault) if fault else contextlib.nullcontext():
            res = train_elastic(g, parts=DIST_PARTS, steps=DIST_STEPS,
                                hidden=DIST_DIMS_HIDDEN, backend=backend,
                                device=dev, log=log, **kw)
        if backend is None:
            want = elastic_step_launches(res["aggregator"], res["trail"])
            if steps != want:
                raise AssertionError(f"{what}: row-3 launches a step "
                                     f"{steps}, expected {want}")
        report["train"][what] = {"losses": res["losses"],
                                 "paths": res["paths"],
                                 "parts": [t["parts"] for t in res["trail"]],
                                 "launches_by_step": steps}
        print(f"elastic {what}: " + json.dumps(report["train"][what]))
        return res

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a = run("cuda")
        b = run("cuda rerun")
    finally:
        torch.use_deterministic_algorithms(was)
    if a["losses"] != b["losses"] or not all(
            torch.equal(x, y) for x, y in zip(tree_leaves(a["params"]),
                                              tree_leaves(b["params"]))):
        raise AssertionError("a same-seed elastic rerun is not bit-identical")
    ref = run("torch backend", backend="torch")
    report["train"]["vs_torch"] = float(np.abs(
        np.asarray(a["losses"]) - np.asarray(ref["losses"])).max())
    if not report["train"]["vs_torch"] <= DIST_LOSS_TOL:
        raise AssertionError(f"elastic losses vs torch: "
                             f"{report['train']['vs_torch']:.3e}")
    fault = FaultPlan.of(Fault("dist.halo", "shard_loss", hit=2, count=6,
                               payload=(("shard", DIST_PARTS - 1),)))
    drill = run("drill", fault=fault, rejoin_at=DIST_REJOIN_AT)
    want_paths = ["halo"] * 2 + ["allgather"] * 2 + ["halo"] * (
        DIST_STEPS - 4)
    want_parts = ([DIST_PARTS] * 3 + [DIST_PARTS - 1] * (DIST_REJOIN_AT - 3)
                  + [DIST_PARTS] * (DIST_STEPS - DIST_REJOIN_AT))
    if (drill["paths"] != want_paths
            or [t["parts"] for t in drill["trail"]] != want_parts
            or drill["trail"][3]["evicted"] != DIST_PARTS - 1):
        raise AssertionError(f"elastic drill trail {drill['trail']}")
    for x, y in [(a["losses"], drill["losses"])] + list(zip(
            tree_leaves(a["params"]), tree_leaves(drill["params"]))):
        x, y = (torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu())
        if not torch.allclose(y, x, rtol=DIST_DRILL_RTOL,
                              atol=DIST_DRILL_ATOL):
            raise AssertionError("the drilled run does not track the "
                                 "no-fault run")
    report["train"]["drill_vs_no_fault"] = float(np.abs(
        np.asarray(a["losses"]) - np.asarray(drill["losses"])).max())

    # the step's time on each path (these launches are not the path's)
    t = lambda v: torch.as_tensor(v, device=dev)
    x = t(g.node_feat)
    deg = t(np.maximum(g.in_degrees().astype(np.float32), 1.0))
    labels = t(g.labels.astype(np.int64))
    mask = t(g.train_mask).to(torch.float32)
    dims = [g.node_feat.shape[1], DIST_DIMS_HIDDEN, int(g.labels.max()) + 1]
    agg = aggs[torch.uint8]
    for path in ("halo", "allgather"):
        opt = adam(1e-2)
        params = dist_gnn_init(torch.Generator().manual_seed(0), dims,
                               device=dev)
        report[f"step_{path}"] = step_breakdown(
            torch, f"elastic {DIST_PARTS}-shard step ({path})",
            elastic_step(agg.aggregate_fn(path), x, deg, labels, mask, opt),
            params, opt.init(params), None)
    reset_launches()
    return cases, total, report


def launcher_runs(torch, cards):
    """``launch.train --arch gcn-cora --dist`` as subprocesses, all started
    together: each aggregator on NCCL at ``parts`` = the card count, the
    halo run on gloo (``--device cpu``) at the same parts, and ``--parts``
    one above the card count, which must exit non-zero with the "need N
    devices, have M" message.  The ranks are spawned by the launcher, so
    their output reaches here through the launcher's pipes."""
    import numpy as np
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "gcn-cora", "--dist", "--steps", str(DIST_LAUNCHER_STEPS)]
    argv = {agg: base + ["--aggregator", agg] for agg in DIST_AGGREGATORS}
    argv["cpu"] = base + ["--device", "cpu", "--parts", str(cards)]
    argv["refused"] = base + ["--parts", str(cards + 1)]
    procs = {}
    t0 = time.perf_counter()
    try:
        for k, a in argv.items():
            procs[k] = subprocess.Popen(a, cwd=ROOT, env=env, text=True,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE)
        outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    runs = {}
    for k, (out, err) in outs.items():
        rc = procs[k].returncode
        print(f"--dist {k}: rc {rc}\n{out}" + (err if rc else ""), end="")
        if k == "refused":
            need = f"need {cards + 1} devices, have {cards}"
            if rc == 0 or need not in err:
                raise AssertionError(f"--parts {cards + 1} on {cards} "
                                     f"card(s): rc {rc}, stderr {err[-500:]}")
            runs[k] = {"rc": rc, "message": need}
            continue
        if rc:
            raise AssertionError(f"--dist {k} failed: {err[-2000:]}")
        lines = out.splitlines()
        backend = "gloo" if k == "cpu" else "nccl"
        want = f"dist backend={backend} ranks={cards} device=" + (
            "cpu" if k == "cpu" else "cuda")
        if want not in lines:
            raise AssertionError(f"--dist {k}: no line {want!r}")
        losses = json.loads(next(l for l in lines if " [dist] losses: " in l)
                            .split(" [dist] losses: ")[1])
        runs[k] = {"dist_line": next(l for l in lines
                                     if l.startswith("dist[gcn-cora] parts")),
                   "backend": backend, "parts": cards, "losses": losses}
    lines = {r["dist_line"] for k, r in runs.items() if k != "refused"}
    if len(lines) != 1:
        raise AssertionError(f"the dist lines differ: {lines}")
    cpu = np.asarray(runs["cpu"]["losses"])
    halo = np.asarray(runs["halo"]["losses"])
    report = {"wall_s": wall, "runs": runs,
              "vs_cpu": float(np.abs(halo - cpu).max())}
    if not report["vs_cpu"] <= DIST_LOSS_TOL:
        raise AssertionError(f"--dist on NCCL vs gloo: {report['vs_cpu']}")
    for agg in DIST_AGGREGATORS[1:]:
        err = float(np.abs(np.asarray(runs[agg]["losses"]) - halo).max())
        report[f"{agg}_vs_halo"] = err
        if not err <= KERNEL_TOL:
            raise AssertionError(f"--dist {agg} vs halo: {err:.3e}")
    print("--dist launchers: " + json.dumps(
        {k: v for k, v in report.items() if k != "runs"}))
    return report


def nccl_rank_phase(torch, dev):
    """(b) In this process, one NCCL rank: the exchanges against the
    segment-sum oracle at d = 1433 (value and gradient), the train step's
    ms on each aggregator, the resilient drill through
    ``train_distributed`` (one step's first aggregation outlives the
    ladder: exactly one ``dist.halo_fallback{reason=shard_loss}``, losses
    equal to the no-fault run's within 1e-5), ``distributed_decode_
    attention`` on a (1, 1) mesh at granite-8b's decode shape in bf16 held
    row by row against the plain reference (3e-2), and
    ``int8_allreduce_psum``."""
    import datetime
    import numpy as np
    import torch.distributed as dist
    from repro_torch import obs
    from repro_torch.chaos import Fault, FaultPlan, armed
    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.core.aggregate import segment_sum
    from repro_torch.dist import (allgather_aggregate, dequantize_int8,
                                  distributed_decode_attention,
                                  halo_aggregate, int8_allreduce_psum,
                                  make_dist_train_step, quantize_int8,
                                  resilient_halo_aggregate,
                                  train_distributed)
    from repro_torch.dist.gnn import dist_gnn_init, training_setup
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.launch.mesh import make_debug_mesh, make_halo_debug_mesh
    from repro_torch.train import adam

    report = {}
    tmp = tempfile.mkdtemp(prefix="nccl-")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        report["backend"] = dist.get_backend()
        mesh = make_halo_debug_mesh(1, device=dev)
        g, plan, send, est = training_setup(1)
        n = g.num_nodes
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        src, dst = t(g.src.astype(np.int64)), t(g.dst.astype(np.int64))
        gen = torch.Generator(device=dev).manual_seed(26)
        x = torch.randn((n, g.node_feat.shape[1]), generator=gen, device=dev)
        xo = x.clone().requires_grad_(True)
        ref = segment_sum(xo[src], dst, n)
        r = torch.randn(ref.shape, generator=gen, device=dev)
        (gref,) = torch.autograd.grad((ref * r).sum(), xo)
        ref = ref.detach()
        holds = {}
        reset_launches()
        for name, fn in (
                ("halo", lambda a: halo_aggregate(mesh, a, plan, send, n)),
                ("allgather", lambda a: allgather_aggregate(mesh, a, plan,
                                                            n)),
                ("resilient", lambda a: resilient_halo_aggregate(
                    mesh, a, plan, send, n))):
            xx = x.clone().requires_grad_(True)
            y = fn(xx)
            (gx,) = torch.autograd.grad((y * r).sum(), xx)
            y = y.detach()
            holds[name] = [
                assert_close_scaled(y, ref, KERNEL_TOL, f"NCCL {name}"),
                assert_close_scaled(gx, gref, KERNEL_TOL,
                                    f"NCCL {name} gradient")]
        report["holds_d1433"] = holds
        if any(read_launches(torch).values()):
            raise AssertionError("the mesh exchange launched a kernel")

        batch = {"x": t(g.node_feat), "labels": t(g.labels.astype(np.int64)),
                 "train_mask": t(g.train_mask),
                 "deg": t(g.in_degrees().astype(np.float32))}
        dims = [g.node_feat.shape[1], 64, int(g.labels.max()) + 1]
        for agg in DIST_AGGREGATORS:
            opt = adam(1e-2)
            params = dist_gnn_init(torch.Generator().manual_seed(0), dims,
                                   device=dev)
            report[f"step_{agg}"] = step_breakdown(
                torch, f"--dist step ({agg}, 1 NCCL rank)",
                make_dist_train_step(mesh, plan, send, n, opt, agg), params,
                opt.init(params), batch)

        obs.reset()
        obs.enable()
        try:
            kw = dict(steps=DIST_LAUNCHER_STEPS, aggregator="resilient",
                      device=dev, log=lambda line: None)
            clean = train_distributed("gcn-cora", **kw)
            obs.reset()
            fault = FaultPlan.of(Fault("dist.halo", "shard_loss",
                                       hit=2 * DIST_DRILL_STEP, count=3))
            with armed(fault) as inj:
                drilled = train_distributed("gcn-cora", **kw)
        finally:
            obs.disable()
            obs.reset()
        counters = {k: v for k, v in drilled["metrics"]["counters"].items()
                    if k.startswith("dist.halo")}
        err = float(np.abs(np.asarray(drilled["losses"])
                           - np.asarray(clean["losses"])).max())
        report["drill"] = {"fired": len(inj.fired), "counters": counters,
                           "losses_vs_no_fault": err}
        if (counters != {"dist.halo_retry{kind=shard_loss}": 2,
                         "dist.halo_fallback{reason=shard_loss}": 1}
                or len(inj.fired) != 3 or not err <= KERNEL_TOL):
            raise AssertionError(f"resilient drill: {report['drill']}")

        dmesh = make_debug_mesh((1, 1), ("data", "model"), device=dev)
        B, H, KV = len(DIST_DECODE_LENS), CONFIG.n_heads, CONFIG.n_kv
        hd, S = CONFIG.d_model // CONFIG.n_heads, DIST_DECODE_SEQ
        bf = torch.bfloat16
        q = torch.randn((B, H, hd), generator=gen, device=dev).to(bf)
        k = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(bf)
        v = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(bf)
        lens = torch.tensor(DIST_DECODE_LENS, device=dev)
        out = distributed_decode_attention(
            dmesh, q, k.repeat_interleave(H // KV, dim=2),
            v.repeat_interleave(H // KV, dim=2), lens)
        want = decode_attention_ref(q, k, v, lens)
        err, worst = assert_close_rows(
            out.float(), want.float(), DECODE_TOL["bfloat16"],
            "distributed_decode_attention (1, 1) vs plain")
        report["decode"] = {"shape": [B, H, KV, hd, S], "max_abs_err": err,
                            "worst_row_share": worst}
        del q, k, v, out, want
        gvec = torch.randn((64, 1433), generator=gen, device=dev)
        got = int8_allreduce_psum(gvec, group=mesh.get_group("data"))
        if not torch.equal(got, dequantize_int8(*quantize_int8(gvec))):
            raise AssertionError("int8_allreduce_psum at one rank is not "
                                 "its own quantization")
        bound = gvec.abs().amax(-1, keepdim=True) / 254
        report["int8_max_abs_err"] = float((got - gvec).abs().max())
        if not bool(((got - gvec).abs() <= bound * (1 + 1e-6)).all()):
            raise AssertionError("int8_allreduce_psum past absmax/254")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print("NCCL rank: " + json.dumps(
        {k: v for k, v in report.items() if not k.startswith("step_")}))
    return report


def dist_phases(torch, dev, g):
    """The graph half of distributed (ROADMAP item 9a): (a) four elastic
    shards on the card through row 3 (:func:`elastic_phase`, under a tuning
    cache of its own: the shards' plans read no verdict of another phase),
    (b) ``--dist`` over NCCL: the launchers (:func:`launcher_runs`) and one
    NCCL rank in this process (:func:`nccl_rank_phase`)."""
    import gc
    t0 = time.perf_counter()
    with tuning_cache():
        cases, elastic_launches, elastic = elastic_phase(torch, dev, g)
    paths = {"elastic (4 shards, train_elastic + drill)": elastic_launches}
    report = {"elastic": elastic}
    cards = torch.cuda.device_count()
    gc.collect()
    torch.cuda.empty_cache()
    report["launchers"] = launcher_runs(torch, cards)
    reset_launches()
    report["nccl_rank"] = nccl_rank_phase(torch, dev)
    paths["--dist mesh (1 NCCL rank in-process)"] = read_launches(torch)
    report["wall_s"] = time.perf_counter() - t0
    print(f"dist phases: {report['wall_s']:.1f}s on "
          f"{torch.cuda.get_device_name(0)}, {SMI_POWER_LIMIT}")
    return cases, paths, report


# ---------------------------------------------------------------------------
# GAT at the shapes of the benchmark's cell gat-reddit.full
# ---------------------------------------------------------------------------
GAT_CONFIG = ROOT / "h100bench" / "configs" / "gat-reddit.json"
# the largest (entries, H, F) temporary the blocked plain versions hold at
# once, in values (2 GiB in float64)
GAT_BLOCK_VALUES = 2 ** 28
GAT_SLOPE = 0.2
# per entry and head, as h100bench/metrics/_gat_work.py counts them: the
# score, LeakyReLU, running max, shift, exponential and sum (forward); the
# recomputed weight, the row term and the two sums (backward)
GAT_SCORE_FLOPS = {"fwd": 7, "bwd": 10}


def gat_graph(torch):
    """The configuration of the cell and its graph as the cell's driver
    builds it: the benchmark's generator at the configuration's sizes, then
    MinHash's order; and the host seconds both took."""
    from h100bench.harness import graphgen
    from repro_torch.core import minhash_reorder
    from repro_torch.graph.structure import Graph

    cfg = json.loads(GAT_CONFIG.read_text())
    t0 = time.perf_counter()
    topo = graphgen.synthesize(cfg["graph"])
    g = Graph(src=topo["src"], dst=topo["dst"], num_nodes=topo["num_nodes"],
              labels=topo["labels"], train_mask=topo["train_mask"])
    g = g.permute(minhash_reorder(g))
    return cfg, g, time.perf_counter() - t0


def gat_row_blocks(torch, row_ptr, per_entry: int) -> list:
    """``(a, b)`` cuts of the rows of ``row_ptr`` whose entries times
    ``per_entry`` stay within ``GAT_BLOCK_VALUES`` (a longer row alone)."""
    ptr = row_ptr.long().cpu()
    n, cap = ptr.numel() - 1, max(1, GAT_BLOCK_VALUES // per_entry)
    cuts, a = [], 0
    while a < n:
        b = int(torch.searchsorted(ptr, ptr[a] + cap, right=True)) - 1
        b = min(n, max(b, a + 1))
        cuts.append((a, b))
        a = b
    return cuts


def gat_plain_fwd(torch, lists, z, s_src, s_dst, slope=GAT_SLOPE):
    """``gat_attention_ref`` by blocks of destination rows, so that no
    (E', H, F) tensor exists: ``(out, lse)``."""
    from repro_torch.kernels.ref import gat_attention_ref

    n_dst, H = s_dst.shape
    out = z.new_empty((n_dst, H, z.shape[2]))
    lse = z.new_empty((n_dst, H))
    ptr = lists.row_ptr.long().cpu()
    for a, b in gat_row_blocks(torch, lists.row_ptr, H * z.shape[2]):
        out[a:b], lse[a:b] = gat_attention_ref(
            lists.row_ptr[a:b + 1] - lists.row_ptr[a],
            lists.src[int(ptr[a]):int(ptr[b])], z, s_src, s_dst[a:b],
            negative_slope=slope)
    return out, lse


def gat_plain_bwd(torch, lists_t, z, s_src, s_dst, lse, row_dot, dout,
                  slope=GAT_SLOPE):
    """``gat_attention_bwd_ref`` by blocks of transposed rows (sources),
    so that no (E', H, F) tensor exists: ``(dz, ds_src, ds_dst)``.  A
    block's dz and ds_src are its own rows; its entries reach ds_dst
    through the plain version's forward places, here the block's entries
    sorted by their destination row, and the blocks' parts are added."""
    from repro_torch.kernels.ref import gat_attention_bwd_ref

    H, F = z.shape[1:]
    n_dst = s_dst.shape[0]
    dz, ds_src = torch.empty_like(z), torch.empty_like(s_src)
    ds_dst = torch.zeros_like(s_dst)
    ptr = lists_t.row_ptr.long().cpu()
    for a, b in gat_row_blocks(torch, lists_t.row_ptr, H * F):
        i = lists_t.src[int(ptr[a]):int(ptr[b])].long()
        order = torch.argsort(i, stable=True)
        place = torch.empty_like(order)
        place[order] = torch.arange(order.numel(), device=order.device)
        row_ptr = torch.zeros(n_dst + 1, dtype=torch.long, device=i.device)
        row_ptr[1:] = torch.cumsum(torch.bincount(i, minlength=n_dst), 0)
        dz[a:b], ds_src[a:b], part = gat_attention_bwd_ref(
            row_ptr, lists_t.row_ptr[a:b + 1] - lists_t.row_ptr[a], i, place,
            z[a:b], s_src[a:b], s_dst, lse, row_dot, dout,
            negative_slope=slope)
        ds_dst += part
    return dz, ds_src, ds_dst


def gat_list_bytes(lists) -> int:
    """A direction's lists: row pointers, entries, hub rows, walk order."""
    return 4 * sum(t.numel() for t in (lists.row_ptr, lists.src, lists.hubs)
                   ) + (0 if lists.order is None else 4 * lists.order.numel())


def gat_case(torch, dev, plan, H, F, weight, gen, what):
    """Both GAT kernels at (H heads, F columns) on ``plan``: each output
    against its plain version in float64 within ``KERNEL_TOL`` of the
    output's largest entry, a rerun bit-identical; each entry point timed
    (the forward: walk and hub pass; the backward: walk, hub pass and
    dst_sum; the wrapper's row term ``Σ_F dout ⊙ out`` outside) beside its
    bound and the plain versions in float32.  The bound reads z, the
    scores and dout once, writes each output once, reads the lists, and
    the backward's (E', H) scratch is written and read once."""
    from repro_torch.kernels import gat_attention as ga
    from repro_torch.kernels.spmm_blockell import Lists

    fwd, bwd = Lists.of(plan.fwd), Lists.of(plan.bwd)
    pos = plan.bwd["fwd_pos"]
    n, nnz = plan.num_nodes, plan.nnz
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    z, s_src, s_dst, dout = r(n, H, F), r(n, H), r(n, H), r(n, H, F)
    out, lse = ga.gat_attention(fwd, z, s_src, s_dst,
                                negative_slope=GAT_SLOPE)
    grads = ga.gat_attention_bwd(fwd, bwd, pos, z, s_src, s_dst, lse, out,
                                 dout, negative_slope=GAT_SLOPE)
    again = ga.gat_attention(fwd, z, s_src, s_dst, negative_slope=GAT_SLOPE)
    again += ga.gat_attention_bwd(fwd, bwd, pos, z, s_src, s_dst, lse, out,
                                  dout, negative_slope=GAT_SLOPE)
    torch.cuda.synchronize()
    got = (out, lse) + tuple(grads)
    names = ("out", "lse", "dz", "ds_src", "ds_dst")
    for name, a, b in zip(names, got, again):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: {name} not finite")
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} rerun not bit-identical")
    d = lambda t: t.double()
    row_dot64 = torch.sum(d(dout) * d(out), dim=-1)
    want = gat_plain_fwd(torch, fwd, d(z), d(s_src), d(s_dst))
    want += gat_plain_bwd(torch, bwd, d(z), d(s_src), d(s_dst), d(lse),
                          row_dot64, d(dout))
    errors = {name: assert_close_scaled(a.double(), b, KERNEL_TOL,
                                        f"{what} {name}", floor=0.0)
              for name, a, b in zip(names, got, want)}
    del want, row_dot64, again

    row_dot = torch.sum(dout * out, dim=-1)
    dz, ds_src, ds_dst = (torch.empty_like(t) for t in grads)
    scratch = torch.empty((nnz, H), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    raw = {
        "gat_attention": (
            fwd.row_ptr.data_ptr(), fwd.src.data_ptr(), fwd.hubs.data_ptr(),
            ptr(fwd.order), z.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
            out.data_ptr(), lse.data_ptr(), fwd.hubs.numel(), n, H, F,
            GAT_SLOPE, stream),
        "gat_attention_bwd": (
            fwd.row_ptr.data_ptr(), bwd.row_ptr.data_ptr(),
            bwd.src.data_ptr(), bwd.hubs.data_ptr(), ptr(bwd.order),
            pos.data_ptr(), z.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
            lse.data_ptr(), row_dot.data_ptr(), dout.data_ptr(),
            dz.data_ptr(), ds_src.data_ptr(), ds_dst.data_ptr(),
            scratch.data_ptr(), bwd.hubs.numel(), n, n, H, F, GAT_SLOPE,
            stream)}
    rows, node = 4 * n * H * F, 4 * n * H
    work = {
        "gat_attention": (
            gat_list_bytes(fwd) + 2 * rows + 4 * node,
            2 * nnz * H * F + GAT_SCORE_FLOPS["fwd"] * nnz * H),
        "gat_attention_bwd": (
            gat_list_bytes(bwd) + 4 * (n + 1) + 4 * nnz + 3 * rows
            + 6 * node + 2 * 4 * nnz * H,
            4 * nnz * H * F + GAT_SCORE_FLOPS["bwd"] * nnz * H)}
    plain32 = {
        "gat_attention": lambda: gat_plain_fwd(torch, fwd, z, s_src, s_dst),
        "gat_attention_bwd": lambda: gat_plain_bwd(
            torch, bwd, z, s_src, s_dst, lse, row_dot, dout)}
    outputs = {"gat_attention": ("out", "lse"),
               "gat_attention_bwd": ("dz", "ds_src", "ds_dst")}
    cases = []
    for name in ("gat_attention", "gat_attention_bwd"):
        fn, args = ga._kernel_fn(name), raw[name]

        def launch():
            if fn(*args):
                raise RuntimeError(f"{name} launch failed")

        nbytes, ops = work[name]
        case = {"kernel": name, "case": what, "weight": weight,
                "nodes": n, "entries": nnz,
                "hubs": [fwd.hubs.numel(), bwd.hubs.numel()],
                "errors": {k: errors[k] for k in outputs[name]},
                "max_abs_err": max(errors[k] for k in outputs[name]),
                "ms": gpu_ms(launch, n_inner=2, reps=5, warmup=1),
                "plain_ms": gpu_ms(plain32[name], n_inner=1, reps=1,
                                   warmup=0),
                "library_ms": None, **bound(nbytes, ops)}
        print("case " + json.dumps(case))
        cases.append(case)
    return cases


def gat_step(torch, dev, cfg, g, plan):
    """One training step of the cell's model through the main path
    (``gat_loss(executor="fused")`` under ``make_train_step``: Adam and the
    clip of the configuration), every launch count zeroed just before it;
    then ``step_breakdown`` over more steps with the ``gat::`` kernels'
    device time."""
    from h100bench.harness import graphgen
    from repro_torch.models.gat import gat_init, gat_loss
    from repro_torch.train import adam, make_train_step

    dims, heads, tr = cfg["dims"], cfg["heads"], cfg["train"]
    gen = torch.Generator(device=dev).manual_seed(36)
    params = gat_init(gen, dims[0], dims[1], heads[0], dims[-1],
                      len(heads), device=dev, out_heads=heads[-1])
    labels = torch.as_tensor(g.labels, device=dev).long()
    batch = {"x": graphgen.make_features(cfg["graph"], labels, 36, dev),
             "labels": labels,
             "mask": torch.as_tensor(g.train_mask, device=dev)}
    opt = adam(tr["lr"], tr["b1"], tr["b2"], tr["eps"])
    step = make_train_step(
        lambda p, b: gat_loss(p, b["x"], None, b["labels"], b["mask"],
                              executor="fused", plan=plan, skip=cfg["skip"],
                              self_loops=cfg["self_loops"]),
        opt, clip_norm=tr["clip_norm"])
    state = opt.init(params)
    reset_launches()
    params, state, loss = step(params, state, batch)
    launches = read_launches(torch)
    want = {**dict.fromkeys(KERNELS, 0),
            "gat_attention": len(heads), "gat_attention_bwd": len(heads)}
    if launches != want:
        raise AssertionError(f"GAT step launched {launches}, want {want}")
    if not math.isfinite(float(loss)):
        raise AssertionError(f"GAT step loss {float(loss)}")
    torch.cuda.reset_peak_memory_stats(dev)
    br = step_breakdown(torch, "gat-reddit step", step, params, state, batch,
                        watch={"gat": "gat::"})
    report = {"launches": launches, "loss": float(loss),
              "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
              "breakdown": br}
    return launches, report


def gat_phases(torch, dev):
    """GAT at the cell's shapes (the module's docstring, 3): the kernels'
    cases and the step's launches and report."""
    import collections
    import gc
    from repro_torch.exec.gat import build_attention_plan

    t0 = time.perf_counter()
    cfg, g, graph_s = gat_graph(torch)
    t1 = time.perf_counter()
    plan = build_attention_plan(g, self_loops=cfg["self_loops"], device=dev)
    torch.cuda.synchronize()
    report = {"graph_s": graph_s, "plan_s": time.perf_counter() - t1,
              "edges": g.num_edges, **plan.describe()}
    print("GAT plan: " + json.dumps(report))
    gen = torch.Generator(device=dev).manual_seed(3600)
    cases = []
    for (H, F), weight in collections.Counter(
            zip(cfg["heads"], cfg["dims"][1:])).items():
        cases += gat_case(torch, dev, plan, H, F, weight, gen,
                          f"gat-reddit {H}x{F} ({plan.nnz} entries, "
                          f"{report['hubs']} / {report['hubs_t']} hubs)")
    launches, report["step"] = gat_step(torch, dev, cfg, g, plan)
    report["wall_s"] = time.perf_counter() - t0
    print(f"GAT phases: {report['wall_s']:.1f}s")
    del plan, g
    gc.collect()
    torch.cuda.empty_cache()
    return cases, launches, report


# ---------------------------------------------------------------------------
# the rest of the GNN zoo: GAT, PNA, NequIP
# ---------------------------------------------------------------------------
ZOO_ARCHS = ("gat-cora", "pna", "nequip")
# ogbn-products at a tenth of its size (244,902 nodes, 6,185,914 edges): the
# generator's host synthesis takes ~500 s at full size
ZOO_PRODUCTS_SCALE = 0.1
ZOO_MOLECULES = 128
# the profiler's kernels by kind, first match wins
ZOO_KINDS = [("scatter", ("scatter", "indexfunc", "index_add",
                          "indexing_backward", "radix", "sort")),
             ("gather", ("index_elementwise", "gather", "index_select",
                         "indexselect")),
             ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
             ("reduce", ("reduce_kernel",)),
             ("elementwise", ("elementwise",)),
             ("cat/copy", ("cat", "copy"))]


def pna_fp64_fit(torch, dev):
    """PNA's launcher problem (seed-0 parameters, the reordered Cora) in
    float64, 10 ``fit`` steps of adam(1e-2) with float64 moments and clip
    1.0, on the card and on the CPU: losses within 1e-4 (relative)."""
    from repro_torch.configs import get
    from repro_torch.launch.train import gnn_batch, training_graph
    from repro_torch.train import adam, fit, tree_map

    bundle = get("pna").bundle()
    g = training_graph()
    losses = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        params = tree_map(lambda t: t.double(), bundle.init_params(
            torch.Generator().manual_seed(0), g.node_feat.shape[1],
            device=d))
        batch = {k: v.double() if v.is_floating_point() else v
                 for k, v in gnn_batch(g, bundle.n_classes, d).items()}
        losses[side] = fit(bundle.loss_fn("full_graph_sm"),
                             adam(1e-2, moments_dtype=torch.float64), params,
                             iter(lambda: batch, None), steps=COMPARE_STEPS,
                             clip_norm=1.0, log=lambda s: None).losses
    rel = [abs(a - b) / max(abs(b), 1e-12)
           for a, b in zip(losses["card"], losses["cpu"])]
    if max(rel) > 1e-4:
        raise AssertionError(f"PNA fp64: card and CPU losses differ by "
                             f"{max(rel):.3e} > 1e-4")
    return {"card_losses": losses["card"], "cpu_losses": losses["cpu"],
            "loss_rel_err": max(rel)}


def gnn_zoo_launcher_phase(torch, dev):
    """``launch.train --arch gat-cora|pna|nequip --steps 10`` (full width,
    ``MODEL_KW``, the reordered Cora) on the card, then with ``--device
    cpu`` in the same process: 10 losses within 1e-4 (relative), no kernel
    launched.  PNA's run is chaotic (its loss jumps from 11.5 to ~814 on
    step 1; fp32 rounding alone parts the reference from its own fp64 run,
    ``tests/test_torch_gnn_zoo.py``): its step 0 is held within 1e-5 and
    its 10 steps in float64 (:func:`pna_fp64_fit`)."""
    report = {}
    launches_all = {k: 0 for k in KERNELS}
    for arch in ZOO_ARCHS:
        reset_launches()
        card, _, card_s = run_launcher(["--arch", arch, "--steps",
                                        str(COMPARE_STEPS)])
        launches = read_launches(torch)
        cpu, _, cpu_s = run_launcher(["--arch", arch, "--steps",
                                      str(COMPARE_STEPS), "--device", "cpu"])
        rel = [abs(a - b) / max(abs(b), 1e-12)
               for a, b in zip(card.losses, cpu.losses)]
        held, tol = (1, 1e-5) if arch == "pna" else (COMPARE_STEPS, 1e-4)
        entry = {"card_losses": card.losses, "cpu_losses": cpu.losses,
                 "loss_rel_err": rel, "held_steps": held, "tolerance": tol,
                 "card_s": card_s, "cpu_s": cpu_s, "launches": launches}
        if arch == "pna":
            entry["fp64"] = pna_fp64_fit(torch, dev)
        print(f"{arch} training (launcher, card vs CPU): "
              + json.dumps(entry))
        if len(card.losses) != COMPARE_STEPS or max(rel[:held]) > tol:
            raise AssertionError(f"{arch} launcher: card and CPU losses of "
                                 f"steps 0-{held - 1} differ by "
                                 f"{max(rel[:held]):.3e} > {tol}")
        if not all(math.isfinite(v) for v in card.losses):
            raise AssertionError(f"{arch} launcher: a loss is not finite")
        if any(launches.values()):
            raise AssertionError(f"{arch} training launched {launches}")
        report[arch] = entry
    return launches_all, report


# fp32 against float64, each gradient held to this share of its leaf's
# largest entry: 1e-4 for NequIP and GAT (on ogb_products at 0.1 they read
# 9.7e-7 and 4.7e-6 on the H100); 1e-2 for PNA, which read 4.4e-3 there:
# E[x²] - E[x]² cancels under its std and near-ties at max / min route a
# gradient to another edge, and the reference's own fp32 gradients part from
# its fp64 ones by up to 3e-3 on products_like(0.001)
# (tests/test_torch_gnn_zoo_train.py::test_reference_fp32_grads_part_from_fp64_on_products)
ZOO_GRAD_TOL = {"gat-cora": 1e-4, "pna": 1e-2, "nequip": 1e-4}


def hold_fp64(torch, what, loss_fn, params, batch, loss_fn64=None,
              grad_tol=1e-4):
    """One step on the card in fp32 against the same step in float64: the
    loss within 1e-5 (relative) and every gradient within ``grad_tol`` of
    its leaf's largest entry (float64)."""
    import gc
    from repro_torch.train import tree_leaves, tree_map

    p32 = leaf_copy(params)
    loss = loss_fn(p32, batch)
    loss.backward()
    l32, g32 = float(loss.detach()), [p.grad for p in tree_leaves(p32)]
    del loss
    gc.collect()
    torch.cuda.empty_cache()
    p64 = tree_map(lambda t: t.detach().double().requires_grad_(), params)
    b64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
           else v for k, v in batch.items()}
    loss = (loss_fn64 or loss_fn)(p64, b64)
    loss.backward()
    l64 = float(loss.detach())
    del loss
    loss_rel = abs(l32 - l64) / max(abs(l64), 1e-30)
    errs = []
    for i, (a, b) in enumerate(zip(g32, (p.grad for p in tree_leaves(p64)))):
        if a is None or b is None:
            # a leaf the loss does not reach (NequIP's last layer's l=1 and
            # l=2 channel mixing): no gradient on either side
            if (a is None) != (b is None):
                raise AssertionError(f"{what}: gradient {i} exists on one "
                                     "side only")
            errs.append(0.0)
            continue
        scale = float(b.abs().max())
        errs.append(float((a.double() - b).abs().max()) / max(scale, 1e-30))
        if errs[-1] > grad_tol:
            raise AssertionError(f"{what}: gradient {i} differs from fp64 by "
                                 f"{errs[-1]:.3e} of its largest entry > "
                                 f"{grad_tol}")
    if loss_rel > 1e-5:
        raise AssertionError(f"{what}: loss {l32} vs fp64 {l64}: "
                             f"{loss_rel:.3e} > 1e-5")
    del p32, p64, b64, g32
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss_fp32": l32, "loss_fp64": l64, "loss_rel_err": loss_rel,
            "grad_err_of_leaf_max": max(errs), "grad_errs": errs,
            "grad_tol": grad_tol}


def zoo_cell(torch, dev, what, arch, shape, batch, loss_fn64=None,
             extra=None):
    """One model on one cell at full width (``MODEL_KW``): seed-0 params
    drawn on the CPU and moved, one step held against float64
    (:func:`hold_fp64`), ``extra(params)`` if given, then
    ``step_breakdown`` of ``bundle.step_fn(shape)`` (ms a step, busy share,
    device time by kind) with its peak memory; no kernel may launch."""
    import gc
    from repro_torch.configs import get

    bundle = get(arch).bundle()
    d_feat = batch["x"].shape[1] if "x" in batch else \
        bundle.geometry(shape)["d"]
    params = bundle.init_params(torch.Generator().manual_seed(0), d_feat,
                                device=dev)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    report = {"hold_fp64": hold_fp64(torch, what, bundle.loss_fn(shape),
                                     params, batch, loss_fn64,
                                     ZOO_GRAD_TOL[arch])}
    report["hold_peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if extra is not None:
        report.update(extra(params))
    torch.cuda.reset_peak_memory_stats(dev)
    br = step_breakdown(torch, what, bundle.step_fn(shape), params,
                        bundle.opt().init(params), batch, kinds=ZOO_KINDS)
    launches = read_launches(torch)
    report.update(step_ms=br["step_ms"], busy_share=br["busy_share"],
                  device_ms_per_step=br["device_ms_per_step"],
                  device_ms_by_kind=br["device_ms_by_kind"],
                  peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                  losses=br["losses"], launches=launches, breakdown=br)
    print(f"{what}: " + json.dumps({k: v for k, v in report.items()
                                    if k != "breakdown"}))
    if not all(math.isfinite(v) for v in br["losses"]):
        raise AssertionError(f"{what}: a loss is not finite {br['losses']}")
    if any(launches.values()):
        raise AssertionError(f"{what} launched {launches}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, report


def nequip_rotation(torch, batch):
    """NequIP's per-molecule energies invariant and its forces equivariant
    under a seeded rotation, on the card (1e-5 of the largest entry)."""
    import numpy as np
    from repro_torch.models import nequip_energy_forces

    q, r = np.linalg.qr(np.random.default_rng(22).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]

    def check(params):
        from repro_torch.models import nequip_energy
        R = torch.as_tensor(q.astype(np.float32), device=batch["pos"].device)
        kw = dict(edge_mask=batch["edge_mask"],
                  node_mask=batch["train_mask"].to(torch.float32))
        args = (params, batch["species"])
        ij = (batch["src"], batch["dst"])
        gid, n_mol = batch["graph_ids"], batch["num_graphs"]
        with torch.no_grad():
            e = nequip_energy(*args, batch["pos"], *ij, graph_ids=gid,
                              num_graphs=n_mol, **kw)
            e_r = nequip_energy(*args, batch["pos"] @ R.T, *ij,
                                graph_ids=gid, num_graphs=n_mol, **kw)
        _, f = nequip_energy_forces(*args, batch["pos"], *ij, **kw)
        _, f_r = nequip_energy_forces(*args, batch["pos"] @ R.T, *ij, **kw)
        return {"rotation": {
            "energy_err": assert_close_scaled(e_r, e, 1e-5,
                                              "NequIP rotated energies"),
            "forces_err": assert_close_scaled(f_r, f @ R.T, 1e-5,
                                              "NequIP rotated forces"),
            "max_abs_energy": float(e.abs().max()),
            "max_abs_force": float(f.abs().max())}}
    return check


def gnn_zoo_cells_phase(torch, dev):
    """GAT (8 heads x 8) and PNA (75 x 4 layers) on ``ogb_products`` built
    from ``products_like(scale=0.1)`` (244,902 nodes, 6,185,914 edges, 100
    features; synthesized once for both), and NequIP (32 channels, 5
    layers, l_max 2) on ``molecule``: a ``pack`` of
    ``molecules_like(128)`` (3,840 atoms, 8,192 edges) padded to the
    geometry's 4,096 nodes, nothing cut.  Each at full width through
    :func:`zoo_cell`; NequIP's rotation check on the card; PNA's float64
    step with each layer rematerialised (``loss_fn(remat=True)``)."""
    import gc
    import numpy as np
    from repro_torch.configs import get
    from repro_torch.graph import molecules_like, pack, products_like
    from repro_torch.launch.train import gnn_batch

    paths, report = {}, {}
    t0 = time.perf_counter()
    g = products_like(scale=ZOO_PRODUCTS_SCALE)
    report["products_synthesis_s"] = time.perf_counter() - t0
    report["products"] = {"nodes": g.num_nodes, "edges": g.num_edges,
                          "features": int(g.node_feat.shape[1]),
                          "scale": ZOO_PRODUCTS_SCALE}
    print(f"ogb_products at {ZOO_PRODUCTS_SCALE}: {g.num_nodes} nodes, "
          f"{g.num_edges} edges, synthesized in "
          f"{report['products_synthesis_s']:.1f}s")
    for arch, name in (("gat-cora", "GAT"), ("pna", "PNA")):
        bundle = get(arch).bundle()
        batch = gnn_batch(g, bundle.n_classes, dev)
        what = f"{name} ogb_products (scale {ZOO_PRODUCTS_SCALE})"
        paths[what], report[arch] = zoo_cell(
            torch, dev, what, arch, "ogb_products", batch,
            # PNA's float64 saved activations (~44 GB) would not fit beside
            # the backward's: its hold recomputes each layer
            loss_fn64=(bundle.loss_fn("ogb_products", remat=True)
                       if arch == "pna" else None))
        del batch
        gc.collect()
        torch.cuda.empty_cache()
    del g

    bundle = get("nequip").bundle()
    geo = bundle.geometry("molecule")
    mols = molecules_like(ZOO_MOLECULES)
    gb, _ = pack([m[0] for m in mols])
    n, pad = gb.num_nodes, geo["n"] - gb.num_nodes
    if gb.src.shape[0] != geo["e"] or pad < 0:
        raise AssertionError(f"molecule pack {n} nodes / {gb.src.shape[0]} "
                             f"edges vs geometry {geo}")
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    batch = {"src": t(gb.src.astype(np.int64)),
             "dst": t(gb.dst.astype(np.int64)), "edge_mask": t(gb.edge_mask),
             "labels": t(np.zeros(geo["n"], np.int64)),
             "train_mask": t(np.concatenate([gb.node_mask,
                                             np.zeros(pad, bool)])),
             "species": t(np.concatenate(
                 [np.concatenate([m[2] for m in mols]),
                  np.zeros(pad, np.int32)]).astype(np.int64)),
             "pos": t(np.concatenate([np.concatenate([m[1] for m in mols]),
                                      np.zeros((pad, 3), np.float32)])),
             "energy_target": torch.zeros((), device=dev)}
    rot_batch = dict(batch, graph_ids=t(np.concatenate(
        [gb.graph_ids, np.full(pad, ZOO_MOLECULES - 1, np.int32)]).astype(
            np.int64)), num_graphs=ZOO_MOLECULES)
    report["molecule"] = {"molecules": ZOO_MOLECULES, "atoms": n,
                          "edges": int(gb.src.shape[0]),
                          "padded_nodes": geo["n"]}
    what = "NequIP molecule (128 molecules)"
    paths[what], report["nequip"] = zoo_cell(
        torch, dev, what, "nequip", "molecule", batch,
        extra=nequip_rotation(torch, rot_batch))
    del batch, rot_batch
    gc.collect()
    torch.cuda.empty_cache()
    return paths, report


def gnn_zoo_phases(torch, dev):
    """GAT, PNA and NequIP, once the LM phases have freed the card: the
    launcher at full width on Cora (card vs CPU), then the three models on
    their cells.  None launches a kernel of the port: the reference runs
    them on ``jax.ops.segment_*``."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths, report = {}, {}
    paths["GAT / PNA / NequIP training (launcher)"], report["launcher"] = \
        gnn_zoo_launcher_phase(torch, dev)
    cell_paths, report["cells"] = gnn_zoo_cells_phase(torch, dev)
    paths.update(cell_paths)
    report["wall_s"] = time.perf_counter() - t0
    print(f"GNN zoo phases: {report['wall_s']:.1f}s")
    return paths, report


# ---------------------------------------------------------------------------
def ptxas_report(log: str) -> list:
    """ptxas's register and spill lines, each after the (demangled, where
    ``c++filt`` is installed) name of its kernel instantiation."""
    out = []
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            if shutil.which("c++filt"):
                name = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True, timeout=60).stdout.strip()
            out.append(name)
        elif "registers" in line or "spill" in line:
            out.append("  " + line)
    return out


def kernel_row(name, cases, launches, work):
    main = [c for c in cases if c["weight"]]
    t_bytes = sum(c["weight"] * c["bound_bytes_ms"] for c in main)
    t_ops = sum(c["weight"] * c["bound_ops_ms"] for c in main)
    lib = [c["library_ms"] for c in main]
    source, replaces, _ = KERNELS[name]
    extra = {}
    if any("composed_ms" in c for c in main):
        comp = [c.get("composed_ms") for c in main]
        extra = {"composed_ms": (None if any(v is None for v in comp) else
                                 sum(c["weight"] * c["composed_ms"]
                                     for c in main)),
                 "composed": COMPOSED}
    return {**extra, "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "work": work,
            "ms": sum(c["weight"] * c["ms"] for c in main),
            "plain_ms": sum(c["weight"] * c["plain_ms"] for c in main),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (None if any(v is None for v in lib)
                           else sum(c["weight"] * c["library_ms"]
                                    for c in main)),
            "peaks": "H100 SXM data sheet: 67 TFLOP/s fp32, 3.35 TB/s"}


# ---------------------------------------------------------------------------
# the dry-run and the roofline: launch.dryrun / launch.roofline_run as
# children (fake process groups on the host, no kernel), then the roofline
# held against two steps the card runs
# ---------------------------------------------------------------------------
ROOFLINE_CHILD_TIMEOUT_S = 600
ROOFLINE_WARMUP = 2
ROOFLINE_TIMED = 5
ROOFLINE_PEAK_TOL = 0.10
# the reference's dry-run on (16, 16): these 12 cells raise at its ZeRO
# entry (a layer stack of 36, 88 or 24 does not divide the data axis)
ROOFLINE_FAILED = {(a, s) for a in ("granite-8b", "mistral-large-123b",
                                    "llama4-maverick-400b-a17b")
                   for s in ("train_4k", "prefill_32k", "decode_32k",
                             "long_500k")}
ROOFLINE_OK = 28


def roofline_children(tmp: Path) -> dict:
    """``python -m repro_torch.launch.dryrun --single-pod-only --json`` (must
    exit 1 with exactly ``ROOFLINE_FAILED`` failed and ``ROOFLINE_OK``
    cells OK), then ``python -m repro_torch.launch.roofline_run --json
    --md`` (``ROOFLINE_OK`` records)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    runs = {"dryrun": ["repro_torch.launch.dryrun", "--single-pod-only",
                       "--json", str(tmp / "dryrun.json")],
            "roofline_run": ["repro_torch.launch.roofline_run", "--json",
                             str(tmp / "roofline.json"), "--md",
                             str(tmp / "roofline.md")]}
    for name, argv in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *argv], env=env,
                              cwd=str(ROOT), capture_output=True, text=True,
                              timeout=ROOFLINE_CHILD_TIMEOUT_S)
        out[name] = {"exit": proc.returncode,
                     "seconds": time.perf_counter() - t0,
                     "last_line": (proc.stdout.strip().splitlines()
                                   or [""])[-1]}
        print(f"roofline: {name} exit {proc.returncode} in "
              f"{out[name]['seconds']:.1f}s: {out[name]['last_line']}")
        if name == "dryrun" and proc.returncode != 1:
            raise AssertionError(f"the dry-run exited {proc.returncode}, "
                                 f"not 1:\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        if name == "roofline_run" and proc.returncode != 0:
            raise AssertionError(f"roofline_run exited {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
    doc = json.loads((tmp / "dryrun.json").read_text())
    ok = {(r["arch"], r["shape"]) for r in doc["results"]}
    failed = {(f["arch"], f["shape"]) for f in doc["failures"]}
    out["dryrun"]["ok"] = len(ok)
    out["dryrun"]["failed"] = sorted(failed)
    out["dryrun"]["over_hbm"] = sorted(
        (r["arch"], r["shape"], r["memory"]["peak_gb_per_device"])
        for r in doc["results"] if r.get("hbm_overflow"))
    if len(ok) != ROOFLINE_OK or failed != ROOFLINE_FAILED:
        raise AssertionError(f"the dry-run's cells: {len(ok)} OK, failed "
                             f"{sorted(failed)}; expected {ROOFLINE_OK} OK "
                             f"and the reference's {len(ROOFLINE_FAILED)}")
    records = json.loads((tmp / "roofline.json").read_text())
    out["roofline_run"]["records"] = records
    out["roofline_run"]["md"] = (tmp / "roofline.md").read_text()
    if len(records) != ROOFLINE_OK:
        raise AssertionError(f"roofline_run gave {len(records)} records, "
                             f"not {ROOFLINE_OK}")
    return out


def arg_bytes(torch, tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    from torch.utils._pytree import tree_flatten
    seen = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def roofline_hold(torch, dev, cell, what, counts, peak_gb, step, args):
    """Run ``step(*args)`` (the (arch, shape) ``cell``, described as
    ``what``) on the card (``ROOFLINE_WARMUP`` steps, then the
    median of ``ROOFLINE_TIMED`` synchronised steps, CUDA events) and hold
    it against its roofline from ``counts`` (``roofline.count``): the
    measured time may not be below the bound, and the dry-run's peak
    (``peak_gb``) must lie within ``ROOFLINE_PEAK_TOL`` of the card's: the
    step's arguments plus what ``max_memory_allocated`` rose above what was
    allocated before the timed steps (the allocator's other residents, the
    cuBLAS workspace among them, left out)."""
    from repro_torch.roofline.analysis import from_counts
    r = from_counts(*cell, "1x1", counts, peak_gb)
    reset_launches()
    for _ in range(ROOFLINE_WARMUP):
        step(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(ROOFLINE_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    del out
    launches = read_launches(torch)
    raw_peak = torch.cuda.max_memory_allocated(dev)
    held = arg_bytes(torch, args)
    card_peak = held + raw_peak - base
    measured = statistics.median(times)
    report = {
        "card": SMI_LINE, "flops": counts["flops"], "bytes": counts["bytes"],
        "collective_bytes": counts["collectives"]["total"],
        "t_compute_s": r.t_compute, "t_memory_s": r.t_memory,
        "t_collective_s": r.t_collective, "dominant": r.dominant,
        "bound_s": r.bound_time, "measured_s": measured,
        "measured_s_all": times, "measured_over_bound":
            measured / max(r.bound_time, 1e-30),
        "dryrun_peak_gb": peak_gb, "argument_gb": held / 1e9,
        "max_memory_allocated_gb": raw_peak / 1e9,
        "allocated_before_gb": base / 1e9, "card_peak_gb": card_peak / 1e9,
        "peak_rel_err": abs(peak_gb * 1e9 - card_peak) / card_peak,
        "launches": launches}
    print(f"roofline hold, {what} ({SMI_LINE}): " + json.dumps(
        {k: v for k, v in report.items() if k not in ("card",
                                                       "measured_s_all")}))
    if any(launches.values()):
        raise AssertionError(f"{what}: the step launched {launches}")
    if measured < r.bound_time:
        raise AssertionError(f"{what}: measured {measured:.6g} s is below "
                             f"the bound {r.bound_time:.6g} s: a miscount")
    if report["peak_rel_err"] > ROOFLINE_PEAK_TOL:
        raise AssertionError(
            f"{what}: the dry-run's peak {peak_gb:.4f} GB is "
            f"{report['peak_rel_err']:.1%} from the card's "
            f"{card_peak / 1e9:.4f} GB (bar {ROOFLINE_PEAK_TOL:.0%})")
    return launches, report


def gnn_batch(torch, bundle, shape, gen, dev):
    """A concrete batch of ``GNNBundle.input_specs``: edge ids uniform over
    the nodes, labels over the classes, every mask set, degrees 1, features
    N(0, 1)."""
    n = bundle.geometry(shape)["n"]
    kw = dict(generator=gen, device=dev)
    out = {}
    for name, (shp, dtype) in bundle.input_specs(shape).items():
        if name in ("src", "dst", "species"):
            out[name] = torch.randint(0, n if name != "species" else 4, shp,
                                      dtype=dtype, **kw)
        elif name == "labels":
            out[name] = torch.randint(0, bundle.n_classes, shp, dtype=dtype,
                                      **kw)
        elif dtype == torch.bool or name == "deg":
            out[name] = torch.ones(shp, dtype=dtype, device=dev)
        else:
            out[name] = torch.randn(shp, dtype=dtype, **kw)
    return out


def lm_train_cut():
    """(the granite-8b ``train_4k`` cut the roofline holds, its name)."""
    import dataclasses
    from repro_torch.configs.granite_8b import CONFIG
    return (dataclasses.replace(CONFIG, n_layers=LM_TRAIN_LAYERS),
            f"granite-8b train_4k ({LM_TRAIN_LAYERS} of {CONFIG.n_layers} "
            f"layers, B = 1)")


def recording(step, losses):
    """``step`` that appends each call's loss (its third output, left on
    the device) to ``losses``."""
    def run(*args):
        out = step(*args)
        losses.append(out[2])
        return out
    return run


def roofline_phase(torch, dev):
    """The dry-run and the roofline on the card's machine: ``roofline.hw``
    against the card (an H100 with at least ``hw.HBM_BYTES``), the two
    children (``roofline_children``), then two steps that reach no kernel,
    counted by ``roofline.count.count_step`` on the host and run on the
    card (``roofline_hold``): granite-8b ``train_4k`` cut to
    ``LM_TRAIN_LAYERS`` of 36 layers at B = 1 (the bundle's step with no
    mesh: the path ``lm_train_config_phase`` runs; its losses are kept for
    ``lm_mesh_train_phase``, which runs the mesh path's step on the same
    state) and gcn-cora ``full_graph_sm`` through
    ``launch.dryrun.lower_cell`` on a (1, 1) mesh over a one-rank fake
    group.  Returns (launches, report)."""
    import gc
    from repro_torch.configs import get
    from repro_torch.configs.families import LMBundle
    from repro_torch.launch.dryrun import fake_world, lower_cell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.roofline import hw
    from repro_torch.roofline.count import count_step

    name = torch.cuda.get_device_name(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"roofline: {name}, {total / 1e9:.2f} GB ({SMI_LINE}); "
          f"roofline.hw: {hw.PEAK_FLOPS_BF16:.4g} FLOP/s bf16, "
          f"{hw.HBM_BW:.4g} B/s, {hw.HBM_BYTES:.4g} B")
    if "H100" not in name or total < hw.HBM_BYTES:
        raise AssertionError(f"roofline.hw describes an H100 with "
                             f"{hw.HBM_BYTES:.4g} B; this card is {name} "
                             f"with {total} B")
    report = {"card": SMI_LINE, "device_name": name, "total_memory": total}
    with tempfile.TemporaryDirectory() as tmp:
        report["children"] = roofline_children(Path(tmp))
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: 0 for k in KERNELS}

    spec = get("gcn-cora")
    bundle = spec.bundle()
    t0 = time.perf_counter()
    with fake_world(1):
        res, _, counts = lower_cell(bundle, spec, "full_graph_sm",
                                    make_debug_mesh((1, 1), device="cpu"))
    trace_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(27)
    g = bundle.geometry("full_graph_sm")
    params = bundle.init_params(gen, g["d"], device=dev)
    args = (params, bundle.opt().init(params),
            gnn_batch(torch, bundle, "full_graph_sm", gen, dev))
    got, report["gcn-cora full_graph_sm"] = roofline_hold(
        torch, dev, ("gcn-cora", "full_graph_sm"), "gcn-cora full_graph_sm",
        counts,
        res["memory"]["peak_gb_per_device"], bundle.step_fn("full_graph_sm"),
        args)
    report["gcn-cora full_graph_sm"]["trace_s"] = trace_s
    launches = {k: launches[k] + got[k] for k in KERNELS}
    del params, args
    gc.collect()
    torch.cuda.empty_cache()

    cfg, what = lm_train_cut()
    bundle = LMBundle(cfg)
    t0 = time.perf_counter()
    counts = count_step(bundle.step_fn("train_4k"),
                        lm_train_abstract_args(torch, bundle), donate=(0, 1))
    trace_s = time.perf_counter() - t0
    args = lm_train_args(bundle, dev)
    losses = []
    got, report[what] = roofline_hold(
        torch, dev, ("granite-8b", "train_4k"), what, counts,
        counts["memory"]["peak_gb_per_device"],
        recording(bundle.step_fn("train_4k"), losses), args)
    report[what]["trace_s"] = trace_s
    report[what]["losses"] = [float(v) for v in losses]
    launches = {k: launches[k] + got[k] for k in KERNELS}
    del args
    gc.collect()
    torch.cuda.empty_cache()
    return launches, report


def lm_train_abstract_args(torch, bundle):
    """``bundle``'s ``train_4k`` state and a B = 1 batch as ``meta``
    tensors, for ``count_step``."""
    specs = bundle.input_specs("train_4k", batch=1)
    return (*bundle.abstract_state("train_4k"),
            {k: torch.empty(s, dtype=d, device="meta")
             for k, (s, d) in specs.items()})


def lm_train_args(bundle, dev):
    """The weights, fresh Adam state and B = 1 batch of ``bundle``'s
    ``train_4k`` step, drawn from seed 27 on ``dev``: the same tensors at
    every call."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(27)
    params = bundle.init_params(gen, dev)
    return (params, bundle.opt().init(params),
            bundle.make_batch("train_4k", gen, dev, batch=1))


def lm_mesh_train_phase(torch, dev, roofline_report):
    """The LM mesh path's training step on the card: the granite-8b
    ``train_4k`` cut of ``roofline_phase`` (``lm_train_cut``) through
    ``dist.sharding.use_mesh`` on a (1, 1) data x model mesh of a one-rank
    NCCL group, on the no-mesh step's weights, batch and fresh donated
    state (``lm_train_args``).  The bundle's step is made under the mesh
    (its clip norm is the mesh's); the mesh path runs each layer and loss
    chunk under its checkpoints.  Counted by ``count_step`` under a (1, 1)
    mesh over a one-rank fake group, then held by ``roofline_hold`` (not
    below the bound, the card's peak within ``ROOFLINE_PEAK_TOL`` of the
    count); its first loss must equal the no-mesh step's first (in
    ``roofline_report``) bit for bit.  Returns (launches, report)."""
    import gc
    import torch.distributed as dist
    from repro_torch.configs.families import LMBundle
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.roofline.count import count_step

    cfg, name = lm_train_cut()
    want = roofline_report[name]
    bundle = LMBundle(cfg)
    what = f"{name} on a (1, 1) NCCL mesh"
    t0 = time.perf_counter()
    with fake_world(1), use_mesh(make_debug_mesh((1, 1), device="cpu")):
        counts = count_step(bundle.step_fn("train_4k"),
                            lm_train_abstract_args(torch, bundle),
                            donate=(0, 1))
    trace_s = time.perf_counter() - t0
    with one_rank_group(dev) as mesh:
        with use_mesh(mesh):
            step = bundle.step_fn("train_4k")

        def meshed(*args):
            with use_mesh(mesh):
                return step(*args)
        args = lm_train_args(bundle, dev)
        losses = []
        launches, report = roofline_hold(
            torch, dev, ("granite-8b", "train_4k"), what, counts,
            counts["memory"]["peak_gb_per_device"],
            recording(meshed, losses), args)
        report["backend"] = dist.get_backend()
    del args
    gc.collect()
    torch.cuda.empty_cache()
    report["trace_s"] = trace_s
    report["losses"] = [float(v) for v in losses]
    report["no_mesh_losses"] = want["losses"]
    report["first_loss_bit_identical"] = (report["losses"][0]
                                          == want["losses"][0])
    report["losses_bit_identical"] = report["losses"] == want["losses"]
    report["no_mesh_measured_s"] = want["measured_s"]
    report["no_mesh_card_peak_gb"] = want["card_peak_gb"]
    print(f"LM mesh train step ({what}, {SMI_LINE}): "
          f"{report['measured_s'] * 1e3:.1f} ms a step vs "
          f"{want['measured_s'] * 1e3:.1f} ms with no mesh; card peak "
          f"{report['card_peak_gb']:.2f} GB vs {want['card_peak_gb']:.2f} GB "
          f"(counted {counts['memory']['peak_gb_per_device']:.2f} GB); first "
          f"loss {report['losses'][0]!r} vs {want['losses'][0]!r}; all "
          f"{len(losses)} losses bit-identical: "
          f"{report['losses_bit_identical']}")
    if not report["first_loss_bit_identical"]:
        raise AssertionError(f"{what}: first loss {report['losses'][0]!r} "
                             f"is not the no-mesh step's "
                             f"{want['losses'][0]!r}")
    return launches, report


MESH_GNN_CELLS = (("gcn-cora", "full_graph_sm"), ("gat-cora", "full_graph_sm"),
                  ("pna", "full_graph_sm"), ("nequip", "molecule"))
MESH_STEPS = 3


def mesh_steps(torch, dev, make, mesh, steps=MESH_STEPS) -> dict:
    """``steps`` donated steps of ``make()``'s ``(step, params, state,
    batch)`` under ``dist.sharding.use_mesh(mesh)`` (None: no mesh): the
    losses, ms a step (CUDA events), the peak device memory and the kernels'
    launches."""
    import gc
    from repro_torch.dist.sharding import use_mesh
    step, params, state, batch = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    losses, ms = [], []
    with use_mesh(mesh):
        for _ in range(steps):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            params, state, loss = step(params, state, batch)
            t1.record()
            torch.cuda.synchronize()
            ms.append(t0.elapsed_time(t1))
            losses.append(float(loss))
    out = {"losses": losses, "ms": ms,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": read_launches(torch)}
    del step, params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def gnn_recsys_mesh_phase(torch, dev):
    """The mesh path of ``GNNBundle`` and ``RecsysBundle`` on the card: a
    (1, 1) data x model mesh of a one-rank NCCL group, where every
    collective is skipped, so each step must compute bit for bit what the
    no-mesh step does.  ``MESH_STEPS`` donated steps of each of gcn-cora,
    gat-cora and pna at ``full_graph_sm`` (3,072 padded nodes, d = 1433,
    ``gnn_batch``'s random edges), nequip at ``molecule`` and wide & deep
    ``train_batch`` at the full ``CONFIG`` (B = 65,536, the 40 M-row
    table, ``lookup="bag"``: row 7), first with no mesh, then on the mesh,
    from the same seeds, under ``torch.use_deterministic_algorithms``
    (``index_add_`` on CUDA sums with atomics otherwise, so two runs of
    one step differ in the last bits).  Prints ms a step, the peak and the
    losses of each; raises unless the losses are bit-identical and
    ``embedding_bag`` launched 4 times a wide & deep step both ways.
    Returns (the launches of every step run, report)."""
    import torch.distributed as dist
    from repro_torch.configs import get

    def gnn_make(arch, shape):
        bundle = get(arch).bundle()

        def make():
            params = bundle.init_params(torch.Generator().manual_seed(0),
                                        bundle.geometry(shape)["d"],
                                        device=dev)
            batch = gnn_batch(torch, bundle, shape,
                              torch.Generator(device=dev).manual_seed(29),
                              dev)
            return (bundle.step_fn(shape), params, bundle.opt().init(params),
                    batch)
        return make

    def recsys_make():
        bundle = get("wide-deep").bundle()
        gen = torch.Generator(device=dev).manual_seed(29)
        params = bundle.init_params(gen, dev)
        return (bundle.step_fn("train_batch", lookup="bag"), params,
                bundle.optimizer().init(params),
                bundle.make_batch("train_batch", gen, dev))

    cells = [(f"{a} {s}", gnn_make(a, s)) for a, s in MESH_GNN_CELLS]
    cells.append(("wide-deep train_batch (CONFIG, bag)", recsys_make))
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    report, launches = {}, {k: 0 for k in KERNELS}
    try:
        with one_rank_group(dev) as mesh, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for name, make in cells:
                runs = {tag: mesh_steps(torch, dev, make, m)
                        for tag, m in (("no_mesh", None), ("mesh", mesh))}
                for r in runs.values():
                    for k, v in r["launches"].items():
                        launches[k] += v
                report[name] = dict(runs, bit_identical=(
                    runs["mesh"]["losses"] == runs["no_mesh"]["losses"]))
            report["backend"] = dist.get_backend()
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    for name, r in report.items():
        if name == "backend":
            continue
        a, b = r["no_mesh"], r["mesh"]
        print(f"mesh step {name} ((1, 1) NCCL, {SMI_LINE}): "
              f"{sum(b['ms'][1:]) / (len(b['ms']) - 1):.2f} ms a step vs "
              f"{sum(a['ms'][1:]) / (len(a['ms']) - 1):.2f} with no mesh "
              f"(steps 2-{MESH_STEPS}); peak {b['peak_gb']:.3f} vs "
              f"{a['peak_gb']:.3f} GB; embedding_bag "
              f"{b['launches']['embedding_bag'] / MESH_STEPS:g} vs "
              f"{a['launches']['embedding_bag'] / MESH_STEPS:g} a step; "
              f"losses {b['losses']} bit-identical: {r['bit_identical']}")
        if not all(math.isfinite(v) for v in a["losses"]):
            raise AssertionError(f"mesh step {name}: a loss is not finite "
                                 f"{a['losses']}")
        if not r["bit_identical"]:
            raise AssertionError(f"mesh step {name}: the (1, 1) mesh's "
                                 f"losses {b['losses']} are not the no-mesh "
                                 f"step's {a['losses']}")
    bag = {tag: report["wide-deep train_batch (CONFIG, bag)"][tag][
        "launches"]["embedding_bag"] for tag in ("no_mesh", "mesh")}
    if bag != {"no_mesh": 4 * MESH_STEPS, "mesh": 4 * MESH_STEPS}:
        raise AssertionError(f"wide & deep mesh steps launched "
                             f"embedding_bag {bag} times in {MESH_STEPS} "
                             "steps each; expected 4 a step")
    return launches, report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    global SMI_POWER_LIMIT, SMI_LINE
    SMI_LINE = smi.stdout.strip().splitlines()[0]
    SMI_POWER_LIMIT = SMI_LINE.rsplit(", ", 1)[1]
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside this "
                         "script; run it from a checkout of the repository")
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.launch.train import training_graph

    dev = resolve_device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    _build.build(*KERNELS, *LIST_SOURCES)
    for name, info in _build.BUILD_LOG.items():
        print(f"build {name}: {info['seconds']:.1f}s")
        for line in ptxas_report(info["log"]):
            print("  " + line)

    paths = {}
    gat_cases, paths["gat-reddit training step (fused)"], gat_report = \
        gat_phases(torch, dev)
    g_train = training_graph()
    compact_cases = serving_kernel_phase(torch, dev)
    compact_cases += training_compact_phase(torch, dev, g_train)
    update_cases = update_phase(torch, dev, g_train)
    bucket_compact, bucket_update = bucket_tile_phase(torch, dev, g_train)
    compact_cases += bucket_compact
    update_cases += bucket_update
    spmm_cases, fused_cases, padded_update_cases = padded_phase(torch, dev,
                                                                g_train)

    paths["serving"] = serving_phase(torch)
    gcn_launches, fused_launches, gcn_losses, gcn_report = \
        gcn_autotune_phase(torch, dev, g_train)
    paths["gcn-cora training (autotuned)"] = gcn_launches
    paths["gcn-cora training (--executor fused)"] = fused_launches
    gin_launches, gin_losses, gin_step_ms, gin_report = gin_training_phase(
        torch, dev, g_train)
    paths["GIN training"] = gin_launches
    paths["ops.spmm"] = ops_spmm_phase(torch, dev, g_train)
    paths["quickstart (examples/quickstart_torch.py)"], quickstart_report = \
        quickstart_phase(torch)
    paths["GCN blockell + BlockEll training"], gcn_ell_report, ell_cases = \
        gcn_blockell_phase(torch, dev, g_train)
    spmm_cases += ell_cases
    paths["GIN shared training"], gin_shared_report = gin_shared_phase(
        torch, dev, g_train)
    (paths["ResilientPlan (healthy, weighted, drills)"], fallback_report,
     weighted_compact, weighted_fused) = fallback_phase(torch, dev, g_train)
    compact_cases += weighted_compact
    fused_cases += weighted_fused
    dist_cases, dist_paths, dist_report = dist_phases(torch, dev, g_train)
    compact_cases += dist_cases
    paths.update(dist_paths)
    sddmm_cases = sddmm_phase(torch, dev, g_train)
    paths["ops.sddmm"] = ops_sddmm_phase(torch, dev, g_train)
    paths["observability (serve + train + audit)"], obs_report = obs_phase(
        torch, dev)
    sage_compact, sage_update, sage_paths, sage_report = sage_phases(torch,
                                                                     dev)
    compact_cases += sage_compact
    update_cases += sage_update
    paths.update(sage_paths)
    bag_cases, recsys_paths, recsys_report = recsys_phases(torch, dev)
    paths.update(recsys_paths)
    decode_cases, lm_paths, lm_report = lm_phases(torch, dev)
    paths.update(lm_paths)
    lm_train_paths, lm_train_report = lm_training_phases(torch, dev)
    paths.update(lm_train_paths)
    moe_cases, moe_paths, moe_report = moe_phases(torch, dev)
    decode_cases += moe_cases
    paths.update(moe_paths)
    zoo_paths, zoo_report = gnn_zoo_phases(torch, dev)
    paths.update(zoo_paths)
    paths["chaos drill (full, 2 runs)"], drill_report = drill_phase(torch,
                                                                    dev)
    paths["roofline holds (gcn-cora, granite-8b train_4k cut)"], \
        roofline_report = roofline_phase(torch, dev)
    paths["LM mesh train step (1 x 1 NCCL, granite-8b train_4k cut)"], \
        roofline_report["lm_mesh_train"] = lm_mesh_train_phase(
            torch, dev, roofline_report)
    paths["GNN and wide & deep mesh steps (1 x 1 NCCL, no mesh then "
          "mesh)"], mesh_report = gnn_recsys_mesh_phase(torch, dev)
    print("launches by path: " + json.dumps(paths))
    total = {k: sum(p[k] for p in paths.values()) for k in KERNELS}
    print(f"gcn-cora losses head {gcn_losses[:3]} tail {gcn_losses[-3:]}; "
          f"GIN losses head {gin_losses[:3]} tail {gin_losses[-3:]}; "
          f"GIN {gin_step_ms:.3f} ms/step")

    kernels = [
        kernel_row("spmm_blockell", spmm_cases, total["spmm_blockell"],
                   "y = A x on the reordered Cora's padded ELL, bm=128: "
                   "d=64 (kernels.ops.spmm's shape) + one GCN [1433, 16, 7] "
                   "blockell + BlockEll training step's 3 launches "
                   "(forward d=1433, 16; transposed d=16); library: "
                   "torch.sparse.mm of the bare adjacency"),
        kernel_row("spmm_blockell_fused", fused_cases,
                   total["spmm_blockell_fused"],
                   "one padded gcn-cora step's aggregations on the reordered "
                   "Cora, bm=128 (forward d=16, 7; transposed d=16, 7), as "
                   "the padded candidates of the autotune race run them, + "
                   "the weighted sum ResilientPlan's padded forward at d=64 "
                   "and d=1433 (f32 tiles, seeded weights); library: "
                   "torch.sparse.mm of the same (weighted) adjacency"),
        kernel_row("spmm_blockell_compact", compact_cases,
                   total["spmm_blockell_compact"],
                   "the list walk (csrc/spmm_blockell_lists.cu: a compact "
                   "cuda plan's per-row entry lists, no tile read; hub pass "
                   "included) at: one GCN serving forward on Cora (d=64 "
                   "then 16) + one gcn-cora compact step (forward d=16, 7; "
                   "transposed d=16, 7) + one GIN step (forward d=128; 5 "
                   "transposed d=128) on the reordered Cora + one "
                   "paper-width SAGE training step on the reordered "
                   "CITESEER-S (227,320 nodes; forward d=256, 41; "
                   "transposed d=256, 41) + the GCN cell's step there "
                   "(forward d=16; transposed d=16, 41) + the weighted sum "
                   "ResilientPlan's compact forward at d=64 and d=1433 on "
                   "the reordered Cora (coefficients, seeded weights) + one "
                   "elastic train step's forward at d=1433 on each of the 4 "
                   "shards of the reordered Cora (Cora's edges weigh 1), "
                   "bm=128; bound: lists, row pointers, gathered x rows and "
                   "y; library: torch.sparse.mm of the same scaled "
                   "(weighted) adjacency; the tile walk on the same plans' "
                   "tiles and the bucketed plans' hub tiles held beside "
                   "(weight 0)"),
        kernel_row("spmm_blockell_update", padded_update_cases,
                   total["spmm_blockell_update"],
                   "one padded GIN conv launch (sum 128->128, w_self is w, "
                   "1+eps, bias, ReLU) on the reordered Cora, bm=128; "
                   "library_ms null: no single PyTorch call computes "
                   "aggregation and W epilogue together (composed_ms: "
                   "two PyTorch calls)"),
        kernel_row("spmm_blockell_update_compact", update_cases,
                   total["spmm_blockell_update_compact"],
                   "the list walk (csrc/spmm_blockell_update_lists.cu) "
                   "at: one GIN training step's 4 fused convs (sum "
                   "128->128, w_self is w, 1+eps, bias, ReLU) on the "
                   "reordered Cora + the GCN cell's layer 2 on the "
                   "reordered CITESEER-S (gcn 16->41, bias) + the sage_gin "
                   "serving forward's layer 1 on reddit --scale 0.02 (mean "
                   "48->64, two W, bias, ReLU), bm=128; the tile walk held "
                   "beside (weight 0); library_ms null: no single PyTorch "
                   "call "
                   "computes aggregation and W epilogue together "
                   "(composed_ms: two PyTorch calls, three for SAGE's two "
                   "W)"),
        kernel_row("sddmm", sddmm_cases, total["sddmm"],
                   "per-edge scores on the reordered Cora (10,556 edges, "
                   "d=64, kernels.ops.sddmm's shape); library: "
                   "torch.sparse.sampled_addmm(csr_pattern, q, k.T, "
                   "beta=0)"),
        kernel_row("embedding_bag", bag_cases, total["embedding_bag"],
                   "one full-width wide & deep training step's 4 launches "
                   "at train_batch (B=65,536 x 40 fields, 40M-row tables): "
                   "the deep lookup (2,621,440 single-id bags, d=32), the "
                   "wide lookup (65,536 bags of 40 ids, d=1) and both "
                   "backwards (40M bags, one per table row); library: "
                   "F.embedding_bag(mode='sum', per_sample_weights)"),
        kernel_row("decode_attention", decode_cases,
                   total["decode_attention"],
                   "one full-width decode step at decode_32k (cache_len "
                   "32,767, bf16) of each of granite-8b (36 launches, B=8, "
                   "q (8, 32, 128), one layer's k/v (8, 32768, 8, 128)), "
                   "granite-moe-3b-a800m (32 launches, B=24, q (24, 24, "
                   "64), k/v (24, 32768, 8, 64)) and llama4-maverick-400b-"
                   "a17b cut to 2 of 48 layers (2 launches, B=64, q (64, "
                   "40, 128), k/v (64, 32768, 8, 128)); library: "
                   "F.scaled_dot_product_attention(q, k, v, bool mask, "
                   "enable_gqa=True)"),
    ]
    kernels[-1]["peaks"] = ("H100 SXM data sheet: 989 TFLOP/s bf16 (the "
                            "main case's inputs), 3.35 TB/s")
    gat_work = ("one gat-reddit.full training step's launches on the cell's "
                "MinHash-ordered graph (58,241 nodes, 27.9 M edges plus a "
                "self loop a node, hubs both ways): 4 heads x 256 twice "
                "(layers 1 and 2), 6 x 6 once (layer 3)")
    of = lambda name: [c for c in gat_cases if c["kernel"] == name]
    kernels += [
        kernel_row("gat_attention", of("gat_attention"),
                   total["gat_attention"],
                   "the forward (gat::fwd::walk, gat::fwd::hubs) at "
                   + gat_work + "; plain: gat_attention_ref by blocks of "
                   "rows; library: none"),
        kernel_row("gat_attention_bwd", of("gat_attention_bwd"),
                   total["gat_attention_bwd"],
                   "the backward (gat::bwd::walk, gat::bwd::hubs, "
                   "gat::bwd::dst_sum; the wrapper's row term outside) at "
                   + gat_work + "; plain: gat_attention_bwd_ref by blocks "
                   "of sources; library: none"),
    ]
    # the full report, too long for the end of the output, beside the
    # kernels' builds in the checkout's ignored build/ directory
    (_build.build_dir() / "chip_smoke.json").write_text(json.dumps({
        "card": smi.stdout.strip(), "kernels": kernels, "paths": paths,
        "cases": (spmm_cases + fused_cases + compact_cases
                  + padded_update_cases + update_cases + sddmm_cases
                  + bag_cases + decode_cases + gat_cases),
        "gcn_autotune": gcn_report, "gin": gin_report, "sage": sage_report,
        "quickstart": quickstart_report, "gcn_blockell": gcn_ell_report,
        "gin_shared": gin_shared_report,
        "wide_deep": recsys_report, "lm": lm_report,
        "lm_training": lm_train_report, "moe": moe_report,
        "fallback": fallback_report, "observability": obs_report,
        "dist": dist_report,
        "gnn_zoo": zoo_report, "gat_reddit": gat_report,
        "drill": drill_report,
        "roofline": roofline_report, "gnn_recsys_mesh": mesh_report,
        "builds": {k: v["seconds"] for k, v in _build.BUILD_LOG.items()}},
        indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
