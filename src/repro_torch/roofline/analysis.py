"""Three-term roofline analysis per (arch x shape x mesh) cell (port of
``repro/roofline/analysis.py``).

Terms (per card, seconds):
  compute    = step FLOPs / PEAK_FLOPS_BF16
  memory     = step bytes / HBM_BW
  collective = collective payload bytes / link_bw(ranks of the mesh)

The counts come from one trace of the cell's eager step at full depth
(``launch.dryrun.lower_cell``, ``roofline.count.count_step``): the eager
trace sees every layer, so the reference's 1-unit / 2-unit unrolled proxies
(its correction for a while body XLA counts once) are not needed.  The
bytes are eager PyTorch's, unfused: XLA's count of a fused program is
lower.

MODEL_FLOPS sanity ratio: 6*N*D (train, dense), 6*N_active*D (MoE), or
2*N_active per generated/scored token (serve) over the traced FLOPs —
flags remat/redundancy waste (ratio << 1 when the step does much more than
the model math).
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import re

from . import hw
from ..configs import get
from ..configs.base import LM_SHAPES, RECSYS_SHAPES


@dataclasses.dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh_desc: str
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    peak_gb: float
    model_flops_global: float

    @property
    def n_ranks(self) -> int:
        """The mesh's size, from the last ``AxB[xC]`` in ``mesh_desc``
        (1 without one)."""
        found = re.findall(r"\d+(?:x\d+)+", self.mesh_desc)
        return math.prod(int(n) for n in found[-1].split("x")) if found \
            else 1

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / hw.link_bw(self.n_ranks)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    # the reference's chip count: 512 on a "2x" mesh, 256 on any other
    # (a debug mesh reads as 256 too)
    @property
    def useful_ratio(self) -> float:
        n_chips = 256 if "2x" not in self.mesh_desc else 512
        hlo_global = self.flops_per_chip * n_chips
        return self.model_flops_global / max(hlo_global, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs throughput as a fraction of the compute roofline:
        (model_flops / bound_time) / (chips * peak)."""
        n_chips = 256 if "2x" not in self.mesh_desc else 512
        ideal = self.model_flops_global / (n_chips * hw.PEAK_FLOPS_BF16)
        return ideal / max(self.bound_time, 1e-30)

    def suggestion(self) -> str:
        if self.dominant == "compute":
            if self.useful_ratio < 0.4:
                return ("compute-bound but mostly non-model FLOPs: cut remat "
                        "recompute / loss-stage masking work")
            return "compute-bound near model math: increase arithmetic intensity only via bigger per-chip batch"
        if self.dominant == "memory":
            return ("HBM-bound: raise arithmetic intensity (larger "
                    "microbatch, fuse aggregation stages, bf16 stashes)")
        return ("collective-bound: cut payloads (reordered halo exchange, "
                "gradient compression, LSE-merged decode) or overlap with "
                "compute")


def _model_flops(arch: str, shape: str) -> float:
    spec = get(arch)
    if spec.family == "lm":
        mod = importlib.import_module(
            "repro_torch.configs." + arch.replace("-", "_"))
        cfg = mod.CONFIG
        info = LM_SHAPES[shape]
        n_active = cfg.active_param_count()
        if info["kind"] == "train":
            return 6.0 * n_active * info["batch"] * info["seq"]
        if info["kind"] == "prefill":
            return 2.0 * n_active * info["batch"] * info["seq"]
        return 2.0 * n_active * info["batch"]          # decode: per token
    if spec.family == "gnn":
        bundle = spec.bundle()
        g = bundle.geometry(shape)
        params, _ = bundle.abstract_state(shape)
        from ..train.optimizer import tree_leaves
        n_params = sum(x.numel() for x in tree_leaves(params))
        # message passing: ~2 flops per edge per feature + dense transforms
        return 6.0 * (n_params * g["n"] / max(g["d"], 1) + 2.0 * g["e"] * g["d"])
    # recsys
    bundle = spec.bundle()
    info = RECSYS_SHAPES[shape]
    cfg = bundle.cfg
    deep_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    dims = (deep_in,) + cfg.mlp_dims + (1,)
    mlp_flops = 2.0 * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    per_ex = mlp_flops + cfg.n_sparse * cfg.embed_dim * 2.0
    mult = 3.0 if info["kind"] == "train" else 1.0
    total = per_ex * info["batch"] * mult
    if shape == "retrieval_cand":
        total += 2.0 * info["n_candidates"] * cfg.mlp_dims[-1]
    return total


def from_counts(arch: str, shape: str, mesh_desc: str, counts: dict,
                peak_gb: float) -> CellRoofline:
    """The cell's roofline from ``count_step``'s counts."""
    return CellRoofline(arch=arch, shape=shape, mesh_desc=mesh_desc,
                        flops_per_chip=counts["flops"],
                        bytes_per_chip=counts["bytes"],
                        coll_bytes_per_chip=counts["collectives"]["total"],
                        peak_gb=peak_gb,
                        model_flops_global=_model_flops(arch, shape))


def analyze_cell(arch: str, shape: str, mesh, mesh_desc: str) -> CellRoofline:
    """Trace the cell's step at full depth once on ``mesh``
    (``launch.dryrun.lower_cell``) and take its three terms."""
    from ..launch.dryrun import lower_cell
    spec = get(arch)
    res, _, counts = lower_cell(spec.bundle(), spec, shape, mesh,
                                compile_=True)
    return from_counts(arch, shape, mesh_desc, counts,
                       res["memory"]["peak_gb_per_device"])


def markdown_row(r: CellRoofline) -> str:
    return (f"| {r.arch} | {r.shape} | {r.t_compute:.3e} | {r.t_memory:.3e} "
            f"| {r.t_collective:.3e} | **{r.dominant}** | "
            f"{r.model_flops_global:.2e} | {r.useful_ratio:.2f} | "
            f"{r.roofline_fraction:.2%} | {r.peak_gb:.1f} | "
            f"{r.suggestion()} |")


MD_HEADER = ("| arch | shape | compute s | memory s | collective s | "
             "dominant | MODEL_FLOPS | useful ratio | roofline frac | "
             "peak GB/chip | what would move the dominant term |\n"
             "|---|---|---|---|---|---|---|---|---|---|---|")
