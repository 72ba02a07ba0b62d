"""The work counts of the metrics, against hand arithmetic, and their
independence of the plan's layout."""
import numpy as np
import pytest
import torch

from ._small import ROOT  # noqa: F401  (puts the checkout on the path)
from h100bench.harness import graphgen, peaks
from h100bench.metrics import _gnn_work as work


def test_sage_counts_by_hand():
    shape = {"model": "sage", "dims": [10, 6, 3], "num_nodes": 100,
             "num_edges": 400}
    # layer 1: 2 forward + 2 dW at (100, 10, 6); layer 2: 2 + 2 + 2 dx
    flops = 4 * 2 * 100 * 10 * 6 + 6 * 2 * 100 * 6 * 3
    assert work.dense_flops(shape) == flops
    assert work.aggregation_widths(shape) == [6, 6, 3, 3]
    agg = sum(4 * (2 * 100 * d + 2 * 100) + 8 * 400 for d in (6, 6, 3, 3))
    assert work.aggregate_bound_s(shape) == pytest.approx(agg / peaks.HBM_BW)
    assert work.model_flops(shape) == flops + 2 * 400 * (6 + 6 + 3 + 3)


def test_gcn_counts_by_hand():
    shape = {"model": "gcn", "dims": [3703, 16, 41], "num_nodes": 227320,
             "num_edges": 814134}
    n = 227320
    flops = 2 * 2 * n * 3703 * 16 + 3 * 2 * n * 16 * 41
    assert work.dense_flops(shape) == flops          # 54.8 GFLOP
    assert flops == pytest.approx(54.8e9, rel=1e-3)
    l1 = max(2 * n * 3703 * 16 / peaks.PEAK_FLOPS_FP32,
             4 * (n * 3703 + 3703 * 16 + n * 16) / peaks.HBM_BW)
    assert l1 == pytest.approx(4 * (n * 3703 + 3703 * 16 + n * 16) / 3.35e12)
    l2 = max(2 * n * 16 * 41 / peaks.PEAK_FLOPS_FP32,
             4 * (n * 16 + 16 * 41 + n * 41) / peaks.HBM_BW)
    assert work.dense_bound_s(shape) == pytest.approx(2 * l1 + 3 * l2)


# device names as the profiler gave them on an H100, cut short
SPMM = ("void blockell::spmm::kernel<blockell::CompactSlots, unsigned char,"
        " 16, 4, true>(blockell::CompactSlots, unsigned char const*)")
UPDATE = ("void blockell::update::kernel<blockell::CompactSlots, unsigned "
          "char, 16, 4, 4>(blockell::CompactSlots, unsigned char const*)")
XMMA = ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8_stage3_"
        "warpsize4x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas")
SIMT = ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x256_8x4_nt_align1>"
        "(cutlass_80_simt_sgemm_128x256_8x4_nt_align1::Params)")
ELEMENTWISE = ("void at::native::vectorized_elementwise_kernel<4, "
               "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >")


def test_kernel_names():
    assert work.is_aggregate(SPMM) and work.is_aggregate(UPDATE)
    assert not work.is_aggregate(XMMA) and not work.is_aggregate(SIMT)
    assert work.is_dense(XMMA) and work.is_dense(SIMT)
    assert not work.is_dense(UPDATE)      # timed with the aggregations only
    assert work.is_dense("void cublasLt::splitKreduce_kernel<32, 16>()")
    assert not work.is_dense(SPMM) and not work.is_dense(ELEMENTWISE)


@pytest.mark.parametrize("bm", [16, 32, 64])
def test_counts_ignore_the_plan_layout(bm):
    """The plan's block size changes its tiles, never the counted work."""
    from repro_torch.exec import build_plan
    from repro_torch.graph.structure import Graph

    spec = {"num_nodes": 600, "num_edges": 2400, "num_classes": 5,
            "community": 0.8, "degree_alpha": 2.1, "train_fraction": 0.7}
    topo = graphgen.synthesize(spec)
    g = Graph(src=topo["src"], dst=topo["dst"], num_nodes=600)
    shape = {"model": "sage", "dims": [48, 16, 5], "num_nodes": 600,
             "num_edges": int(topo["src"].shape[0])}
    counts = (work.dense_flops(shape), work.dense_bound_s(shape),
              work.aggregate_bound_s(shape), work.model_flops(shape))
    base = build_plan(g, "mean", bm=8, backend="torch", device="cpu")
    plan = build_plan(g, "mean", bm=bm, backend="torch", device="cpu")
    assert plan.n_active != base.n_active            # another layout ...
    assert counts == (work.dense_flops(shape), work.dense_bound_s(shape),
                      work.aggregate_bound_s(shape),
                      work.model_flops(shape))        # ... the same work
    x = torch.randn(600, 16, dtype=torch.float32)
    assert torch.allclose(plan.apply(x), base.apply(x), atol=1e-5)
    assert np.isfinite(counts).all()
