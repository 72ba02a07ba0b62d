"""``repro_torch.roofline`` against the reference and against hand
arithmetic.

Held: ``hlo``'s text functions byte-equal to the reference's on
hand-written HLO lines (a tuple all-to-all, ``-start`` / ``-done`` pairs,
while bodies, get-tuple-element consumers) and on the compiled HLO of a
small sharded jax function (lowered in a subprocess on 8 host devices);
``analysis._model_flops`` equal for all 40 (arch, shape) cells;
``CellRoofline``'s terms, properties and ``markdown_row`` equal to the
reference's for the same counts, with the port's ``hw`` set to the
reference's v5e constants.  ``count.count_step`` against hand arithmetic:
the FLOPs of a tiny MLP's forward and backward and of a ``REDUCED``
granite-8b decode step (2 N_active B, attention over the cache, the RMSNorm
contractions); the bytes of a short op sequence; the collective payloads of
``dist.spmd``'s calls on a fake (2, 2) mesh; the peak of a hand-written
Adam step; counts that step by equal amounts at 1, 2 and 3 layers; and no
kernel launched (a trace that launched one raises).
"""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from repro.roofline import analysis as ref_analysis
from repro.roofline import hlo as ref_hlo
from repro_torch.configs import get
from repro_torch.configs.registry import ALL_ARCHS
from repro_torch.roofline import analysis, count, hlo, hw

HLO_LINES = r"""
HloModule jit_step, entry_computation_layout={(f32[8,128]{1,0})->f32[8,128]{1,0}}

%body.3 (param: (s32[], f32[8,128])) -> (s32[], f32[8,128]) {
  %param = (s32[], f32[8,128]{1,0}) parameter(0)
  %gte = f32[8,128]{1,0} get-tuple-element(%param), index=1
  %all-reduce.1 = f32[8,128]{1,0} all-reduce(%gte), channel_id=1, replica_groups={{0,1}}, to_apply=%add
  %ag-start = (f32[8,128]{1,0}, f32[16,128]{1,0}) all-gather-start(%all-reduce.1), dimensions={0}
  %ag-done = f32[16,128]{1,0} all-gather-done(%ag-start)
  ROOT %t = (s32[], f32[8,128]{1,0}) tuple(%c, %all-reduce.1)
}

%cond.4 (param.1: (s32[], f32[8,128])) -> pred[] {
  ROOT %lt = pred[] compare(%a, %b), direction=LT
}

%fused_computation.while_body.7 (p0: bf16[4,256]) -> bf16[4,256] {
  %cp = bf16[4,256]{1,0} collective-permute(%p0), source_target_pairs={{0,1},{1,0}}
}

ENTRY %main.9 (Arg_0.1: f32[8,128]) -> f32[8,128] {
  %Arg_0.1 = f32[8,128]{1,0} parameter(0)
  %a2a = (bf16[2,64]{1,0}, bf16[2,64]{1,0}, bf16[2,64]{1,0}) all-to-all(%x, %y, %z), replica_groups={{0,1,2}}
  %rs = s8[32]{0} reduce-scatter(%q), dimensions={0}, to_apply=%add
  %ar-start = f32[1024]{0} all-reduce-start(%v), to_apply=%add
  %ar-done = f32[1024]{0} all-reduce-done(%ar-start)
  %gte.2 = f32[8,128]{1,0} get-tuple-element(%a2a), index=0
  %w = (s32[], f32[8,128]{1,0}) while(%init), condition=%cond.4, body=%body.3
  %cp2 = u16[7,3]{1,0} collective-permute-start(%u), source_target_pairs={{0,1}}
  %noop = f32[8,128]{1,0} add(%p, %q)
  ROOT %out = f32[8,128]{1,0} get-tuple-element(%w), index=1
}
"""

SHARDED_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)

def f(x, w):
    def body(c, _):
        return jnp.tanh(c @ w), None
    y, _ = jax.lax.scan(body, x, None, length=3)
    return (y @ w.T).sum(), y

x = jax.ShapeDtypeStruct((64, 128), jnp.float32,
                         sharding=NamedSharding(mesh, P("data", "model")))
w = jax.ShapeDtypeStruct((128, 128), jnp.float32,
                         sharding=NamedSharding(mesh, P("model", None)))
print(jax.jit(f).lower(x, w).compile().as_text())
"""


def _ops(ops):
    return [dataclasses.astuple(o) for o in ops]


def _hlo_equal(text):
    assert _ops(hlo.parse_collectives(text)) == _ops(
        ref_hlo.parse_collectives(text))
    assert hlo.while_body_names(text) == ref_hlo.while_body_names(text)
    for kw in ({}, {"default_trip": 5},
               {"loop_trip_counts": {"body.3": 36}, "default_trip": 2}):
        assert hlo.collective_bytes(text, **kw) == \
            ref_hlo.collective_bytes(text, **kw), kw


def test_hlo_text_functions_equal_the_reference_on_hand_written_lines():
    assert hlo.COLLECTIVES == ref_hlo.COLLECTIVES
    assert hlo._DTYPE_BYTES == ref_hlo._DTYPE_BYTES
    for s in ("f32[16,128]{1,0}", "bf16[3]", "pred[]", "s8[2,2,2]",
              "f8e4m3fn[10]", "c64[4]", "token[]", "(f32[2])", "f64[0,5]"):
        assert hlo.shape_bytes(s) == ref_hlo.shape_bytes(s), s
    ops = hlo.parse_collectives(HLO_LINES)
    assert {o.kind for o in ops} == set(hlo.COLLECTIVES)
    assert sum(o.kind == "all-to-all" for o in ops) == 1
    _hlo_equal(HLO_LINES)


def test_hlo_text_functions_equal_the_reference_on_compiled_hlo():
    proc = subprocess.run([sys.executable, "-c", SHARDED_SCRIPT],
                          capture_output=True, text=True, timeout=240,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    text = proc.stdout
    assert ref_hlo.parse_collectives(text), "no collective in the HLO"
    assert ref_hlo.while_body_names(text), "no while body in the HLO"
    _hlo_equal(text)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_equal_the_reference(arch):
    for shape in get(arch).shapes:
        assert analysis._model_flops(arch, shape) == \
            ref_analysis._model_flops(arch, shape), shape


V5E = {"PEAK_FLOPS_BF16": 197e12, "HBM_BW": 819e9}
COUNTS = [  # (flops, bytes, collective bytes, peak GB, model FLOPs)
    (3e14, 1e11, 1e9, 12.5, 5e16),        # compute
    (3e14, 1e11, 1e9, 12.5, 5e15),        # compute, mostly non-model
    (1e12, 8e11, 1e9, 70.0, 1e14),        # memory
    (1e9, 1e9, 5e10, 0.3, 1e9),           # collective
    (0.0, 0.0, 0.0, 0.0, 0.0),
]


@pytest.mark.parametrize("mesh_desc", ["16x16", "2x16x16", "4x4"])
def test_cell_roofline_equals_the_reference(monkeypatch, mesh_desc):
    for k, v in V5E.items():
        monkeypatch.setattr(hw, k, v)
    monkeypatch.setattr(hw, "link_bw", lambda n: 50e9)
    assert analysis.MD_HEADER == ref_analysis.MD_HEADER
    props = ("t_compute", "t_memory", "t_collective", "dominant",
             "bound_time", "useful_ratio", "roofline_fraction")
    for f, b, c, peak, model in COUNTS:
        kw = dict(arch="minitron-8b", shape="train_4k", mesh_desc=mesh_desc,
                  flops_per_chip=f, bytes_per_chip=b, coll_bytes_per_chip=c,
                  peak_gb=peak, model_flops_global=model)
        got = analysis.CellRoofline(**kw)
        want = ref_analysis.CellRoofline(**kw)
        for p in props:
            assert getattr(got, p) == getattr(want, p), p
        assert got.suggestion() == want.suggestion()
        assert analysis.markdown_row(got) == ref_analysis.markdown_row(want)
    assert [f.name for f in dataclasses.fields(analysis.CellRoofline)] == \
        [f.name for f in dataclasses.fields(ref_analysis.CellRoofline)]


def test_link_bw_and_mesh_ranks():
    assert hw.link_bw(8) == hw.NVLINK_BW and hw.link_bw(16) == hw.NET_BW
    r = analysis.CellRoofline("a", "s", "2-pod(2x16x16)", 1.0, 1.0, 1.0,
                              0.0, 1.0)
    assert r.n_ranks == 512
    assert dataclasses.replace(r, mesh_desc="1x1").n_ranks == 1
    assert hw.hbm_fraction(2.0) == hw.implied_bandwidth(2.0) / hw.HBM_BW


def test_mlp_flops_and_bytes_match_hand_arithmetic():
    B, d0, d1, d2 = 8, 32, 64, 16
    x, w1, w2 = torch.randn(B, d0), torch.randn(d0, d1), torch.randn(d1, d2)

    def step(x, w1, w2):
        w1, w2 = w1.requires_grad_(True), w2.requires_grad_(True)
        loss = torch.relu(x @ w1).matmul(w2).square().mean()
        return torch.autograd.grad(loss, (w1, w2))
    c = count.count_step(step, (x, w1, w2))
    # forward 2 matmuls; backward: dW2, dH, dW1 (x needs no gradient)
    assert c["flops"] == 2 * 2 * B * d0 * d1 + 3 * 2 * B * d1 * d2
    assert c["collectives"]["total"] == 0 and c["collectives"]["n_ops"] == 0

    n, f = 100, 4

    def seq(a, b):
        c = a + b            # read 2n, write n
        t = c.t()            # a view: nothing
        c.add_(b)            # read c and b, write c
        d = torch.empty_like(a)   # an allocation: nothing
        d.copy_(t.t())       # read the source, write d
        return d.sum()       # read n, write one element
    c = count.count_step(seq, (torch.randn(n), torch.randn(n)))
    assert c["bytes"] == f * (3 * n + 3 * n + 2 * n + n + 1)
    assert c["flops"] == 0


def test_reduced_decode_flops_match_hand_arithmetic():
    from repro_torch.configs.families import LMBundle
    from repro_torch.configs.granite_8b import REDUCED as cfg
    from repro_torch.configs.base import LM_SHAPES
    bundle = LMBundle(cfg)
    B, S = 4, LM_SHAPES["decode_32k"]["seq"]
    specs = bundle.input_specs("decode_32k", batch=B)
    meta = lambda s, d: torch.empty(s, dtype=d, device="meta")
    batch = {"token": meta(*specs["token"]),
             "caches": {k: tuple(meta(*x) for x in pair)
                        for k, pair in specs["caches"].items()},
             "cache_len": S - 1}
    c = count.count_step(bundle.step_fn("decode_32k", attn="plain"),
                         (bundle.abstract_params(), batch), donate=(1,))
    d = cfg.d_model
    want = (2 * B * (cfg.active_param_count() - cfg.vocab * d)  # no embed
            + cfg.n_layers * 2 * 2 * B * cfg.n_heads * S * cfg.hd
            + (2 * cfg.n_layers + 1) * 2 * B * d)    # RMSNorm's x . x
    assert c["flops"] == want
    cache = sum(s.numel() * s.element_size()
                for pair in batch["caches"].values() for s in pair)
    mem = c["memory"]
    # the caches are written in place and returned: donated, aliased
    assert mem["alias_gb_per_device"] * 1e9 == pytest.approx(cache, rel=0,
                                                             abs=1)
    assert mem["output_gb_per_device"] * 1e9 == pytest.approx(
        cache + B * cfg.vocab * 4, rel=0, abs=1)


def test_spmd_collectives_on_a_fake_mesh_equal_their_payloads():
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import as_mesh
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_debug_mesh
    x = torch.randn(6, 10)
    nb = x.numel() * 4
    with fake_world(4):
        mesh = as_mesh(make_debug_mesh((2, 2), device="cpu"))

        def step(x):
            a = spmd.all_reduce(x, mesh, "model")           # nb
            g = spmd.gather(a, mesh, "data", 0)             # 2 nb
            b = spmd.layer_of(torch.stack([x, x]), 1, 4, mesh, "data")
            m = spmd.max_(x, mesh, ("data", "model"))       # nb
            return g.sum() + b.sum() + m.sum()
        c = count.count_step(step, (x,))
    coll = c["collectives"]
    assert coll["all-reduce"] == 2 * nb
    assert coll["all-gather"] == 2 * nb
    assert coll["broadcast"] == nb
    assert coll["reduce-scatter"] == coll["all-to-all"] == \
        coll["collective-permute"] == 0
    assert coll["total"] == 5 * nb and coll["n_ops"] == 4
    assert set(coll) == set(hlo.COLLECTIVES) | {"broadcast", "total",
                                                "n_ops"}


def test_adam_step_peak_matches_hand_arithmetic():
    n, f = 1000, 4
    lr, b1, b2, eps = 1e-3, 0.9, 0.999, 1e-8

    def adam(p, m, v, g):
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = v.sqrt().add_(eps)          # the step's one transient
        p.addcdiv_(m, denom, value=-lr)
        return p, m, v
    args = tuple(torch.randn(n) for _ in range(4))
    mem = count.count_step(adam, args, donate=(0, 1, 2))["memory"]
    assert mem["argument_gb_per_device"] * 1e9 == pytest.approx(4 * n * f)
    assert mem["output_gb_per_device"] == mem["alias_gb_per_device"]
    assert mem["output_gb_per_device"] * 1e9 == pytest.approx(3 * n * f)
    assert mem["temp_gb_per_device"] * 1e9 == pytest.approx(n * f)
    assert mem["peak_gb_per_device"] * 1e9 == pytest.approx(5 * n * f)
    # not donated: the outputs still live in the arguments' storage, but
    # count as new, as XLA counts an output it may not alias
    mem = count.count_step(adam, args)["memory"]
    assert mem["alias_gb_per_device"] == 0
    assert mem["peak_gb_per_device"] * 1e9 == pytest.approx(8 * n * f)


@pytest.mark.parametrize("arch", ["granite_8b", "granite_moe_3b_a800m"])
def test_counts_step_linearly_with_depth(arch):
    import importlib
    from repro_torch.configs.families import LMBundle
    from repro_torch.configs.base import LM_SHAPES
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    unit = mod.REDUCED.moe_every if mod.REDUCED.n_experts else 1
    B = 2
    seq = LM_SHAPES["train_4k"]["seq"]
    LM_SHAPES["train_4k"]["seq"] = 64
    try:
        counts = []
        for units in (1, 2, 3):
            cfg = dataclasses.replace(mod.REDUCED, n_layers=units * unit)
            bundle = LMBundle(cfg)
            params, opt = bundle.abstract_state("train_4k")
            batch = {k: torch.empty(s, dtype=d, device="meta") for k, (s, d)
                     in bundle.input_specs("train_4k", batch=B).items()}
            counts.append(count.count_step(bundle.step_fn("train_4k"),
                                           (params, opt, batch),
                                           donate=(0, 1)))
    finally:
        LM_SHAPES["train_4k"]["seq"] = seq
    for key in ("flops", "bytes"):
        a, b, c = (x[key] for x in counts)
        assert b - a == c - b > 0, key
    arg = [x["memory"]["argument_gb_per_device"] for x in counts]
    assert arg[1] - arg[0] == pytest.approx(arg[2] - arg[1], rel=1e-9)


def test_a_traced_kernel_launch_raises(monkeypatch):
    from repro_torch.kernels import sddmm

    def launching(x):
        sddmm.sddmm.launches += 1
        return x * 2
    launches = sddmm.sddmm.launches
    try:
        with pytest.raises(RuntimeError, match="sddmm"):
            count.count_step(launching, (torch.randn(3),))
    finally:
        sddmm.sddmm.launches = launches
