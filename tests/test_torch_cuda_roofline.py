"""The roofline held against the card: gcn-cora ``full_graph_sm``, counted
by ``launch.dryrun.lower_cell`` on a (1, 1) mesh over a one-rank fake
process group (host only, no kernel), then run on the card: the median of
5 synchronised steps may not be below the roofline's bound, and the
dry-run's peak lies within 10% of the card's (the step's arguments plus
what ``max_memory_allocated`` rose above what was allocated before the
timed steps).

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false.  The file imports neither jax nor the reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_roofline.py
"""
import statistics

import pytest
import torch

pytestmark = pytest.mark.cuda


def test_gcn_cora_step_against_its_roofline():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hold times the card)")
    from repro_torch.configs import get
    from repro_torch.launch.dryrun import fake_world, lower_cell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.roofline.analysis import from_counts
    from repro_torch.train.optimizer import tree_leaves

    spec = get("gcn-cora")
    bundle = spec.bundle()
    with fake_world(1):
        res, _, counts = lower_cell(bundle, spec, "full_graph_sm",
                                    make_debug_mesh((1, 1), device="cpu"))
    peak_gb = res["memory"]["peak_gb_per_device"]
    bound = from_counts("gcn-cora", "full_graph_sm", "1x1", counts,
                        peak_gb).bound_time

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(27)
    g = bundle.geometry("full_graph_sm")
    n = g["n"]
    batch = {}
    for name, (shp, dtype) in bundle.input_specs("full_graph_sm").items():
        if name in ("src", "dst"):
            batch[name] = torch.randint(0, n, shp, dtype=dtype,
                                        generator=gen, device=dev)
        elif name == "labels":
            batch[name] = torch.randint(0, bundle.n_classes, shp,
                                        dtype=dtype, generator=gen,
                                        device=dev)
        elif dtype == torch.bool or name == "deg":
            batch[name] = torch.ones(shp, dtype=dtype, device=dev)
        else:
            batch[name] = torch.randn(shp, dtype=dtype, generator=gen,
                                      device=dev)
    params = bundle.init_params(gen, g["d"], device=dev)
    args = (params, bundle.opt().init(params), batch)
    held = sum(t.numel() * t.element_size() for t in tree_leaves(args))
    assert held / 1e9 == pytest.approx(
        res["memory"]["argument_gb_per_device"], rel=1e-12)
    step = bundle.step_fn("full_graph_sm")
    for _ in range(2):
        step(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(*args)[2]
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    assert torch.isfinite(loss)
    card_peak = held + torch.cuda.max_memory_allocated(dev) - base
    assert statistics.median(times) >= bound
    assert abs(peak_gb * 1e9 - card_peak) <= 0.10 * card_peak
