"""The dry-run's largest mesh training cell at full width and depth:
minitron-8b ``train_4k`` (32 layers, B = 256 x 4,096) lowered and counted
by ``launch.dryrun.lower_cell`` on the (16, 16) production mesh, as rank 0
of a fake process group of 256 ranks (host only: fake tensors, nothing
allocated).  With the mesh path's remat and its head-cut attention core
its peak fits the H100's 80 GB a rank (the reference's compiled step:
22.38 GB); without them it counted 3,697.6 GB.

A file of its own (~30-45 s of tracing), so that xdist's ``loadfile``
spreads it.
"""
from repro_torch.configs import get
from repro_torch.launch.dryrun import fake_world, lower_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import hw


def test_minitron_train_4k_fits_a_card_on_the_production_mesh():
    spec = get("minitron-8b")
    with fake_world(256):
        res, _, counts = lower_cell(spec.bundle(), spec, "train_4k",
                                    make_production_mesh(device="cpu"))
    peak = res["memory"]["peak_gb_per_device"]
    assert res["mesh"] == "16x16"
    assert 0 < peak <= hw.HBM_BYTES / 1e9, peak
    assert counts["memory"]["temp_gb_per_device"] > 0
