"""The LM mesh path on the card: ``REDUCED`` granite-moe and granite-8b
decode steps (bf16) through ``dist.sharding.use_mesh`` on a (1, 1) data x
model mesh of a one-rank NCCL group, against the same steps with no mesh:
bit-identical logits and caches, and one ``decode_attention`` launch a
layer on both paths; and granite-8b's donated train step (the mesh path's
remat), its first loss bit-identical to the no-mesh step's.

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false.  The file imports neither jax nor the reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_lm_mesh.py
"""
import copy
import dataclasses
import datetime
import os

import pytest
import torch
import torch.distributed as dist

pytestmark = pytest.mark.cuda


@pytest.fixture
def nccl_mesh(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL and the kernel have no CPU "
                    "mode)")
    from repro_torch.launch.mesh import make_debug_mesh
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        yield make_debug_mesh((1, 1), device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "granite_8b"])
def test_one_rank_mesh_decode_is_bit_identical(nccl_mesh, arch):
    import importlib
    from repro_torch.configs.families import LMBundle
    from repro_torch.configs import LM_SHAPES
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(
        importlib.import_module(f"repro_torch.configs.{arch}").REDUCED,
        dtype=torch.bfloat16)
    bundle = LMBundle(cfg)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = bundle.init_params(gen, "cuda", dtype=torch.bfloat16)
    S = LM_SHAPES["decode_32k"]["seq"] // 256
    prompt = torch.randint(0, cfg.vocab, (4, 16), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        _, pre = tf.lm_prefill(params, prompt, cfg)
        runs = []
        for mesh in (None, nccl_mesh):
            caches = tf.make_kv_caches(cfg, 4, S, device="cuda")
            tf.fill_caches(caches, pre)
            tok = torch.randint(0, cfg.vocab, (4, 1), generator=torch.
                                Generator(device="cuda").manual_seed(4),
                                device="cuda", dtype=torch.int32)
            before = kda.decode_attention.launches
            with use_mesh(mesh):
                logits, caches = tf.lm_decode_step(params, tok, caches, 16,
                                                   cfg, S)
            torch.cuda.synchronize()
            runs.append((logits, caches,
                         kda.decode_attention.launches - before))
    (a, ca, na), (b, cb, nb) = runs
    assert torch.equal(a, b)
    for name in ca:
        for x, y in zip(ca[name], cb[name]):
            assert torch.equal(x, y)
    assert na == nb == cfg.n_layers


def test_one_rank_mesh_train_step_gives_the_no_mesh_loss(nccl_mesh):
    """The bundle's donated ``train_4k`` step on ``REDUCED`` granite-8b
    (B = 2 x 64), made and run under the (1, 1) mesh (the mesh path's remat
    units and loss chunks, its clip norm over the mesh), against the same
    step with no mesh from the same weights and state: the first loss bit
    for bit, each updated parameter within 1e-6 of its leaf's largest
    entry."""
    from repro_torch.configs.families import LMBundle
    from repro_torch.configs.granite_8b import REDUCED
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.train.optimizer import tree_leaves

    bundle = LMBundle(REDUCED)
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = bundle.init_params(gen, "cuda")
    tok, tgt = (torch.randint(0, REDUCED.vocab, (2, 64), generator=gen,
                              device="cuda", dtype=torch.int32)
                for _ in range(2))
    runs = []
    for mesh in (None, nccl_mesh):
        p = copy.deepcopy(params)
        with use_mesh(mesh):
            step = bundle.step_fn("train_4k")
            p2, _, loss = step(p, bundle.opt().init(p),
                               {"tokens": tok, "targets": tgt})
        torch.cuda.synchronize()
        runs.append((loss, tree_leaves(p2)))
    (la, pa), (lb, pb) = runs
    assert torch.equal(la, lb)
    for a, b in zip(pa, pb):
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= 1e-6 * scale
