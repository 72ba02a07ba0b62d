"""The LM mesh path on the card: ``REDUCED`` granite-moe and granite-8b
decode steps (bf16) through ``dist.sharding.use_mesh`` on a (1, 1) data x
model mesh of a one-rank NCCL group, against the same steps with no mesh:
bit-identical logits and caches, and one ``decode_attention`` launch a
layer on both paths.

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false.  The file imports neither jax nor the reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_lm_mesh.py
"""
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
