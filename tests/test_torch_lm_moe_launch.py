"""The MoE LMs' launchers against the reference's (the rest of the MoE LM
parity tests is ``tests/test_torch_lm_moe.py``, whose helpers and
tolerances this file takes; split so that pytest-xdist's ``--dist
loadfile`` spreads the two over workers): ``launch.serve --arch ...``
generates the ids of the reference's ``serve_lm`` (same parameters and
prompt), and ``launch.train --arch ... --steps 10`` the losses of its
``lm_reduced_driver`` within 1e-4.
"""
import argparse
import re

import numpy as np
import pytest
import torch

import jax
from repro.launch import serve as ref_serve
from repro.launch import train as ref_launch
from repro_torch.kernels import decode_attention as kd
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as train_launcher

from test_torch_lm_moe import ARCHS, LOSS_TOL, _port, _ref_params


# ------------------------------------------------------------- launchers
def _ref_prompt(cfg, batch, prompt_len):
    return np.array(jax.random.randint(jax.random.PRNGKey(0),
                                       (batch, prompt_len), 0, cfg.vocab))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_launcher_generates_the_reference_ids(arch, monkeypatch,
                                                    capsys):
    _, mod = ARCHS[arch]
    ref_serve.serve_lm(argparse.Namespace(arch=arch, tokens=8, batch=2,
                                          prompt_len=16))
    want = re.search(r"generated: (\[.*\])", capsys.readouterr().out)[1]
    ref_params = _port(_ref_params(arch))
    monkeypatch.setattr(launch_serve, "lm_init",
                        lambda gen, cfg, device="cuda": ref_params)
    monkeypatch.setattr(launch_serve, "draw_prompt",
                        lambda gen, vocab, b, p: torch.as_tensor(
                            _ref_prompt(mod.REDUCED, b, p)))
    before = kd.decode_attention.launches
    res = launch_serve.main(["--arch", arch, "--tokens", "8", "--device",
                             "cpu"])
    assert kd.decode_attention.launches == before
    got = re.search(r"generated: (\[.*\])", capsys.readouterr().out)[1]
    assert got == want
    assert tuple(res.tokens.shape) == (2, 9)
    plain = launch_serve.serve_lm(launch_serve.parse_args(
        ["--arch", arch, "--tokens", "8", "--device", "cpu"]), attn="plain")
    torch.testing.assert_close(plain.logits, res.logits, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_launcher_matches_the_reference(arch, monkeypatch, capsys):
    ref = ref_launch.lm_reduced_driver(arch, 10, None)
    port_params = _port(_ref_params(arch))
    monkeypatch.setattr(train_launcher, "lm_init",
                        lambda gen, cfg, device="cuda": port_params)
    res = train_launcher.main(["--arch", arch, "--steps", "10",
                               "--device", "cpu"])
    assert res.steps == 10
    np.testing.assert_allclose(res.losses, ref.losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert res.losses[-1] < res.losses[0]
    assert f"{arch}: 10 steps, loss" in capsys.readouterr().out
