"""Import hygiene of the port: importing every ``repro_torch`` module, and
``chip_smoke.py``, pulls in neither ``jax`` nor the reference package, nor
``triton``, and builds or loads no CUDA library.  Checked in a fresh
interpreter so nothing the test process imported leaks in."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
from repro_torch.kernels import _build
print(json.dumps({
    "modules": names,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "repro": sorted(m for m in sys.modules
                    if m == "repro" or m.startswith("repro.")),
    "triton": "triton" in sys.modules,
    "libs_loaded": sorted(_build._LIBS),
}))
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {"repro_torch.convert", "repro_torch.device",
                "repro_torch.configs.base", "repro_torch.configs.families",
                "repro_torch.configs.gcn_cora",
                "repro_torch.configs.wide_deep",
                "repro_torch.configs.granite_8b",
                "repro_torch.configs.minitron_8b",
                "repro_torch.configs.mistral_large_123b",
                "repro_torch.configs.granite_moe_3b_a800m",
                "repro_torch.configs.llama4_maverick_400b_a17b",
                "repro_torch.nn.moe",
                "repro_torch.configs.registry",
                "repro_torch.configs.gat_cora", "repro_torch.configs.pna",
                "repro_torch.configs.nequip", "repro_torch.exec.fallback",
                "repro_torch.models.gat", "repro_torch.models.pna",
                "repro_torch.models.nequip",
                "repro_torch.core.blocksparse", "repro_torch.core.reorder",
                "repro_torch.core.cache_model",
                "repro_torch.core.shared_set", "repro_torch.core.aggregate",
                "repro_torch.core.mapping", "repro_torch.core.perf_model",
                "repro_torch.graph.partition", "repro_torch.memo",
                "repro_torch.exec.plan",
                "repro_torch.exec.bucketing", "repro_torch.exec.autotune",
                "repro_torch.exec.forward", "repro_torch.obs.audit",
                "repro_torch.kernels.ops",
                "repro_torch.graph.datasets", "repro_torch.graph.sampler",
                "repro_torch.graph.batching",
                "repro_torch.graph.structure", "repro_torch.kernels._build",
                "repro_torch.kernels.ref",
                "repro_torch.kernels.spmm_blockell",
                "repro_torch.kernels.embedding_bag",
                "repro_torch.kernels.sddmm",
                "repro_torch.kernels.decode_attention",
                "repro_torch.nn.attention", "repro_torch.models.transformer",
                "repro_torch.models.recsys", "repro_torch.nn.embedding",
                "repro_torch.train.data",
                "repro_torch.launch.serve", "repro_torch.launch.train",
                "repro_torch.models.gcn", "repro_torch.models.sage_gin",
                "repro_torch.nn.layers", "repro_torch.obs.registry",
                "repro_torch.obs.trace", "repro_torch.serve.batcher",
                "repro_torch.serve.cache", "repro_torch.serve.engine",
                "repro_torch.serve.registry", "repro_torch.train.fault",
                "repro_torch.train.loop", "repro_torch.train.optimizer",
                "repro_torch.train.checkpoint", "repro_torch.chaos",
                "repro_torch.chaos.inject", "repro_torch.chaos.traffic",
                "repro_torch.obs.export", "repro_torch.obs.summary",
                "repro_torch.obs.validate", "repro_torch.obs.regress"}
    assert expected <= set(out["modules"])
    assert out["jax"] == []
    assert out["repro"] == []
    assert out["triton"] is False
    assert out["libs_loaded"] == []


@pytest.mark.parametrize("name", ["spmm_blockell_compact",
                                  "spmm_blockell_update_compact",
                                  "spmm_blockell", "spmm_blockell_fused",
                                  "spmm_blockell_update", "embedding_bag",
                                  "sddmm", "decode_attention"])
def test_kernel_source_ships_beside_the_package(name):
    from repro_torch.kernels import _build
    src = _build.CSRC / f"{name}.cu"
    assert src.is_file()
    # a source and the shared headers it may include
    text = "\n".join(p.read_text() for p in
                     [src, *sorted(_build.CSRC.glob("*.cuh"))])
    reference = ("spmm_blockell" if name.startswith("spmm_blockell")
                 else name)
    assert f"repro/kernels/{reference}.py::{name}" in text
    assert f'extern "C" int {name}(' in text
    # the products are written by hand: no library GEMM and no torch
    for banned in ("cublas", "cutlass", "torch", "#include <ATen"):
        assert banned not in text.lower(), banned
    # the build lands in the repository's ignored build/ directory
    assert _build.build_dir() == ROOT / "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert _build.library_path(name).parent == _build.build_dir()


def test_installed_copy_refuses_to_build_outside_a_checkout(tmp_path,
                                                           monkeypatch):
    from repro_torch.kernels import _build
    site = tmp_path / "lib" / "python3" / "site-packages" / "repro_torch"
    monkeypatch.setattr(_build, "_PKG", site)
    with pytest.raises(RuntimeError, match="checkout"):
        _build.build_dir()
    with pytest.raises(RuntimeError, match="checkout"):
        _build.build("spmm_blockell_compact")
