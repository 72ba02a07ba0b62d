"""The port's autotune and whole-forward DP against the reference's.

* exactly equal: ``graph_fingerprint``; ``model_layer_cost_dims``; both
  candidate grids (the card's against the reference's TPU grid with
  ``pallas`` read as ``cuda``, the CPU's against its CPU grid with ``jnp``
  read as ``torch``, width gate included); ``device_sig``'s sanitising;
  ``chain_params`` byte for byte;
* the DP: ``dp_schedule`` equals ``exhaustive_schedule`` and both equal the
  reference's, on synthetic measured oracles, on the cold gcn-cora, GIN and
  SAGE chains over the reordered Cora, and under a skewed calibration
  table, which must flip the cold pick as in the reference;
* autotune on a temporary cache (``$REPRO_TORCH_EXEC_CACHE``) on the CPU:
  ``autotune``, ``autotune_layer`` and ``autotune_forward`` round-trip, the
  second call hits the cache, and a corrupt entry counts as a miss;
  ``cached_layer_costs``, the quarantine helpers and ``prune_cache``; a
  failed trial drops out uncached, except a ``cuda`` candidate on the card,
  whose error propagates.
"""
import json

import numpy as np
import pytest
import torch

import importlib

from repro.core import minhash_reorder as ref_minhash
from repro.exec import forward as ref_forward
from repro.graph import cora_like as ref_cora_like
from repro_torch.exec import forward as fw
from repro_torch.exec import build_plan

from _torch_parity import GRAPHS, assert_bytes_equal, to_port

# both packages re-export their autotune FUNCTION under the submodule's
# name, so the module objects come from the import system
at = importlib.import_module("repro_torch.exec.autotune")
plan_mod = importlib.import_module("repro_torch.exec.plan")
ref_at = importlib.import_module("repro.exec.autotune")

PORT_NAME = {"pallas": "cuda", "jnp": "torch"}
REF_PLATFORM = {"cuda": "tpu", "cpu": "cpu"}


def _port(c):
    return tuple(PORT_NAME.get(v, v) if isinstance(v, str) else v for v in c)


def _ref(c):
    back = {v: k for k, v in PORT_NAME.items()}
    return tuple(back.get(v, v) if isinstance(v, str) else v for v in c)


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    """Every test tunes into its own cache, never the user's."""
    monkeypatch.setenv("REPRO_TORCH_EXEC_CACHE", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_EXEC_CACHE", str(tmp_path / "ref"))
    return tmp_path


_CORA = ref_cora_like().permute(ref_minhash(ref_cora_like()))


# ---------------------------------------------------------------------------
# exactly equal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_graph_fingerprint_matches_reference(gname):
    import dataclasses
    g = GRAPHS[gname]
    assert at.graph_fingerprint(to_port(g)) == ref_at.graph_fingerprint(g)
    masked = dataclasses.replace(g, edge_mask=np.arange(g.num_edges) % 3 > 0)
    assert at.graph_fingerprint(to_port(masked)) == \
        ref_at.graph_fingerprint(masked) != ref_at.graph_fingerprint(g)


def test_launcher_graph_fingerprint_matches_reference():
    from repro_torch.launch.train import training_graph
    assert at.graph_fingerprint(training_graph()) == \
        ref_at.graph_fingerprint(_CORA)


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
@pytest.mark.parametrize("d_in,d_out", [(1433, 16), (16, 7), (128, 128),
                                        (300, 200), (None, None)])
def test_candidate_grids_match_reference(platform, d_in, d_out):
    ref_p = REF_PLATFORM[platform]
    assert at.default_layer_candidates(platform, d_in, d_out) == [
        _port(c) for c in ref_at.default_layer_candidates(ref_p, d_in,
                                                          d_out)]
    assert at.default_candidates(platform) == [
        _port(c) for c in ref_at.default_candidates(ref_p)]


def test_model_layer_cost_dims_match_reference():
    cands = (at.default_layer_candidates("cuda")
             + at.default_layer_candidates("cpu"))
    for n, e, d_in, d_out in ((2708, 10556, 1433, 16), (2708, 10556, 16, 7),
                              (300, 2000, 20, 12), (1024, 2047, 128, 128)):
        assert at.model_graph_cost(n, e, d_in) == \
            ref_at.model_graph_cost(n, e, d_in)
        for c in cands:
            assert at.model_layer_cost_dims(n, e, d_in, d_out, c) == \
                ref_at.model_layer_cost_dims(n, e, d_in, d_out, _ref(c))


def test_device_sig(monkeypatch):
    assert at.device_sig("cpu") == "cpu"
    monkeypatch.setattr(at, "_device_kind", lambda p: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(ref_at, "_device_kind",
                        lambda: "NVIDIA H100 80GB HBM3")
    assert at.device_sig("cuda") == "cuda-NVIDIA-H100-80GB-HBM3" == \
        ref_at.device_sig("cuda")
    monkeypatch.setattr(at, "_device_kind", lambda p: "unknown")
    assert at.device_sig("cuda") == "cuda"


@pytest.mark.parametrize("chain", ["gcn", "sage", "gin"])
def test_chain_params_byte_equal(chain):
    specs = {"gcn": fw.gcn_chain([20, 12, 5]),
             "sage": fw.sage_chain([20, 12, 5]),
             "gin": fw.gin_chain(20, 12, 3)}[chain]
    ref_specs = {"gcn": ref_forward.gcn_chain([20, 12, 5]),
                 "sage": ref_forward.sage_chain([20, 12, 5]),
                 "gin": ref_forward.gin_chain(20, 12, 3)}[chain]
    assert [s.sig for s in specs] == [s.sig for s in ref_specs]
    port = fw.chain_params(specs, seed=3, device="cpu")
    ref = ref_forward.chain_params(ref_specs, seed=3)
    assert [sorted(p) for p in port] == [sorted(p) for p in ref]
    for p, r in zip(port, ref):
        for k in p:
            assert_bytes_equal(p[k].numpy(), np.asarray(r[k]), k)


# ---------------------------------------------------------------------------
# the DP
# ---------------------------------------------------------------------------
def _both_oracles(seed, n_layers=3):
    """The same synthetic oracle on both sides: random measured costs for
    some candidates, the model for the rest."""
    rng = np.random.default_rng(seed)
    dims = [int(v) for v in rng.integers(4, 300, n_layers + 1)]
    specs = fw.gcn_chain(dims)
    ref_specs = ref_forward.gcn_chain(dims)
    cands, measured = [], []
    for s in specs:
        cs = at.default_layer_candidates("cuda", s.d_in, s.d_out) + [
            ("aggregate_first", True, "cuda", 256, True, "128@7+256")]
        cands.append(tuple(cs))
        measured.append({c: float(rng.uniform(10, 1000)) for c in cs
                         if rng.random() < 0.6})
    kw = dict(n=2708, e=10556, scale=float(rng.uniform(0.001, 0.01)),
              sources=("model",) * n_layers)
    port = fw.ForwardCostOracle(specs=specs, cands=tuple(cands),
                                measured=tuple(measured), **kw)
    ref = ref_forward.ForwardCostOracle(
        specs=ref_specs, cands=tuple(tuple(_ref(c) for c in cs)
                                     for cs in cands),
        measured=tuple({_ref(c): v for c, v in m.items()}
                       for m in measured), **kw)
    return port, ref


@pytest.mark.parametrize("seed", range(6))
def test_dp_equals_exhaustive_and_reference_on_synthetic_oracles(seed):
    port, ref = _both_oracles(seed)
    cost, path = fw.dp_schedule(port)
    ex_cost, ex_path = fw.exhaustive_schedule(port)
    ref_cost, ref_path = ref_forward.dp_schedule(ref)
    assert path == ex_path == [_port(c) for c in ref_path]
    assert cost == pytest.approx(ex_cost, rel=1e-12)
    assert cost == ref_cost


@pytest.mark.parametrize("chain", ["gcn-cora", "gin", "sage"])
def test_cold_dp_matches_reference_on_reordered_cora(chain):
    """The cold, uncalibrated DP over the card's grid (bucketed candidates
    included) picks what the reference's picks over the TPU grid."""
    from repro_torch.launch.train import training_graph
    specs, ref_specs = {
        "gcn-cora": (fw.gcn_chain([1433, 16, 7]),
                     ref_forward.gcn_chain([1433, 16, 7])),
        "gin": (fw.gin_chain(1433, 128, 5), ref_forward.gin_chain(1433, 128,
                                                                  5)),
        "sage": (fw.sage_chain([1433, 64, 16]),
                 ref_forward.sage_chain([1433, 64, 16]))}[chain]
    kw = dict(use_cache=False, use_calibration=False,
              respect_quarantine=False)
    port = fw.build_cost_oracle(training_graph(), specs, platform="cuda",
                                **kw)
    ref = ref_forward.build_cost_oracle(_CORA, ref_specs, platform="tpu",
                                        **kw)
    assert port.cands == tuple(tuple(_port(c) for c in cs)
                               for cs in ref.cands)
    cost, path = fw.dp_schedule(port)
    ref_cost, ref_path = ref_forward.dp_schedule(ref)
    assert path == [_port(c) for c in ref_path]
    assert cost == ref_cost
    assert fw.exhaustive_schedule(port)[1] == path
    if chain == "gcn-cora":
        assert path == [("update_first", False, "cuda", 128, True)] * 2


def test_skewed_calibration_flips_cold_dp_like_reference(tmp_path):
    """A calibration table that marks the picked class as measured 50x its
    model must flip the cold pick, on both sides alike."""
    from repro.obs.audit import class_key as ref_class_key
    from repro_torch.obs.audit import class_key
    g = GRAPHS["random"]
    cands = [("aggregate_first", False, "coo", 128, True),
             ("update_first", False, "coo", 128, True)]
    specs, ref_specs = fw.gcn_chain([16, 16]), ref_forward.gcn_chain([16, 16])
    kw = dict(candidates=[cands], cache_dir=str(tmp_path), use_cache=False)
    base = fw.build_cost_oracle(to_port(g), specs, use_calibration=False,
                                **kw)
    picked = fw.dp_schedule(base)[1][0]
    other = next(c for c in cands if c != picked)
    key = class_key(picked[2], picked[3], picked[4], picked[0])
    assert key == ref_class_key(picked[2], picked[3], picked[4], picked[0])
    cal = {"global_ratio": 1.0, "classes": {key: {"ratio": 50.0}}}
    skewed = fw.build_cost_oracle(to_port(g), specs, calibration=cal, **kw)
    ref_skewed = ref_forward.build_cost_oracle(g, ref_specs,
                                               calibration=cal, **kw)
    assert skewed.class_scale == ref_skewed.class_scale == {key: 50.0}
    assert fw.dp_schedule(skewed)[1] == \
        ref_forward.dp_schedule(ref_skewed)[1] == [other]
    assert skewed.node_cost(0, picked) == pytest.approx(
        50.0 * base.node_cost(0, picked))
    # a table saved for this device is read from the cache directory
    (tmp_path / "calibration.json").write_text(json.dumps(
        {at.device_sig("cpu"): cal}))
    fed = fw.build_cost_oracle(to_port(g), specs, platform="cpu", **kw)
    assert fw.dp_schedule(fed)[1] == [other]


# ---------------------------------------------------------------------------
# autotune on a temporary cache
# ---------------------------------------------------------------------------
def _small():
    return to_port(GRAPHS["random"])


def test_autotune_round_trips_and_hits_the_cache(_cache):
    g = _small()
    cands = [("coo", 128, True), ("torch", 32, True), ("torch", 32, False)]
    rec = at.autotune(g, 8, "gcn", candidates=cands, iters=1, device="cpu")
    assert not rec.from_cache and len(rec.table) == 3
    assert (rec.backend, rec.bm, rec.compact) in cands
    again = at.autotune(g, 8, "gcn", candidates=cands, iters=1,
                        device="cpu")
    assert again.from_cache and again.key == rec.key
    assert again.table == rec.table and again.us == rec.us
    plan, rec2 = at.autotune_plan(g, 8, "gcn", candidates=cands, iters=1,
                                  device="cpu")
    assert rec2.from_cache and (plan.backend, plan.bm, plan.compact) == \
        (rec.backend, rec.bm, rec.compact)
    # the key carries the fingerprint, shape, mode, device and candidates
    assert rec.key.startswith(f"{at.graph_fingerprint(g)}:8:gcn:cpu:")


def test_autotune_layer_round_trips_and_corrupt_entry_is_a_miss(_cache):
    g = _small()
    cands = [("aggregate_first", False, "coo", 128, True),
             ("update_first", False, "torch", 32, True),
             ("aggregate_first", False, "torch", 32, True, "8@4+32"),
             ("aggregate_first", True, "cuda", 32, False)]
    rec = at.autotune_layer(g, 12, 6, "gcn", candidates=cands, iters=1,
                            device="cpu")
    assert not rec.from_cache
    # every candidate raced, the bucketed row carries its signature
    assert len(rec.table) == 4
    assert any(len(r) == 7 and r[5] == "8@4+32" for r in rec.table)
    again = at.autotune_layer(g, 12, 6, "gcn", candidates=cands, iters=1,
                              device="cpu")
    assert again.from_cache and again.as_config() == rec.as_config()
    costs = at.cached_layer_costs(g, 12, 6, "gcn", platform="cpu")
    assert set(costs) == {tuple(c) for c in cands}
    # a corrupt entry is re-measured, never a crash
    path = _cache / "port" / "autotune.json"
    doc = json.loads(path.read_text())
    doc[rec.key]["bm"] = "not a number"
    path.write_text(json.dumps(doc))
    fresh = at.autotune_layer(g, 12, 6, "gcn", candidates=cands, iters=1,
                              device="cpu")
    assert not fresh.from_cache
    lp, rec3 = at.autotune_layer_plan(g, 12, 6, "gcn", candidates=cands,
                                      iters=1, device="cpu")
    assert rec3.from_cache and (lp.order, lp.fuse) == (rec3.order, rec3.fuse)


def test_autotune_forward_round_trips_on_the_cpu(_cache):
    g = _small()
    specs = fw.gcn_chain([12, 8, 4])
    plan, rec = fw.autotune_forward(g, specs, iters=1, device="cpu")
    assert not rec.from_cache and rec.greedy_us is not None
    assert {lab for lab, _ in rec.table} <= {"greedy", "dp", "dp-model"}
    assert tuple(plan.configs) == rec.configs and len(plan) == 2
    # every layer was tuned on its own first, into the same cache
    for s in specs:
        assert at.cached_layer_costs(g, s.d_in, s.d_out, s.mode,
                                     relu=s.relu, platform="cpu")
    again, rec2 = fw.autotune_forward(g, specs, iters=1, device="cpu")
    assert rec2.from_cache and rec2.configs == rec.configs
    assert rec2.schedule_configs("greedy") == rec.schedule_configs("greedy")
    x = torch.randn(g.num_nodes, 12)
    params = fw.chain_params(specs, device="cpu")
    torch.testing.assert_close(again.apply_chain(x, params),
                               plan.apply_chain(x, params))
    # warm now: plan_forward reads the measured costs
    assert fw.plan_forward(g, specs, device="cpu").source == "dp-measured"


def test_quarantine_and_prune(_cache):
    g = _small()
    fp = at.graph_fingerprint(g)
    at.record_quarantine(fp, "torch", reason="test", platform="cpu")
    at.record_quarantine(fp, "cuda|8@4+32", platform="cpu")
    assert at.quarantined_backends(fp, platform="cpu") == {"torch",
                                                           "cuda|8@4+32"}
    oracle = fw.build_cost_oracle(g, fw.gcn_chain([12, 6]), platform="cpu",
                                  use_cache=False)
    assert all(c[2] != "torch" for c in oracle.cands[0])
    assert at.clear_quarantine(fp, platform="cpu") == 2
    assert at.quarantined_backends(fp, platform="cpu") == set()
    for i in range(5):
        at._cache_put(at._cache_path(None), f"k{i}", {"v": i})
    assert at.prune_cache(2) == 2
    doc = json.loads((_cache / "port" / "autotune.json").read_text())
    assert sorted(doc) == ["k3", "k4"]


def test_trial_that_fails_drops_out_of_the_race(_cache, capsys):
    """As in the reference, a candidate that fails to build just loses; the
    drop is printed, and neither the layer's verdict nor a forward verdict
    built on it is cached."""
    g = _small()
    cands = [("update_first", False, "coo", 128, True),
             ("aggregate_first", False, "coo", 128, False, "8@4+32")]
    rec = at.autotune_layer(g, 12, 6, "gcn", candidates=cands, iters=1,
                            device="cpu")
    assert [r[:-1] for r in rec.table] == [cands[0]]
    assert rec.failed == (cands[1],)
    assert "drops out of the race" in capsys.readouterr().err
    with pytest.raises(ValueError, match="coo"):
        build_plan(g, "gcn", backend="coo", buckets="8@4+32", device="cpu")
    again = at.autotune_layer(g, 12, 6, "gcn", candidates=cands, iters=1,
                              device="cpu")
    assert not again.from_cache
    specs = fw.gcn_chain([12, 6])
    _, frec = fw.autotune_forward(g, specs, candidates=[cands], iters=1,
                                  device="cpu")
    _, frec2 = fw.autotune_forward(g, specs, candidates=[cands], iters=1,
                                   device="cpu")
    assert not frec.from_cache and not frec2.from_cache


def _broken_kernel(*args, **kwargs):
    raise RuntimeError("kernel launch failed")


@pytest.mark.parametrize("race", ["layer", "graph"])
def test_cuda_candidate_failure_propagates_on_the_card(_cache, monkeypatch,
                                                       race):
    """On the card a ``cuda`` candidate runs a hand-written kernel: when its
    wrapper raises, the error gets through the race (it must not leave the
    run on plain code as a lost race), and nothing is cached.  The card is
    stood in for by forcing the platform on CPU tensors."""
    g = _small()
    monkeypatch.setattr(at, "platform_of", lambda device: "cuda")
    monkeypatch.setattr(plan_mod, "spmm_blockell_update", _broken_kernel)
    monkeypatch.setattr(plan_mod, "spmm_blockell_fused", _broken_kernel)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        if race == "layer":
            at.autotune_layer(g, 12, 6, "gcn", iters=1, device="cpu",
                              candidates=[
                                  ("update_first", False, "coo", 128, True),
                                  ("aggregate_first", True, "cuda", 32,
                                   False)])
        else:
            at.autotune(g, 8, "gcn", iters=1, device="cpu",
                        candidates=[("coo", 128, True),
                                    ("cuda", 32, False)])
    assert not (_cache / "port" / "autotune.json").exists()
