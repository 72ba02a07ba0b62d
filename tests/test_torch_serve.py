"""The serving slice end to end: the port's GNNSession and engine against
the reference's, with the reference's weights carried over by
``params_from_jax``.

On a small graph the offline layer values agree to 1e-5 and the same
Zipfian trace served through both engines gives embeddings within 1e-5 and
identical batching and cache statistics, for the ``gcn`` and the
``sage_gin`` (GraphSAGE) sessions.  At full width (Cora, GCN dims
[1433, 64, 16]) the values agree to 1e-4: sums of 1433 terms in another
order, the serving oracle's own bar.  The launcher serves Cora, and the
CITESEER-S and REDDIT stand-ins at a small ``--scale``, on the CPU.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import minhash_reorder as ref_minhash
from repro.graph import DatasetSpec as RefSpec, synthesize as ref_synthesize
from repro.serve import (EmbeddingCache as RefCache,
                         MicroBatcher as RefBatcher,
                         Request as RefRequest,
                         ServeEngine as RefEngine,
                         ServeSLO as RefSLO,
                         make_session as ref_make_session,
                         zipfian_trace as ref_zipfian_trace)
from repro_torch.convert import params_from_jax
from repro_torch.core import minhash_reorder
from repro_torch.graph import cora_like
from repro_torch.kernels import spmm_blockell as sk
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import (EmbeddingCache, GNNSession, MicroBatcher,
                               Request, ServeEngine, ServeSLO, make_session,
                               zipfian_trace)

from _torch_parity import assert_bytes_equal, to_port

SMALL = dict(hidden=16, out_dim=8, seed=0)


@pytest.fixture(scope="module")
def small():
    g = ref_synthesize(RefSpec("t", 400, 2500, 32, 4, community=0.9,
                               num_communities=6, seed=4))
    ref = ref_make_session("gcn", g, **SMALL)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             device="cpu")
    return g, ref, params


def _port_session(small, **kw):
    g, _, params = small
    return make_session("gcn", to_port(g), device="cpu", params=params,
                        **SMALL, **kw)


@pytest.mark.parametrize("executor", ["fused", "segment"])
def test_layer_values_match_reference(small, executor):
    _, ref, _ = small
    sess = _port_session(small, executor=executor)
    assert sess.layer_dims == ref.layer_dims == [32, 16, 8]
    for l in range(sess.num_layers + 1):
        np.testing.assert_allclose(sess.layer_values(l), ref.layer_values(l),
                                   atol=1e-5, rtol=1e-5, err_msg=f"layer {l}")


def _serve(engine_cls, cache_cls, batcher_cls, sess, order, trace,
           slo=None):
    cache = cache_cls(sess.layer_dims, capacity_bytes=60_000, order=order,
                      line_size=16)
    eng = engine_cls(sess, cache, batcher_cls(max_batch=8, max_wait=1e-3),
                     oracle_check=True, keep_records=True, slo=slo)
    outs = []
    serve_batch = eng.process_batch
    eng.process_batch = lambda mb: outs.append(serve_batch(mb)) or outs[-1]
    eng.warm(order)
    return eng.serve(trace), outs, eng


@pytest.mark.parametrize("expander", ["full", "fanout"])
def test_engine_serves_the_same_answers_as_reference(small, expander):
    g, ref, _ = small
    if expander != "full":
        ref = ref_make_session("gcn", g, expander=expander, **SMALL)
    sess = _port_session(small, expander=expander)
    order = minhash_reorder(sess.g)
    assert_bytes_equal(order, ref_minhash(g), "order")
    trace = zipfian_trace(g.num_nodes, 120, a=1.2, seed=1)
    ref_trace = ref_zipfian_trace(g.num_nodes, 120, a=1.2, seed=1)
    assert [(r.node_id, r.t_arrival) for r in trace] == \
           [(r.node_id, r.t_arrival) for r in ref_trace]
    rep, outs, _ = _serve(ServeEngine, EmbeddingCache, MicroBatcher, sess,
                          order, trace)
    ref_rep, ref_outs, _ = _serve(RefEngine, RefCache, RefBatcher, ref,
                                  order, ref_trace)
    assert rep.num_requests == ref_rep.num_requests == 120
    assert rep.num_batches == ref_rep.num_batches == len(outs)
    for got, want in zip(outs, ref_outs):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert rep.hit_rate == ref_rep.hit_rate
    assert rep.cache.per_layer == ref_rep.cache.per_layer
    assert rep.cache.bytes_missed == ref_rep.cache.bytes_missed
    np.testing.assert_allclose(rep.max_oracle_err, ref_rep.max_oracle_err,
                               atol=1e-5)
    if expander == "full":           # exact serving: answers equal the oracle
        assert rep.max_oracle_err < 1e-5


def test_slo_mode_sheds_and_degrades_like_reference(small):
    """Overload plus malformed ids: the modeled-clock admission decisions are
    a pure function of the trace, so both engines decide identically."""
    g, ref, _ = small
    sess = _port_session(small)
    order = minhash_reorder(sess.g)

    def trace(request_cls, zipf):
        reqs = zipf(g.num_nodes, 150, a=1.1, rate=40_000.0, seed=3)
        t = reqs[-1].t_arrival
        return reqs + [request_cls(150, -1, t + 1e-4),
                       request_cls(151, g.num_nodes, t + 2e-4)]

    slo = ServeSLO(deadline_s=4e-3, max_queue=6)
    ref_slo = RefSLO(deadline_s=4e-3, max_queue=6)
    rep, _, eng = _serve(ServeEngine, EmbeddingCache, MicroBatcher, sess,
                         order, trace(Request, zipfian_trace), slo)
    ref_rep, _, ref_eng = _serve(RefEngine, RefCache, RefBatcher, ref, order,
                                 trace(RefRequest, ref_zipfian_trace),
                                 ref_slo)
    assert rep.num_rejected == ref_rep.num_rejected == 2
    assert rep.num_shed + rep.num_degraded > 0
    assert (rep.num_shed, rep.num_degraded, rep.num_batches) == \
           (ref_rep.num_shed, ref_rep.num_degraded, ref_rep.num_batches)
    key = lambda r: (r.req_id, r.outcome, r.stale)
    assert sorted(map(key, eng.records)) == sorted(map(key, ref_eng.records))
    assert rep.p99_ms == pytest.approx(ref_rep.p99_ms)


def test_full_width_cora_matches_reference():
    from repro.graph import cora_like as ref_cora_like
    ref = ref_make_session("gcn", ref_cora_like(seed=0), seed=0)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             device="cpu")
    sess = make_session("gcn", cora_like(seed=0), seed=0, device="cpu",
                        params=params)
    assert sess.layer_dims == [1433, 64, 16]
    assert [lp.order for lp in sess._layer_plans] == ["update_first"] * 2
    assert sess._layer_plans[1].gplan is sess._layer_plans[0].gplan
    for l in (1, 2):
        got = sess.layer_values(l)
        assert got.shape == (2708, sess.layer_dims[l])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref.layer_values(l), atol=1e-4,
                                   rtol=1e-4, err_msg=f"layer {l}")


@pytest.mark.parametrize("warm", [False, True])
def test_session_schedule_matches_reference(warm, tmp_path, monkeypatch):
    """``GNNSession`` builds its plans through ``plan_forward`` as the
    reference's session does: on the serving graph its schedule is the
    reference's (``jnp`` read as ``torch``), cold, and warm after the same
    measured layer table is in both caches."""
    from repro.graph import cora_like as ref_cora_like
    monkeypatch.setenv("REPRO_TORCH_EXEC_CACHE", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_EXEC_CACHE", str(tmp_path / "ref"))
    g_ref = ref_cora_like(seed=0)
    if warm:
        # one measured table, written under each side's own key
        import importlib
        ref_at = importlib.import_module("repro.exec.autotune")
        at = importlib.import_module("repro_torch.exec.autotune")
        rows = [["aggregate_first", False, "coo", 128, True, 100.0],
                ["update_first", False, "coo", 128, True, 5000.0]]
        for mod, name in ((ref_at, "jnp"), (at, "torch")):
            mod._cache_put(mod._cache_path(None),
                           f"{ref_at.graph_fingerprint(g_ref)}:layer:1433x64"
                           f":gcn:r1b1:cpu:x", {"table": rows + [
                               ["update_first", False, name, 64, True,
                                2000.0]]})
    ref = ref_make_session("gcn", g_ref, seed=0)
    sess = make_session("gcn", cora_like(seed=0), seed=0, device="cpu")
    expected = [tuple({"jnp": "torch"}.get(v, v) if isinstance(v, str)
                      else v for v in c) for c in ref._fplan.configs]
    assert list(sess._fplan.configs) == expected
    assert sess._fplan.source == ref._fplan.source
    if warm:
        assert expected[0][0] == "aggregate_first"   # the measured table won
    assert [lp.gplan.backend for lp in sess._layer_plans] == \
        [c[2] for c in expected]


def test_seeded_init_is_reproducible():
    g = to_port(ref_synthesize(RefSpec("t", 64, 300, 8, 2, seed=3)))
    a = make_session("gcn", g, hidden=8, out_dim=4, seed=5, device="cpu")
    b = make_session("gcn", g, hidden=8, out_dim=4, seed=5, device="cpu")
    for pa, pb in zip(a.params["layers"], b.params["layers"]):
        assert torch.equal(pa["w"], pb["w"]) and torch.equal(pa["b"], pb["b"])
    np.testing.assert_array_equal(a.layer_values(2), b.layer_values(2))


def test_unported_sessions_and_devices_raise():
    g = to_port(ref_synthesize(RefSpec("t", 64, 300, 8, 2, seed=3)))
    # every registered model is ported by now: wide & deep serves one user
    # per node of the graph, sage_gin GraphSAGE
    assert make_session("wide_deep", g, device="cpu").num_users == 64
    assert make_session("sage_gin", g, device="cpu").kind == "sage"
    with pytest.raises(ValueError, match="unknown session kind"):
        GNNSession("gat", g, "gat", device="cpu")
    with pytest.raises(ValueError, match="unknown serve model"):
        make_session("gat", g, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_session("gcn", g, device="cuda")


def test_model_constructors_default_to_the_card():
    """``gcn_init``, ``make_graph_inputs`` and ``linear_init`` run on cuda
    unless asked for the CPU, as every other entry point does."""
    from repro_torch.models.gcn import gcn_init, make_graph_inputs
    from repro_torch.nn.layers import linear_init

    g = to_port(ref_synthesize(RefSpec("t", 64, 300, 8, 2, seed=3)))
    gen = lambda: torch.Generator().manual_seed(0)
    calls = [lambda **kw: gcn_init(gen(), [8, 4, 2], **kw),
             lambda **kw: make_graph_inputs(g, **kw),
             lambda **kw: linear_init(gen(), 8, 4, **kw)]
    for call in calls:
        cpu = call(device="cpu")
        leaves = (cpu["layers"][0].values() if "layers" in cpu
                  else cpu.values())
        assert all(t.device.type == "cpu" for t in leaves)
        if torch.cuda.is_available():
            out = call()
            leaves = (out["layers"][0].values() if "layers" in out
                      else out.values())
            assert all(t.device.type == "cuda" for t in leaves)
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_launcher_serves_cora_on_cpu(capsys):
    before = sk.spmm_blockell_compact.launches
    rep = launch_serve.main(["--graph", "cora", "--model", "gcn",
                             "--requests", "60", "--device", "cpu"])
    assert rep.num_requests == 60 and rep.max_oracle_err < 1e-4
    assert sk.spmm_blockell_compact.launches == before   # plain path on CPU
    out = capsys.readouterr().out
    assert "oracle check" in out and "OK" in out


# ---------------------------------------------------------------- sage_gin
@pytest.fixture(scope="module")
def small_sage():
    g = ref_synthesize(RefSpec("t", 400, 2500, 32, 4, community=0.9,
                               num_communities=6, seed=4))
    ref = ref_make_session("sage_gin", g, **SMALL)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             device="cpu")
    return g, ref, params


@pytest.mark.parametrize("executor", ["fused", "segment"])
def test_sage_layer_values_match_reference(small_sage, executor):
    g, ref, params = small_sage
    sess = make_session("sage_gin", to_port(g), device="cpu", params=params,
                        executor=executor, **SMALL)
    assert sess.kind == "sage" and sess.layer_dims == [32, 16, 8]
    if executor == "fused":
        assert all(lp.mode == "mean" for lp in sess._layer_plans)
    for l in range(sess.num_layers + 1):
        np.testing.assert_allclose(sess.layer_values(l), ref.layer_values(l),
                                   atol=1e-5, rtol=1e-5, err_msg=f"layer {l}")
    # every served layer is L2-normalized
    for l in (1, 2):
        np.testing.assert_allclose(
            np.linalg.norm(sess.layer_values(l), axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("expander", ["full", "fanout"])
def test_sage_engine_serves_the_same_answers_as_reference(small_sage,
                                                          expander):
    g, ref, params = small_sage
    if expander != "full":
        ref = ref_make_session("sage_gin", g, expander=expander, **SMALL)
    sess = make_session("sage_gin", to_port(g), device="cpu", params=params,
                        expander=expander, **SMALL)
    order = minhash_reorder(sess.g)
    trace = zipfian_trace(g.num_nodes, 120, a=1.2, seed=1)
    ref_trace = ref_zipfian_trace(g.num_nodes, 120, a=1.2, seed=1)
    rep, outs, _ = _serve(ServeEngine, EmbeddingCache, MicroBatcher, sess,
                          order, trace)
    ref_rep, ref_outs, _ = _serve(RefEngine, RefCache, RefBatcher, ref,
                                  order, ref_trace)
    assert rep.num_requests == ref_rep.num_requests == 120
    assert rep.num_batches == ref_rep.num_batches == len(outs)
    for got, want in zip(outs, ref_outs):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert rep.hit_rate == ref_rep.hit_rate
    assert rep.cache.per_layer == ref_rep.cache.per_layer
    assert rep.cache.bytes_missed == ref_rep.cache.bytes_missed
    np.testing.assert_allclose(rep.max_oracle_err, ref_rep.max_oracle_err,
                               atol=1e-5)
    if expander == "full":
        assert rep.max_oracle_err < 1e-5


def test_sage_layer_forward_computes_cold_blocks(small_sage):
    """With no cache, every answer goes through ``layer_forward`` (the
    sampled-block SAGE layer), and still equals the offline forward."""
    g, _, params = small_sage
    sess = make_session("sage_gin", to_port(g), device="cpu", params=params,
                        **SMALL)
    eng = ServeEngine(sess, None, MicroBatcher(max_batch=8, max_wait=1e-3),
                      oracle_check=True)
    rep = eng.serve(zipfian_trace(g.num_nodes, 40, a=1.1, seed=2))
    assert rep.num_requests == 40 and rep.max_oracle_err < 1e-5


@pytest.mark.parametrize("graph", ["citeseer-s", "reddit"])
def test_launcher_serves_sage_on_paper_stand_ins_on_cpu(graph, capsys):
    from repro_torch.graph import citeseer_s_like, reddit_like
    before = (sk.spmm_blockell_compact.launches,
              sk.spmm_blockell_update_compact.launches)
    rep = launch_serve.main(["--graph", graph, "--scale", "0.005",
                             "--model", "sage_gin", "--requests", "60",
                             "--device", "cpu"])
    assert rep.num_requests == 60 and rep.max_oracle_err < 1e-4
    assert (sk.spmm_blockell_compact.launches,
            sk.spmm_blockell_update_compact.launches) == before
    out = capsys.readouterr().out
    g = (citeseer_s_like if graph == "citeseer-s" else reddit_like)(0.005)
    assert f"graph {graph}: {g.num_nodes} nodes, {g.num_edges} edges" in out
    assert "model=sage_gin" in out and "OK" in out


def test_launcher_rejects_an_unknown_graph():
    with pytest.raises(SystemExit, match="choices: cora, citeseer-s, reddit"):
        launch_serve.main(["--graph", "pubmed", "--device", "cpu"])
