"""The port's resilience slice against the reference's: the chaos hooks,
checkpoints, resume and the crash drill.

* ``FaultPlan.generate(seed, spec).describe()`` equal to the reference's;
  the hooks (disarmed no-ops, ``armed`` / ``fire`` / ``fail_point`` /
  ``mangle``); ``corrupt_file`` byte-equal to the reference's on the same
  file.
* Checkpoints: the port writes and the reference restores, and the
  reverse, every leaf byte-equal (fp32 and int leaves); a bf16 leaf, which
  both write as its raw two bytes, read back bit-exactly by the port;
  ``_gc_old`` keeping the newest 3; restore falling back past a corrupt
  newest file (``train.ckpt_fallback`` counts 1); mirrored restore with
  one shard directory deleted; the ``AsyncCheckpointer`` writing what
  ``save`` saw even when the step then updates the parameters in place.
* The crash drill of ``tests/test_chaos.py`` on the port: a crash
  injected at step 5 of 6, a resumed ``fit`` equal to the uninterrupted
  one, bit for bit on the CPU; ``fit(ckpt_dir)`` against the reference's:
  the same checkpoint steps on disk, losses within 1e-4.
* ``RetryingStep`` and the ``Prefetcher`` on the CPU.
"""
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.chaos import inject as ref_inject
from repro.train import checkpoint as ref_ckpt
from repro.train import fit as ref_fit
from repro.train import adam as ref_adam
from repro_torch import obs
from repro_torch.chaos import (Fault, FaultPlan, InjectedFault, armed,
                               corrupt_file, inject)
from repro_torch.convert import params_from_jax
from repro_torch.train import (AsyncCheckpointer, Prefetcher, RetryingStep,
                               adam, checkpoint, fit, latest_step, resume,
                               tree_leaves)

LOSS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.reset()
    obs.enable()
    yield
    obs.disable()
    obs.reset()


def _counter(name: str) -> float:
    return sum(v for k, v in obs.snapshot()["counters"].items()
               if k == name or k.startswith(name + "{"))


# ------------------------------------------------------------ fault plans
SPEC = {"exec.pallas_launch": [("kernel_launch", 10)],
        "train.step": [("crash", 50)],
        "dist.halo": [("shard_loss", 4), ("straggler", 4)]}


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_plan_generate_matches_reference(seed):
    got = FaultPlan.generate(seed, SPEC)
    want = ref_inject.FaultPlan.generate(seed, SPEC)
    assert got.describe() == want.describe()
    assert got.seed == want.seed == seed
    assert [f.site for f in got.for_site("train.step")] == ["train.step"]


def test_faults_validate_like_reference():
    assert inject.KINDS == ref_inject.KINDS
    for bad in (dict(kind="not_a_kind"), dict(kind="crash", hit=-1),
                dict(kind="crash", count=0)):
        with pytest.raises(ValueError):
            Fault("x", **bad)
        with pytest.raises(ValueError):
            ref_inject.Fault("x", **bad)
    f = Fault("s", "straggler", payload=(("delay", 2),))
    assert f.arg("delay") == 2 and f.arg("other", 5) == 5
    assert FaultPlan.of(f, seed=3).describe() == [
        {"site": "s", "kind": "straggler", "hit": 0, "count": 1,
         "payload": [("delay", 2)]}]


def test_disarmed_hooks_are_noops():
    assert inject.active() is None
    assert inject.fire("train.step") is None
    inject.fail_point("train.step")
    x = torch.ones(4)
    assert inject.mangle("exec.kernel_result", x) is x


def test_armed_fires_at_hit_and_restores():
    with armed(FaultPlan.of(Fault("s", "crash", hit=2, count=2))) as inj:
        assert inject.fire("s") is None
        assert inject.fire("s") is None
        assert inject.fire("s").hit == 2
        assert inject.fire("s").hit == 3
        assert inject.fire("s") is None
        assert inj.hits["s"] == 5 and len(inj.fired) == 2
        with armed(FaultPlan.of()) as inner:
            assert inject.active() is inner
        assert inject.active() is inj
    assert inject.active() is None
    assert _counter("chaos.fired") == 2 and _counter("chaos.armed") == 2


def test_fail_point_and_mangle():
    with armed(FaultPlan.of(Fault("train.step", "crash", hit=1))):
        inject.fail_point("train.step")
        with pytest.raises(InjectedFault) as ei:
            inject.fail_point("train.step")
    assert ei.value.fault.kind == "crash" and ei.value.fault.hit == 1
    plan = FaultPlan.of(Fault("r", "nan_backend", count=2),
                        Fault("r", "kernel_launch", hit=2))
    with armed(plan):
        x = torch.ones(4, 4)
        y = inject.mangle("r", x)
        a = inject.mangle("r", np.ones(16, np.float32))
        with pytest.raises(InjectedFault):
            inject.mangle("r", x)
    assert torch.isnan(y).sum() == 2 and torch.isfinite(x).all()
    assert np.isnan(a).sum() == 2


@pytest.mark.parametrize("mode", ["garble", "truncate"])
@pytest.mark.parametrize("seed", [0, 1, 9])
def test_corrupt_file_byte_equal_to_reference(tmp_path, mode, seed):
    payload = bytes(range(256)) * 40
    a, b = tmp_path / "port.bin", tmp_path / "ref.bin"
    a.write_bytes(payload)
    b.write_bytes(payload)
    corrupt_file(str(a), seed=seed, mode=mode)
    ref_inject.corrupt_file(str(b), seed=seed, mode=mode)
    assert a.read_bytes() == b.read_bytes() != payload
    with pytest.raises(ValueError):
        corrupt_file(str(a), mode="shred")


# ------------------------------------------------------------ checkpoints
def _tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"layers": [{"w": f(4, 3), "b": f(3)}, {"w": f(3, 2)}],
              "emb": f(6, 2)}
    opt = {"m": {"layers": [{"w": f(4, 3), "b": f(3)}, {"w": f(3, 2)}],
                 "emb": f(6, 2)},
           "step": np.asarray(seed, np.int32)}
    return params, opt


def _port(tree):
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return torch.as_tensor(t)
    return walk(tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_leaves_byte_equal(port_tree, ref_tree):
    got = dict(checkpoint._paths(port_tree))
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_tree)
    want = {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.asarray(v) for path, v in flat}
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert g.tobytes() == v.tobytes(), k


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    p, o = _tree(3)
    checkpoint.save_checkpoint(str(tmp_path), 7, _port(p), _port(o),
                               extra={"note": "port"})
    tp, to = _tree(0)
    rp, ro, step = ref_ckpt.restore_checkpoint(str(tmp_path), _jax(tp),
                                               _jax(to))
    assert step == 7
    _assert_leaves_byte_equal(_port(p), rp)
    _assert_leaves_byte_equal(_port(o), ro)
    # the same members, spelled and stored as the reference stores them
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 7, _jax(p), _jax(o))
    mine = np.load(tmp_path / "step_00000007.npz")
    theirs = np.load(tmp_path / "ref" / "step_00000007.npz")
    assert sorted(mine.files) == sorted(theirs.files)
    for k in theirs.files:
        assert mine[k].dtype == theirs[k].dtype
        assert mine[k].tobytes() == theirs[k].tobytes(), k


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    p, o = _tree(4)
    ref_ckpt.save_checkpoint(str(tmp_path), 12, _jax(p), _jax(o))
    tp, to = _tree(0)
    gp, go, step = checkpoint.restore_checkpoint(str(tmp_path), _port(tp),
                                                 _port(to))
    assert step == 12 and go["step"].dtype == torch.int32
    _assert_leaves_byte_equal(gp, _jax(p))
    _assert_leaves_byte_equal(go, _jax(o))


def test_bf16_leaves_read_back_bit_exactly(tmp_path):
    """Both packages write a bf16 leaf as its raw bytes (``|V2``); the port
    reads the reference's, and its own, back bit for bit."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 1,
                             {"w": jnp.asarray(w, jnp.bfloat16)}, {})
    template = {"w": torch.zeros(5, 3, dtype=torch.bfloat16)}
    got, _, _ = checkpoint.restore_checkpoint(str(tmp_path / "ref"),
                                              template, {})
    want = torch.as_tensor(w).to(torch.bfloat16)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), want.view(torch.int16))
    checkpoint.save_checkpoint(str(tmp_path / "port"), 1, {"w": want}, {})
    stored = np.load(tmp_path / "port" / "step_00000001.npz")["params:w"]
    assert stored.dtype == np.dtype("V2")
    assert stored.tobytes() == np.load(
        tmp_path / "ref" / "step_00000001.npz")["params:w"].tobytes()
    back, _, _ = checkpoint.restore_checkpoint(str(tmp_path / "port"),
                                               template, {})
    assert torch.equal(back["w"].view(torch.int16), want.view(torch.int16))
    # into an fp32 template: the bf16 values, widened
    wide, _, _ = checkpoint.restore_checkpoint(
        str(tmp_path / "port"), {"w": torch.zeros(5, 3)}, {})
    assert wide["w"].dtype == torch.float32
    assert torch.equal(wide["w"], want.to(torch.float32))


def test_gc_keeps_the_newest_three_like_reference(tmp_path):
    p, o = _tree(1)
    for s in (1, 5, 2, 9, 3):
        checkpoint.save_checkpoint(str(tmp_path / "port"), s, _port(p),
                                   _port(o))
        ref_ckpt.save_checkpoint(str(tmp_path / "ref"), s, _jax(p),
                                 _jax(o))
    assert checkpoint.available_steps(str(tmp_path / "port")) == [9, 5, 3]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref"))
    assert checkpoint.latest_step(str(tmp_path / "port")) == 9
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    # a stray or in-flight name is never a checkpoint
    (tmp_path / "port" / ".step_00000010.npz.tmp").write_bytes(b"x")
    (tmp_path / "port" / "step_10.npz").write_bytes(b"x")
    assert checkpoint.available_steps(str(tmp_path / "port")) == [9, 5, 3]


@pytest.mark.parametrize("mode", ["truncate", "garble"])
def test_restore_falls_back_past_corrupt_newest(tmp_path, mode):
    d = str(tmp_path)
    for s in (1, 2):
        p, o = _tree(s)
        checkpoint.save_checkpoint(d, s, _port(p), _port(o))
    corrupt_file(os.path.join(d, "step_00000002.npz"), seed=0, mode=mode)
    tp, to = _port(_tree(0)[0]), _port(_tree(0)[1])
    p, o, step = checkpoint.restore_checkpoint(d, tp, to)
    assert step == 1 and int(o["step"]) == 1
    _assert_leaves_byte_equal(p, _jax(_tree(1)[0]))
    assert _counter("train.ckpt_fallback") == 1
    with pytest.raises(Exception):
        checkpoint.restore_checkpoint(d, tp, to, step=2)
    corrupt_file(os.path.join(d, "step_00000001.npz"), mode="truncate")
    with pytest.raises(RuntimeError, match="unreadable"):
        checkpoint.restore_checkpoint(d, tp, to)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_path / "empty"), tp, to)


def test_restore_refuses_a_tree_the_checkpoint_lacks(tmp_path):
    p, o = _tree(1)
    checkpoint.save_checkpoint(str(tmp_path), 1, _port(p), _port(o))
    with pytest.raises(RuntimeError, match="unreadable"):
        checkpoint.restore_checkpoint(str(tmp_path),
                                      {"other": torch.zeros(2)}, {})
    assert _counter("train.ckpt_fallback") == 1


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("lost", [0, 2])
def test_mirrored_restore_survives_a_lost_shard(tmp_path, writer, lost):
    p, o = _tree(6)
    root = str(tmp_path / "mirrored")
    for step in (3, 4):
        if writer == "port":
            checkpoint.save_mirrored_checkpoint(root, step, _port(p),
                                                _port(o), num_shards=3)
        else:
            ref_ckpt.save_mirrored_checkpoint(root, step, _jax(p), _jax(o),
                                              num_shards=3)
    assert checkpoint.buddy_of(2, 3) == 0 == ref_ckpt.buddy_of(2, 3)
    shutil.rmtree(os.path.join(root, f"shard_{lost:02d}"))
    tp, to = _port(_tree(0)[0]), _port(_tree(0)[1])
    gp, go, step = checkpoint.restore_mirrored_checkpoint(root, tp, to, 3)
    assert step == 4
    _assert_leaves_byte_equal(gp, _jax(p))
    _assert_leaves_byte_equal(go, _jax(o))
    assert _counter("train.ckpt_mirror_fallback") == 1
    assert _counter("train.ckpt_fallback") == 0
    # a second lost directory loses the quorum of every step
    shutil.rmtree(os.path.join(root, f"shard_{(lost + 1) % 3:02d}"))
    with pytest.raises(RuntimeError, match="unreadable"):
        checkpoint.restore_mirrored_checkpoint(root, tp, to, 3)


def test_async_checkpointer_writes_what_save_saw(tmp_path):
    """``save`` copies to the host before it returns: a step that then
    updates the tensors in place does not change what is written."""
    p = {"w": torch.zeros(64, 64)}
    o = {"step": torch.zeros((), dtype=torch.int32)}
    ck = AsyncCheckpointer(str(tmp_path))
    for s in range(1, 4):
        ck.save(s, p, o)
        p["w"].add_(1.0)                # the next step, in place
        o["step"].add_(1)
    ck.wait()
    ck.close()
    assert not ck._worker.is_alive()
    for s in (1, 2, 3):
        got, go, _ = checkpoint.restore_checkpoint(
            str(tmp_path), {"w": torch.ones(64, 64)},
            {"step": torch.ones((), dtype=torch.int32)}, step=s)
        assert torch.equal(got["w"], torch.full((64, 64), float(s - 1)))
        assert int(go["step"]) == s - 1


def test_async_checkpointer_surfaces_a_write_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, {"w": torch.zeros(2)}, {})
    with pytest.raises(OSError):
        ck.wait()
    ck.close()


def test_resume_returns_the_templates_without_a_checkpoint(tmp_path):
    tp, to = {"w": torch.zeros(2)}, {"m": torch.ones(2)}
    p, o, start = resume(str(tmp_path / "none"), tp, to)
    assert p is tp and o is to and start == 0
    checkpoint.save_checkpoint(str(tmp_path), 4, {"w": torch.full((2,), 3.)},
                               {"m": torch.full((2,), 5.)})
    p, o, start = resume(str(tmp_path), tp, to)
    assert start == 5 and float(p["w"][0]) == 3 and float(o["m"][0]) == 5


# ------------------------------------------------------------- the drill
W_TRUE = np.random.default_rng(9).standard_normal((4, 1)).astype(np.float32)


def _batches(start, framework="port"):
    i = start
    while True:
        r = np.random.default_rng(500 + i)
        xb = r.standard_normal((8, 4)).astype(np.float32)
        yb = xb @ W_TRUE
        if framework == "port":
            yield {"x": torch.as_tensor(xb), "y": torch.as_tensor(yb)}
        else:
            yield {"x": jnp.asarray(xb), "y": jnp.asarray(yb)}
        i += 1


def _loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def _params0():
    return {"w": torch.zeros((4, 1), dtype=torch.float32)}


def test_crash_resume_bit_identical(tmp_path):
    quiet = dict(log_every=0, log=lambda *a: None)
    ref = fit(_loss, adam(1e-2), _params0(), _batches(0), 6,
              ckpt_dir=str(tmp_path / "ref"), ckpt_every=2, **quiet)
    crash_dir = str(tmp_path / "crash")
    with pytest.raises(InjectedFault):
        with armed(FaultPlan.of(Fault("train.step", "crash", hit=5))):
            fit(_loss, adam(1e-2), _params0(), _batches(0), 6,
                ckpt_dir=crash_dir, ckpt_every=2, **quiet)
    done = threading.Event()
    for _ in range(250):                # the writer thread may lag the crash
        if latest_step(crash_dir) == 4:
            break
        done.wait(0.02)
    assert latest_step(crash_dir) == 4
    res = fit(_loss, adam(1e-2), _params0(), _batches(5), 6,
              ckpt_dir=crash_dir, ckpt_every=2, **quiet)
    assert res.steps == 1 and res.losses == ref.losses[5:]
    for a, b in zip(tree_leaves(ref.params), tree_leaves(res.params)):
        assert torch.equal(a, b)
    assert _counter("chaos.fired{kind=crash,site=train.step}") == 1
    assert _counter("train.ckpt_fallback") == 0


def test_fit_checkpoints_like_the_reference(tmp_path):
    """The same steps on disk (every 3rd step and the last, newest 3 kept)
    and the same losses; each side restores the other's last checkpoint."""
    quiet = dict(log_every=0, log=lambda *a: None)
    ref_p = {"w": jnp.zeros((4, 1), jnp.float32)}

    def ref_loss(params, batch):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
    ref = ref_fit(ref_loss, ref_adam(1e-2), ref_p, _batches(0, "ref"), 11,
                  ckpt_dir=str(tmp_path / "ref"), ckpt_every=3, **quiet)
    res = fit(_loss, adam(1e-2), _params0(), _batches(0), 11,
              ckpt_dir=str(tmp_path / "port"), ckpt_every=3, **quiet)
    steps = checkpoint.available_steps(str(tmp_path / "port"))
    assert steps == ref_ckpt.available_steps(str(tmp_path / "ref")) == \
        [10, 9, 6]
    np.testing.assert_allclose(res.losses, ref.losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    tp = _params0()
    got, go, step = checkpoint.restore_checkpoint(
        str(tmp_path / "ref"), tp, adam(1e-2).init(tp))
    assert step == 10 and int(go["step"]) == 11
    np.testing.assert_allclose(got["w"].numpy(), res.params["w"].numpy(),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    rt = ref_adam(1e-2).init(ref_p)
    rp, ro, _ = ref_ckpt.restore_checkpoint(str(tmp_path / "port"), ref_p,
                                            rt)
    assert int(ro["step"]) == 11
    np.testing.assert_allclose(np.asarray(rp["w"]), res.params["w"].numpy(),
                               rtol=0, atol=0)


# ------------------------------------------------- retry and prefetch
def test_retrying_step_retries_device_errors_only(monkeypatch):
    monkeypatch.setattr("time.sleep", lambda s: None)
    calls = []

    def flaky(x):
        calls.append(x)
        if len(calls) < 3:
            raise torch.AcceleratorError("CUDA error: an illegal access")
        return x + 1

    step = RetryingStep(flaky, max_retries=2)
    assert step(1) == 2 and step.retries == 2 and len(calls) == 3

    def broken(x):
        raise torch.AcceleratorError("CUDA error: still broken")
    step = RetryingStep(broken, max_retries=2)
    with pytest.raises(torch.AcceleratorError):
        step(0)
    assert step.retries == 2

    def wrong(x):
        calls.append(x)
        raise RuntimeError("shape mismatch")
    calls.clear()
    step = RetryingStep(wrong, max_retries=3)
    with pytest.raises(RuntimeError, match="shape"):
        step(0)
    assert step.retries == 0 and len(calls) == 1


def test_prefetcher_moves_batches_and_raises_source_errors():
    src = [{"tokens": np.full((2, 3), i, np.int32), "step": i}
           for i in range(4)]
    got = list(Prefetcher(iter(src), device="cpu"))
    assert [b["step"] for b in got] == [0, 1, 2, 3]
    assert all(isinstance(b["tokens"], torch.Tensor) and
               int(b["tokens"][0, 0]) == b["step"] for b in got)
    assert list(Prefetcher(iter(src)))[2] is src[2]

    def failing():
        yield src[0]
        raise ValueError("bad shard")
    it = Prefetcher(failing(), device="cpu")
    assert next(it)["step"] == 0
    with pytest.raises(ValueError, match="bad shard"):
        next(it)
    with pytest.raises(ValueError, match="bad shard"):
        next(it)


def test_params_from_jax_round_trips_through_a_checkpoint(tmp_path):
    """A reference LM tree saved by the reference restores in the port onto
    ``params_from_jax``'s tree, leaf for leaf."""
    from repro.configs import granite_8b as ref_granite
    from repro.models import transformer as ref_tf
    rp = ref_tf.lm_init(jax.random.PRNGKey(2), ref_granite.REDUCED)
    ref_ckpt.save_checkpoint(str(tmp_path), 0, rp, {})
    template = params_from_jax(jax.tree_util.tree_map(np.zeros_like, rp),
                               device="cpu")
    got, _, _ = checkpoint.restore_checkpoint(str(tmp_path), template, {})
    _assert_leaves_byte_equal(got, rp)
