"""The port's MoE FFN (``repro_torch.nn.moe``) against the reference's
``repro.nn.moe``, on the reference's own ``moe_init`` parameters carried
over by ``convert.params_from_jax`` and inputs drawn in numpy from a seed.

Cases: top-k 1, 2 and 8; a capacity that drops tokens and one that cannot
(C >= T); ``sort_tokens``; ``token_chunks=4``; the shared expert; and a
tie case (zero input rows give a uniform softmax, so every expert ties:
the top k are the k lowest ids on both sides).  The routes (expert ids,
``_segment_cumcount``, ``keep``) are held exactly; the output within 1e-5
of its largest entry, the aux loss within 1e-6, and the gradients of every
parameter and of x within 1e-5, absolute where an array's entries are
below 1 and of its largest entry above (fp32 sums in another order; and a
top-1 gate is p / p, whose gradient is a cancellation to zero that the two
frameworks round differently, leaving ~1e-6 of noise on a router gradient
whose largest entry, from the aux loss alone, is ~0.03).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.nn import moe as ref_moe
from repro_torch.convert import params_from_jax
from repro_torch.nn import moe
from repro_torch.train import tree_leaves
from repro_torch.train.optimizer import tree_unflatten

TOL = 1e-5
AUX_TOL = 1e-6


@dataclasses.dataclass(frozen=True)
class Case:
    T: int = 48
    d: int = 16
    f: int = 24
    E: int = 8
    k: int = 2
    cf: float = 1.25
    sort: bool = False
    chunks: int = 1
    shared: bool = False
    zero_rows: int = 0


CASES = {
    "top1": Case(k=1),
    "top1_no_drop": Case(k=1, cf=8.0),          # C = T: nothing drops
    "top2_drops": Case(k=2, cf=0.5),
    "top2_no_drop": Case(k=2, cf=4.0),
    "top8": Case(E=16, k=8),
    "top8_drops": Case(E=16, k=8, cf=0.5),
    "sort_tokens": Case(k=2, cf=0.75, sort=True),
    "token_chunks": Case(T=64, k=2, chunks=4),
    "shared_expert": Case(k=1, shared=True),
    "ties": Case(k=2, cf=0.5, zero_rows=12),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, tol, what, floor=1e-30):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), floor)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3g}"


def _inputs(c: Case, seed: int):
    rp = ref_moe.moe_init(jax.random.PRNGKey(seed), c.d, c.f, c.E,
                          shared_expert=c.shared)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c.T, c.d)).astype(np.float32)
    x[rng.permutation(c.T)[:c.zero_rows]] = 0.0
    g = rng.standard_normal((c.T, c.d)).astype(np.float32)
    return rp, x, g


def _ref_routes(rp, x, c: Case):
    """The reference's routing, computed with its own pieces (as
    ``_moe_apply_impl`` computes it)."""
    probs = jax.nn.softmax(jnp.asarray(x) @ rp["router"], axis=-1)
    _, expert_ids = jax.lax.top_k(probs, c.k)
    flat = expert_ids.reshape(-1)
    if c.sort:
        flat = flat[jnp.argsort(flat)]
    seg = ref_moe._segment_cumcount(flat, c.E)
    C = max(int(np.ceil(c.T * c.k / c.E * c.cf)), min(c.k, c.T))
    return (np.asarray(expert_ids), np.asarray(seg), np.asarray(seg < C), C)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_matches_reference(name):
    c = CASES[name]
    rp, x, g = _inputs(c, seed=len(name))
    aux_w = 0.37

    def ref_obj(p, xx):
        out, aux = ref_moe.moe_apply(p, xx, c.k, c.cf, c.sort,
                                     token_chunks=c.chunks)
        return jnp.sum(out * jnp.asarray(g)) + aux_w * aux, (out, aux)

    (_, (r_out, r_aux)), (r_gp, r_gx) = jax.value_and_grad(
        ref_obj, argnums=(0, 1), has_aux=True)(rp, jnp.asarray(x))

    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rp),
                             device="cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    tx = torch.as_tensor(x).requires_grad_()
    out, aux = moe.moe_apply(p, tx, c.k, c.cf, c.sort,
                             token_chunks=c.chunks)
    (torch.sum(out * torch.as_tensor(g)) + aux_w * aux).backward()

    _close(out, r_out, TOL, f"{name} out")
    assert abs(float(aux.detach()) - float(r_aux)) <= AUX_TOL * max(
        1.0, abs(float(r_aux))), (float(aux), float(r_aux))
    _close(tx.grad, r_gx, TOL, f"{name} dx", floor=1.0)
    got = tree_unflatten(params, [t.grad for t in leaves])
    want = jax.tree_util.tree_map(np.asarray, r_gp)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda t: isinstance(t, torch.Tensor))[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        _close(flat_got[path], leaf, TOL, f"{name} grad {path}", floor=1.0)

    if c.chunks == 1:
        ids, seg, keep, C = _ref_routes(rp, x, c)
        with torch.no_grad():
            r = moe.moe_routes(params, torch.as_tensor(x), c.k, c.cf, c.sort)
        assert r.capacity == C
        assert np.array_equal(r.expert_ids.numpy(), ids), name
        assert r.seg_pos.dtype == torch.int32
        assert np.array_equal(r.seg_pos.numpy(), seg), name
        assert np.array_equal(r.keep.numpy(), keep), name
        if name.endswith("drops") or name == "ties":
            assert not keep.all(), "the case should drop assignments"
        if name.endswith("no_drop"):
            assert keep.all()


def test_ties_go_to_the_lowest_expert_ids():
    """A zero token's softmax is uniform: its top k are experts 0..k-1 on
    both sides, in that order (``jax.lax.top_k``'s rule)."""
    c = CASES["ties"]
    rp, x, _ = _inputs(c, seed=3)
    zero = ~x.any(axis=1)
    assert zero.sum() == c.zero_rows
    ids, _, _, _ = _ref_routes(rp, x, c)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rp),
                             device="cpu")
    r = moe.moe_routes(params, torch.as_tensor(x), c.k, c.cf)
    want = np.tile(np.arange(c.k), (int(zero.sum()), 1))
    assert np.array_equal(ids[zero], want)
    assert np.array_equal(r.expert_ids.numpy()[zero], want)


@pytest.mark.parametrize("E,N,seed", [(8, 200, 0), (40, 1024, 1),
                                      (128, 64, 2)])
def test_segment_cumcount_equals_reference(E, N, seed):
    ids = np.random.default_rng(seed).integers(0, E, N).astype(np.int32)
    want = np.asarray(ref_moe._segment_cumcount(jnp.asarray(ids), E))
    got = moe._segment_cumcount(torch.as_tensor(ids).long(), E)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("T,k,E,cf", [(64, 1, 128, 1.25), (24, 8, 40, 1.25),
                                      (12288, 8, 40, 1.25), (3, 8, 40, 1.0),
                                      (1000, 2, 7, 0.3)])
def test_capacity_is_the_reference_arithmetic(T, k, E, cf):
    want = max(int(np.ceil(T * k / E * cf)), min(k, T))
    assert moe.capacity(T, k, E, cf) == want


def test_moe_init_shapes_match_reference():
    for shared in (False, True):
        ref = ref_moe.moe_init(jax.random.PRNGKey(0), 12, 20, 6,
                               shared_expert=shared)
        got = moe.moe_init(torch.Generator().manual_seed(0), 12, 20, 6,
                           shared_expert=shared, device="cpu",
                           dtype=torch.bfloat16)
        assert jax.tree_util.tree_map(lambda a: a.shape, ref) == \
            jax.tree_util.tree_map(lambda t: tuple(t.shape), got,
                                   is_leaf=lambda t: isinstance(
                                       t, torch.Tensor))
        assert all(t.dtype == torch.bfloat16 for t in tree_leaves(got))
        # one expert at a time: expert 1's wg is the generator's 3rd draw
        # (router, expert 0, expert 1), at the reference's 1/sqrt(d) scale
        gen = torch.Generator().manual_seed(0)
        for shape in ((12, 6), (12, 20)):
            torch.randn(shape, generator=gen)
        e1 = torch.randn((12, 20), generator=gen) / np.sqrt(12)
        assert torch.equal(got["wg"][1], e1.to(torch.bfloat16))


def test_moe_rerun_and_chunked_recompute_are_bit_identical():
    """The forward twice gives the same bits, and the gradient through
    ``token_chunks`` (each chunk recomputed under checkpoint) equals the
    gradient of the same chunks run without checkpoint, bit for bit."""
    c = CASES["token_chunks"]
    rp, x, g = _inputs(c, seed=7)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rp),
                             device="cpu")
    tx = torch.as_tensor(x)
    a = moe.moe_apply(params, tx, c.k, c.cf, token_chunks=4)
    b = moe.moe_apply(params, tx, c.k, c.cf, token_chunks=4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    grads = []
    for remat in (True, False):
        xx = tx.clone().requires_grad_()
        if remat:
            out, aux = moe.moe_apply(params, xx, c.k, c.cf, token_chunks=4)
        else:
            parts = [moe._moe_apply_impl(params, xc, c.k, c.cf)
                     for xc in xx.split(c.T // 4)]
            out = torch.cat([o for o, _ in parts])
            aux = torch.mean(torch.stack([a for _, a in parts]))
        (torch.sum(out * torch.as_tensor(g)) + aux).backward()
        grads.append(xx.grad)
    assert torch.equal(grads[0], grads[1])
