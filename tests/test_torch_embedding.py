"""The port's EmbeddingBag against the reference's.

* ``kernels.ops.embedding_bag`` (on CPU tensors: the kernel wrapper's plain
  version) against the reference's ``ops.embedding_bag``, which runs the
  Pallas kernel in interpret mode (one grid step per id, so L <= 300), and
  against its ``embedding_bag_ref``: d in {1, 32, 37}, weighted and not,
  unsorted bag ids, with and without empty bags; and at the shapes the
  Hopper kernel's mapping branches on (under one id a bag with long empty
  runs, one bag holding every id, num_bags = 1; d in {1, 3, 4, 32, 33}).
  1e-5 of the largest entry: fp32 sums of at most a bag's ids in another
  order.
* The table's gradient (the same kernel wrapper on the transposed entries)
  against ``jax.grad`` of the reference's ``embedding_bag_ref``, 1e-5, also
  with far more table rows than ids (the backward's shape).
* ``nn.embedding``: ``embedding_bag_apply`` (sum, mean, max; weighted and
  not), ``multi_field_lookup`` and ``fused_field_lookup`` at 1e-5 (gathers
  are exact); ``hash_bucket`` byte-equal to the reference's uint32
  arithmetic.

The kernel itself against its plain version is in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ops as ref_ops
from repro.kernels.ref import embedding_bag_ref as ref_embedding_bag_ref
from repro.nn import embedding as ref_emb
from repro_torch.kernels import embedding_bag as kb
from repro_torch.kernels import ops
from repro_torch.kernels.ref import embedding_bag_ref
from repro_torch.nn import embedding as emb

from _torch_parity import assert_bytes_equal

TOL = 1e-5
V = 64
NUM_BAGS = 48


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: max err {err} > {TOL} x {scale}"


def _inputs(d, empty, seed=0, L=300):
    """Unsorted bag ids; with ``empty`` a third of the bags (the last eight
    among them) receive no id.  The last 16 table rows are never looked
    up."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, d)).astype(np.float32)
    ids = rng.integers(0, V - 16, L).astype(np.int32)
    bags = np.arange(NUM_BAGS, dtype=np.int32)
    if empty:
        bags = rng.permutation(bags[:NUM_BAGS - 8])[:NUM_BAGS * 2 // 3 - 8]
    bag_ids = rng.choice(bags, L).astype(np.int32)
    weights = rng.uniform(-1, 2, L).astype(np.float32)
    return ids, bag_ids, weights, table


@pytest.mark.parametrize("d", [1, 32, 37])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("empty", [False, True], ids=["full", "empty_bags"])
def test_ops_embedding_bag_matches_reference(d, weighted, empty):
    ids, bag_ids, weights, table = _inputs(d, empty)
    w = weights if weighted else None
    ref_kernel = ref_ops.embedding_bag(
        jnp.asarray(ids), jnp.asarray(bag_ids), jnp.asarray(table), NUM_BAGS,
        None if w is None else jnp.asarray(w), interpret=True)
    ref_plain = ref_embedding_bag_ref(
        jnp.asarray(ids), jnp.asarray(bag_ids),
        jnp.asarray(weights if weighted else np.ones_like(weights)),
        jnp.asarray(table), NUM_BAGS)
    got = ops.embedding_bag(torch.as_tensor(ids), torch.as_tensor(bag_ids),
                            torch.as_tensor(table), NUM_BAGS,
                            None if w is None else torch.as_tensor(w))
    assert got.shape == (NUM_BAGS, d) and got.dtype == torch.float32
    _close(got, ref_kernel, "vs the Pallas kernel (interpret)")
    _close(got, ref_plain, "vs embedding_bag_ref")
    if empty:
        counts = np.bincount(bag_ids, minlength=NUM_BAGS)
        assert (counts == 0).sum() >= 8
        assert not got[torch.as_tensor(counts == 0)].any()


@pytest.mark.parametrize("d", [1, 32, 37])
def test_table_gradient_matches_jax_grad(d):
    """The transposed bag list: the same kernel wrapper, sorted by id, one
    bag per table row, gathering the output gradient's rows."""
    ids, bag_ids, weights, table = _inputs(d, empty=True, seed=1)
    g = np.random.default_rng(2).standard_normal(
        (NUM_BAGS, d)).astype(np.float32)
    ref_grad = jax.grad(lambda t: jnp.sum(ref_embedding_bag_ref(
        jnp.asarray(ids), jnp.asarray(bag_ids), jnp.asarray(weights), t,
        NUM_BAGS) * g))(jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    out = ops.embedding_bag(torch.as_tensor(ids), torch.as_tensor(bag_ids), t,
                            NUM_BAGS, torch.as_tensor(weights))
    (out * torch.as_tensor(g)).sum().backward()
    _close(t.grad, ref_grad, "table gradient")
    # rows no id touches get exact zeros from the kernel's empty bags
    assert not t.grad[V - 16:].any()


def test_kernel_wrapper_takes_sorted_offsets():
    """The wrapper's contract, the TPU kernel's: entries sorted by bag, a bag
    id per entry and the bag count (the bags' offsets until the kernel took
    the TPU kernel's contract); its plain version on CPU tensors equals
    ``embedding_bag_ref`` on the unsorted entries."""
    ids, bag_ids, weights, table = _inputs(32, empty=True, seed=3)
    order = np.argsort(bag_ids, kind="stable")
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt))
    got = kb.embedding_bag(t(ids[order], np.int32),
                           t(bag_ids[order], np.int32),
                           t(weights[order], np.float32),
                           t(table, np.float32), NUM_BAGS)
    ref = embedding_bag_ref(t(ids, np.int32), t(bag_ids, np.int32),
                            t(weights, np.float32), t(table, np.float32),
                            NUM_BAGS)
    _close(got, ref.numpy())
    assert kb.embedding_bag.launches == 0        # the plain version


@pytest.mark.parametrize("bad", ["weights_grad", "id_range", "bag_range",
                                 "float_ids", "offsets_dtype",
                                 "bag_ids_dtype"])
def test_embedding_bag_rejects_bad_operands(bad):
    ids, bag_ids, weights, table = (torch.as_tensor(a) for a in
                                    _inputs(8, empty=False, L=20))
    if bad == "weights_grad":
        with pytest.raises(NotImplementedError, match="table only"):
            ops.embedding_bag(ids, bag_ids, table, NUM_BAGS,
                              weights.requires_grad_())
    elif bad == "id_range":
        ids[3] = V
        with pytest.raises(IndexError, match="ids out of range"):
            ops.embedding_bag(ids, bag_ids, table, NUM_BAGS)
    elif bad == "bag_range":
        bag_ids[0] = -1
        with pytest.raises(IndexError, match="bag_ids out of range"):
            ops.embedding_bag(ids, bag_ids, table, NUM_BAGS)
    elif bad == "float_ids":
        with pytest.raises(TypeError, match="integers"):
            ops.embedding_bag(ids.float(), bag_ids, table, NUM_BAGS)
    elif bad == "offsets_dtype":
        # the bags' offsets (num_bags + 1 of them) in place of a bag id per
        # entry: the wrapper refuses the old contract
        offsets = torch.zeros(NUM_BAGS + 1, dtype=torch.int32)
        with pytest.raises(ValueError, match="entries"):
            kb.embedding_bag(ids.int(), offsets, weights, table, NUM_BAGS)
    else:
        with pytest.raises(TypeError, match="bag_ids"):
            kb.embedding_bag(ids.int(), bag_ids.long(), weights, table,
                             NUM_BAGS)


def _shaped(shape, d, seed):
    """Entries (unsorted) of the shape classes the kernel's mapping branches
    on: ``sparse``, 60 ids over 400 bags (0.15 a bag) with runs of empty
    bags at the start (0-49), the middle (150-299) and the end (390-399)
    longer than a warp's range at this size; ``one_bag``, every id in bag
    17 of 48; ``single_bag``, num_bags = 1."""
    rng = np.random.default_rng(seed)
    nb, L = {"sparse": (400, 60), "one_bag": (48, 120),
             "single_bag": (1, 90)}[shape]
    if shape == "sparse":
        bag_ids = np.concatenate([rng.integers(50, 150, L // 2),
                                  rng.integers(300, 390, L - L // 2)])
        rng.shuffle(bag_ids)
    else:
        bag_ids = np.full(L, 17 if shape == "one_bag" else 0)
    table = rng.standard_normal((V, d)).astype(np.float32)
    ids = rng.integers(0, V, L).astype(np.int32)
    weights = rng.uniform(-1, 2, L).astype(np.float32)
    return ids, bag_ids.astype(np.int32), weights, table, nb


@pytest.mark.parametrize("shape", ["sparse", "one_bag", "single_bag"])
@pytest.mark.parametrize("d", [1, 3, 4, 32, 33])
def test_ops_embedding_bag_at_the_mapping_shapes(shape, d):
    """``ops.embedding_bag`` on CPU tensors (its plain path,
    ``embedding_bag_ref``) against the reference's (the Pallas kernel in
    interpret mode) at the bag shapes and widths the Hopper kernel's
    mapping branches on; empty bags exact zeros.  The kernel itself meets
    these shapes in ``test_torch_cuda.py``, on the card."""
    ids, bag_ids, weights, table, nb = _shaped(shape, d, seed=10 + d)
    ref = ref_ops.embedding_bag(jnp.asarray(ids), jnp.asarray(bag_ids),
                                jnp.asarray(table), nb, jnp.asarray(weights),
                                interpret=True)
    got = ops.embedding_bag(torch.as_tensor(ids), torch.as_tensor(bag_ids),
                            torch.as_tensor(table), nb,
                            torch.as_tensor(weights))
    assert got.shape == (nb, d)
    _close(got, ref, f"{shape} d={d}")
    empty = torch.as_tensor(np.bincount(bag_ids, minlength=nb) == 0)
    assert not got[empty].any()


@pytest.mark.parametrize("d", [1, 3, 4, 32, 33])
def test_table_gradient_with_far_more_rows_than_ids(d):
    """The backward's shape on CPU tensors (the plain path): the table
    gradient over V = 4096 rows (one bag each in the transposed entries)
    from 60 ids, against ``jax.grad`` of the reference's
    ``embedding_bag_ref``; rows no id touches exact zeros."""
    rng = np.random.default_rng(20 + d)
    rows, L, nb = 4096, 60, 40
    table = rng.standard_normal((rows, d)).astype(np.float32)
    ids = np.concatenate([rng.integers(100, 1000, L // 2),
                          rng.integers(3000, 4000, L - L // 2)]
                         ).astype(np.int32)
    bag_ids = rng.integers(0, nb, L).astype(np.int32)
    weights = rng.uniform(-1, 2, L).astype(np.float32)
    g = rng.standard_normal((nb, d)).astype(np.float32)
    ref_grad = jax.grad(lambda t: jnp.sum(ref_embedding_bag_ref(
        jnp.asarray(ids), jnp.asarray(bag_ids), jnp.asarray(weights), t,
        nb) * g))(jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    out = ops.embedding_bag(torch.as_tensor(ids), torch.as_tensor(bag_ids), t,
                            nb, torch.as_tensor(weights))
    (out * torch.as_tensor(g)).sum().backward()
    _close(t.grad, ref_grad, "table gradient")
    touched = torch.zeros(rows, dtype=torch.bool)
    touched[torch.as_tensor(ids).long()] = True
    assert not t.grad[~touched].any()


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [True, False])
def test_embedding_bag_apply_matches_reference(mode, weighted):
    ids, bag_ids, weights, table = _inputs(16, empty=True, seed=4)
    w = weights if weighted else None
    ref = ref_emb.embedding_bag_apply(
        {"table": jnp.asarray(table)}, jnp.asarray(ids), jnp.asarray(bag_ids),
        NUM_BAGS, None if w is None else jnp.asarray(w), mode=mode)
    got = emb.embedding_bag_apply(
        {"table": torch.as_tensor(table)}, torch.as_tensor(ids),
        torch.as_tensor(bag_ids), NUM_BAGS,
        None if w is None else torch.as_tensor(w), mode=mode)
    _close(got, ref, mode)
    with pytest.raises(ValueError):
        emb.embedding_bag_apply({"table": torch.as_tensor(table)},
                                torch.as_tensor(ids),
                                torch.as_tensor(bag_ids), NUM_BAGS,
                                mode="min")


def test_field_lookups_match_reference():
    rng = np.random.default_rng(5)
    B, F, d, rows = 24, 5, 8, 30
    tables = [rng.standard_normal((rows, d)).astype(np.float32)
              for _ in range(F)]
    ids = rng.integers(0, rows, (B, F)).astype(np.int32)
    ref = ref_emb.multi_field_lookup([{"table": jnp.asarray(t)}
                                      for t in tables], jnp.asarray(ids))
    got = emb.multi_field_lookup([{"table": torch.as_tensor(t)}
                                  for t in tables], torch.as_tensor(ids))
    assert_bytes_equal(got.numpy(), np.asarray(ref), "multi_field_lookup")
    fused = np.concatenate(tables)
    offs = (np.arange(F) * rows).astype(np.int32)
    ref = ref_emb.fused_field_lookup({"table": jnp.asarray(fused)},
                                     jnp.asarray(ids), jnp.asarray(offs))
    got = emb.fused_field_lookup({"table": torch.as_tensor(fused)},
                                 torch.as_tensor(ids), torch.as_tensor(offs))
    assert_bytes_equal(got.numpy(), np.asarray(ref), "fused_field_lookup")


@pytest.mark.parametrize("vocab", [1, 97, 1000, 1 << 20])
def test_hash_bucket_is_byte_equal(vocab):
    rng = np.random.default_rng(6)
    ids = np.concatenate([
        rng.integers(-2 ** 31, 2 ** 31, 500, dtype=np.int64),
        [0, 1, -1, 2 ** 31 - 1, -2 ** 31]]).astype(np.int32)
    ref = ref_emb.hash_bucket(jnp.asarray(ids), vocab)
    got = emb.hash_bucket(torch.as_tensor(ids), vocab)
    assert_bytes_equal(got.numpy(), np.asarray(ref), f"vocab={vocab}")


def test_embedding_bag_init_scale():
    p = emb.embedding_bag_init(torch.Generator().manual_seed(0), 4096, 16,
                               device="cpu")
    assert p["table"].shape == (4096, 16)
    assert abs(float(p["table"].std()) - 0.25) < 0.01
