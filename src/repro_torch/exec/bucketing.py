"""Degree-binned bucketing for multi-grid block-ELL plans (numpy copy of
``repro/exec/bucketing.py``).

Destination nodes are partitioned by in-degree at plan compile time; each
bucket gets its own rectangular block-ELL (bucket-local destination rows x
global source columns) at its own square tile, one kernel launch per
bucket, and the per-bucket outputs are stitched back through the inverse
permutation.

A bucket *scheme* is a tuple of (bm, cut) pairs with ascending cuts, the
last cut ``None`` (unbounded): nodes with in-degree < cut_0 land in bucket
0 at tile bm_0, and so on.  Its canonical string form — ``"64@8+256"`` =
tile 64 for degree < 8, tile 256 for the rest — is the *bucket signature*
carried by autotune candidates, cache rows and calibration class keys.  The
empty signature means "unbucketed" and is never encoded, so unbucketed
candidates stay ``(backend, bm, compact)`` and
``(order, fuse, backend, bm, compact)``; bucketed ones append the
signature.  ``split_graph_cand`` / ``split_layer_cand`` unpack either form.

Backends follow the port's names: the reference's accelerator branch
(``pallas``, compact sub-grids) is ``cuda`` here, its CPU branch (``jnp``,
per-bucket padded einsum) is ``torch``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

Scheme = Tuple[Tuple[int, Optional[int]], ...]


def parse_bucket_sig(sig: str) -> Scheme:
    """``"64@8+256"`` -> ((64, 8), (256, None)); ``""`` -> ()."""
    if not sig:
        return ()
    items = []
    parts = sig.split("+")
    for i, part in enumerate(parts):
        if "@" in part:
            bm_s, cut_s = part.split("@", 1)
            bm, cut = int(bm_s), int(cut_s)
        else:
            bm, cut = int(part), None
        if bm <= 0:
            raise ValueError(f"bad bucket tile in {sig!r}")
        if (cut is None) != (i == len(parts) - 1):
            raise ValueError(f"only the last bucket may omit its cut: {sig!r}")
        items.append((bm, cut))
    cuts = [c for _, c in items[:-1]]
    if any(c <= 0 for c in cuts) or any(b <= a for a, b in zip(cuts, cuts[1:])):
        raise ValueError(f"bucket cuts must be positive ascending: {sig!r}")
    return tuple(items)


def bucket_sig(scheme: Scheme) -> str:
    """Inverse of :func:`parse_bucket_sig` (canonical string form)."""
    return "+".join(f"{bm}@{cut}" if cut is not None else str(bm)
                    for bm, cut in scheme)


def assign_buckets(deg: np.ndarray, scheme: Scheme) -> List[np.ndarray]:
    """Stable node partitions: bucket b = nodes with cut_{b-1} <= deg < cut_b.

    One int64 index array per scheme entry, each in ascending node order;
    every node lands in exactly one bucket; empty buckets are empty arrays.
    """
    deg = np.asarray(deg)
    out = []
    lo = None
    for bm, cut in scheme:
        mask = np.ones(deg.shape[0], bool)
        if lo is not None:
            mask &= deg >= lo
        if cut is not None:
            mask &= deg < cut
        out.append(np.nonzero(mask)[0].astype(np.int64))
        lo = cut
    return out


def bucket_occupancy(deg: np.ndarray, scheme: Scheme) -> List[dict]:
    """Per-bucket occupancy stats (obs gauges)."""
    stats = []
    for (bm, cut), idx in zip(scheme, assign_buckets(deg, scheme)):
        d = np.asarray(deg)[idx]
        stats.append({
            "bm": int(bm),
            "cut": None if cut is None else int(cut),
            "nodes": int(idx.size),
            "edges": int(d.sum()),
            "mean_deg": float(d.mean()) if d.size else 0.0,
            "max_deg": int(d.max()) if d.size else 0,
        })
    return stats


def split_graph_cand(cand: Sequence) -> Tuple[str, int, bool, str]:
    """(backend, bm, compact[, sig]) -> (backend, bm, compact, sig)."""
    if len(cand) == 4:
        backend, bm, compact, sig = cand
        return str(backend), int(bm), bool(compact), str(sig)
    backend, bm, compact = cand
    return str(backend), int(bm), bool(compact), ""


def split_layer_cand(cand: Sequence
                     ) -> Tuple[str, bool, str, int, bool, str]:
    """(order, fuse, backend, bm, compact[, sig]) -> 6-tuple with sig."""
    if len(cand) == 6:
        order, fuse, backend, bm, compact, sig = cand
        return (str(order), bool(fuse), str(backend), int(bm), bool(compact),
                str(sig))
    order, fuse, backend, bm, compact = cand
    return str(order), bool(fuse), str(backend), int(bm), bool(compact), ""


def make_graph_cand(backend: str, bm: int, compact: bool, sig: str = ""):
    """Canonical candidate tuple: the sig element exists only when
    non-empty."""
    base = (backend, bm, compact)
    return base + (sig,) if sig else base


def make_layer_cand(order: str, fuse: bool, backend: str, bm: int,
                    compact: bool, sig: str = ""):
    base = (order, fuse, backend, bm, compact)
    return base + (sig,) if sig else base


def quarantine_class(backend: str, sig: str = "") -> str:
    """The quarantine key class of a candidate: ``"backend|sig"`` for a
    bucketed plan, the bare backend otherwise (which bans every bucketing
    of it)."""
    return f"{backend}|{sig}" if sig else backend


def default_scheme(deg: np.ndarray, tail_bm: int, hub_bm: int,
                   cut: Optional[int] = None) -> Scheme:
    """Two-bucket scheme at the degree-90th-percentile cut (min 2); ()
    when one bucket would hold every node."""
    deg = np.asarray(deg)
    if deg.size == 0:
        return ()
    if cut is None:
        cut = max(int(np.percentile(deg, 90)), 2)
    if int(deg.max()) < cut or int(deg.min()) >= cut:
        return ()    # single populated bucket: bucketing is pure overhead
    return ((tail_bm, cut), (hub_bm, None))


def bucket_candidates(g, platform: str) -> List[Tuple]:
    """Bucketed graph-candidate tuples for ``autotune``: per-bucket padded
    plain products at small tiles on the CPU (``torch``), per-bucket compact
    kernels at 128 / 256 and 128 / 512 on the card (``cuda``).  Empty on
    uniform-degree graphs."""
    deg = g.in_degrees()
    out = []
    if platform == "cpu":
        pairs = [(16, 64), (32, 128)]
        backend = "torch"
    else:
        pairs = [(128, 256), (128, 512)]
        backend = "cuda"
    for tail_bm, hub_bm in pairs:
        scheme = default_scheme(deg, tail_bm, hub_bm)
        if scheme:
            out.append(make_graph_cand(backend, hub_bm, True,
                                       bucket_sig(scheme)))
    return out


def bucket_layer_candidates(g, platform: str, d_in: int, d_out: int
                            ) -> List[Tuple]:
    """Bucketed layer-candidate tuples for ``autotune_layer`` (fused on the
    kernel backend, as the reference fuses on ``pallas``)."""
    cands = []
    for c in bucket_candidates(g, platform):
        backend, bm, compact, sig = split_graph_cand(c)
        fuse = backend == "cuda"
        cands.append(make_layer_cand("aggregate_first", fuse, backend, bm,
                                     compact, sig))
    return cands
