"""Compile a ``HaloPlan`` into static send/recv tables for the mesh exchange
(numpy copy of ``repro/dist/plan.py``; every table byte-equal to the
reference's).

``graph.partition.build_halo_plan`` answers *what* each rank needs (the
deduplicated remote rows feeding its local aggregation); this module answers
*how* those rows move: a padded pairwise table driving one
``all_to_all_single`` per aggregation (``dist.halo``).  Shapes are static,
padded to the worst (sender, receiver) pair, so every rank sends and
receives equal splits on every step.

``collective_bytes_estimate`` is the analytical payoff: the halo exchange
ships only cut-edge rows, so its per-chip bytes scale with the partition's
cut fraction (which LSH reordering shrinks), while the all-gather baseline
ships the full feature table regardless.  It sets the reference's
``dist.*`` gauges under the same names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .. import obs
from ..graph.partition import HaloPlan


@dataclasses.dataclass(frozen=True)
class SendPlan:
    """Padded pairwise exchange tables for one ``HaloPlan``.

    For parts p, q and slot k (all tables are (P, P, K)):
      * ``send_idx[p, q, k]`` — local row (within p's window) that p ships to
        q in slot k; ``send_mask`` marks live slots.
      * ``recv_slot[p, q, k]`` — halo-buffer slot (0..H-1) on p where the
        k-th row arriving FROM q lands; ``recv_mask`` marks live slots.
    Slot k is aligned between the two views: sender q's k-th row for p is
    receiver p's k-th row from q, which is what an all_to_all of equal splits preserves.
    """

    send_idx: np.ndarray   # (P, P, K) int32
    send_mask: np.ndarray  # (P, P, K) bool
    recv_slot: np.ndarray  # (P, P, K) int32
    recv_mask: np.ndarray  # (P, P, K) bool

    @property
    def num_parts(self) -> int:
        return int(self.send_idx.shape[0])

    @property
    def pair_capacity(self) -> int:
        return int(self.send_idx.shape[2])

    def rows_received(self) -> np.ndarray:
        """(P,) deduplicated remote rows each part receives per exchange."""
        return self.recv_mask.sum(axis=(1, 2))


def build_send_plan(plan: HaloPlan, pair_capacity: int | None = None
                    ) -> SendPlan:
    """Group each part's halo needs by owner and emit aligned tables.

    ``pair_capacity`` can be fixed externally (e.g. a budget the reordered
    graph is known to satisfy); by default it is the max rows any single
    (sender, receiver) pair moves.
    """
    parts = plan.parts
    Pn = parts.num_parts
    needs = []  # needs[p] = (global ids, halo slots) p must receive
    for p in range(Pn):
        ids = plan.halo_src[p][plan.halo_mask[p]].astype(np.int64)
        slots = np.nonzero(plan.halo_mask[p])[0]
        needs.append((ids, slots))

    pair_rows: Dict[tuple, tuple] = {}
    k_needed = 1
    for p in range(Pn):
        ids, slots = needs[p]
        owner = parts.part_of(ids)
        for q in range(Pn):
            sel = owner == q
            if not sel.any():
                continue
            if q == p:
                raise ValueError(f"part {p} lists an owned node as halo")
            local = ids[sel] - parts.boundaries[q]
            pair_rows[(q, p)] = (local, slots[sel])
            k_needed = max(k_needed, int(sel.sum()))

    K = k_needed if pair_capacity is None else pair_capacity
    if k_needed > K:
        raise ValueError(f"pair capacity overflow: need {k_needed} > {K}")
    send_idx = np.zeros((Pn, Pn, K), np.int32)
    send_mask = np.zeros((Pn, Pn, K), bool)
    recv_slot = np.zeros((Pn, Pn, K), np.int32)
    recv_mask = np.zeros((Pn, Pn, K), bool)
    for (q, p), (local, slots) in pair_rows.items():
        n = local.shape[0]
        send_idx[q, p, :n] = local
        send_mask[q, p, :n] = True
        recv_slot[p, q, :n] = slots
        recv_mask[p, q, :n] = True
    sp = SendPlan(send_idx=send_idx, send_mask=send_mask,
                  recv_slot=recv_slot, recv_mask=recv_mask)
    obs.gauge("dist.send_plan.pair_capacity").set(sp.pair_capacity)
    obs.gauge("dist.send_plan.rows_per_chip").set(
        float(sp.rows_received().mean()))
    return sp


def collective_bytes_estimate(plan: HaloPlan, send: SendPlan, d: int,
                              bytes_per_elem: int = 4) -> Dict[str, float]:
    """Per-chip collective volume of one aggregation, three ways.

    * ``halo_bytes_per_chip_real``  — deduplicated cut-edge rows actually
      received (mean over parts): the wire payload a ragged exchange ships.
    * ``halo_bytes_per_chip_padded`` — what the STATIC equal-split
      all_to_all ships, including padding slots (P * K rows regardless of masks).
    * ``allgather_bytes_per_chip`` — the all-gather baseline: every chip receives
      the (N - local) remote portion of the full feature table.
    """
    Pn = plan.parts.num_parts
    n = int(plan.parts.boundaries[-1])
    row_bytes = d * bytes_per_elem
    real_rows = send.rows_received().astype(np.float64)
    padded_rows = float(Pn * send.pair_capacity)
    allgather_rows = n - n / Pn
    real = float(real_rows.mean()) * row_bytes
    allgather = allgather_rows * row_bytes
    est = {
        "cut_edge_fraction": plan.halo_fraction,
        "halo_rows_per_chip": float(real_rows.mean()),
        "halo_rows_per_chip_max": float(real_rows.max()),
        "halo_bytes_per_chip_real": real,
        "halo_bytes_per_chip_padded": padded_rows * row_bytes,
        "allgather_bytes_per_chip": allgather,
        "reduction_vs_allgather": allgather / max(real, 1e-9),
    }
    if obs.enabled():
        obs.gauge("dist.cut_edge_fraction").set(est["cut_edge_fraction"])
        obs.gauge("dist.halo.bytes_per_chip").set(
            est["halo_bytes_per_chip_real"])
        obs.gauge("dist.halo.bytes_per_chip_padded").set(
            est["halo_bytes_per_chip_padded"])
        obs.gauge("dist.allgather.bytes_per_chip").set(
            est["allgather_bytes_per_chip"])
        obs.gauge("dist.reduction_vs_allgather").set(
            est["reduction_vs_allgather"])
    return est
