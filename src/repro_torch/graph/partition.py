"""Contiguous-window node partitions (numpy copy of the first part of
``repro/graph/partition.py``).

The paper assigns consecutive windows of the reordered execution order to
PEs (§IV-D1); ``core.mapping`` builds its graph-level mapping on these.
The halo-exchange plans of the reference's distributed path are not ported
yet (ROADMAP §1 item 9).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Partition:
    """Contiguous-window node partition.

    boundaries[p] .. boundaries[p+1] is the node range owned by part p
    (node ids refer to the *current* graph order, i.e. run after `permute`).
    """

    boundaries: np.ndarray  # (P+1,)
    num_parts: int

    def part_of(self, node: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.boundaries, node, side="right") - 1

    def sizes(self) -> np.ndarray:
        return np.diff(self.boundaries)


def window_partition(num_nodes: int, num_parts: int) -> Partition:
    """Equal contiguous windows (the first ``num_nodes % num_parts`` parts
    take one node more)."""
    base = num_nodes // num_parts
    sizes = np.full(num_parts, base, dtype=np.int64)
    sizes[: num_nodes - base * num_parts] += 1
    boundaries = np.concatenate([[0], np.cumsum(sizes)])
    return Partition(boundaries=boundaries, num_parts=num_parts)
