"""A cell's configuration cut to a size a CPU test holds (the widths too:
these runs check control flow and comparisons, not performance)."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from h100bench.harness import manifest  # noqa: E402

WORKLOADS = ("sage-citeseer-s.full", "gcn-citeseer-s.full")
BENCH = manifest.load_benchmark()


def small_config(workload: str, nodes: int = 3000, edges: int = 12000,
                 feat: int = 96, hidden: int = 32, classes: int = 7) -> dict:
    cfg = manifest.load_config(BENCH, manifest.cell(BENCH, workload)["config"])
    cfg["graph"].update(num_nodes=nodes, num_edges=edges, feat_dim=feat,
                        num_classes=classes)
    cfg["dims"] = [feat, hidden, classes]
    return cfg


def small_spec(workload: str, **kw) -> dict:
    return manifest.cell_spec(BENCH, workload, config=small_config(workload,
                                                                   **kw))
