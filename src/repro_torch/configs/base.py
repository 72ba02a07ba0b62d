"""Architecture registry — port of ``repro/configs/base.py``.

Every arch is an ``ArchSpec`` whose ``bundle()`` builds the family's
bundle.  ``gcn-cora``, ``wide-deep`` and the dense LMs (``granite-8b``,
``minitron-8b``, ``mistral-large-123b``) are ported; asking for another
arch of the reference raises ``NotImplementedError`` naming the ROADMAP
item."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

REGISTRY: Dict[str, "ArchSpec"] = {}

# the archs of repro.configs.registry that the port has no config for yet
NOT_PORTED = ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b", "pna",
              "gat-cora", "nequip")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                    # "lm" | "gnn" | "recsys"
    shapes: Tuple[str, ...]
    build: Callable[[], Any]       # returns the family-specific bundle

    def bundle(self):
        return self.build()


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> ArchSpec:
    if name not in REGISTRY:
        from . import _load_all        # lazy-populate
        _load_all()
    if name in REGISTRY:
        return REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet "
                                  "(ROADMAP §1 item 8b); ported: "
                                  f"{sorted(REGISTRY)}")
    raise KeyError(f"unknown arch {name!r}")


# the reference's 4 LM cells
LM_SHAPES = {
    "train_4k":    {"kind": "train",   "seq": 4096,    "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768,   "batch": 32},
    "decode_32k":  {"kind": "decode",  "seq": 32768,   "batch": 128},
    "long_500k":   {"kind": "decode",  "seq": 524288,  "batch": 1},
}

GNN_SHAPES = {
    "full_graph_sm": {"kind": "train", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433},
}

RECSYS_SHAPES = {
    "train_batch":    {"kind": "train", "batch": 65_536},
    "serve_p99":      {"kind": "serve", "batch": 512},
    "serve_bulk":     {"kind": "serve", "batch": 262_144},
    # 1M candidates padded to 2^20, as the reference shards them
    "retrieval_cand": {"kind": "serve", "batch": 1,
                       "n_candidates": 1_048_576},
}
