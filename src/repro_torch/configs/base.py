"""Architecture registry — port of ``repro/configs/base.py``.

Every arch is an ``ArchSpec`` whose ``bundle()`` builds the family's
bundle.  Every arch of the reference is ported: the four GNNs
(``gcn-cora``, ``gat-cora``, ``pna``, ``nequip``) over its four graph
cells, ``wide-deep``, the dense LMs (``granite-8b``, ``minitron-8b``,
``mistral-large-123b``) and the MoE LMs (``granite-moe-3b-a800m``,
``llama4-maverick-400b-a17b``).  The port adds ``gat-reddit`` (GAT at its
published inductive widths, the benchmark's configuration), which ``get``
finds and ``all_archs`` leaves out."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

REGISTRY: Dict[str, "ArchSpec"] = {}
# archs of the port alone (the benchmark's configurations), which the
# reference's registry has no counterpart of: ``get`` finds them,
# ``all_archs`` (the reference's set) does not list them
PORT_ONLY: Dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class Cell:
    """One (architecture x input-shape) dry-run cell."""

    shape_name: str
    kind: str                      # "train" | "prefill" | "decode" | "serve"
    meta: Dict[str, Any]


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


def register_port_only(spec: ArchSpec) -> ArchSpec:
    PORT_ONLY[spec.name] = spec
    return spec


def get(name: str) -> ArchSpec:
    if name not in REGISTRY and name not in PORT_ONLY:
        from . import _load_all        # lazy-populate
        _load_all()
    if name in REGISTRY:
        return REGISTRY[name]
    if name in PORT_ONLY:
        return PORT_ONLY[name]
    raise KeyError(f"unknown arch {name!r}")


def all_archs() -> Dict[str, ArchSpec]:
    """name -> ArchSpec of every registered arch."""
    from . import _load_all
    _load_all()
    return dict(REGISTRY)


# the reference's 4 LM cells
LM_SHAPES = {
    "train_4k":    {"kind": "train",   "seq": 4096,    "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768,   "batch": 32},
    "decode_32k":  {"kind": "decode",  "seq": 32768,   "batch": 128},
    "long_500k":   {"kind": "decode",  "seq": 524288,  "batch": 1},
}

# the reference's 4 graph cells
GNN_SHAPES = {
    "full_graph_sm": {"kind": "train", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433},
    "minibatch_lg":  {"kind": "train", "n_nodes": 232_965,
                      "n_edges": 114_615_892, "batch_nodes": 1024,
                      "fanout": (15, 10), "d_feat": 602},
    "ogb_products":  {"kind": "train", "n_nodes": 2_449_029,
                      "n_edges": 61_859_140, "d_feat": 100},
    "molecule":      {"kind": "train", "n_nodes": 30, "n_edges": 64,
                      "batch": 128},
}

RECSYS_SHAPES = {
    "train_batch":    {"kind": "train", "batch": 65_536},
    "serve_p99":      {"kind": "serve", "batch": 512},
    "serve_bulk":     {"kind": "serve", "batch": 262_144},
    # 1M candidates padded to 2^20, as the reference shards them
    "retrieval_cand": {"kind": "serve", "batch": 1,
                       "n_candidates": 1_048_576},
}


def pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult
