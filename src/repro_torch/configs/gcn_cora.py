"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden=16, sym-norm agg."""
from .base import GNN_SHAPES, ArchSpec, register
from .families import GNNBundle

MODEL_KW = {"hidden": [16]}
REDUCED = {"hidden": [8], "classes": 4}

SPEC = register(ArchSpec(
    name="gcn-cora", family="gnn", shapes=tuple(GNN_SHAPES),
    build=lambda: GNNBundle("gcn", MODEL_KW, n_classes=7)))
