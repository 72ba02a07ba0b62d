"""gat-cora [arXiv:1710.10903]: 2 layers, d_hidden=8, 8 heads, attn agg."""
from .base import GNN_SHAPES, ArchSpec, register
from .families import GNNBundle

MODEL_KW = {"d_hidden": 8, "n_heads": 8, "n_layers": 2}
REDUCED = {"d_hidden": 4, "n_heads": 2, "n_layers": 2, "classes": 4}

SPEC = register(ArchSpec(
    name="gat-cora", family="gnn", shapes=tuple(GNN_SHAPES),
    build=lambda: GNNBundle("gat", MODEL_KW, n_classes=7)))
