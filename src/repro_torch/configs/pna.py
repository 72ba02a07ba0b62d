"""pna [arXiv:2004.05718]: 4 layers d_hidden=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation."""
from .base import GNN_SHAPES, ArchSpec, register
from .families import GNNBundle

MODEL_KW = {"d_hidden": 75, "n_layers": 4}
REDUCED = {"d_hidden": 8, "n_layers": 2, "classes": 4}

SPEC = register(ArchSpec(
    name="pna", family="gnn", shapes=tuple(GNN_SHAPES),
    build=lambda: GNNBundle("pna", MODEL_KW, n_classes=10)))
