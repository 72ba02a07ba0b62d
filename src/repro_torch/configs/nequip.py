"""nequip [arXiv:2101.03164]: 5 layers, 32 channels, l_max=2 (Cartesian
irreps), n_rbf=8, cutoff=5, E(3)-equivariant."""
from .base import GNN_SHAPES, ArchSpec, register
from .families import GNNBundle

MODEL_KW = {"d_hidden": 32, "n_layers": 5, "n_rbf": 8, "cutoff": 5.0}
REDUCED = {"d_hidden": 8, "n_layers": 2, "n_rbf": 4, "cutoff": 5.0}

SPEC = register(ArchSpec(
    name="nequip", family="gnn", shapes=tuple(GNN_SHAPES),
    build=lambda: GNNBundle("nequip", MODEL_KW)))
