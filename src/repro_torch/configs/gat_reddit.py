"""gat-reddit [arXiv:1710.10903 §3.3]: GAT's inductive model at its
published widths, 3 layers: 4 heads of 256 (concatenated), 4 heads of 256
with a skip across the layer, 6 heads averaged; each node attends over
itself besides its in-neighbours; no bias.  Its classes are those of the
port's Table I REDDIT row.  A configuration of the port alone (the
benchmark's ``gat-reddit``), kept out of the reference's registry."""
from ..graph.datasets import PAPER_TABLE_I
from .base import GNN_SHAPES, ArchSpec, register_port_only
from .families import GNNBundle

MODEL_KW = {"d_hidden": 256, "n_heads": 4, "n_layers": 3, "out_heads": 6,
            "skip": True, "self_loops": True}
N_CLASSES = PAPER_TABLE_I["REDDIT"][4]

SPEC = register_port_only(ArchSpec(
    name="gat-reddit", family="gnn", shapes=tuple(GNN_SHAPES),
    build=lambda: GNNBundle("gat", MODEL_KW, n_classes=N_CLASSES)))
