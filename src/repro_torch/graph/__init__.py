"""Graph containers, the Cora-shaped generator and serving expanders."""
from .structure import Graph, CSR
from .datasets import DatasetSpec, synthesize, cora_like
from .sampler import FullNeighborhood, NeighborSampler
