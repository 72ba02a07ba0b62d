"""Architecture configs (the GNN part of ``repro.configs``)."""
from .base import GNN_SHAPES, REGISTRY, ArchSpec, get, register


def _load_all():
    from . import registry  # noqa: F401
