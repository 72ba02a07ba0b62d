"""Architecture configs (the GNN, recsys and dense LM parts of
``repro.configs``)."""
from .base import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, REGISTRY, ArchSpec,
                   Cell, all_archs, get, register)


def _load_all():
    from . import registry  # noqa: F401
