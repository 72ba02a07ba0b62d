"""wide-deep [arXiv:1606.07792]: 40 sparse fields, embed 32,
MLP 1024-512-256, interaction=concat.  1M rows/field fused table."""
from .base import RECSYS_SHAPES, ArchSpec, register
from .families import RecsysBundle
from ..models.recsys import WideDeepConfig

CONFIG = WideDeepConfig(rows_per_field=1_000_000)
REDUCED = WideDeepConfig(rows_per_field=1000, mlp_dims=(64, 32, 16))

SPEC = register(ArchSpec(
    name="wide-deep", family="recsys", shapes=tuple(RECSYS_SHAPES),
    build=lambda: RecsysBundle(CONFIG)))
