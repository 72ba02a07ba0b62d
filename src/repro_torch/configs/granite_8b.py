"""granite-8b [arXiv:2405.04324]: llama-arch code model.
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152."""
import torch

from .base import LM_SHAPES, ArchSpec, register
from .families import LMBundle
from ..models.transformer import LMConfig

CONFIG = LMConfig("granite-8b", n_layers=36, d_model=4096, n_heads=32,
                  n_kv=8, d_ff=14336, vocab=49152)
REDUCED = LMConfig("granite-8b-reduced", n_layers=2, d_model=128, n_heads=8,
                   n_kv=2, d_ff=256, vocab=512, dtype=torch.float32)

SPEC = register(ArchSpec(
    name="granite-8b", family="lm", shapes=tuple(LM_SHAPES),
    build=lambda: LMBundle(CONFIG)))
