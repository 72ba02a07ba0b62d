"""minitron-8b [arXiv:2407.14679]: pruned nemotron.
32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000."""
import torch

from .base import LM_SHAPES, ArchSpec, register
from .families import LMBundle
from ..models.transformer import LMConfig

CONFIG = LMConfig("minitron-8b", n_layers=32, d_model=4096, n_heads=32,
                  n_kv=8, d_ff=16384, vocab=256000)
REDUCED = LMConfig("minitron-8b-reduced", n_layers=2, d_model=128,
                   n_heads=8, n_kv=2, d_ff=320, vocab=1024,
                   dtype=torch.float32)

SPEC = register(ArchSpec(
    name="minitron-8b", family="lm", shapes=tuple(LM_SHAPES),
    build=lambda: LMBundle(CONFIG)))
