"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407].
88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768."""
import torch

from .base import LM_SHAPES, ArchSpec, register
from .families import LMBundle
from ..models.transformer import LMConfig

CONFIG = LMConfig("mistral-large-123b", n_layers=88, d_model=12288,
                  n_heads=96, n_kv=8, d_ff=28672, vocab=32768)
REDUCED = LMConfig("mistral-large-reduced", n_layers=3, d_model=192,
                   n_heads=12, n_kv=2, d_ff=448, vocab=512,
                   dtype=torch.float32)

SPEC = register(ArchSpec(
    name="mistral-large-123b", family="lm", shapes=tuple(LM_SHAPES),
    build=lambda: LMBundle(CONFIG)))
