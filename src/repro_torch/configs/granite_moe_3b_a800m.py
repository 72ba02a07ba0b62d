"""granite-moe-3b-a800m [hf:ibm-granite]: 32L d_model=1536 24H (GQA kv=8)
d_ff=512/expert, vocab=49155, MoE 40 experts top-8 (every layer)."""
import torch

from .base import LM_SHAPES, ArchSpec, register
from .families import LMBundle
from ..models.transformer import LMConfig

CONFIG = LMConfig("granite-moe-3b-a800m", n_layers=32, d_model=1536,
                  n_heads=24, n_kv=8, d_ff=512, vocab=49155,
                  head_dim=64, n_experts=40, top_k=8, moe_every=1)
REDUCED = LMConfig("granite-moe-reduced", n_layers=2, d_model=96, n_heads=6,
                   n_kv=2, d_ff=64, vocab=512, head_dim=16, n_experts=8,
                   top_k=2, moe_every=1, dtype=torch.float32)

SPEC = register(ArchSpec(
    name="granite-moe-3b-a800m", family="lm", shapes=tuple(LM_SHAPES),
    build=lambda: LMBundle(CONFIG)))
