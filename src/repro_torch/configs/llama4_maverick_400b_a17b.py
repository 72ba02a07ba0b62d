"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4]: 48L d_model=5120 40H
(GQA kv=8) d_ff=8192, vocab=202048, MoE 128e top-1, interleaved every 2
layers + shared expert (~400B total / ~17B active, see
``LMConfig.param_count``).  bf16 parameters and bf16 Adam moments, as the
reference's config."""
import torch

from .base import LM_SHAPES, ArchSpec, register
from .families import LMBundle
from ..models.transformer import LMConfig

CONFIG = LMConfig("llama4-maverick-400b-a17b", n_layers=48, d_model=5120,
                  n_heads=40, n_kv=8, d_ff=8192, vocab=202048,
                  n_experts=128, top_k=1, moe_every=2, shared_expert=True,
                  param_dtype=torch.bfloat16)
REDUCED = LMConfig("llama4-reduced", n_layers=2, d_model=128, n_heads=8,
                   n_kv=2, d_ff=128, vocab=512, n_experts=8, top_k=1,
                   moe_every=2, shared_expert=True, dtype=torch.float32)

SPEC = register(ArchSpec(
    name="llama4-maverick-400b-a17b", family="lm", shapes=tuple(LM_SHAPES),
    build=lambda: LMBundle(CONFIG, moments_dtype=torch.bfloat16)))
