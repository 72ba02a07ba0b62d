from .layers import (cross_entropy, embedding_apply, embedding_init,
                     layernorm_apply, layernorm_init, linear_apply,
                     linear_init, mlp_apply, mlp_init, rmsnorm_apply,
                     rmsnorm_init, swiglu)
from .embedding import (embedding_bag_apply, embedding_bag_init,
                        fused_field_lookup, hash_bucket, multi_field_lookup)
from .moe import moe_apply, moe_init
