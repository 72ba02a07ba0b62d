from .layers import (cross_entropy, linear_apply, linear_init, mlp_apply,
                     mlp_init, rmsnorm_apply, rmsnorm_init, swiglu)
from .embedding import (embedding_bag_apply, embedding_bag_init,
                        fused_field_lookup, hash_bucket, multi_field_lookup)
