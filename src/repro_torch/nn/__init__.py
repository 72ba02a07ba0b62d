from .layers import (cross_entropy, linear_apply, linear_init, mlp_apply,
                     mlp_init)
