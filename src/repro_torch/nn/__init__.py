from .layers import linear_init, linear_apply
