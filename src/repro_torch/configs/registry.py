"""Import every ported arch module to populate the registry."""
from . import (gat_cora, gcn_cora, granite_8b,  # noqa: F401
               granite_moe_3b_a800m, llama4_maverick_400b_a17b, minitron_8b,
               mistral_large_123b, nequip, pna, wide_deep)

ALL_ARCHS = ["granite-8b", "minitron-8b", "mistral-large-123b",
             "granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
             "gcn-cora", "pna", "gat-cora", "nequip", "wide-deep"]
