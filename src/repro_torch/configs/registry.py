"""Import every ported arch module to populate the registry."""
from . import (gat_cora, gcn_cora, granite_8b, minitron_8b,  # noqa: F401
               mistral_large_123b, nequip, pna, wide_deep)
