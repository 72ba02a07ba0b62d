"""Import every ported arch module to populate the registry."""
from . import (gcn_cora, granite_8b, minitron_8b,  # noqa: F401
               mistral_large_123b, wide_deep)
