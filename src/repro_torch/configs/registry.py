"""Import every ported arch module to populate the registry."""
from . import gcn_cora, wide_deep  # noqa: F401
