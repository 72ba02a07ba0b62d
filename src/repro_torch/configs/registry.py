"""Import every ported arch module to populate the registry."""
from . import gcn_cora  # noqa: F401
