"""The roofline (port of ``repro/roofline``): the H100's constants
(``hw``), the HLO text functions (``hlo``), the counts of a traced eager
step (``count``, the counterpart of XLA's cost and memory analyses) and the
three-term analysis per cell (``analysis``)."""
from . import hw
from .hlo import collective_bytes, parse_collectives, shape_bytes
from .analysis import CellRoofline, analyze_cell, markdown_row, MD_HEADER
