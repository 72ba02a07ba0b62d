"""NVIDIA H100 SXM5 80GB constants (the port's target card, at its 700 W
power limit), from NVIDIA's H100 data sheet: the port of
``repro/roofline/hw.py``, whose TPU v5e constants these replace.

A card held below 700 W runs slower under load than these peaks say; the
chip runs print the card's power limit beside every number.
"""

PEAK_FLOPS_BF16 = 989e12      # per card, dense bf16 on tensor cores
PEAK_FLOPS_FP32 = 67e12       # per card, fp32 on the CUDA cores
HBM_BW = 3.35e12              # B/s per card, HBM3
HBM_BYTES = 80e9              # per card
SMEM_BYTES_PER_BLOCK = 227 * 1024   # shared memory one thread block may use

GPUS_PER_NODE = 8
NVLINK_BW = 450e9             # B/s per card per direction, inside a node
# across nodes: one 400 Gb/s NDR InfiniBand port per card (the counterpart
# of the reference's inter-pod DCI_BW)
NET_BW = 50e9
CHIPS_PER_POD = 256           # the production mesh's (16, 16)


def link_bw(n_ranks: int) -> float:
    """B/s per card of a collective over ``n_ranks`` ranks: NVLink while
    they fit in one node, the network above (both axes of (16, 16) cross
    nodes)."""
    return NVLINK_BW if n_ranks <= GPUS_PER_NODE else NET_BW


def implied_bandwidth(us_per_byte_equiv: float) -> float:
    """Effective byte-equivalents/second implied by a measured/model
    calibration ratio (the exec cost model is denominated in
    byte-equivalents; ``repro_torch.obs.audit`` produces the ratio in us per
    byte-equivalent).  Comparing against :data:`HBM_BW` places the host this
    process measured on relative to the card's roofline."""
    return 1e6 / max(float(us_per_byte_equiv), 1e-30)


def hbm_fraction(us_per_byte_equiv: float) -> float:
    """:func:`implied_bandwidth` as a fraction of the card's HBM roofline
    (CPU hosts are expected to sit far below 1.0)."""
    return implied_bandwidth(us_per_byte_equiv) / HBM_BW
