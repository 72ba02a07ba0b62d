"""NVIDIA H100 SXM5 80GB peaks from NVIDIA's data sheet (dense rates,
without sparsity, at the card's 700 W power limit).  The benchmark's own
copy: the program's ``roofline/hw.py`` holds the same numbers."""

PEAK_FLOPS_FP32 = 67e12       # FLOP/s, fp32 on the CUDA cores
HBM_BW = 3.35e12              # B/s
