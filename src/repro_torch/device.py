"""Device selection shared by the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
request for ``cuda`` on a machine without one raises instead of carrying on
on the CPU.  Both TF32 switches are turned off here: the port's parity bars
are fp32 bars (1e-5 for plans and layers, 1e-4 for the serving oracle), and
TF32 keeps only about three decimal digits.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Validate ``device`` and pin fp32 matmuls to full precision."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was requested but no CUDA device "
                           "is available; pass device='cpu' to run the "
                           "plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
