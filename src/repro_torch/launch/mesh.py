"""Device meshes over ``torch.distributed`` ranks (port of
``repro/launch/mesh.py``).

The reference is one program over every device (SPMD under ``jax.jit``);
PyTorch runs one process per rank.  So each mesh here is a
:class:`torch.distributed.device_mesh.DeviceMesh` built by
``init_device_mesh`` over the ranks of an initialised process group whose
world size is the mesh's size: NCCL with one rank per card on ``cuda``,
gloo with one process per part on the CPU.  NCCL takes one rank per
card, so on ``cuda`` a mesh larger than the card count raises with the
reference's "need N devices, have M" message, as does a world of another
size than the mesh.

Defined as FUNCTIONS so that importing never touches device state.
Single pod: (16, 16) ranks, axes (data, model); multi-pod (2, 16, 16),
axes (pod, data, model), as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def available_devices(device="cuda") -> int:
    """What a mesh on ``device`` can span: the card count on ``cuda``, the
    world size of the initialised process group (1 without one) on the
    CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return dist.get_world_size() if dist.is_initialized() else 1


def require_devices(n: int, device="cuda") -> str:
    """Raise the reference's "need N devices, have M" unless ``device`` can
    span ``n`` ranks; returns its device type."""
    device_type = torch.device(device).type
    have = available_devices(device_type)
    if have < n:
        raise ValueError(
            f"need {n} devices, have {have}; " + (
                "NCCL takes one rank per card" if device_type == "cuda"
                else f"start {n} ranks (torch.distributed, gloo)"))
    return device_type


def _require(n: int, device) -> str:
    """Raise unless ``n`` ranks of ``device`` exist and form the world;
    returns the mesh's device type."""
    device_type = require_devices(n, device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {n} needs an initialised process group "
            f"(torch.distributed.init_process_group with world size {n})")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"need {n} devices, have {world} (the process "
                         "group's world size)")
    return device_type


def make_production_mesh(*, multi_pod: bool = False, device="cuda"
                         ) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_require(math.prod(shape), device), shape,
                            mesh_dim_names=axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), device="cuda"
                    ) -> DeviceMesh:
    """Small mesh for tests on a handful of ranks."""
    return init_device_mesh(_require(math.prod(shape), device), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_halo_debug_mesh(parts: int | None = None, device="cuda"
                         ) -> DeviceMesh:
    """1-D data mesh for the dist halo-exchange path, one rank per part
    (default: the world size, or every card on ``cuda``)."""
    if parts is None:
        parts = (dist.get_world_size() if dist.is_initialized()
                 else available_devices(device))
    return init_device_mesh(_require(parts, device), (parts,),
                            mesh_dim_names=("data",))
