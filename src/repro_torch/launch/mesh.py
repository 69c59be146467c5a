"""Host mesh builder (torch port of ``repro.launch.mesh.make_host_mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group.  :func:`make_host_mesh` starts that group when none exists:
from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``) when it is set, else as a group of one
over an in-process store, with no TCP port.  gloo serves ``cpu``, NCCL
``cuda``.  The production meshes (256 and 512 chips) are not here.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu --mesh 2,1
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_process_group(device) -> None:
    """Start the default process group on ``device``'s backend, unless one
    exists: from ``torchrun``'s environment, or a group of one."""
    device = resolve_device(device)
    if dist.is_initialized():
        return
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(_backend(device))
    else:
        dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0,
                                world_size=1)


def make_host_mesh(shape=None, axes=("data", "model"), device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    default process group (started here if need be) on ``device`` (the
    card unless ``device="cpu"``).  ``shape=None`` puts every rank on the
    last axis.  Raises unless ``prod(shape)`` is the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    init_process_group(device)
    n = dist.get_world_size()
    if shape is None:
        shape = (1,) * (len(axes) - 1) + (n,)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} names {len(axes)} axes {axes}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} ranks, the process "
                         f"group {n}")
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)
