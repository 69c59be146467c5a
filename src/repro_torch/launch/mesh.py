"""Host mesh builder (torch port of ``repro.launch.mesh.make_host_mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group.  :func:`make_host_mesh` starts that group when none exists:
from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``) when it is set, else as a group of one
over an in-process store, with no TCP port.  gloo serves ``cpu``; on
``cuda`` NCCL serves one rank a card, and gloo ranks that outnumber the
cards (NCCL refuses two ranks on one device), each card shared by
``ceil(ranks / cards)`` of them, by ``LOCAL_RANK`` modulo the card count.
The choice follows that rule, never a failure, and is printed on the
group's log line.

:func:`make_production_mesh` builds the reference's production meshes,
(16, 16) and (2, 16, 16), on a default group of 256 or 512 ranks, which
the dry run (``launch/dryrun.py``) starts in its own process as a
``"fake"`` group (:func:`fake_process_group`: rank 0 of a world that
answers every collective without a peer), as the reference forces 512
host devices in that process alone.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu --mesh 2,1
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh 1,2   # one card: gloo
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device


def backend_for(device: torch.device, ranks: int, cards: int) -> str:
    """gloo on the CPU, and on cards that ``ranks`` outnumber; else NCCL."""
    return "nccl" if device.type == "cuda" and ranks <= cards else "gloo"


def init_process_group(device) -> None:
    """Start the default process group on the backend :func:`backend_for`
    picks, unless one exists: from ``torchrun``'s environment, or a group
    of one.  Prints the choice (rank 0)."""
    device = resolve_device(device)
    if dist.is_initialized():
        return
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    ranks = int(os.environ["WORLD_SIZE"]) if env else 1
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % cards)
    backend = backend_for(device, ranks, cards)
    if env:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_rank() == 0:
        print(f"process group: {ranks} rank(s) on {device.type}"
              + (f" over {cards} card(s)" if cards else "") + f": {backend}")


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


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (16, 16) = 256 ranks, ("data", "model").  Multi-pod:
    (2, 16, 16) = 512 ranks, ("pod", "data", "model").  Over the default
    process group, which must hold exactly that many ranks (the dry run's
    :func:`fake_process_group`)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION[bool(multi_pod)]
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise ValueError(f"the {'multi-pod' if multi_pod else 'single-pod'} production mesh "
                         f"{shape} needs a process group of {n} ranks, not {have}")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """The default process group as rank 0 of ``world_size`` ranks on
    torch's ``"fake"`` backend (``torch.testing._internal.distributed.
    fake_pg``): every collective returns at once and moves nothing, so one
    process runs what rank 0 of the world runs.  Destroyed on exit.
    Raises if a group exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already; the fake group needs its own "
                           "process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
