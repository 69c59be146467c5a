"""Elastic reshard: restore a checkpoint onto whatever mesh exists now
(torch port of ``repro.dist.elastic``).

``repro_torch.ckpt`` stores leaves host-gathered (whole tensors, no
per-rank files), so elasticity is purely a *placement* problem: every rank
reads the whole tree, casts each leaf to the template's dtype and places
it under the specs ``dist/sharding.py`` derives for the current mesh.  A
2-rank checkpoint restores onto 4 ranks with no resharding pass.

A placed leaf is a ``DTensor`` whose local tensor is this rank's slice of
the whole one, cut on the host side: placing moves no bytes between
ranks.
"""
from __future__ import annotations

import torch

from repro_torch import ckpt as ckpt_lib
from repro_torch.dist import sharding as shd


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shards on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_slice(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` under ``placements``:
    each ``Shard(d)`` cuts dim ``d`` evenly, mesh dims major to minor."""
    from torch.distributed.tensor import Shard

    for md, pl in enumerate(placements):
        if isinstance(pl, Shard) and mesh.size(md) > 1:
            k, c = mesh.size(md), mesh.get_local_rank(md)
            if t.shape[pl.dim] % k:
                raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does not split {k} ways")
            w = t.shape[pl.dim] // k
            t = t.narrow(pl.dim, c * w, w)
    return t


def whole(t):
    """A leaf as one whole tensor: a DTensor's ``full_tensor()`` (a
    collective unless every shard is whole), anything else as it is."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t
    if all(not isinstance(pl, Shard) or t.device_mesh.size(md) == 1
           for md, pl in enumerate(t.placements)):
        return t.to_local()
    return t.full_tensor()


def default_specs(like, mesh):
    """The specs a tree is placed under: a DTensor leaf keeps its own
    placements, every other leaf takes ``state_specs``' rule."""
    from torch.distributed.tensor import DTensor

    def pick(_, leaf, spec):
        if isinstance(leaf, DTensor):
            return shd.spec_of(leaf.placements, mesh, leaf.ndim)
        return spec

    return shd.map_tree(pick, like, shd.state_specs(like, mesh))


def place(state, mesh, specs=None):
    """``state`` with every tensor leaf placed on ``mesh`` under ``specs``
    (derived by :func:`default_specs` when None): a ``DTensor`` on the
    mesh's device holding this rank's slice.  Host ints stay as they are."""
    from torch.distributed.tensor import DTensor

    specs = specs if specs is not None else default_specs(state, mesh)
    dev = mesh_device(mesh)

    def put(_, leaf, placements):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        full = whole(leaf)
        local = local_slice(full, mesh, placements).to(dev).contiguous()
        return DTensor.from_local(local, mesh, placements, run_check=False, shape=full.shape,
                                  stride=torch.empty(full.shape, device="meta").stride())

    return shd.map_tree(put, state, shd.to_placements(specs, mesh))


def restore_elastic(directory: str, like, mesh, *, specs=None, step: int | None = None):
    """-> (state placed on ``mesh``, meta, step).

    ``like`` is a template tree (tensors, DTensors or meta stand-ins)
    giving the target structure and dtypes; the checkpoint may have been
    written under any rank count.  A leaf whose shape differs from the
    template's raises, naming it.  Raises FileNotFoundError when no
    checkpoint exists: callers fall back to a fresh init."""
    tree, meta, step = ckpt_lib.restore(directory, step, device="cpu")

    def cast(names, ref, a):
        if not isinstance(ref, torch.Tensor):
            return a
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {'/'.join(names)}: the checkpoint holds "
                             f"{tuple(a.shape)}, the template {tuple(ref.shape)}")
        return a.to(ref.dtype)

    cast_tree = shd.map_tree(cast, like, tree)
    specs = specs if specs is not None else default_specs(like, mesh)
    return place(cast_tree, mesh, specs), meta, step
