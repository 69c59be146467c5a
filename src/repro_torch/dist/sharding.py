"""Partition specs for every leaf the system moves: params, opt, batch, cache
(torch port of ``repro.dist.sharding``).

One rule table instead of per-arch spec trees: a leaf is classified by the
*names on its tree path* (``blocks/0/attn/wq``, ``blocks/tm/wo``,
``.../moe/wg/planes``), so the same rules cover every layout the port
produces:

- stacked training params (a leading ``L_super`` axis),
- unrolled serving params (per-layer lists of ``Packed`` bitplane weights,
  whose ``planes``/``scale`` leaves inherit their matrix's rule; a ``QDQ``
  embedding's ``w``),
- optimizer moments (fp32 mirrors or 8-bit ``QTensor`` code blocks, which
  inherit the parent parameter's rule through their path suffix).

Path names and leaf order are the reference's: dict keys sorted, list
items by index, ``Packed`` as ``planes`` then ``scale``, ``QDQ`` as ``w``
(its precomputed ``value`` takes ``w``'s spec and is not a leaf of its
own), ``QTensor`` as ``codes`` then ``scale``, and a host int (AdamW's
step) as a 0-d leaf.

A spec is a :class:`PartitionSpec`: one entry per tensor dim, each ``None``
(replicated), a mesh-axis name, or a tuple of names (major to minor); the
empty spec replicates every dim.  Specs are computed from the mesh's axis
names and sizes alone, so they need no process group: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` or an :class:`AbstractMesh`.
:func:`to_placements` turns them into DTensor placements over a
``DeviceMesh``, the counterpart of the reference's ``to_named``.

Profiles (:func:`shard_profile`, env ``REPRO_SHARD_PROFILE``):

- ``tp`` / ``tp_sp``: Megatron pairing -- attention/MLP input projections
  column-parallel (output dim on "model"), output projections row-parallel
  (contraction dim on "model"); embed and lm_head vocab-parallel; MoE
  banks expert-parallel (E on "model").
- ``fsdp``: every matched weight shards its rule dim over *all* mesh axes
  (ZeRO-3), falling back to whichever dim shards widest.

Every placement passes a divisibility guard: an axis (or axis suffix) that
does not divide the dim is dropped, never erred on, so glm4's 2 KV heads
or a 251-token smoke vocab degrade to replication.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

from repro_torch.models.model import cache_batch_axis
from repro_torch.quant.int8_opt import QTensor
from repro_torch.quant.pack import QDQ, Packed


class PartitionSpec(tuple):
    """Per-dim mesh-axis names (or None), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh as axis sizes and names only (``AbstractMesh((2, 4), ("data",
    "model"))``): enough for every spec, with no process group."""

    axis_sizes: tuple
    axis_names: tuple


def shard_profile() -> str:
    """The sharding profile: ``tp`` (default), ``tp_sp``, ``fsdp`` or ``dp``
    (env ``REPRO_SHARD_PROFILE``, read as the reference reads it)."""
    return os.environ.get("REPRO_SHARD_PROFILE", "tp")


# (parent, matrix) -> column-parallel (shard the output/minor dim) or
# row-parallel (shard the contraction dim).  Covers transformer attn/mlp,
# hymba's mamba branch, and rwkv's time-mix/channel-mix blocks.
_COL = {
    ("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
    ("mlp", "wg"), ("mlp", "wu"), ("shared", "wg"), ("shared", "wu"),
    ("ssm", "in_x"), ("ssm", "in_z"),
    ("tm", "wr"), ("tm", "wk"), ("tm", "wv"), ("tm", "wg"),
    ("cm", "wk"), ("cm", "wr"),
}
_ROW = {
    ("attn", "wo"), ("mlp", "wd"), ("shared", "wd"), ("ssm", "out"),
    ("tm", "wo"), ("cm", "wv"),
}
# norm/gain vectors: their D dim on "model", as the reference places them
_NORM = {"ln1", "ln2", "final_norm", "gn"}
# leaf attributes of containers (Packed / QDQ / QTensor) that inherit the
# parent matrix's rule rather than naming a matrix themselves
_CONTAINER_ATTRS = ("planes", "scale", "w", "codes")


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def _fit(dim: int, axes, sizes):
    """Largest suffix of ``axes`` whose size product divides ``dim``, or
    None -> replicate this dim."""
    axes = tuple(a for a in axes if a in sizes)
    for start in range(len(axes)):
        sub = axes[start:]
        if dim % math.prod(sizes[a] for a in sub) == 0:
            return sub[0] if len(sub) == 1 else sub
    return None


def _batch_mesh_axes(sizes) -> tuple[str, ...]:
    axes = (("pod", "data", "model") if shard_profile() == "fsdp"
            else ("pod", "data"))
    return tuple(a for a in axes if a in sizes)


def _leaf_spec(names: list[str], shape, sizes) -> PartitionSpec:
    """Sharding rule for one leaf, by path names + shape."""
    nd = len(shape)
    if nd == 0:
        return P()
    core = [n for n in names if not n.isdigit() and n not in _CONTAINER_ATTRS]
    mat = core[-1] if core else ""
    parent = core[-2] if len(core) >= 2 else ""
    leaf_attr = names[-1] if names else ""

    if mat in _NORM:
        dim, axes = nd - 1, ("model",)
    elif mat == "router":
        # router (L, D, E): D over the combined axes; E is never sharded
        dim, axes = max(nd - 2, 0), ("data", "model")
    elif parent == "moe" and mat in ("wg", "wu", "wd"):
        # expert-parallel bank: E on "model".  raw (E,D,F) / packed planes
        # (E,bits,K8,N) / scale (E,1,N): E=0; stacked training bank
        # (L_super, E, D, F): E=1.
        dim = 1 if (leaf_attr not in _CONTAINER_ATTRS and nd == 4) else 0
        axes = ("model",)
    elif mat == "embed":
        dim, axes = max(nd - 2, 0), ("model",)      # vocab rows
    elif mat == "lm_head":
        dim, axes = nd - 1, ("model",)              # vocab-parallel readout
    elif (parent, mat) in _COL and nd >= 2:
        dim, axes = nd - 1, ("model",)
    elif (parent, mat) in _ROW and nd >= 2:
        dim, axes = nd - 2, ("model",)
    else:
        # norms, routers, decay LoRAs, token-shift mixes, step counters:
        # tiny and sensitivity-critical -- replicated in every profile
        return P()

    if shard_profile() == "fsdp":
        # ZeRO-3: shard over ALL axes; when the rule dim does not divide the
        # full device count, fall back to whichever dim shards widest
        axes = tuple(sizes)

        def width(fit):
            picked = (fit,) if isinstance(fit, str) else tuple(fit or ())
            return math.prod(sizes[a] for a in picked)

        fit = _fit(shape[dim], axes, sizes)
        if width(fit) < math.prod(sizes[a] for a in axes):
            for d in sorted(range(nd), key=lambda d: -shape[d]):
                alt = _fit(shape[d], axes, sizes)
                if width(alt) > width(fit):
                    dim, fit = d, alt
        spec = [None] * nd
        spec[dim] = fit
        return P(*spec)
    spec = [None] * nd
    spec[dim] = _fit(shape[dim], axes, sizes)
    return P(*spec)


def leaf_spec(path_names: list, shape, mesh) -> PartitionSpec:
    """Public single-leaf rule lookup."""
    return _leaf_spec([str(n) for n in path_names], tuple(shape), mesh_sizes(mesh))


# ---- tree walks in the reference's order -------------------------------------------
def _children(node):
    """(name, child) pairs of a container in ``jax.tree`` order, or None
    for a leaf.  A ``QDQ``'s ``value`` rides with its ``w``."""
    if isinstance(node, PartitionSpec):
        return None
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if isinstance(node, Packed):
        return [("planes", node.planes), ("scale", node.scale)]
    if isinstance(node, QDQ):
        return [("w", node.w)]
    if isinstance(node, QTensor):
        return [("codes", node.codes), ("scale", node.scale)]
    return None


def named_leaves(tree, names=()):
    """[(path names, leaf)] in ``jax.tree`` order; a host int is a leaf."""
    kids = _children(tree)
    if kids is None:
        return [(list(names), tree)]
    return [x for k, v in kids for x in named_leaves(v, (*names, k))]


def map_tree(fn, tree, *others, names=()):
    """``tree`` rebuilt with every leaf ``fn(names, leaf, *other_leaves)``;
    ``others`` are trees of the same structure (spec or placement trees,
    whose leaves may be tuples).  A ``QDQ``'s ``value`` is mapped with
    its ``w``'s path and the others' ``w``."""
    kids = _children(tree)
    if kids is None:
        return fn(list(names), tree, *others)
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(o[k] for o in others), names=(*names, k))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(o[i] for o in others), names=(*names, str(i)))
                          for i, v in enumerate(tree))
    if isinstance(tree, Packed):
        return Packed(map_tree(fn, tree.planes, *(o.planes for o in others),
                               names=(*names, "planes")),
                      map_tree(fn, tree.scale, *(o.scale for o in others),
                               names=(*names, "scale")), tree.bits)
    if isinstance(tree, QDQ):
        w_names = (*names, "w")
        return QDQ(map_tree(fn, tree.w, *(o.w for o in others), names=w_names), tree.bits,
                   map_tree(fn, tree.value, *(o.w for o in others), names=w_names))
    return QTensor(map_tree(fn, tree.codes, *(o.codes for o in others),
                            names=(*names, "codes")),
                   map_tree(fn, tree.scale, *(o.scale for o in others),
                            names=(*names, "scale")), tree.shape)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def param_specs(params, mesh):
    """Tree of :class:`PartitionSpec`, one per array leaf of ``params``
    (real tensors, DTensors or meta stand-ins; training, serving or
    optimizer layout)."""
    sizes = mesh_sizes(mesh)
    return map_tree(lambda names, leaf: _leaf_spec(names, _shape(leaf), sizes), params)


def state_specs(state, mesh):
    """Specs for a train state ``{"params": ..., "opt": ...}``: optimizer
    moments mirror their parameter's spec through the shared path suffix;
    the step counter replicates."""
    return param_specs(state, mesh)


def spec_leaves(specs) -> list:
    """The specs of a spec tree, in ``jax.tree`` order."""
    return [leaf for _, leaf in named_leaves(specs)]


def batch_specs(batch, mesh, *, seq_shard: bool = False):
    """Specs for an input batch dict (tokens/labels/embeds/positions): the
    batch dim over the profile's batch axes; ``seq_shard=True`` also puts
    the sequence dim on "model" when the profile keeps "model" free of
    batch."""
    sizes = mesh_sizes(mesh)
    baxes = _batch_mesh_axes(sizes)
    seq_ax = ("model" if seq_shard and "model" not in baxes
              and "model" in sizes else None)

    def spec(key, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 0:
            return P()
        bdim = 1 if key == "positions" and nd == 3 else 0
        s = [None] * nd
        s[bdim] = _fit(shape[bdim], baxes, sizes)
        if seq_ax and nd > bdim + 1 and shape[bdim + 1] % sizes["model"] == 0:
            s[bdim + 1] = seq_ax
        return P(*s)

    return {k: spec(k, v) for k, v in batch.items()}


def cache_specs(cache, mesh):
    """Specs for a decode cache: the slot/batch axis (per-leaf position
    from ``models.model.cache_batch_axis``) shards over the data axes;
    heads and state dims stay local.  A paged pool's block axis sits where
    the slot axis does, so KV *blocks* spread over the data axes; the
    per-sequence ``block_tables`` and ``kv_qmax`` replicate."""
    sizes = mesh_sizes(mesh)
    daxes = tuple(a for a in ("pod", "data") if a in sizes)

    def spec(key, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 0 or key == "block_tables":
            return P()
        ax = cache_batch_axis(key)
        if ax < 0:  # no per-sequence axis (kv_qmax): replicate
            return P()
        s = [None] * nd
        s[ax] = _fit(shape[ax], daxes, sizes)
        return P(*s)

    return {k: spec(k, v) for k, v in cache.items()}


def placements_of(spec, mesh) -> tuple:
    """One :class:`PartitionSpec` -> its DTensor placements over ``mesh``'s
    dims: ``Shard(d)`` on every mesh dim named at tensor dim ``d``,
    ``Replicate()`` elsewhere.  A tuple entry's axes must come in mesh
    order (DTensor shards a dim over mesh dims major to minor)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not in mesh order {names}")
        for md in dims:
            if isinstance(out[md], Shard):
                raise ValueError(f"spec {spec} uses mesh axis {names[md]!r} twice")
            out[md] = Shard(d)
    return tuple(out)


def spec_of(placements, mesh, ndim: int) -> PartitionSpec:
    """DTensor placements -> the :class:`PartitionSpec` they realize (the
    inverse of :func:`placements_of`; the empty spec when replicated)."""
    from torch.distributed.tensor import Shard

    names = list(mesh_sizes(mesh))
    entries: list = [[] for _ in range(ndim)]
    for md, pl in enumerate(placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(names[md])
    if not any(entries):
        return P()
    return P(*(None if not e else e[0] if len(e) == 1 else tuple(e) for e in entries))


def to_placements(specs, mesh):
    """Spec tree -> the same tree with each spec's DTensor placements
    (``distribute_tensor`` / ``DTensor.from_local``-ready)."""
    return map_tree(lambda _, spec: placements_of(spec, mesh), specs)
