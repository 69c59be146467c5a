"""Tensor- and expert-parallel execution on explicit ``torch.distributed``
collectives: what the reference's GSPMD step computes under ``jax.set_mesh``
with the ``tp`` profile (``repro.models.common``'s sharding helpers, the
``constrain`` calls of ``repro.models.transformer``, the collectives GSPMD
inserts for them, and ``repro.models.moe._moe_ep``'s ``shard_map``).

A :class:`TensorParallel` is made from the model's config and a ``("data",
"model")`` or ``("pod", "data", "model")`` ``DeviceMesh`` (``launch/mesh.py``;
the batch runs over "pod" and "data" together, as the reference's
``batch_axes()`` puts it); the train step
(``train.train_step.make_tp_train_step``) makes it the active one
(:func:`active`) around its forward and backward, and the model reads it
(:func:`current`) where the reference constrains.  With ``m`` ranks on
"model":

- attention: heads split over "model" when ``H % m == 0`` (wq column-,
  wo row-parallel).  K and V are local when ``KV % m == 0``; otherwise each
  rank computes them whole and its q heads read their KV heads by global
  head index (:meth:`TensorParallel.kv_for_heads`: glm4's 2 KV heads at
  m = 4).  When ``KV % m`` but ``m`` divides ``KV · hd``, the stored
  column shards of wk and wv compute their columns of K and V, which are
  gathered over "model" (a reduce-scatter in the backward), as GSPMD
  computes a column-sharded projection whose output it needs whole.  When
  ``H % m`` the whole sublayer runs replicated.  The one-token decode step
  splits the same way over a contiguous cache laid out as
  ``dist.sharding.cache_specs`` lays it out (rows over the data axes,
  every KV head on every model rank): each rank writes the new token's
  K/V of every KV head and attends its q heads' ones.
- the dense MLP (and a MoE's shared one): wg/wu column-, wd row-parallel
  when ``d_ff % m == 0``, else replicated.
- embed and readout: vocab-parallel when ``V % m == 0`` (a masked lookup and
  an all_reduce; the cross-entropy's max, sum of exponentials and target
  logit all-reduced: :func:`vocab_ce`), else replicated (the smoke vocab of
  251).
- a MoE layer: expert parallelism, ``E / m`` experts a rank
  (``models.moe.moe_ep``): the tokens split over "model" along the
  sequence, capacity from the rank's tokens, an all_to_all out to the
  experts' ranks and one back; a sequence that ``m`` does not divide (a
  decode step's one token) stays whole on every model rank.
- a prefill batch that arrives sequence-sharded over "model"
  (``seq_shard``, the reference's ``batch_specs(seq_shard=True)``): the
  forward gathers its tokens whole, where the replicated residual starts.

Megatron's two operators carry the activations with ``all_reduce`` alone:
:func:`copy_to_model` (identity forward, all_reduce backward) where a
replicated activation enters a split region, :func:`reduce_from_model`
(all_reduce forward, identity backward) where a split region's partial
sums leave it.  So a replicated activation and its gradient are whole and
equal on every rank of "model", and a split leaf's gradient is exact on
its rank.

Each rank computes on its *compute* shard of every leaf
(:meth:`TensorParallel.compute_leaf`): the leaf's stored shard (its
``dist.sharding`` rule-table placement) where the compute splits the same
dim, else the whole leaf gathered from the stored shards, as GSPMD gathers
a leaf whose spec differs from where it is used (glm4's wk/wv at m = 4,
the norm gains, the router).  No rank builds a whole column- or
row-parallel projection, expert bank, or vocab-parallel embed or readout.
A gathered leaf's gradient is summed over "model" when each rank computed
a partial of it (K/V computed whole for split heads, the router on the
rank's tokens), and sliced back to the stored shard
(:meth:`TensorParallel.stored_grads`).

Collectives: ``all_reduce`` (sum and max), ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``all_to_all_single``, which a gloo group
takes on CUDA tensors as well (checked on the H100 by
``scripts/gloo_cuda_probe.py``; ``all_to_all`` of lists it refuses).
:data:`stats` counts the bytes each kind moves, and times them with CUDA
events while ``stats.timing`` is on.
"""
from __future__ import annotations

import contextlib
import math
import time

import torch
import torch.distributed as dist

from repro_torch import not_ported
from repro_torch.dist.sharding import _CONTAINER_ATTRS, mesh_sizes, shard_profile

_AXES = ("pod", "data", "model")

_ACTIVE = None


def current():
    """The active :class:`TensorParallel`, or None (one rank, or the
    data-parallel step)."""
    return _ACTIVE


def split(part: str):
    """The active context when it splits ``part`` (``"heads"``, ``"ff"`` or
    ``"vocab"``) over "model", else None."""
    return _ACTIVE if _ACTIVE is not None and getattr(_ACTIVE, part) else None


@contextlib.contextmanager
def active(tp):
    """Make ``tp`` the active context for the block (a module global, not
    thread-local: the backward of CUDA tensors runs on autograd's device
    thread, and a checkpointed layer's recompute runs there too)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tp
    try:
        yield tp
    finally:
        _ACTIVE = prev


# ---- collectives, counted -----------------------------------------------------------
class Stats:
    """Bytes and calls of each collective kind since :meth:`reset`; while
    ``timing`` is on, the host's time in each call (``host_ms``) and, on a
    CUDA tensor, a (start, end) CUDA event pair around it on the current
    stream (:meth:`device_ms` reads them after a synchronize)."""

    def __init__(self):
        self.timing = False
        self.reset()

    def reset(self):
        self.bytes: dict[str, int] = {}
        self.calls: dict[str, int] = {}
        self.host_ms: dict[str, float] = {}
        self.events: list = []

    @contextlib.contextmanager
    def record(self, kind: str, t: torch.Tensor):
        self.bytes[kind] = self.bytes.get(kind, 0) + t.numel() * t.element_size()
        self.calls[kind] = self.calls.get(kind, 0) + 1
        if not self.timing:
            yield
            return
        start = end = None
        if t.is_cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        yield
        self.host_ms[kind] = self.host_ms.get(kind, 0.0) + (time.perf_counter() - t0) * 1e3
        if end is not None:
            end.record()
            self.events.append((kind, start, end))

    def device_ms(self) -> dict[str, float]:
        """Milliseconds of the timed calls of each kind (synchronizes)."""
        if self.events:
            torch.cuda.synchronize()
        out: dict[str, float] = {}
        for kind, start, end in self.events:
            out[kind] = out.get(kind, 0.0) + start.elapsed_time(end)
        return out


stats = Stats()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over ``group``; ``t`` returned."""
    with stats.record("all_reduce", t):
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` concatenated along ``dim`` in rank order."""
    out = torch.empty((n * t.numel(),), dtype=t.dtype, device=t.device)
    with stats.record("all_gather", out):
        dist.all_gather_into_tensor(out, t.reshape(-1).contiguous(), group=group)
    return torch.cat(out.view(n, *t.shape).unbind(0), dim=dim)


def reduce_scatter(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The sum over the ``n`` ranks of ``t``, this rank's ``1/n`` slice of
    ``dim``."""
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=t.dtype, device=t.device)
    with stats.record("reduce_scatter", out):
        dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (n, ...): row j goes to rank j; row i of the result came from
    rank i."""
    t = t.contiguous()
    out = torch.empty_like(t)
    with stats.record("all_to_all", out):
        dist.all_to_all_single(out, t, group=group)
    return out


def _slice(t: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    w = t.shape[dim] // n
    return t.narrow(dim, r * w, w).contiguous()


# ---- autograd operators over "model" ---------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.tp.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), tp.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToModel(torch.autograd.Function):
    """This rank's 1/m slice of ``dim``; backward: the slices gathered."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _slice(x, dim, tp.m, tp.mrank)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return all_gather(g, tp.model_group, tp.m, ctx.dim), None, None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' slices concatenated along ``dim``; backward: this rank's
    slice (the gradient of a replicated activation is whole on every rank)."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return all_gather(x, tp.model_group, tp.m, dim)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return _slice(g, ctx.dim, tp.m, tp.mrank), None, None


class _GatherColumns(torch.autograd.Function):
    """The ranks' slices concatenated along ``dim``; backward: the sum over
    the ranks of the gradient, this rank's slice (each rank's gradient of
    the whole tensor is a partial: its heads' share)."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return all_gather(x, tp.model_group, tp.m, dim)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return reduce_scatter(g, tp.model_group, tp.m, ctx.dim), None, None


class _AllToAllModel(torch.autograd.Function):
    """(m, ...) rows exchanged over "model"; the backward exchanges back."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return all_to_all(x, tp.model_group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.tp.model_group), None


def copy_to_model(x, tp):
    """Identity forward, all_reduce backward over "model" (Megatron's f)."""
    return x if tp.m == 1 else _CopyToModel.apply(x, tp)


def reduce_from_model(x, tp):
    """all_reduce forward over "model", identity backward (Megatron's g)."""
    return x if tp.m == 1 else _ReduceFromModel.apply(x, tp)


def scatter_to_model(x, tp, dim: int):
    return x if tp.m == 1 else _ScatterToModel.apply(x, tp, dim)


def gather_from_model(x, tp, dim: int):
    return x if tp.m == 1 else _GatherFromModel.apply(x, tp, dim)


def gather_columns(x, tp, dim: int):
    return x if tp.m == 1 else _GatherColumns.apply(x, tp, dim)


def all_to_all_model(x, tp):
    return x if tp.m == 1 else _AllToAllModel.apply(x, tp)


# ---- vocab-parallel embed and cross-entropy -------------------------------------------
def vocab_embed(tokens: torch.Tensor, emb: torch.Tensor, tp) -> torch.Tensor:
    """Rows of a vocab-parallel table: this rank's ``V / m`` rows looked up
    where the token falls in them, zeros elsewhere, summed over "model"
    (each token's row comes from exactly one rank, so the sum is exact)."""
    V = emb.shape[0]
    ids = tokens.long() - tp.mrank * V
    hit = (ids >= 0) & (ids < V)
    rows = torch.nn.functional.embedding(ids.clamp(0, V - 1), emb)
    return reduce_from_model(rows * hit[..., None].to(rows.dtype), tp)


def vocab_ce(logits: torch.Tensor, labels: torch.Tensor, tp):
    """(logz, target logit), each (...,) f32, of logits whose vocab dim is
    split over "model" (this rank's ``V / m`` columns): the row max
    (all_reduce MAX, held constant), the sum of exponentials below it and
    the label's logit (a masked pick), each summed over "model"."""
    V = logits.shape[-1]
    mx = logits.detach().amax(dim=-1)
    all_reduce(mx, tp.model_group, dist.ReduceOp.MAX)
    se = reduce_from_model(torch.exp(logits - mx[..., None]).sum(dim=-1), tp)
    logz = torch.log(se) + mx
    ids = labels.long() - tp.mrank * V
    hit = (ids >= 0) & (ids < V)
    pick = torch.gather(logits, -1, ids.clamp(0, V - 1)[..., None])[..., 0]
    return logz, reduce_from_model(torch.where(hit, pick, torch.zeros_like(pick)), tp)


# ---- the plan ---------------------------------------------------------------------------
def _names(names) -> tuple[str, str, str]:
    """(parent, matrix, container field or "") of a leaf's path names."""
    names = [str(n) for n in names]
    field = names[-1] if names and names[-1] in _CONTAINER_ATTRS else ""
    core = [n for n in names if not n.isdigit() and n not in _CONTAINER_ATTRS]
    return (core[-2] if len(core) > 1 else ""), (core[-1] if core else ""), field


def refusal(cfg, sizes: dict, profile: str | None = None):
    """The error :class:`TensorParallel` raises for ``cfg`` on a mesh of
    ``sizes`` (``{axis: size}``) under ``profile`` (the environment's by
    default), or None: a family other than dense and moe, or another
    profile than ``tp``, at m > 1 (ROADMAP item 11b-iv)."""
    if set(sizes) - set(_AXES):
        return ValueError(f"a tensor-parallel mesh has axes {_AXES}, got {sizes}")
    profile = profile or shard_profile()
    if sizes.get("model", 1) > 1:
        if cfg.family not in ("dense", "moe"):
            return not_ported(f"tensor parallelism (MODEL > 1) for the {cfg.family} family",
                              "item 11b-iv")
        if profile != "tp":
            return not_ported(f"the {profile} profile at MODEL > 1", "item 11b-iv")
    return None


class TensorParallel:
    """One rank's view of a ``("data", "model")`` or ``("pod", "data",
    "model")`` mesh for a model config: its groups and coordinates (the
    batch's data-parallel rank runs over "pod" and "data" together, one
    flattened group), which sublayers split over "model", and the compute
    layout of every leaf.  ``seq_shard``: the forward's batch arrives with
    its sequence split over "model".  Raises where the port has no
    tensor-parallel path (:func:`refusal`, ROADMAP item 11b-iv) and, as the
    reference, for experts that ``m`` does not divide."""

    def __init__(self, cfg, mesh, *, seq_shard: bool = False):
        sizes = mesh_sizes(mesh)
        err = refusal(cfg, sizes)
        if err is not None:
            raise err
        self.cfg, self.mesh, self.seq_shard = cfg, mesh, seq_shard
        daxes = [a for a in ("pod", "data") if a in sizes]
        self.m, self.d = sizes.get("model", 1), math.prod(sizes[a] for a in daxes)
        self.model_group = mesh.get_group("model") if "model" in sizes else None
        self.mrank = mesh.get_local_rank("model") if "model" in sizes else 0
        self.drank = 0
        for a in daxes:
            self.drank = self.drank * sizes[a] + mesh.get_local_rank(a)
        if len(daxes) == 2:
            self.data_group = mesh[tuple(daxes)]._flatten().get_group()
        else:
            self.data_group = mesh.get_group(daxes[0]) if daxes else None
        m = self.m
        if cfg.num_experts and cfg.num_experts % m:
            raise ValueError(f"experts {cfg.num_experts} must divide model axis {m}")
        # which parts split over "model" (none at m = 1)
        self.heads = m > 1 and cfg.num_heads % m == 0
        self.kv = self.heads and cfg.num_kv_heads % m == 0
        self.kv_cols = self.heads and not self.kv and (cfg.num_kv_heads * cfg.hd) % m == 0
        self.ff = m > 1 and cfg.d_ff % m == 0
        self.vocab = m > 1 and cfg.vocab_size % m == 0

    # -- layout
    def split_dim(self, names, ndim: int):
        """The dim of a leaf this rank holds ``1/m`` of in the compute
        layout, or None (the leaf whole).  A serving leaf (``Packed``
        planes ``(bits, K/8, N)`` and scale ``(1, N)``, a ``QDQ``'s table)
        splits as its matrix does, except a row-parallel scale, which is
        per output column and whole; a packed bank splits its experts, dim
        0."""
        if self.m == 1:
            return None
        parent, mat, field = _names(names)
        row = None if field == "scale" else ndim - 2
        if parent == "attn":
            if mat == "wq" and self.heads or mat in ("wk", "wv") and (self.kv or self.kv_cols):
                return ndim - 1
            if mat == "wo" and self.heads:
                return row
        elif parent in ("mlp", "shared") and self.ff:
            if mat in ("wg", "wu"):
                return ndim - 1
            if mat == "wd":
                return row
        elif parent == "moe" and mat in ("wg", "wu", "wd"):
            return 0 if field else ndim - 3
        elif mat == "embed" and self.vocab:
            return ndim - 2
        elif mat == "lm_head" and self.vocab:
            return ndim - 1
        return None

    def splits_contraction(self, names, ndim: int) -> bool:
        """The leaf holds a shard of its contraction dim ``ndim - 2`` (its
        per-column scales are a max over "model")."""
        return self.split_dim(names, ndim) == ndim - 2

    def partial_over_model(self, names) -> bool:
        """A whole leaf whose gradient on each rank is a partial sum: K/V
        computed whole for split heads, the router on the rank's tokens."""
        if self.m == 1:
            return False
        parent, mat, _ = _names(names)
        return (parent == "attn" and mat in ("wk", "wv") and self.heads and not self.kv
                and not self.kv_cols or mat == "router")

    def _mesh_dims(self, placements):
        """[(mesh dim, tensor dim, size)] of the placements' shards, major to
        minor."""
        from torch.distributed.tensor import Shard

        return [(md, pl.dim, self.mesh.size(md)) for md, pl in enumerate(placements)
                if isinstance(pl, Shard) and self.mesh.size(md) > 1]

    def compute_leaf(self, names, t) -> torch.Tensor:
        """The tensor this rank computes with for the stored leaf ``t`` (a
        DTensor placed by ``dist.elastic.place``): its local shard where the
        compute splits the same dim, else the whole leaf gathered from the
        shards."""
        sd = self.split_dim(names, t.ndim)
        local, shards = t.to_local(), self._mesh_dims(t.placements)
        if sd is not None:
            model_md = list(self.mesh.mesh_dim_names).index("model")
            if shards != [(model_md, sd, self.m)]:
                raise ValueError(f"leaf {'/'.join(map(str, names))} is placed "
                                 f"{t.placements}; the compute splits dim {sd} over model")
            return local
        for md, d, n in reversed(shards):
            local = all_gather(local, self.mesh.get_group(md), n, d)
        return local

    def stored_grads(self, named, grads) -> list:
        """The gradient of each stored shard, from the compute leaves'
        gradients of this rank's loss (the mean over its data rows): summed
        over "model" where each rank computed a partial, averaged over
        "data" (one all_reduce a dtype for each), then a whole leaf's sliced
        to its stored shard.  ``named``: [(names, stored DTensor)] in the
        gradients' order."""
        from repro_torch.dist.elastic import local_slice

        grads = list(grads)
        self._bucket_reduce(grads, [i for i, (names, _) in enumerate(named)
                                    if self.partial_over_model(names)], self.model_group)
        if self.d > 1:
            self._bucket_reduce(grads, range(len(grads)), self.data_group)
            grads = [g.div_(self.d) for g in grads]
        return [g if self.split_dim(names, t.ndim) is not None
                else local_slice(g, self.mesh, t.placements).contiguous()
                for (names, t), g in zip(named, grads)]

    @staticmethod
    def _bucket_reduce(grads: list, where, group) -> None:
        """Sum ``grads[i]`` for ``i`` in ``where`` over ``group``, one
        all_reduce a dtype, replacing them in ``grads``."""
        if group is None or dist.get_world_size(group) == 1:
            return
        by_dtype: dict = {}
        for i in where:
            by_dtype.setdefault(grads[i].dtype, []).append(i)
        for idx in by_dtype.values():
            flat = all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]), group)
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                grads[i] = part.view_as(grads[i])

    def global_norm(self, named, grads) -> torch.Tensor:
        """The norm of the global gradient from this rank's stored-shard
        gradients: each distinct shard counted once, each replicated leaf
        once (a shard's square sum divided by the ranks that hold a copy)."""
        world = self.m * self.d
        per_copies: dict[int, torch.Tensor] = {}
        for (_, t), g in zip(named, grads):
            copies = world // math.prod(n for _, _, n in self._mesh_dims(t.placements))
            sq = torch.sum(torch.square(g.float()))
            per_copies[copies] = per_copies[copies] + sq if copies in per_copies else sq
        keys = sorted(per_copies)
        vec = torch.stack([per_copies[c] for c in keys])
        for group in (self.model_group, self.data_group):
            if group is not None and dist.get_world_size(group) > 1:
                all_reduce(vec, group)
        return torch.sqrt(sum(v / c for v, c in zip(vec, keys)))

    def kv_whole(self, t: torch.Tensor, all_heads: bool = False) -> torch.Tensor:
        """K or V (..., columns) from this rank's compute leaf of wk or wv ->
        the columns its heads need: every column, gathered over "model",
        under ``kv_cols`` (a shard's columns cut heads) and, when
        ``all_heads`` (the decode step's write into a cache that holds
        every KV head), under ``kv``; else ``t``."""
        if self.kv_cols or self.kv and all_heads:
            return gather_columns(t, self, t.ndim - 1)
        return t

    def mean_over_data(self, t: torch.Tensor) -> torch.Tensor:
        if self.d > 1:
            all_reduce(t, self.data_group)
            t.div_(self.d)
        return t

    def max_over_model(self, scales) -> None:
        """Per-column scales of leaves whose K is split over "model": the max
        over the ranks, in place, one all_reduce for all of them."""
        if self.m == 1 or not scales:
            return
        flat = torch.cat([s.reshape(-1) for s in scales])
        all_reduce(flat, self.model_group, dist.ReduceOp.MAX)
        for s, part in zip(scales, flat.split([s.numel() for s in scales])):
            s.copy_(part.view_as(s))

    # -- attention
    def kv_for_heads(self, k: torch.Tensor, H: int) -> torch.Tensor:
        """K or V (B, S, heads, hd) -> the KV heads this rank's ``H / m`` q
        heads read, in the order ``blocked_attention`` groups them: the
        local heads when K/V were computed split (from all the KV heads,
        the local ones), else, from the whole KV heads, the slice (or, when
        neither of ``H / m`` and the group size divides the other, one KV
        head per q head) of each local q head's global index
        ``h // (H / KV)``."""
        KV = k.shape[2]
        if self.kv:
            if KV == self.cfg.num_kv_heads:
                n = KV // self.m
                return k.narrow(2, self.mrank * n, n)
            return k
        n, G = H // self.m, H // KV
        a = self.mrank * n
        if G % n == 0:
            return k[:, :, a // G:a // G + 1]
        if n % G == 0:
            return k[:, :, a // G:a // G + n // G]
        idx = torch.tensor([(a + i) // G for i in range(n)], device=k.device)
        return k.index_select(2, idx)
