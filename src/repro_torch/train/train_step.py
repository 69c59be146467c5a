"""QAT train/eval step factories (torch port of ``repro.train.train_step``).

``step(state, batch, bits_map) -> (new state, metrics)``:
  1. QDQ every quantizable weight group at its bitwidth: the paper's WRPN
     technique with STE, all the groups' leaves in one grouped launch
     (``quant.qat.quantize_params``), so "short retrain" inside the ReLeQ
     environment is just N of these steps at the candidate policy;
  2. forward + backward with the configured remat policy;
  3. AdamW update (fp32 or 8-bit moments).

``bits_map`` holds int32 tensors on the card (``quant.qat.bits_to_device``;
host values are copied there at each call): a new policy is new data,
never a new code path.

The step returns a new state like the reference's, whose jit donates the
old one: here the old state's fp32 moments are updated in place
(``optim.adamw``), its params are kept.  The metrics ``{"loss",
"grad_norm", "nll", "aux"}`` are 0-d tensors on the device (reading one
is the caller's host sync).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import collectives
from repro_torch.dist.elastic import local_slice, mesh_device, place, whole
from repro_torch.dist.sharding import P, map_tree, placements_of
from repro_torch.optim.adamw import AdamW, global_norm, tree_leaves, tree_unflatten
from repro_torch.quant.qat import get_by_path, quantize_params


def init_state(model, optimizer: AdamW, seed: int = 0, device=None) -> dict:
    params = model.init(seed, device=device)
    return {"params": params, "opt": optimizer.init(params)}


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays (the data pipeline's) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) if not isinstance(v, torch.Tensor)
            else v.to(device) for k, v in batch.items()}


def make_train_step(model, optimizer: AdamW, *, remat: str = "none"):
    groups = model.quant_groups()

    def step(state, batch, bits_map):
        params = state["params"]
        dev = _device_of(params)
        batch = batch_to(batch, dev)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            qp = quantize_params(tree_unflatten(params, leaves), bits_map, groups)
            loss, metrics = model.loss(qp, batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves)
        del qp
        grads = tree_unflatten(params, list(grads))
        new_params, new_opt = optimizer.update(params, grads, state["opt"])
        out = {"loss": loss.detach(), "grad_norm": global_norm(tree_leaves(grads)),
               **{k: v.detach() for k, v in metrics.items()}}
        return {"params": new_params, "opt": new_opt}, out

    return step


def _from_local(local, like):
    """``local`` (this rank's piece) placed as the DTensor ``like`` is;
    ``local`` itself when ``like`` is a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return local
    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def _placed_like(full, like):
    """The whole tensor ``full`` placed as ``like`` is: this rank's slice."""
    if hasattr(like, "device_mesh"):
        full = local_slice(full, like.device_mesh, like.placements).contiguous()
    return _from_local(full, like)


def _map_state(fn, tree, *like):
    """``fn(leaf, *like_leaves)`` over the tensor leaves of a params or
    optimizer tree (``QTensor`` fields included); host ints pass."""
    return map_tree(lambda _, x, *y: fn(x, *y) if isinstance(x, torch.Tensor) else x,
                    tree, *like)


def local_rows(batch: dict, rank: int, n: int) -> dict:
    """Rows ``[rank·B/n, (rank+1)·B/n)`` of every leaf of a global batch (the
    batch dim: dim 1 of a 3-D ``positions``, dim 0 elsewhere).  A leaf
    placed as a DTensor (``dist.sharding.batch_specs``) is this rank's
    shard already: its local tensor."""
    from torch.distributed.tensor import DTensor

    out = {}
    for k, v in batch.items():
        if isinstance(v, DTensor):
            out[k] = v.to_local()
            continue
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        bdim = 1 if k == "positions" and v.ndim == 3 else 0
        B = v.shape[bdim]
        if B % n:
            raise ValueError(f"batch {k!r} has {B} rows, not divisible over {n} ranks")
        out[k] = v.narrow(bdim, rank * (B // n), B // n)
    return out


def make_dp_train_step(model, optimizer: AdamW, mesh, *, axis: str = "data",
                       planes: int = 2, remat: str = "none"):
    """Pure data-parallel QAT train step with a *compressed* gradient
    all-reduce (``dist.collectives.compressed_allreduce_tree``, the
    two-phase construction: fp8 planes + error feedback) in place of the
    exact mean.

    Every rank of ``mesh``'s ``axis`` runs the step: params and moments are
    replicated (a leaf placed sharded is gathered whole for the step and
    its new value placed as the old one was, as the reference's
    ``shard_map(in_specs=P())`` does), each rank takes rows
    ``[r·B/n, (r+1)·B/n)`` of the global batch, runs the local loss and
    backward through ``quantize_params``, then the gradients cross the wire
    as ``planes`` fp8 payloads an element.  What the last plane could not represent is carried per rank
    in ``state["ef"]`` (a DTensor with a leading axis of the rank count,
    each rank holding its row) and folded into the next step.  Loss and
    metrics are averaged over the group, then AdamW runs.  ``planes=0`` is
    the exact mean (``all_reduce`` / n, the wire-byte baseline); its state
    may carry no ``ef`` (``launch/train.py --mesh``'s), else zeros.

    Params and moments are DTensors (``dist.elastic.place``) or plain
    tensors, ``ef`` DTensors (:func:`init_dp_state`); the new state is
    placed as the old one was.  The step signature matches
    :func:`make_train_step`'s."""
    groups = model.quant_groups()
    group = mesh.get_group(axis)
    n = mesh.size(list(mesh.mesh_dim_names).index(axis))
    rank = dist.get_rank(group)

    def step(state, batch, bits_map):
        params = _map_state(whole, state["params"])
        opt = _map_state(whole, state["opt"])
        dev = _device_of(params)
        batch = batch_to(local_rows(batch, rank, n), dev)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            qp = quantize_params(tree_unflatten(params, leaves), bits_map, groups)
            loss, metrics = model.loss(qp, batch, remat=remat)
            grads = list(torch.autograd.grad(loss, leaves))
        del qp, leaves
        ef_like = state.get("ef")
        if planes:
            if ef_like is None:
                raise ValueError("a compressed step (planes > 0) needs state['ef'] "
                                 "(init_dp_state)")
            ef = [e.to_local()[0] for e in tree_leaves(ef_like)]
            grads, ef = collectives.compressed_allreduce_tree(
                grads, group, residuals=ef, planes=planes, axis_size=n)
            new_ef = tree_unflatten(ef_like, [
                _from_local(f.unsqueeze(0), e) for f, e in zip(ef, tree_leaves(ef_like))])
        else:   # the exact mean
            for g in grads:
                dist.all_reduce(g, group=group)
                g.div_(n)
            new_ef = ef_like
        means = {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}
        for v in means.values():
            dist.all_reduce(v, group=group)
            v.div_(n)
        grads = tree_unflatten(params, grads)
        new_params, new_opt = optimizer.update(params, grads, opt)
        out = {"loss": means.pop("loss"), "grad_norm": global_norm(tree_leaves(grads)), **means}
        new_state = {"params": _map_state(_placed_like, new_params, state["params"]),
                     "opt": _map_state(_placed_like, new_opt, state["opt"])}
        if new_ef is not None:
            new_state["ef"] = new_ef
        return new_state, out

    return step


def make_tp_train_step(model, optimizer: AdamW, mesh, *, remat: str = "none"):
    """The QAT train step sharded over a ``("data", "model")`` mesh, the
    reference's GSPMD step under ``jax.set_mesh`` with the ``tp`` profile
    (``dist.tp``): tensor-parallel attention and MLP, vocab-parallel embed
    and readout, expert-parallel MoE layers (``models.moe.moe_ep``, at any
    mesh: a ``(D, 1)`` mesh routes each rank's tokens flattened, as the
    reference's does).

    ``state`` is placed on ``mesh`` under ``dist.sharding.state_specs``
    (``dist.elastic.place``).  Each rank takes its "data" rows of the batch
    (:func:`local_rows`), builds its compute shard of every leaf
    (``TensorParallel.compute_leaf``), QDQs them (the per-column scales of a
    leaf whose contraction dim is split taken as the max over "model"), runs
    the loss and its backward under the active context, reduces each
    leaf's gradient over exactly the ranks that computed a partial of it
    and averages it over "data" (``stored_grads``), clips by the global
    norm (each distinct shard counted once) and updates its stored shards
    with AdamW.  Loss and metrics are the mean over "data" (equal on the
    ranks of "model").  8-bit moments are refused across ranks: a
    column-parallel shard cuts their 256-wide blocks (ROADMAP item 11b-iv).
    The step signature matches :func:`make_train_step`'s; ``step.grads(params,
    batch, bits_map)`` returns (metrics, the stored shards' gradients in
    leaf order, the global norm) without the update, and ``step.tp`` is the
    ``TensorParallel``."""
    from repro_torch.dist import tp as tpm
    from repro_torch.dist.sharding import named_leaves
    from repro_torch.quant.qat import _paths_index

    tp = tpm.TensorParallel(model.cfg, mesh)
    err = tp_step_refusal(optimizer, tp.m * tp.d)
    if err is not None:
        raise err
    groups = model.quant_groups()
    paths = _paths_index(groups)

    def grads(params, batch, bits_map):
        """-> (metrics, this rank's stored-shard gradients in leaf order,
        the global norm) for placed ``params``."""
        from torch.distributed.tensor import DTensor

        named = named_leaves(params)
        if not all(isinstance(t, DTensor) for _, t in named):
            raise ValueError("make_tp_train_step takes a state placed on its mesh "
                             "(dist.elastic.place)")
        leaves = [tp.compute_leaf(names, t).detach().requires_grad_(True) for names, t in named]
        comp = tree_unflatten(params, leaves)
        split = {k for k in bits_map
                 if tp.splits_contraction(paths[k], get_by_path(comp, paths[k]).ndim)}
        batch = batch_to(local_rows(batch, tp.drank, tp.d), leaves[0].device)
        with tpm.active(tp), torch.enable_grad():
            qp = quantize_params(comp, bits_map, groups, split, tp.max_over_model)
            loss, metrics = model.loss(qp, batch, remat=remat)
            g = torch.autograd.grad(loss, leaves)
        del qp, comp, leaves
        g = tp.stored_grads(named, g)
        means = {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}
        return {k: tp.mean_over_data(v) for k, v in means.items()}, g, tp.global_norm(named, g)

    def step(state, batch, bits_map):
        means, g, norm = grads(state["params"], batch, bits_map)
        local = _map_state(lambda t: t.to_local(), state["params"])
        new_params, new_opt = optimizer.update(
            local, tree_unflatten(local, g), _map_state(lambda t: t.to_local(), state["opt"]),
            norm=norm)
        out = {"loss": means.pop("loss"), "grad_norm": norm, **means}
        return {"params": _map_state(_from_local, new_params, state["params"]),
                "opt": _map_state(_from_local, new_opt, state["opt"])}, out

    step.grads = grads
    step.tp = tp
    return step


def tp_step_refusal(optimizer: AdamW, ranks: int):
    """The error :func:`make_tp_train_step` raises for ``optimizer`` over
    ``ranks`` ranks, or None: 8-bit moments across ranks, whose 256-wide
    blocks a column-parallel shard cuts (ROADMAP item 11b-iv)."""
    from repro_torch import not_ported

    if optimizer.moments == "int8" and ranks > 1:
        return not_ported("8-bit moments (--opt8) under the tensor-parallel step on more than "
                          "one rank", "item 11b-iv")
    return None


def init_dp_state(model, optimizer: AdamW, seed: int, mesh, axis: str = "data") -> dict:
    """Train state for :func:`make_dp_train_step`, placed on ``mesh``'s
    device: params and moments under ``dist.sharding.state_specs``, plus the
    error-feedback tree (:func:`add_error_feedback`)."""
    state = init_state(model, optimizer, seed, device=mesh_device(mesh))
    return add_error_feedback(place(state, mesh), mesh, axis)


def add_error_feedback(state: dict, mesh, axis: str = "data") -> dict:
    """``state`` with the per-rank error-feedback tree ``ef`` added: f32
    zeros in the params' layout behind a leading axis of the rank count,
    sharded over ``axis`` (each rank holds its row)."""
    from torch.distributed.tensor import DTensor

    dev = mesh_device(mesh)
    n = mesh.size(list(mesh.mesh_dim_names).index(axis))
    pl = placements_of(P(axis), mesh)

    def zeros(p):
        shape = (n,) + tuple(p.shape)
        local = torch.zeros((1,) + tuple(p.shape), dtype=torch.float32, device=dev)
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    params = state["params"]
    return {**state, "ef": tree_unflatten(params, [zeros(p) for p in tree_leaves(params)])}


def make_eval_step(model):
    """Eval NLL of a *quantized* model: the ReLeQ accuracy-proxy input."""
    groups = model.quant_groups()

    @torch.no_grad()
    def step(params, batch, bits_map):
        dev = _device_of(params)
        qp = quantize_params(params, bits_map, groups)
        _, metrics = model.loss(qp, batch_to(batch, dev))
        return metrics["nll"]

    return step


def make_fp_eval_step(model):
    @torch.no_grad()
    def step(params, batch):
        _, metrics = model.loss(params, batch_to(batch, _device_of(params)))
        return metrics["nll"]

    return step

