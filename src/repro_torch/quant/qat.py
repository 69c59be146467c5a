"""QAT parameter transform, torch port of ``repro.quant.qat``: the WRPN
STE fake-quant of every quantizable group at its policy bitwidth, with the
bitwidths as DATA (int32 tensors on the card), so a policy candidate
changes no code path and no value leaves the device.

Paths are string keys ``"blocks/0/attn/wq"``; leaves with a stacked layer
axis get a per-layer bits vector, an expert bank ``(L, E, K, N)`` too:
its ``(L,)`` bits reach the kernel as they are, each shared by the E
experts of its layer, as the reference's ``_qdq`` broadcasts them.
:func:`quantize_params` quantizes every leaf of the bits map at its
per-output-column scale in ONE grouped launch
(``quant.wrpn.fake_quant_ste_group_col``), and its backward is one more.

The reference's mesh branch annotates each leaf's QDQ with its rule-table
spec inside a GSPMD step, which computes it on the stored shards.  Here
the tensor-parallel step (``train.train_step.make_tp_train_step``) hands
each rank's compute shards in, and names in ``split`` the leaves whose
contraction dim is split across ranks (a row-parallel ``wo``/``wd``, a
vocab-parallel ``embed``): their scales are the max over those ranks
(``reduce_max``), so each rank's QDQ is bitwise its shard of the whole
leaf's.  The data-parallel step replicates the params and needs none.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.wrpn import FP_BITS, fake_quant_ste_group_col


def path_key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def get_by_path(tree, path: tuple):
    node = tree
    for p in path:
        node = node[p]
    return node


def set_by_path(tree, path: tuple, value):
    """Functional set returning a shallow-copied tree along the path."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    new = list(tree) if isinstance(tree, list) else dict(tree)
    new[head] = set_by_path(tree[head], rest, value)
    return new


def bits_assignment(groups, policy: QuantPolicy) -> dict[str, np.ndarray]:
    """QuantPolicy -> {path_key: int32 () or (L_stack,) array} (host numpy,
    as the reference returns it; :func:`bits_to_device` moves it)."""
    per_path: dict[tuple, dict | int] = {}
    for g in groups:
        b = policy.get(g.name)
        if g.layer is None:
            per_path[g.path] = b
        else:
            per_path.setdefault(g.path, {})[g.layer] = b
    out = {}
    for path, v in per_path.items():
        if isinstance(v, dict):
            L = max(v) + 1
            arr = np.full((L,), FP_BITS, np.int32)
            for i, b in v.items():
                arr[i] = b
            out[path_key(path)] = arr
        else:
            out[path_key(path)] = np.int32(v)
    return out


def bits_to_device(bits_map: dict, device) -> dict[str, torch.Tensor]:
    """A bits map as int32 tensors on ``device`` (one copy per leaf, made
    once per policy)."""
    return {k: torch.as_tensor(np.asarray(v, np.int32), device=device)
            for k, v in bits_map.items()}


def _paths_index(groups):
    """path_key -> path tuple (stable order)."""
    return {path_key(g.path): g.path for g in groups}


def quantize_params(params, bits_map: dict, groups, split=(), reduce_max=None):
    """Return params with every group's leaf QDQ'd at its bitwidth and
    per-output-column scale (max|w| over dim ``ndim - 2``, the matrix
    contraction dim, under any stacking of layer axes: the codes the
    bitplane serving path packs), all the leaves of ``bits_map`` in one
    grouped forward launch.  ``bits_map`` values: int32 tensors on the
    params' device (:func:`bits_to_device`), or host ints/arrays.  The
    leaves keyed in ``split`` hold a shard of their contraction dim: their
    scales are ``reduce_max`` of the shard's (the max over the ranks that
    hold the others) before their QDQ."""
    idx = _paths_index(groups)
    keys = list(bits_map)
    leaves = [get_by_path(params, idx[k]) for k in keys]
    if not leaves:
        return params
    qdq = fake_quant_ste_group_col(leaves, [bits_map[k] for k in keys],
                                   [k in split for k in keys], reduce_max)
    new = params
    for k, q in zip(keys, qdq):
        new = set_by_path(new, idx[k], q)
    return new


def policy_for(model, default_bits: int = 8) -> QuantPolicy:
    """Fresh all-``default_bits`` policy with the model's frozen groups."""
    groups = model.quant_groups()
    return QuantPolicy(
        tuple(g.name for g in groups),
        {g.name: default_bits for g in groups},
        default_bits=default_bits,
        frozen=model.frozen_bits(),
    )
