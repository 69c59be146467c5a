"""Carry the JAX package's parameters into the port.

``repro_torch`` cannot draw ``jax.random`` numbers, so a run that must
agree with the reference takes the reference's own weights.  The caller
hands them over as nested dicts and lists of numpy arrays (the only form
both packages read), with each quantized leaf written out as a plain
dict:

- a ``repro.quant.pack.Packed`` as ``{"planes", "scale", "bits"}``,
- a ``repro.quant.pack.QDQ`` as ``{"w", "bits"}``.

:func:`params_from_numpy` maps that tree onto the port's: the training
layout (stacked ``blocks``: a list of stacked subtrees, or RWKV's one
stacked dict; hymba's ``ssm`` subtree and 0-d ``mix`` with them) and the
serving layout (per-layer lists, ``Packed`` and ``QDQ`` leaves) alike.
A MoE model's ``blocks`` is a list of ``n_sub`` stacked subtrees (the
MoE sub last, its router f32) in the training layout and ``n_sub``
per-layer lists in the serving layout, where an expert bank is a
``Packed`` with 4-D planes ``(E, bits, K//8, N)`` and scales ``(E, 1,
N)``; the walk carries each as it is.  bfloat16 arrays (numpy dtype name
``bfloat16``) go through float32, which is exact both ways.  A ``QDQ``
embedding gets its quantize-dequantize value computed once, as
``train.serve.quantize_for_serving`` does.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.quant.pack import QDQ, Packed
from repro_torch.quant.wrpn import fake_quant


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_numpy(tree, device=None):
    """Nested dicts/lists of numpy arrays (reference layout) -> the port's
    params on ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"planes", "scale", "bits"}:
                return Packed(tensor_from_numpy(node["planes"], device),
                              tensor_from_numpy(node["scale"], device),
                              int(node["bits"]))
            if set(node) == {"w", "bits"}:
                w = tensor_from_numpy(node["w"], device)
                bits = int(node["bits"])
                return QDQ(w, bits, fake_quant(w, bits, axis=0))
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return tensor_from_numpy(node, device)

    return walk(tree)


def cnn_params_from_numpy(tree, device=None):
    """Reference CNN params ``{layer: {"w", "b"}}`` as numpy -> the port's
    (``cnn.models``): conv weights HWIO ``(k, k, c_in, c_out)`` -> OIHW,
    depthwise ``(k, k, 1, c)`` -> ``(c, 1, k, k)`` (the same permutation);
    fc weights and biases unchanged."""
    device = resolve_device(device)
    out = {}
    for name, p in tree.items():
        w = tensor_from_numpy(p["w"], device)
        if w.ndim == 4:
            w = w.permute(3, 2, 0, 1).contiguous()
        out[name] = {"w": w, "b": tensor_from_numpy(p["b"], device)}
    return out


def agent_params_from_numpy(tree, device=None):
    """Reference agent params (``core.agent.init_agent``'s nested dict) as
    numpy -> the port's: the same layout, as tensors on ``device``."""
    device = resolve_device(device)
    return {k: {n: tensor_from_numpy(a, device) for n, a in p.items()}
            for k, p in tree.items()}


def _jax_order(tree, path=()):
    """(path, tensor) of a params tree in ``jax.tree`` flatten order:
    dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_order(tree[k], (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_order(v, (*path, str(i)))
    else:
        yield path, tree


def is_jax_checkpoint(path: str) -> bool:
    """A step directory the reference's ``repro.ckpt.save`` wrote."""
    return os.path.exists(os.path.join(path, "treedef.pkl"))


def params_from_jax_checkpoint(directory: str, model, step: int | None = None,
                               device=None):
    """-> (params, meta, step): the training-layout params of a checkpoint
    that the reference's trainer saved under ``directory`` (the newest
    complete step for ``step=None``), on ``device`` (the card unless
    ``device="cpu"``).

    The model's own ``init`` gives the template; its leaves, in
    ``jax.tree`` order, are matched to the checkpoint's last leaves, each
    shape and dtype checked against the manifest (a mismatch raises and
    names the leaf), and overwritten in place.  bfloat16 and float8
    leaves, which the reference stores as raw void bytes, are viewed as
    their bits and then as the torch dtype, exactly.  The pickled treedef
    is never read."""
    from repro_torch.ckpt.checkpoint import step_path

    device = resolve_device(device)
    step, path = step_path(directory, step)
    if not is_jax_checkpoint(path):
        raise ValueError(f"{path} was not written by the reference's repro.ckpt")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    params = model.init(seed=0, device=device)
    leaves = list(_jax_order(params))
    first = manifest["num_leaves"] - len(leaves)
    if first < 0:
        raise ValueError(f"{path} holds {manifest['num_leaves']} leaves, fewer than the "
                         f"model's {len(leaves)} parameters")
    with np.load(os.path.join(path, "leaves.npz")) as data:
        for i, (name, leaf) in enumerate(leaves, start=first):
            want = manifest["leaves"][i]
            dtype = str(leaf.dtype).removeprefix("torch.")
            if tuple(want["shape"]) != tuple(leaf.shape) or want["dtype"] != dtype:
                raise ValueError(
                    f"leaf {'/'.join(name)} (checkpoint leaf {i}): the checkpoint holds "
                    f"{tuple(want['shape'])} {want['dtype']}, the model's template "
                    f"{tuple(leaf.shape)} {dtype}")
            arr = data[f"leaf_{i}"]
            if arr.dtype.kind == "V":   # bfloat16 / float8 as raw bytes
                raw = np.ascontiguousarray(arr).view({2: np.int16, 1: np.uint8}[arr.itemsize])
                src = torch.from_numpy(raw).view(leaf.dtype)
            else:
                src = torch.from_numpy(np.ascontiguousarray(arr))
            leaf.copy_(src)
    return params, manifest["meta"], step
