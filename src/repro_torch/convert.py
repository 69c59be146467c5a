"""Carry the JAX package's parameters into the port.

``repro_torch`` cannot draw ``jax.random`` numbers, so a run that must
agree with the reference takes the reference's own weights.  The caller
hands them over as nested dicts and lists of numpy arrays (the only form
both packages read), with each quantized leaf written out as a plain
dict:

- a ``repro.quant.pack.Packed`` as ``{"planes", "scale", "bits"}``,
- a ``repro.quant.pack.QDQ`` as ``{"w", "bits"}``.

:func:`params_from_numpy` maps that tree onto the port's: the training
layout (stacked ``blocks``) and the serving layout (per-layer lists,
``Packed`` and ``QDQ`` leaves) alike.  bfloat16 arrays (numpy dtype name
``bfloat16``) go through float32, which is exact both ways.  A ``QDQ``
embedding gets its quantize-dequantize value computed once, as
``train.serve.quantize_for_serving`` does.
"""
from __future__ import annotations

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
