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
