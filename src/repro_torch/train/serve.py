"""Serving transform (torch port of ``repro.train.serve``): pack ReLeQ's
bitwidths into bitplane weights.

``quantize_for_serving`` turns training-layout params + a QuantPolicy into
the serving layout:

- a per-layer LIST under ``params["blocks"][0]`` (each layer's packed
  buffers keep their own bitwidth),
- every packable matrix replaced by ``Packed(planes (bits, K//8, N)
  uint8, scale (1, N) f32, bits)``; ``bits >= 16`` stays dense,
- the embedding kept dense but wrapped as ``QDQ(w, bits, value)``.  The
  reference re-quantizes the whole ``(V, D)`` table on every lookup;
  here ``value = fake_quant(w, bits, axis=0)`` is computed once, with
  bitwise the same result,
- norms untouched.

Packing runs layer by layer on ``device`` (the card unless
``device="cpu"``), so a full-width model never holds more than one f32
copy of one matrix beside its masters.  The step builders of the
reference (``make_decode_step`` and friends) wrap ``jax.jit`` and have no
counterpart: the engine calls the model's methods directly.
"""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.quant.pack import QDQ, Packed, pack_weight
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qat import get_by_path, set_by_path
from repro_torch.quant.wrpn import FP_BITS, fake_quant


def _pack_matrix(w, bits: int, device):
    if bits >= 16:  # not worth packing; serve dense
        return w.to(device)
    planes, scale = pack_weight(w.to(device).float(), bits)
    return Packed(planes, scale, bits)


def _layer(tree, l: int, device):
    """Layer ``l`` of a stacked subtree, on ``device``."""
    if isinstance(tree, dict):
        return {k: _layer(v, l, device) for k, v in tree.items()}
    return tree[l].to(device)


def quantize_for_serving(model, params, policy: QuantPolicy, device=None) -> dict:
    device = resolve_device(device)
    stacked = params["blocks"][0]
    layers = [_layer(stacked, l, device) for l in range(model.cfg.num_layers)]
    out = {key: val for key, val in params.items() if key != "blocks"}
    out["final_norm"] = params["final_norm"].to(device)
    for g in model.quant_groups():
        bits = policy.get(g.name)
        if g.path[0] == "blocks":
            rest = g.path[2:]
            w = get_by_path(stacked, rest)[g.layer]
            layers[g.layer] = set_by_path(layers[g.layer], rest,
                                          _pack_matrix(w, bits, device))
        elif g.path == ("embed",):
            emb = params["embed"].to(device)
            out["embed"] = (QDQ(emb, bits, fake_quant(emb, bits, axis=0))
                            if bits < FP_BITS else emb)
        elif g.path == ("lm_head",):
            out["lm_head"] = _pack_matrix(params["lm_head"], bits, device)
        else:  # pragma: no cover - future group kinds
            raise ValueError(f"no serving transform for group {g.name}")
    out["blocks"] = [layers]
    return out
