"""Stand-ins for every model input on the meta device (torch twin of
``repro.launch.specs``): no allocation.

The reference builds ``jax.ShapeDtypeStruct`` pytrees with
``jax.eval_shape``.  Here a stand-in is a tensor on ``torch.device("meta")``:
a shape and a dtype with no storage, made by running the port's own
builders there -- ``model.init``, ``train.serve.quantize_for_serving`` and
``model.init_cache`` -- which draw nothing on meta (``models.common.
generator``) and read no values.  Every kernel entry point takes meta
inputs too (``kernels.ops``), so a model's step runs on them whole; that
is what ``launch.op_costs.count_costs`` counts.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.optim.adamw import tree_leaves

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """One stand-in: ``shape`` of ``dtype`` (a torch dtype or its name)."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_struct(cfg: ModelConfig, shape: ShapeConfig, *, train: bool) -> dict:
    B, S = shape.global_batch, shape.seq_len
    out = {}
    if cfg.frontend:  # stub modality frontend: precomputed embeddings
        out["embeds"] = sds((B, S, cfg.d_model), cfg.dtype)
    else:
        out["tokens"] = sds((B, S), torch.int32)
    if cfg.rope == "mrope":
        out["positions"] = sds((3, B, S), torch.int32)
    if train:
        out["labels"] = sds((B, S), torch.int32)
    return out


def params_struct(model):
    return model.init(device=META)


def serving_params_struct(model, policy):
    from repro_torch.train.serve import quantize_for_serving

    return quantize_for_serving(model, params_struct(model), policy, device=META)


def cache_struct(model, batch: int, max_len: int):
    return model.init_cache(batch, max_len=max_len, device=META)


def decode_structs(model, shape: ShapeConfig, policy):
    """(serving params, cache, one-token batch) stand-ins for
    ``model.decode_step``."""
    sparams = serving_params_struct(model, policy)
    cache = cache_struct(model, shape.global_batch, shape.seq_len)
    # decode against a *full* cache (length = seq_len context)
    tokens = sds((shape.global_batch, 1), torch.int32)
    return sparams, cache, tokens


def count_params(model) -> int:
    return sum(math.prod(x.shape) for x in tree_leaves(params_struct(model)))


def active_params(cfg: ModelConfig, model) -> int:
    """Per-token active parameters (MoE: routed k of E)."""
    total = count_params(model)
    if not cfg.num_experts:
        return total
    groups = model.quant_groups()
    bank = sum(g.n_weights for g in groups if "/moe/" in "/".join(map(str, g.path))
               or "moe." in g.name)
    return int(total - bank + bank * cfg.experts_per_token / cfg.num_experts)
