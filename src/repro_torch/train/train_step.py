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

from repro_torch import not_ported
from repro_torch.optim.adamw import AdamW, global_norm, tree_leaves, tree_unflatten
from repro_torch.quant.qat import quantize_params


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


def make_dp_train_step(*args, **kwargs):
    """Data parallelism with a compressed gradient all-reduce needs the
    port's ``dist`` (ROADMAP queue 1, item 11)."""
    raise not_ported("make_dp_train_step (data-parallel QAT)", "slice D, item 11")


def init_dp_state(*args, **kwargs):
    raise not_ported("init_dp_state (data-parallel QAT)", "slice D, item 11")


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

