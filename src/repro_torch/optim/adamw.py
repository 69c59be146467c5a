"""AdamW from scratch (torch port of ``repro.optim.adamw``), with fp32 or
block-wise 8-bit moments.

The reference's math and order of operations, which ``torch.optim.AdamW``
does not share (its ``b2`` is 0.999, it has no global-norm clip, and it
decays the weights before the moment update):

    g   <- g * min(1, clip / max(‖g‖, 1e-9))          (global norm, all leaves)
    m   <- b1 m + (1 - b1) g ;  v <- b2 v + (1 - b2) g²
    u   <- (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) [+ wd p]
    p   <- p - lr(t) u

Functional like the reference: ``init(params) -> state`` and
``update(params, grads, state) -> (params, state)`` over nested dicts and
lists of tensors, leaves in the order ``jax.tree`` flattens them (dict
keys sorted, list items in order).  The step counter is a host int, the
bias corrections and a schedule's learning rate are f32 values computed
on the host, as the reference's ``step.astype(float32)`` arithmetic is.
Nothing leaves the device: the clip scale stays a 0-d tensor.

``moments="int8"`` stores both moments as ``quant.int8_opt.QTensor``
(fp8 codes + per-block f32 scales; the second moment in sqrt space),
dequantized, updated and requantized leaf by leaf.

Memory: the reference's train step donates its state, so the old
moments die as the new ones are made.  Here the fp32 moments are updated
in place (the old state's ``m`` and ``v`` are consumed), with the
reference's roundings (``b1 m``, ``(1 - b1) g`` and their sum, each
rounded to f32), and each gradient is clipped as its leaf is reached; new
params are new tensors.  At the 4-layer glm4-9b cell (2.06 B params) a
functional update would hold two sets of f32 moments, 33 GB, and did not
fit the 80 GB card beside the step's other buffers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.quant.int8_opt import (
    dequantize_state,
    dequantize_state_sq,
    quantize_state,
    quantize_state_sq,
)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts and lists, in ``jax.tree`` order: dict keys
    sorted at every level, list and tuple items in order.  Anything else
    (a tensor, a ``QTensor``, an int) is a leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """Rebuild ``like``'s nesting from leaves in :func:`tree_leaves` order."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it)

    return walk(like)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up, then cosine decay to ``floor * base_lr``; ``lr(step)``
    -> a Python float holding the f32 value the reference computes."""
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return float(torch.where(step < warmup, warm, cos))
    return lr


def linear_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return float(torch.where(step < warmup, warm, base_lr * (1 - t)))
    return lr


def global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def _f32_pow(base: float, step: int) -> float:
    return float(torch.tensor(base, dtype=torch.float32) ** float(step))


@dataclass(frozen=True)
class AdamW:
    lr: object = 1e-3                 # float or schedule fn(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = 1.0
    moments: str = "fp32"             # fp32 | int8
    # The reference chains its per-leaf updates through barriers under jit
    # so that one leaf's f32 transients die before the next starts.  Eager
    # torch updates leaf by leaf already, so the field changes nothing here;
    # it is kept so that configurations carry over.
    sequential: bool | None = None

    def __post_init__(self):
        if self.moments not in ("fp32", "int8"):
            raise ValueError(f"moments must be 'fp32' or 'int8', got {self.moments!r}")

    def _lr(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else self.lr

    def init(self, params) -> dict:
        def zeros(q):
            z = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in tree_leaves(params)]
            if self.moments == "int8":
                z = [q(x) for x in z]
            return tree_unflatten(params, z)
        return {"m": zeros(quantize_state), "v": zeros(quantize_state_sq), "step": 0}

    @torch.no_grad()
    def update(self, params, grads, opt, norm=None):
        """``norm``: the global gradient norm to clip by, when ``grads`` are
        one rank's shards of it (the tensor-parallel step); else taken over
        ``grads``."""
        step = opt["step"] + 1
        lr = self._lr(step)
        g_leaves = tree_leaves(grads)
        scale = None
        if self.clip_norm is not None:
            gn = global_norm(g_leaves) if norm is None else norm
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        int8 = self.moments == "int8"
        c1 = 1 - _f32_pow(self.b1, step)
        c2 = 1 - _f32_pow(self.b2, step)
        new_p, new_m, new_v = [], [], []
        for p, g, mm, vv in zip(tree_leaves(params), g_leaves, tree_leaves(opt["m"]),
                                tree_leaves(opt["v"])):
            gf = (g if scale is None else g * scale).float()
            if int8:
                mm = self.b1 * dequantize_state(mm) + (1 - self.b1) * gf
                vv = self.b2 * dequantize_state_sq(vv) + (1 - self.b2) * torch.square(gf)
            else:
                mm = mm.mul_(self.b1).add_(gf * (1 - self.b1))
                vv = vv.mul_(self.b2).add_(torch.square(gf).mul_(1 - self.b2))
            u = (mm / c1) / (torch.sqrt(vv / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            new_p.append((p.float() - lr * u).to(p.dtype))
            new_m.append(quantize_state(mm) if int8 else mm)
            new_v.append(quantize_state_sq(vv) if int8 else vv)
        return (tree_unflatten(params, new_p),
                {"m": tree_unflatten(params, new_m), "v": tree_unflatten(params, new_v),
                 "step": step})
