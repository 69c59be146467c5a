"""AdamW from scratch (torch port of ``repro.optim.adamw``, fp32 moments).

The reference's math and order of operations, which ``torch.optim.AdamW``
does not share (its ``b2`` is 0.999, it has no global-norm clip, and it
decays the weights before the moment update):

    g   <- g * min(1, clip / max(‖g‖, 1e-9))          (global norm, all leaves)
    m   <- b1 m + (1 - b1) g ;  v <- b2 v + (1 - b2) g²
    u   <- (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) [+ wd p]
    p   <- p - lr u

Functional like the reference: ``init(params) -> state`` and
``update(params, grads, state) -> (params, state)`` over nested dicts of
tensors, leaves in sorted-key order (the order ``jax.tree`` flattens a
dict).  The step counter is a host int and the bias corrections are f32,
as the reference's ``step.astype(float32)`` powers are.  Nothing leaves
the device: the clip scale stays a 0-d tensor.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def tree_leaves(tree) -> list[torch.Tensor]:
    """Leaves of a nested dict of tensors, keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> dict:
    """Rebuild ``like``'s nesting from leaves in :func:`tree_leaves` order."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    return walk(like)


def global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def _f32_pow(base: float, step: int) -> float:
    return float(torch.tensor(base, dtype=torch.float32) ** float(step))


@dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = 1.0
    moments: str = "fp32"             # fp32 only: int8 moments are not ported

    def __post_init__(self):
        if self.moments != "fp32":
            from repro_torch import not_ported

            raise not_ported(f"AdamW moments={self.moments!r} (quant/int8_opt.py, "
                             f"the LM training path)", "slice B, item 8")

    def init(self, params) -> dict:
        zeros = tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device)
                                        for p in tree_leaves(params)])
        return {"m": zeros, "v": tree_unflatten(params, [torch.zeros_like(z) for z in
                                                         tree_leaves(zeros)]),
                "step": 0}

    @torch.no_grad()
    def update(self, params, grads, opt):
        step = opt["step"] + 1
        lr = self.lr
        g_leaves = tree_leaves(grads)
        if self.clip_norm is not None:
            gn = global_norm(g_leaves)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
            g_leaves = [g * scale for g in g_leaves]
        c1 = 1 - _f32_pow(self.b1, step)
        c2 = 1 - _f32_pow(self.b2, step)
        new_p, new_m, new_v = [], [], []
        for p, g, mm, vv in zip(tree_leaves(params), g_leaves, tree_leaves(opt["m"]),
                                tree_leaves(opt["v"])):
            gf = g.float()
            mm = self.b1 * mm + (1 - self.b1) * gf
            vv = self.b2 * vv + (1 - self.b2) * torch.square(gf)
            u = (mm / c1) / (torch.sqrt(vv / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            new_p.append((p.float() - lr * u).to(p.dtype))
            new_m.append(mm)
            new_v.append(vv)
        return (tree_unflatten(params, new_p),
                {"m": tree_unflatten(params, new_m), "v": tree_unflatten(params, new_v),
                 "step": step})
