"""ADMM bitwidth-selection baseline (paper §4.6 / Table 4, Ye et al.),
torch port of ``repro.core.admm_baseline``.

The paper describes the comparison method as: "runs a binary search to
minimize the total square quantization error in order to decide the
quantization levels for the layers, then an iterative optimization
technique for fine-tuning".  The decision rule:

    min_b  Σ_l ‖W_l − Q_{b_l}(W_l)‖²   s.t.  Σ_l cost_l·b_l ≤ budget

solved by bisection on the Lagrange multiplier λ: for each λ every layer
picks b_l = argmin_b err_l(b) + λ·cost_l·b on its own (the objective is
separable), and λ is bisected until the budget binds.  Fine-tuning
afterwards is the same QAT retrain as ReLeQ's, so the comparison isolates
the selection policy.

Each squared error is the WRPN QDQ at a per-tensor max|w| scale through
``kernels.ops.fake_quant`` (the flat fake-quant kernel on a CUDA tensor,
bitwise ``quant.wrpn.fake_quant``; the scale ``tensor_scale`` takes once
per layer for its 7 bitwidths), summed in f32 on the weights' device;
the errors come to the host in one copy.  The λ search is the reference's,
step for step.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.quant.wrpn import tensor_scale


def layer_quant_errors(weights_by_name: dict, bitset=(2, 3, 4, 5, 6, 7, 8)):
    """name -> {bits: squared quantization error}."""
    names = list(weights_by_name)
    sums = []
    for name in names:
        w = weights_by_name[name].float()
        scale = tensor_scale(w)           # fake_quant's own scale, taken once per layer
        for b in bitset:
            sums.append(torch.sum(torch.square(w - kops.fake_quant(w, b, scale))))
    host = torch.stack(sums).cpu().tolist() if sums else []
    n = len(bitset)
    return {name: {b: host[i * n + j] for j, b in enumerate(bitset)}
            for i, name in enumerate(names)}


def admm_select(groups, weights_by_name: dict, budget_avg_bits: float,
                bitset=(2, 3, 4, 5, 6, 7, 8), frozen: dict | None = None,
                iters: int = 50) -> dict:
    """-> bits dict meeting the average-bits budget with min total sq error."""
    frozen = frozen or {}
    searchable = [g for g in groups if g.name not in frozen]
    errs = layer_quant_errors(
        {g.name: weights_by_name[g.name] for g in searchable}, bitset)
    cost = {g.name: float(g.n_weights) for g in searchable}
    budget = budget_avg_bits * sum(cost.values())

    def pick(lmbda):
        bits = {}
        for g in searchable:
            obj = [(errs[g.name][b] + lmbda * cost[g.name] * b, b) for b in bitset]
            bits[g.name] = min(obj)[1]
        return bits

    lo, hi = 0.0, 1.0
    # grow hi until the budget is met
    for _ in range(60):
        b = pick(hi)
        if sum(cost[n] * v for n, v in b.items()) <= budget:
            break
        hi *= 4.0
    for _ in range(iters):  # bisect λ
        mid = 0.5 * (lo + hi)
        b = pick(mid)
        used = sum(cost[n] * v for n, v in b.items())
        if used > budget:
            lo = mid
        else:
            hi = mid
    bits = pick(hi)
    bits.update(frozen)
    return bits
