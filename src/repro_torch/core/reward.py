"""Reward shaping (paper §2.6, Fig 3) — three formulations; a numpy-only
copy of ``repro.core.reward``.

The paper's proposed reward (Fig 3a) is given graphically, not as a printed
equation; the text pins down its properties and parameters:

- asymmetric: accuracy is prioritized over quantization benefit,
- smooth 2-D gradient that steepens as the agent approaches the optimum,
- parameters a = 0.2, b = 0.4 ("can be tuned"),
- hard threshold th = 0.4 on relative accuracy, below which the reward is a
  flat penalty (prunes unrecoverable regions, accelerating learning).

We reconstruct it as

    R(acc, q) = -1                              acc < th
    R(acc, q) = acc^(2/b) · (1 - q^a)           otherwise

acc^(2/b) = acc^5 is the steep accuracy emphasis — chosen so the
asymmetry is a checkable property (an ε loss of relative accuracy always
costs more reward than an ε gain of quantization benefit recovers, for
acc ≥ 0.9, q ≥ 0.3; tests/test_core_rl.py); (1 - q^a) with a = 0.2
rewards quantization progressively faster as q drops (the "smooth
gradient toward the optimum"); the threshold is the flat dark region of
Fig 3a.  The two ablation alternatives (Fig 3b, 3c) are implemented
exactly as stated: acc/q and acc − q.
"""
from __future__ import annotations

import numpy as np


def reward_proposed(acc: float, quant: float, a: float = 0.2, b: float = 0.4,
                    th: float = 0.4) -> float:
    acc = float(np.clip(acc, 0.0, 1.5))   # relative accuracy can exceed 1 slightly
    quant = float(np.clip(quant, 0.0, 1.0))
    if acc < th:
        return -1.0
    return acc ** (2.0 / b) * (1.0 - quant ** a)


def reward_ratio(acc: float, quant: float, **_) -> float:
    """Fig 3b: State_Accuracy / State_Quantization."""
    return float(acc) / max(float(quant), 1e-6)


def reward_difference(acc: float, quant: float, **_) -> float:
    """Fig 3c: State_Accuracy - State_Quantization."""
    return float(acc) - float(quant)


REWARDS = {
    "proposed": reward_proposed,
    "ratio": reward_ratio,
    "difference": reward_difference,
}
