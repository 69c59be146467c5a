"""Design-space enumeration + Pareto frontier (paper §5.2, Fig 6), a copy
of ``repro.core.pareto`` (numpy only).

For networks small enough to enumerate (LeNet: 4 layers, SimpleNet: 5),
sweep every bitwidth combination, record (State_Quantization,
rel-accuracy) per point, extract the Pareto frontier, and check where the
ReLeQ solution lands: the paper's check that the agent finds the desired
region of the frontier.

:func:`as_archive` lifts an enumerated space into a
:class:`~repro_torch.autotune.archive.ParetoArchive`, whose 2-objective
frontier equals :func:`pareto_frontier`, with dominance-pruned insertion,
a third latency objective, JSON checkpoints and warm-start on top.
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.core import costmodel


def enumerate_space(groups, evaluate, bitset=(2, 3, 4, 5, 6, 7, 8),
                    frozen: dict | None = None, limit: int | None = None):
    """-> list of {bits, quant, acc}.  ``evaluate``: dict -> rel_acc."""
    frozen = frozen or {}
    searchable = [g for g in groups if g.name not in frozen]
    combos = itertools.product(bitset, repeat=len(searchable))
    points = []
    for i, combo in enumerate(combos):
        if limit is not None and i >= limit:
            break
        bits = {g.name: b for g, b in zip(searchable, combo)}
        bits.update(frozen)
        vec = [bits[g.name] for g in groups]
        points.append({
            "bits": bits,
            "quant": costmodel.state_of_quantization(vec, groups),
            "acc": float(evaluate(bits)),
        })
    return points


def pareto_frontier(points):
    """Non-dominated set: maximize acc, minimize quant."""
    pts = sorted(points, key=lambda p: (p["quant"], -p["acc"]))
    frontier, best_acc = [], -np.inf
    for p in pts:
        if p["acc"] > best_acc:
            frontier.append(p)
            best_acc = p["acc"]
    return frontier


def as_archive(points, latency_fn=None):
    """Enumerated points -> a ``repro_torch.autotune`` Pareto archive (oracle)."""
    from repro_torch.autotune.archive import ParetoArchive

    return ParetoArchive.from_enumeration(points, latency_fn=latency_fn)


def distance_to_frontier(point, frontier) -> float:
    """L2 distance in (quant, acc) space from a point to the frontier."""
    d = min(((point["quant"] - f["quant"]) ** 2 +
             (point["acc"] - f["acc"]) ** 2) ** 0.5 for f in frontier)
    return float(d)
