"""Parameter-path helpers and the default serving policy, torch port of
the host-side part of ``repro.quant.qat``.  The STE parameter transform
(``quantize_params``, ``bits_assignment``) belongs to the QAT loop and
waits for ROADMAP slice B."""
from __future__ import annotations

from repro_torch.quant.policy import QuantPolicy


def path_key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def get_by_path(tree, path: tuple):
    node = tree
    for p in path:
        node = node[p]
    return node


def set_by_path(tree, path: tuple, value):
    """Functional set returning a shallow-copied tree along the path."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    new = list(tree) if isinstance(tree, list) else dict(tree)
    new[head] = set_by_path(tree[head], rest, value)
    return new


def policy_for(model, default_bits: int = 8) -> QuantPolicy:
    """Fresh all-``default_bits`` policy with the model's frozen groups."""
    groups = model.quant_groups()
    return QuantPolicy(
        tuple(g.name for g in groups),
        {g.name: default_bits for g in groups},
        default_bits=default_bits,
        frozen=model.frozen_bits(),
    )
