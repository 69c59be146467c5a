"""Model protocol + dispatch (torch port of ``repro.models.model``)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class QuantGroup:
    """One quantizable weight group = one RL action step.

    ``path`` addresses the leaf in the params tree, ``layer`` the index
    into its stacked leading axis (None for unstacked leaves like
    lm_head).  ``n_weights``/``n_macs`` feed the paper's
    State-of-Quantization metric.
    """

    name: str
    path: tuple[str, ...]
    layer: int | None
    shape: tuple[int, ...]
    n_weights: int
    n_macs: int


def cache_batch_axis(key: str) -> int:
    """Axis of the batch/slot dimension in a decode-cache leaf: per-layer
    state is ``(L, B, ...)``, per-sequence bookkeeping (``"length"``) is
    ``(B,)``."""
    return 0 if key == "length" else 1


def build_model(cfg):
    """Config -> model object.  Only the dense transformer family is
    ported so far."""
    from repro_torch import not_ported
    from repro_torch.models.transformer import TransformerLM

    if cfg.family != "dense":
        raise not_ported(f"model family {cfg.family!r} ({cfg.name})",
                         "slice C, item 9")
    return TransformerLM(cfg)
