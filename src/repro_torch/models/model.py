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


# decode-cache leaves that are not O(1) per-row state: K/V (paged blocks
# or contiguous rows) and their quantization scales, written at a slot and
# never rewritten in place, and the per-call bookkeeping
_NOT_RECURRENT = ("k", "v", "k_scale", "v_scale", "kv_qmax", "length", "block_tables")


def recurrent_keys(cache) -> tuple[str, ...]:
    """The leaves of a decode cache (or its template from ``init_cache``)
    that hold O(1) recurrent state a row carries from token to token,
    rewritten in place by the decode step and the chunk body: RWKV's
    ``wkv``/``x_tm``/``x_cm``, hymba's ``ssm_h``/``ssm_conv``.  The pool's
    row reset, the spec path's snapshot and the graphed step's capture all
    read this one list."""
    return tuple(k for k in cache if k not in _NOT_RECURRENT)


def build_model(cfg):
    """Config -> model object: the ssm family (RWKV6) as an ``RWKV6LM``,
    every other family (dense, moe, vlm, audio, hybrid) as a
    ``TransformerLM``."""
    from repro_torch.models.rwkv import RWKV6LM
    from repro_torch.models.transformer import TransformerLM

    if cfg.family == "ssm":
        return RWKV6LM(cfg)
    return TransformerLM(cfg)
