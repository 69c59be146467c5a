"""repro_torch.spec — speculative decoding with a quantized self-draft
(torch port of ``repro.spec``).

- :mod:`repro_torch.spec.config` — :class:`SpecConfig`, the
  ``ServeEngine(spec=...)`` knob.
- :mod:`repro_torch.spec.draft` — :func:`low_bit_view`,
  :class:`DraftSelector` (a draft policy off a ``ParetoArchive``),
  :func:`snap_params_to_grid`.
- :mod:`repro_torch.spec.sampler` — the distribution-exact rejection
  sampler that resolves each window on the host (a copy).

The drafter and the verifier live in the engine and the model: the draft
rolls k tokens through a decode step of its own (a second captured graph
on the card) over the SAME pool blocks the target owns, so speculation
allocates no extra KV, and the target scores all k + 1 positions of every
row in one batched ``verify_chunk`` call.
"""
from repro_torch.spec.config import SpecConfig
from repro_torch.spec.draft import DraftSelector, low_bit_view, snap_params_to_grid
from repro_torch.spec.sampler import (
    KIND_ACCEPT,
    KIND_DRAFT,
    KIND_RESIDUAL,
    KIND_TOKEN,
    draft_token,
    greedy_window,
    spec_window,
)

__all__ = [
    "SpecConfig",
    "DraftSelector",
    "low_bit_view",
    "snap_params_to_grid",
    "KIND_ACCEPT",
    "KIND_DRAFT",
    "KIND_RESIDUAL",
    "KIND_TOKEN",
    "draft_token",
    "greedy_window",
    "spec_window",
]
