"""Configuration for quantized self-draft speculative decoding (the port of
``repro.spec.config``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.quant.policy import QuantPolicy


@dataclass(frozen=True)
class SpecConfig:
    """Knobs for :class:`~repro_torch.serve.engine.ServeEngine` speculation.

    The draft is the SAME weights at a lower-bit policy (ReLeQ's frontier
    supplies it), so a draft is specified by *bitwidths*, not by a second
    model.

    - ``k``: speculative window — tokens the draft rolls per engine step;
      the verifier scores all ``k + 1`` positions in one batched call.
    - ``draft_bits``: uniform draft bitwidth; the engine derives the draft
      via :func:`repro_torch.spec.draft.low_bit_view` (frozen-at-8 groups such
      as ``lm_head`` stay at 8, exactly like a searched policy would).
    - ``draft_policy``: full per-group :class:`QuantPolicy` for the draft
      (e.g. a :class:`~repro_torch.spec.draft.DraftSelector` pick off the
      Pareto archive).  Overrides ``draft_bits``.
    - ``draft_sparams``: pre-packed serving params for the draft.  Skips
      derivation entirely; caller owns layout compatibility.  Overrides
      both of the above.
    """

    k: int = 4
    draft_bits: int | None = None
    draft_policy: QuantPolicy | None = None
    draft_sparams: Any = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec window k must be >= 1, got {self.k}")
        if (self.draft_bits is None and self.draft_policy is None
                and self.draft_sparams is None):
            raise ValueError(
                "SpecConfig needs a draft: draft_bits, draft_policy, or "
                "draft_sparams")
        if self.draft_bits is not None and not 2 <= self.draft_bits <= 8:
            raise ValueError(
                f"draft_bits must be in 2..8, got {self.draft_bits}")
