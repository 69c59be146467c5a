"""Configuration for quantized self-draft speculative decoding (the port of
``repro.spec.config``, its uniform-bits draft only)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SpecConfig:
    """Knobs for :class:`~repro_torch.serve.engine.ServeEngine` speculation.

    The draft is the SAME weights at a lower bitwidth, so a draft is
    specified by *bits*, not by a second model.

    - ``k``: speculative window — tokens the draft rolls per engine step;
      the verifier scores all ``k + 1`` positions in one batched call.
    - ``draft_bits``: uniform draft bitwidth; the engine derives the draft
      via :func:`repro_torch.spec.draft.low_bit_view` (frozen-at-8 groups such
      as ``lm_head`` stay at 8, exactly like a searched policy would).

    The reference's per-group ``draft_policy`` and pre-packed
    ``draft_sparams`` come with its Pareto-archive draft selection
    (ROADMAP.md queue 1, item 10).
    """

    k: int = 4
    draft_bits: int | None = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec window k must be >= 1, got {self.k}")
        if self.draft_bits is None:
            raise ValueError("SpecConfig needs a draft: draft_bits")
        if not 2 <= self.draft_bits <= 8:
            raise ValueError(
                f"draft_bits must be in 2..8, got {self.draft_bits}")
