"""Draft construction: low-bit views of packed weights and archive picks
(torch port of ``repro.spec.draft``).

The draft model is never a second network: it is the target's own
bitplane-packed weights packed again at fewer planes
(:func:`repro_torch.quant.pack.repack_weight`), so a decode step reads
fewer plane bytes while every other tensor (norms, embedding, caches) is
shared by reference.

- :func:`low_bit_view`: serving params -> draft serving params at a
  uniform ``bits`` or a full per-group policy.
- :class:`DraftSelector`: pick a draft policy off a
  :class:`~repro_torch.autotune.archive.ParetoArchive` frontier: among
  entries whose relative accuracy clears ``acc_floor`` (a proxy for the
  acceptance rate), the cheapest by average bits.
- :func:`snap_params_to_grid`: project training weights onto the
  ``bits`` grid, so a wider target and its ``bits``-plane draft agree and
  the acceptance approaches 1: the regime of spec decoding's mechanical
  ceiling.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.autotune.archive import ArchiveEntry, ParetoArchive
from repro_torch.quant.pack import Packed, dequant_packed, pack_weight, repack_weight
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qat import get_by_path, policy_for, set_by_path


def low_bit_view(model, sparams, bits: int | None = None,
                 policy: QuantPolicy | None = None):
    """Serving params -> draft serving params at ``policy`` (with ``bits``
    given instead, ``policy_for(model, bits)``).

    Each :class:`Packed` leaf of a quant group is packed again at the
    policy's width for it, so frozen-at-8 groups keep their 8 planes;
    dense and QDQ leaves pass through by reference.  Packing to >= the
    current plane count is a no-op, so the draft is at most as wide as the
    target."""
    if policy is None:
        if bits is None:
            raise ValueError("low_bit_view needs bits or a policy")
        policy = policy_for(model, bits)

    blocks = sparams["blocks"]
    nested = bool(blocks) and isinstance(blocks[0], list)
    nb = [list(sub) for sub in blocks] if nested else list(blocks)
    out = dict(sparams)
    for g in model.quant_groups():
        want = policy.get(g.name)
        if g.path[0] == "blocks":
            if nested:
                sub, rest = g.path[1], g.path[2:]
                tree = nb[sub][g.layer]
            else:
                rest, tree = g.path[1:], nb[g.layer]
            leaf = get_by_path(tree, rest)
            if isinstance(leaf, Packed) and want < leaf.bits:
                tree = set_by_path(tree, rest, repack_weight(leaf, want))
                if nested:
                    nb[sub][g.layer] = tree
                else:
                    nb[g.layer] = tree
        elif g.path == ("lm_head",):
            head = out["lm_head"]
            if isinstance(head, Packed) and want < head.bits:
                out["lm_head"] = repack_weight(head, want)
    out["blocks"] = nb
    return out


@dataclass(frozen=True)
class DraftSelector:
    """Pick a quantized self-draft policy off the Pareto frontier.

    ``acc_floor`` gates on relative accuracy (entries that disagree with
    the fp model rarely agree with the 8-bit target either);
    ``max_avg_bits`` optionally caps draft width (a 7-bit "draft" saves
    almost no traffic).  Among survivors the *cheapest* entry wins
    (lowest average bits, ties to higher accuracy): draft cost scales
    with plane count, and acceptance differences above the floor are
    second-order next to a 4x traffic cut.
    """

    acc_floor: float = 0.95
    max_avg_bits: float | None = None

    def candidates(self, archive: ParetoArchive) -> list[ArchiveEntry]:
        out = []
        for e in archive.entries():
            if e.acc < self.acc_floor:
                continue
            if self.max_avg_bits is not None and _avg_bits(e) > self.max_avg_bits:
                continue
            out.append(e)
        return out

    def select(self, archive: ParetoArchive) -> ArchiveEntry | None:
        """Cheapest sufficiently-accurate entry, or None (empty/too
        strict — caller falls back to a uniform ``draft_bits``)."""
        cands = self.candidates(archive)
        if not cands:
            return None
        return min(cands, key=lambda e: (_avg_bits(e), -e.acc, e.bits))

    def policy(self, model, archive: ParetoArchive) -> QuantPolicy | None:
        """Archive -> draft QuantPolicy aligned with ``model``'s groups."""
        from repro_torch.autotune.deploy import policy_from_entry

        entry = self.select(archive)
        if entry is None:
            return None
        return policy_from_entry(model, entry)


def _avg_bits(entry: ArchiveEntry) -> float:
    bits = [b for _, b in entry.bits]
    return sum(bits) / max(len(bits), 1)


def _roundtrip(w: torch.Tensor, bits: int) -> torch.Tensor:
    if w.ndim > 2:  # stacked layers or expert banks: slice by slice
        return torch.stack([_roundtrip(m, bits) for m in w])
    planes, scale = pack_weight(w.float(), bits)
    return dequant_packed(planes, scale, bits).to(w.dtype)


def snap_params_to_grid(model, params, bits: int):
    """Project training params onto the ``bits`` quantization grid: every
    searchable quant group goes through pack -> dequant at ``bits``, so
    packing at ``bits`` or wider then reconstructs it (nearly) exactly.
    Frozen groups are skipped (the draft never packs them again), and so
    are leaves outside the quant groups."""
    frozen = model.frozen_bits()
    out = params
    seen: set[tuple] = set()
    for g in model.quant_groups():
        # a stacked training leaf holds every layer: round-trip it once
        if g.path in seen or g.name in frozen:
            continue
        seen.add(g.path)
        out = set_by_path(out, g.path, _roundtrip(get_by_path(out, g.path), bits))
    return out
