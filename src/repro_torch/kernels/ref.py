"""Plain torch versions of the hand-written kernels' functions (port of
the matching ``repro.kernels.ref`` oracles).

They are what a CPU tensor runs through ``kernels.ops``, and what the
tests and ``chip_smoke.py`` hold each CUDA kernel against.  Nothing on
the main path calls them when the tensors live on a card.
"""
from __future__ import annotations

import torch

from repro_torch.quant.pack import unpack_bitplanes


def dequant_ref(packed: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed bitplanes (bits, K//8, N) + scale (1, N) -> float32 (K, N)."""
    n = float(2 ** (bits - 1) - 1) if bits > 1 else 1.0
    return unpack_bitplanes(packed, bits).float() / n * scale


def qmm_ref(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
            bits: int) -> torch.Tensor:
    """y = x @ dequant(packed).  x: (M, K) float; out: (M, N) float32."""
    return x.float() @ dequant_ref(packed, scale, bits)


def paged_attention_ref(
    q: torch.Tensor,             # (B, 1, H, hd) — one new token per sequence
    k_pool: torch.Tensor,        # (NB, bs, KV, hd) — one layer's paged blocks
    v_pool: torch.Tensor,        # (NB, bs, KV, hd)
    block_tables: torch.Tensor,  # (B, nb) int32 physical block ids
    lengths: torch.Tensor,       # (B,) valid tokens per sequence
) -> torch.Tensor:
    """Gather each sequence's pages into a contiguous (B, nb*bs, KV, hd)
    view, then run the exact :func:`models.common.decode_attention`
    math.  Returns (B, 1, H, hd) in ``q``'s dtype.  A row of length 0
    gives the uniform average over its pages, as the reference oracle
    does; the kernel returns zeros there, and such rows are never read."""
    from repro_torch.models.common import decode_attention

    B, nb = block_tables.shape
    bs = k_pool.shape[1]
    bt = block_tables.long()
    kg = k_pool[bt].reshape(B, nb * bs, *k_pool.shape[2:])
    vg = v_pool[bt].reshape(B, nb * bs, *v_pool.shape[2:])
    return decode_attention(q, kg, vg, lengths)
