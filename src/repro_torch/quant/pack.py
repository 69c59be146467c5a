"""Bitplane packing of quantized weights (serving path), torch port of
``repro.quant.pack``.

Layout (identical to the reference, so packed buffers cross between the
two packages unchanged): a ``k``-bit ``(K, N)`` matrix with signed codes
``c ∈ [-n, n]``, ``n = 2^(k-1) - 1``, is stored as the shifted unsigned
codes ``u = c + n`` split into ``k`` binary planes, 8 contraction rows per
byte: ``(k, K//8, N) uint8``, byte ``[b, j, col]`` holding bit ``b`` of
rows ``8j..8j+7`` (row ``8j+i`` in bit ``i``), ``N`` minor-most.

Reconstruction:  ``W = (Σ_b 2^b · plane_b − n) / n · scale``
Bit-serial GEMM: ``x @ W = (Σ_b 2^b (x @ plane_b) − n · rowsum(x)) / n · scale``

The quantized-KV helpers (``kv_quantize`` and friends) wait for the
quantized KV pool (ROADMAP slice A item 4).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Packed:
    """Bitplane-packed weight: planes ``(bits, K//8, N) uint8``, per-column
    scale ``(1, N) f32`` and the plane count ``bits``."""

    planes: torch.Tensor
    scale: torch.Tensor
    bits: int


@dataclass
class QDQ:
    """Dense weight tagged for quantize-dequantize at lookup (embeddings:
    a gather, not a matmul).  ``value`` is ``fake_quant(w, bits, axis=0)``,
    computed once when the serving params are built; the reference
    recomputes the same values on every lookup."""

    w: torch.Tensor
    bits: int
    value: torch.Tensor


def _check_k(K: int):
    if K % 8 != 0:
        raise ValueError(f"contraction dim {K} must be a multiple of 8 (pad first)")


def _check_bits(bits: int):
    # mid-tread ternary (k=1: {-1,0,1}) needs 2 planes — pack at >= 2 bits.
    if not 2 <= bits <= 8:
        raise ValueError(f"bitplane packing supports 2..8 bits, got {bits}")


def pack_bitplanes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack signed codes (K, N) int -> (bits, K//8, N) uint8 planes.

    ``codes`` must lie in ``[-(2^(bits-1)-1), 2^(bits-1)-1]``.  One plane
    at a time, so a full-width matrix never holds a (bits, K, N) temporary.
    """
    K, N = codes.shape
    _check_k(K)
    _check_bits(bits)
    n = 2 ** (bits - 1) - 1
    u = (codes.to(torch.int32) + n).to(torch.uint8)        # [0, 2n]
    weights = (1 << torch.arange(8, dtype=torch.int32, device=codes.device)
               ).view(1, 8, 1)
    out = torch.empty((bits, K // 8, N), dtype=torch.uint8, device=codes.device)
    for b in range(bits):
        plane = ((u >> b) & 1).view(K // 8, 8, N).to(torch.int32)
        out[b] = (plane * weights).sum(dim=1).to(torch.uint8)
    return out


def unpack_bitplanes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse: (bits, K//8, N) uint8 -> signed codes (K, N) int32.  One
    plane at a time, so the largest temporary is one (K, N) plane."""
    b, K8, N = packed.shape
    if b != bits:
        raise ValueError(f"packed has {b} planes, expected {bits}")
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device).view(1, 8, 1)
    u = torch.zeros((K8 * 8, N), dtype=torch.int32, device=packed.device)
    for p in range(bits):
        bit = ((packed[p][:, None, :] >> shifts) & 1).reshape(K8 * 8, N)
        u |= bit.to(torch.int32) << p
    n = 2 ** (bits - 1) - 1 if bits > 1 else 1
    return u - n


def pack_weight(w: torch.Tensor, bits: int):
    """Float (K, N) weight -> ``(planes uint8 (bits, K//8, N), scale f32
    (1, N))`` with per-output-column scales (axis=0 reduction)."""
    from repro_torch.quant.wrpn import quantize_to_int

    codes, scale = quantize_to_int(w, bits, axis=0)
    return pack_bitplanes(codes, bits), scale


def dequant_packed(packed: torch.Tensor, scale: torch.Tensor, bits: int):
    """Reconstruct float32 weights from packed planes + per-column scale."""
    n = float(2 ** (bits - 1) - 1) if bits > 1 else 1.0
    return unpack_bitplanes(packed, bits).float() / n * scale
