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

Quantized-KV helpers (``kv_quantize`` and friends, the numerics of the
quantized paged pool): per-(token, KV-head) symmetric codes with
``scale = amax / qmax``, and the nibble-packed uint8 container of uniform
4-bit pools.  They are bitwise the reference's: ``torch.round`` is
half-to-even like ``jnp.round`` and ``x / safe`` is a true division.
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


# --------------------------------------------------------------------------
# Quantized-KV helpers: the one source of KV numerics for the pool, the
# model and the plain kernel versions, so the fp-KV oracle parity is exact.


def kv_quantize(x: torch.Tensor, qmax):
    """Per-(token, KV-head) symmetric quantization of new KV vectors.

    ``x``: float (..., KV, hd); ``qmax``: code ceiling ``2^(b-1) - 1`` (a
    number or a 0-d tensor).  Returns ``(codes int8 (..., KV, hd), scale
    float32 (..., KV))`` with ``scale = amax(|x|) / qmax`` over the head
    dim.  All-zero vectors get scale 0 and codes 0."""
    x = x.float()
    qmax = torch.as_tensor(qmax, dtype=torch.float32, device=x.device)
    scale = x.abs().amax(dim=-1) / qmax
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    codes = torch.clamp(torch.round(x / safe), -qmax, qmax).to(torch.int8)
    return codes, scale


def kv_dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """codes int (..., KV, hd) + scale f32 (..., KV) -> float32 values."""
    return codes.float() * scale.float()[..., None]


def kv_qdq(x: torch.Tensor, qmax) -> torch.Tensor:
    """Quantize-dequantize: exactly ``kv_dequantize(*kv_quantize(x,
    qmax))``, the value an fp-KV oracle pool stores."""
    return kv_dequantize(*kv_quantize(x, qmax))


def kv_pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Nibble-pack int8 codes in [-7, 7]: (..., hd) -> (..., hd//2) uint8,
    ``u = c + 8``, the even head index in the low nibble."""
    if codes.shape[-1] % 2:
        raise ValueError(f"head dim {codes.shape[-1]} must be even for int4 packing")
    u = (codes.to(torch.int32) + 8).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def kv_unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`kv_pack_int4`: (..., hd//2) uint8 -> (..., hd) int8."""
    lo = (packed & 0x0F).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                 packed.shape[-1] * 2)
