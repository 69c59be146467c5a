"""WRPN mid-tread quantizer (the paper's Eq. 1), torch port of
``repro.quant.wrpn``.

    w_q = round((2^(k-1) - 1) * clip(w / s, -1, 1)) / (2^(k-1) - 1) * s

with ``s = max|w|`` per tensor (``axis=None``) or per output column
(``axis=0``).  Every function repeats the reference's arithmetic op for op
(including the dtype in which the ``eps`` floor is taken), so codes,
scales and QDQ values are bitwise equal to the JAX package on equal
inputs.  The straight-through estimator (``fake_quant_ste``) belongs to
the QAT loop and is not ported yet (ROADMAP slice B).
"""
from __future__ import annotations

import torch

# Bitwidth >= FP_BITS means "leave in full precision".
FP_BITS = 32


def _levels(bits: int) -> float:
    """Number of positive quantization steps: 2^(k-1) - 1 (one bit = sign)."""
    return max(2.0 ** (bits - 1.0) - 1.0, 1.0)


def tensor_scale(w: torch.Tensor, axis=None, eps: float = 1e-8) -> torch.Tensor:
    """max|w| scale so w/scale ∈ [-1, 1].  axis=None → per-tensor.

    The floor is taken in ``w``'s own dtype before the f32 cast, as
    ``jnp.maximum(s, eps)`` does with a weakly typed ``eps``."""
    if axis is None:
        s = w.abs().amax()
    else:
        s = w.abs().amax(dim=axis, keepdim=True)
    s = torch.maximum(s, torch.tensor(eps, dtype=s.dtype, device=s.device))
    return s.float()


def fake_quant(w: torch.Tensor, bits: int, scale: torch.Tensor | None = None,
               axis=None) -> torch.Tensor:
    """Quantize-dequantize (no STE).  ``bits >= FP_BITS`` returns ``w``."""
    if bits >= FP_BITS:
        return w
    if scale is None:
        scale = tensor_scale(w, axis=axis)
    n = _levels(bits)
    # f32 division, as jnp promotes bf16 / f32 (a 0-d torch scale would not)
    wc = torch.clamp(w.float() / scale, -1.0, 1.0)
    wq = torch.round(wc * n) / n * scale
    return wq.to(w.dtype)


def quantize_to_int(w: torch.Tensor, bits: int,
                    scale: torch.Tensor | None = None, axis=None):
    """Quantize to signed integer codes in [-(2^(k-1)-1), +(2^(k-1)-1)].

    Returns ``(codes int8 (int32 above 8 bits), scale f32)``."""
    if bits >= FP_BITS:
        raise ValueError("quantize_to_int requires bits < 32")
    if scale is None:
        scale = tensor_scale(w, axis=axis)
    n = float(2 ** (bits - 1) - 1) if bits > 1 else 1.0
    wc = torch.clamp(w.float() / scale, -1.0, 1.0)
    codes = torch.round(wc * n)
    return codes.to(torch.int8 if bits <= 8 else torch.int32), scale


def dequantize_from_int(codes: torch.Tensor, bits: int, scale: torch.Tensor):
    """Inverse of :func:`quantize_to_int`."""
    n = float(2 ** (bits - 1) - 1) if bits > 1 else 1.0
    return codes.float() / n * scale
