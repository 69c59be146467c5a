"""WRPN mid-tread quantizer (the paper's Eq. 1), torch port of
``repro.quant.wrpn``.

    w_q = round((2^(k-1) - 1) * clip(w / s, -1, 1)) / (2^(k-1) - 1) * s

with ``s = max|w|`` per tensor (``axis=None``) or per output column
(``axis=0``).  Every function repeats the reference's arithmetic op for op
(including the dtype in which the ``eps`` floor is taken), so codes,
scales and QDQ values are bitwise equal to the JAX package on equal
inputs.

``bits`` may be an int or an int32 tensor on ``w``'s device (a layer's
entry of the QAT bits vector): the ``bits >= 32`` pass-through is a
``torch.where`` and the level count is computed from integers, so no
value leaves the device.  :func:`fake_quant_ste_group` is the QAT
quantizer: one call quantizes every weight of a forward at its own
per-tensor max|w| scale, through the grouped fake-quant kernel on CUDA
tensors (``kernels.ops.fake_quant_group``: one launch that takes the
scales too), and its backward, the clipped straight-through estimator,
is one more launch (``kernels.ops.fake_quant_group_bwd``).
:func:`fake_quant_ste` is a group of one.
"""
from __future__ import annotations

import torch

# Bitwidth >= FP_BITS means "leave in full precision".
FP_BITS = 32
# The floor of a per-tensor scale, taken in the weights' dtype.
EPS = 1e-8


def _levels(bits: torch.Tensor) -> torch.Tensor:
    """Number of positive quantization steps, 2^(k-1) - 1 (one bit =
    sign), at least 1, as f32.  Taken from integers: the shift never
    reaches 1 << 31, and the f32 conversion rounds as the reference's
    ``2.0 ** (bits - 1.0) - 1.0`` does (both exact below 2^24)."""
    shift = (bits.clamp(2, FP_BITS - 1) - 1).to(torch.int64)
    return torch.where(bits >= 2, (1 << shift) - 1, 1).float()


def tensor_scale(w: torch.Tensor, axis=None, eps: float = EPS) -> torch.Tensor:
    """max|w| scale so w/scale ∈ [-1, 1].  axis=None → per-tensor.

    The floor is taken in ``w``'s own dtype before the f32 cast, as
    ``jnp.maximum(s, eps)`` does with a weakly typed ``eps``; it is made on
    ``w``'s device by a fill (a host tensor would be a blocking copy)."""
    if axis is None:
        s = w.abs().amax()
    else:
        s = w.abs().amax(dim=axis, keepdim=True)
    s = torch.maximum(s, s.new_full((), eps))
    return s.float()


def fake_quant(w: torch.Tensor, bits, scale: torch.Tensor | None = None,
               axis=None) -> torch.Tensor:
    """Quantize-dequantize (no STE).  ``bits >= FP_BITS`` returns ``w``.

    ``bits``: an int or an int32 tensor (0-d, or broadcastable against
    ``w``) on ``w``'s device."""
    bits = torch.as_tensor(bits, dtype=torch.int32, device=w.device)
    if scale is None:
        scale = tensor_scale(w, axis=axis)
    n = _levels(bits)
    # f32 division, as jnp promotes bf16 / f32 (a 0-d torch scale would not)
    wc = torch.clamp(w.float() / scale, -1.0, 1.0)
    wq = torch.round(wc * n) / n * scale
    return torch.where(bits >= FP_BITS, w, wq.to(w.dtype))


class _FakeQuantSTEGroup(torch.autograd.Function):
    """Forward: every tensor's per-tensor max|w| scale and QDQ in one
    grouped launch (plain versions on CPU tensors).  Backward: the clipped
    STE of every tensor in one launch, at the forward's scales (constants,
    as ``repro.quant.wrpn._fq_bwd`` takes them)."""

    @staticmethod
    def forward(ctx, bits, *ws):
        from repro_torch.kernels import ops

        outs, scales = ops.fake_quant_group(ws, bits)
        ctx.save_for_backward(scales, *ws)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        from repro_torch.kernels import ops

        scales, *ws = ctx.saved_tensors
        return (None, *ops.fake_quant_group_bwd(ws, gs, scales))


def fake_quant_ste_group(ws, bits) -> list:
    """fake_quant with a straight-through estimator for every tensor of
    ``ws`` at its own per-tensor max|w| scale (the paper's choice):
    ``bits`` holds one entry per tensor (a list, or an int32 vector on the
    tensors' device: the QAT bits vector).  Returns the QDQ tensors."""
    if not ws:
        raise ValueError("fake_quant_ste_group needs one or more tensors")
    bits = torch.as_tensor(bits, dtype=torch.int32, device=ws[0].device).reshape(-1)
    if bits.numel() != len(ws):
        raise ValueError(f"{len(ws)} tensors and {bits.numel()} bits")
    return list(_FakeQuantSTEGroup.apply(bits, *ws))


def fake_quant_ste(w: torch.Tensor, bits, axis=None) -> torch.Tensor:
    """fake_quant with a straight-through estimator, at the per-tensor
    max|w| scale (the paper's choice, ``axis=None``): a group of one.
    ``bits``: an int or an int32 tensor on ``w``'s device.  The
    per-column scale (``axis=0``) belongs to the LM QAT path, which is not
    ported."""
    if axis is not None:
        from repro_torch import not_ported

        raise not_ported("fake_quant_ste with a per-column scale (the LM QAT path)",
                         "slice B, item 8")
    return fake_quant_ste_group([w], bits)[0]


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
