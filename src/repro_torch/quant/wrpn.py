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
:func:`fake_quant_ste_group_col` is the LM QAT quantizer: every stacked
``(L, K, N)`` leaf at its per-column scales (max|w| over dim ``ndim - 2``)
and per-layer bits, forward and STE each one launch
(``kernels.ops.fake_quant_group_col`` and ``..._bwd``).
Under tensor parallelism a leaf that holds a shard of its K takes the
max of its scales across ranks between the kernel's two passes
(``kernels.ops.fake_quant_group_col_max`` and ``..._qdq``).
:func:`fake_quant_ste` is a group of one of either.
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


class _FakeQuantSTEColGroup(torch.autograd.Function):
    """Forward: every leaf's per-column scales and QDQ in one grouped
    launch (plain versions on CPU tensors); the leaves marked ``split``
    instead take the max pass, ``reduce_max`` of their scales (in place:
    the max over the ranks that share their K, ``dist.tp``), then the QDQ
    pass.  Backward: the clipped STE of every leaf in one launch, at the
    forward's f32 scales held constant (``repro.quant.wrpn._fq_bwd`` under
    ``repro.quant.qat._qdq``'s stop_gradient)."""

    @staticmethod
    def forward(ctx, n, split, reduce_max, *args):
        from repro_torch.kernels import ops

        bits, ws = args[:n], args[n:]
        outs, scales = [None] * n, [None] * n
        whole = [i for i in range(n) if not split[i]]
        parts = [i for i in range(n) if split[i]]
        if whole:
            o, s = ops.fake_quant_group_col([ws[i] for i in whole], [bits[i] for i in whole])
            for i, oi, si in zip(whole, o, s):
                outs[i], scales[i] = oi, si
        if parts:
            s = ops.fake_quant_group_col_max([ws[i] for i in parts])
            reduce_max(s)
            o = ops.fake_quant_group_col_qdq([ws[i] for i in parts], [bits[i] for i in parts], s)
            for i, oi, si in zip(parts, o, s):
                outs[i], scales[i] = oi, si
        ctx.n = n
        ctx.save_for_backward(*scales, *ws)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        from repro_torch.kernels import ops

        n = ctx.n
        saved = ctx.saved_tensors
        scales, ws = saved[:n], saved[n:]
        return (None, None, None, *([None] * n), *ops.fake_quant_group_col_bwd(ws, gs, scales))


def fake_quant_ste_group_col(ws, bits, split=None, reduce_max=None) -> list:
    """fake_quant with a straight-through estimator for every leaf of
    ``ws`` (2 or more dims) at its per-column max|w| scales (reduced over
    dim ``ndim - 2``), leaf i at ``bits[i]``: an int or an int32 tensor on
    the leaves' device, one value per layer of the leading dims, one per
    stacked layer of an expert bank ``(L, E, K, N)`` (the reference's
    ``(L,)`` bits), or one.  ``split[i]`` marks a leaf that holds a shard
    of its K: its scales are ``reduce_max(scales)`` of this shard's (a
    list of f32 ``(..., 1, N)`` tensors, reduced in place) before its
    QDQ.  Returns the QDQ leaves."""
    if not ws:
        raise ValueError("fake_quant_ste_group_col needs one or more leaves")
    if len(bits) != len(ws):
        raise ValueError(f"{len(ws)} leaves and {len(bits)} bits")
    split = tuple(bool(x) for x in (split or [False] * len(ws)))
    if len(split) != len(ws) or (any(split) and reduce_max is None):
        raise ValueError("split needs one flag a leaf, and reduce_max when any is set")
    bits = [torch.as_tensor(b, dtype=torch.int32, device=w.device).reshape(-1)
            for w, b in zip(ws, bits)]
    return list(_FakeQuantSTEColGroup.apply(len(ws), split, reduce_max, *bits, *ws))


def fake_quant_ste(w: torch.Tensor, bits, axis=None) -> torch.Tensor:
    """fake_quant with a straight-through estimator: at the per-tensor
    max|w| scale (the paper's choice, ``axis=None``), or per output column
    (``axis`` the contraction dim ``ndim - 2``: ``axis=0`` of a matrix, the
    LM path's scale).  A group of one.  ``bits``: an int or an int32
    tensor on ``w``'s device."""
    if axis is None:
        return fake_quant_ste_group([w], bits)[0]
    if w.ndim < 2 or axis % w.ndim != w.ndim - 2:
        raise ValueError(f"the per-column STE reduces dim ndim - 2 = {w.ndim - 2} of a "
                         f"{w.ndim}-d weight, not axis {axis}")
    return fake_quant_ste_group_col([w], [bits])[0]


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
