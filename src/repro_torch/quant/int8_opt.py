"""Block-wise 8-bit quantization of optimizer moments; torch port of
``repro.quant.int8_opt``.

Both Adam moments are stored as float8-e4m3 codes with one f32 scale per
block of up to ``BLOCK`` elements along the LAST axis (``(…, F) ->
(…, F/B, B)``): 4x less moment memory than f32, the scheme of 8-bit Adam
(Dettmers et al.).  fp8 codes rather than linear int8 keep the tiny
entries of a block alive; the second moment is stored in sqrt space,
which halves its log-range.

Every function repeats the reference's arithmetic op for op, so codes
and scales are bitwise the reference's on equal inputs: the blocks are
divided by their scale and multiplied by 448 in f32, then rounded to
e4m3 to nearest even, as ``astype(float8_e4m3fn)`` rounds.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

BLOCK = 256

_F8 = torch.float8_e4m3fn
_F8_MAX = 448.0  # finfo max; per-block scale maps blockmax here


@dataclass
class QTensor:
    """Block-quantized tensor: fp8 codes (…, nblocks, B) + f32 per-block
    scales (…, nblocks); ``shape`` is the original tensor's shape."""

    codes: torch.Tensor
    scale: torch.Tensor
    shape: tuple

    @property
    def nbytes_effective(self) -> int:
        return self.codes.numel() + 4 * self.scale.numel()


def _block_for(last_dim: int) -> int:
    b = BLOCK
    while b > 1 and last_dim % b:
        b //= 2
    return b


def quantize_state(x: torch.Tensor):
    """float tensor -> block-wise 8-bit :class:`QTensor`.  Leaves whose
    last dim resists blocking (<8) and scalars stay f32, as in the
    reference."""
    shape = tuple(x.shape)
    last = shape[-1] if shape else 1
    b = _block_for(last)
    if b < 8 or x.ndim == 0:
        return x
    blocks = x.float().reshape(*shape[:-1], last // b, b)
    scale = torch.clamp(blocks.abs().amax(dim=-1), min=1e-20)
    codes = (blocks / scale[..., None] * _F8_MAX).to(_F8)
    return QTensor(codes, scale, shape)


def dequantize_state(q) -> torch.Tensor:
    if not isinstance(q, QTensor):
        return q
    blocks = (q.codes.float() / _F8_MAX) * q.scale[..., None]
    return blocks.reshape(q.shape)


def quantize_state_sq(x: torch.Tensor):
    """Sqrt-space quantization for Adam's second moment."""
    return quantize_state(torch.sqrt(torch.clamp(x, min=0.0)))


def dequantize_state_sq(q) -> torch.Tensor:
    return torch.square(dequantize_state(q))
