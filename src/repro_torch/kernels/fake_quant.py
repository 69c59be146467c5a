"""Launch wrapper for the hand-written Hopper WRPN fake-quant kernel
(``csrc/fake_quant.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/fake_quant.py::fake_quant_pallas``: the per-tensor WRPN
quantize-dequantize with ``bits`` and ``scale`` as device scalars, bitwise
equal to ``kernels.ref.fake_quant_ref``.  The source note in
``csrc/fake_quant.cu`` says what bounds it and how its design answers
that.  This wrapper checks device, types, shapes and contiguity,
allocates the output and launches on the current stream; it never falls
back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fake_quant_cuda(w: torch.Tensor, bits: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """``w`` contiguous f32 or bf16 (any shape, flat to the kernel);
    ``bits`` one int32 and ``scale`` one f32, both on ``w``'s device ->
    the QDQ of ``w`` in its dtype."""
    dev = w.device
    if dev.type != "cuda" or bits.device != dev or scale.device != dev:
        raise ValueError("fake_quant_cuda needs w, bits and scale on one CUDA device")
    if w.dtype not in _DTYPES:
        raise TypeError(f"fake_quant_cuda takes f32 or bf16 weights, got {w.dtype}")
    if bits.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError(f"bits must be int32 and scale f32, got {bits.dtype} / {scale.dtype}")
    if bits.numel() != 1 or scale.numel() != 1:
        raise ValueError(f"bits {tuple(bits.shape)} and scale {tuple(scale.shape)} "
                         f"must hold one value each")
    if not w.is_contiguous():
        raise ValueError("fake_quant_cuda needs a contiguous w")
    build.require_sm90(dev)
    out = torch.empty_like(w)
    if w.numel() == 0:
        return out
    vectorized = int(w.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    err = build.library("fake_quant").fake_quant_launch(
        w.data_ptr(), out.data_ptr(), bits.data_ptr(), scale.data_ptr(), w.numel(),
        _DTYPES[w.dtype], vectorized, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"fake_quant (shape {tuple(w.shape)}, {w.dtype})")
    return out
