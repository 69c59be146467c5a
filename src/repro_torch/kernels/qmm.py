"""Launch wrapper for the hand-written Hopper qmm kernel (``csrc/qmm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/qmm.py::qmm_pallas``:
``y[M, N] = x[M, K] @ dequant(planes[bits, K//8, N], scale[1, N])`` in
f32, with a bit-serial body (decode rows) and a dequant body (prefill
chunks).  The source note in ``csrc/qmm.cu`` says what bounds each body
on the card and how its design answers that.  This wrapper checks device,
types, shapes and contiguity, allocates the output and launches on the
current stream; it never falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

PATHS = {"bitserial": 0, "dequant": 1}
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def qmm_cuda(x: torch.Tensor, planes: torch.Tensor, scale: torch.Tensor,
             bits: int, path: str) -> torch.Tensor:
    """Run one qmm body on CUDA tensors.  ``x`` (M, K) bf16 or f32,
    ``planes`` (bits, K//8, N) uint8, ``scale`` (1, N) f32 -> (M, N) f32."""
    if path not in PATHS:
        raise ValueError(f"qmm path {path!r} (want one of {sorted(PATHS)})")
    dev = x.device
    if dev.type != "cuda" or planes.device != dev or scale.device != dev:
        raise ValueError(f"qmm_cuda needs CUDA tensors on one device, got "
                         f"x {x.device}, planes {planes.device}, scale {scale.device}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"qmm_cuda takes bf16 or f32 activations, got {x.dtype}")
    if planes.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError(f"planes must be uint8 and scale float32, got "
                        f"{planes.dtype} / {scale.dtype}")
    M, K = x.shape
    bts, K8, N = planes.shape
    if bts != bits or K8 * 8 != K or not 2 <= bits <= 8:
        raise ValueError(f"planes {tuple(planes.shape)} inconsistent with x "
                         f"{tuple(x.shape)} at bits={bits}")
    if tuple(scale.shape) != (1, N):
        raise ValueError(f"scale shape {tuple(scale.shape)} != (1, {N})")
    if not (x.is_contiguous() and planes.is_contiguous() and scale.is_contiguous()):
        raise ValueError("qmm_cuda needs contiguous x, planes and scale")
    build.require_sm90(dev)
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    err = build.library("qmm").qmm_launch(
        x.data_ptr(), _X_DTYPES[x.dtype], planes.data_ptr(), scale.data_ptr(),
        y.data_ptr(), M, K, N, bits, PATHS[path],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"qmm_{path} (M={M}, K={K}, N={N}, bits={bits})")
    return y
