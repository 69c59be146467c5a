"""repro_torch — the PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package keeps its
subpackage and module names so every ported module has one obvious
reference file.  It imports torch and numpy, never JAX and nothing of
``repro``.  Every Pallas kernel on the ported path is a hand-written CUDA
kernel for sm_90a (``csrc/``, bound in ``kernels/``); its plain torch
version serves CPU tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no card present they raise (:func:`resolve_device`).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise if there is none.  Never falls back
    to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card unless the "
                "caller passes device='cpu'")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a reference feature this port does not have yet."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, {item})")
