"""Public kernel entry points, dispatched by the tensor's device.

- A CPU tensor takes the plain torch version (``kernels.ref``).
- A CUDA tensor launches the hand-written Hopper kernel, or raises: when
  the card is not sm_90, or the kernel fails to build or launch.  There
  is no switch that sends a CUDA tensor to the plain version.

``counts`` holds one plain integer per kernel body, bumped where the
wrapper launches it, plus ``"plain"`` for calls that took the plain
version; ``reset_counts()`` zeroes them.  ``chip_smoke.py`` reads them to
show that the main path went through the kernels.

These wrappers own the shape normalisation the kernels do not: batch
dims are flattened to rows and restored after.  Ragged edges (N or K not
a multiple of the tile, as at d_ff = 13696) are masked inside the
kernels, so nothing is padded here.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref as kref

counts = {"qmm_bitserial": 0, "qmm_dequant": 0, "paged_attention": 0,
          "plain": 0}


def reset_counts() -> None:
    for key in counts:
        counts[key] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return False


def qmm(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
        bits: int, path: str = "auto",
        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched y = x @ dequant(packed).  x: (..., K); packed: (bits, K//8, N).

    ``path='auto'`` picks the bit-serial body when the flattened batch
    M ≤ 32 (decode rows) and the dequant body otherwise, as the
    reference's ``ops.qmm`` does."""
    *batch, K = x.shape
    bts, K8, N = packed.shape
    if bts != bits or K8 * 8 != K:
        raise ValueError(f"packed {tuple(packed.shape)} inconsistent with x "
                         f"{tuple(x.shape)} at bits={bits}")
    M = math.prod(batch)
    x2 = x.reshape(M, K)
    if path == "auto":
        path = "bitserial" if M <= 32 else "dequant"
    if path not in ("bitserial", "dequant"):
        raise ValueError(f"qmm path {path!r}")
    if _on_cuda(x):
        from repro_torch.kernels.qmm import qmm_cuda

        out = qmm_cuda(x2.contiguous(), packed, scale.reshape(1, N), bits, path)
        counts["qmm_" + path] += 1
    else:
        out = kref.qmm_ref(x2, packed, scale, bits)
        counts["plain"] += 1
    return out.to(out_dtype).reshape(*batch, N)


def paged_attention(
    q: torch.Tensor,             # (B, 1, H, hd) — one new token per sequence
    k_pool: torch.Tensor,        # (NB, bs, KV, hd) — one layer's paged blocks
    v_pool: torch.Tensor,        # same shape as k_pool
    block_tables: torch.Tensor,  # (B, nb) int32
    lengths: torch.Tensor,       # (B,) int32 effective lengths
) -> torch.Tensor:
    """Decode attention over a paged fp KV pool -> (B, 1, H, hd) in
    ``q``'s dtype."""
    B, _, H, hd = q.shape
    KV = k_pool.shape[2]
    if _on_cuda(q):
        from repro_torch.kernels.paged_attention import paged_attention_cuda

        out = paged_attention_cuda(q.reshape(B, KV, H // KV, hd).contiguous(),
                                   k_pool, v_pool, block_tables, lengths)
        counts["paged_attention"] += 1
        return out.reshape(B, 1, H, hd).to(q.dtype)
    counts["plain"] += 1
    return kref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                    lengths).to(q.dtype)
