"""Public kernel entry points, dispatched by the tensor's device.

- A CPU tensor takes the plain torch version (``kernels.ref``).
- A CUDA tensor launches the hand-written Hopper kernel, or raises: when
  the card is not sm_90, or the kernel fails to build or launch.  There
  is no switch that sends a CUDA tensor to the plain version.

``counts`` holds one plain integer per kernel body, bumped where the
wrapper launches it, plus ``"plain"`` for calls that took the plain
version; ``reset_counts()`` zeroes them.  ``chip_smoke.py`` reads them to
show that the main path went through the kernels.  A wrapper called while
a CUDA graph is captured launches nothing then: the captured callables
(``train.serve``) take those ticks back and add them again at every
replay (:func:`add_counts`), so a count is kernel launches, graphed or
not.

These wrappers own the shape normalisation the kernels do not: batch
dims are flattened to rows and restored after.  Ragged edges (N or K not
a multiple of the tile, as at d_ff = 13696) are masked inside the
kernels, so nothing is padded here.

``fake_quant_group`` is the QAT quantizer's forward and
``fake_quant_group_bwd`` its STE (``quant.wrpn.fake_quant_ste_group``):
one launch each per QAT forward and backward.  ``fake_quant`` is the flat
kernel, for a scale the caller gives.

Quantized KV: ``paged_attention`` takes the quantized-block kernel when
scales are passed, and ``fused_qkv_paged_decode`` runs the fused QKV +
RoPE + KV-quantize + attention kernel.  The reference gates its fused
Pallas kernel on the packed planes fitting 8 MiB of TPU VMEM; the Hopper
kernel streams the planes from device memory, so on the card the fused
op always launches it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref as kref

counts = {"qmm_bitserial": 0, "qmm_dequant": 0, "paged_attention": 0,
          "paged_attention_quant": 0, "fused_qkv_paged_decode": 0, "fake_quant": 0,
          "fake_quant_group": 0, "fake_quant_group_bwd": 0, "plain": 0}


def reset_counts() -> None:
    for key in counts:
        counts[key] = 0


def add_counts(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (key -> launches) to ``counts``."""
    for key, n in delta.items():
        counts[key] += times * n


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return False


def fake_quant(w: torch.Tensor, bits, scale: torch.Tensor | None = None) -> torch.Tensor:
    """WRPN QDQ of an arbitrary-shape tensor at a per-tensor scale, with
    ``bits`` (an int, or an int32 tensor on ``w``'s device) as data.
    ``scale=None`` takes ``tensor_scale(w)``.  Batch dims are flattened to
    rows, as the reference's ``ops.fake_quant`` does; the kernel walks the
    flat rows without tiles or padding."""
    from repro_torch.quant.wrpn import tensor_scale

    bits = torch.as_tensor(bits, dtype=torch.int32, device=w.device)
    if scale is None:
        scale = tensor_scale(w)
    scale = scale.to(torch.float32).reshape(())
    shape = w.shape
    w2 = w.reshape(-1, shape[-1]) if w.ndim != 2 else w
    if _on_cuda(w):
        from repro_torch.kernels.fake_quant import fake_quant_cuda

        out = fake_quant_cuda(w2.contiguous(), bits, scale)
        counts["fake_quant"] += 1
    else:
        out = kref.fake_quant_ref(w2, bits, scale)
        counts["plain"] += 1
    return out.reshape(shape)


def fake_quant_group(ws, bits):
    """WRPN QDQ of every tensor of ``ws`` at its own per-tensor scale
    ``max(max|w|, eps)`` (``tensor_scale``), tensor i at ``bits[i]`` (an
    int32 vector on the tensors' device).  Returns (the QDQ tensors, the
    f32 vector of scales).  On CUDA: one grouped launch (more only past
    ``GROUP_MAX`` tensors), counted per launch."""
    if _on_cuda(ws[0]):
        from repro_torch.kernels.fake_quant import fake_quant_group_cuda

        outs, scales, launches = fake_quant_group_cuda([w.contiguous() for w in ws], bits)
        counts["fake_quant_group"] += launches
        return outs, scales
    counts["plain"] += 1
    return kref.fake_quant_group_ref(ws, bits)


def fake_quant_group_bwd(ws, gs, scales: torch.Tensor) -> list:
    """The clipped STE of a group: ``gs[i] * (|ws[i]| <= scales[i])`` in
    each gradient's dtype.  On CUDA: one launch for the group."""
    if _on_cuda(gs[0]):
        from repro_torch.kernels.fake_quant import fake_quant_group_bwd_cuda

        grads, launches = fake_quant_group_bwd_cuda([w.contiguous() for w in ws],
                                                    [g.contiguous() for g in gs], scales)
        counts["fake_quant_group_bwd"] += launches
        return grads
    counts["plain"] += 1
    return kref.fake_quant_group_bwd_ref(ws, gs, scales)


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
    k_pool: torch.Tensor,        # (NB, bs, KV, hd[/2]) — one layer's paged blocks
    v_pool: torch.Tensor,        # same container as k_pool
    block_tables: torch.Tensor,  # (B, nb) int32
    lengths: torch.Tensor,       # (B,) int32 effective lengths
    k_scale: torch.Tensor | None = None,  # (NB, bs, KV) f32 — quantized pools
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode attention over a paged KV pool -> (B, 1, H, hd) in ``q``'s
    dtype.  Passing ``k_scale``/``v_scale`` selects the quantized-block
    path (int8 codes, or nibble-packed uint8 at uniform int4).  An f32
    pool (the kv-oracle's) with a bf16 ``q`` attends in f32: the cast is
    exact, and it is what the reference's kernel does inside."""
    B, _, H, hd = q.shape
    KV = k_pool.shape[2]
    quantized = k_scale is not None
    if _on_cuda(q):
        q4 = q.reshape(B, KV, H // KV, hd)
        if quantized:
            from repro_torch.kernels.paged_attention_quant import (
                paged_attention_quant_cuda)

            out = paged_attention_quant_cuda(q4.contiguous(), k_pool, v_pool, k_scale,
                                             v_scale, block_tables, lengths)
            counts["paged_attention_quant"] += 1
        else:
            from repro_torch.kernels.paged_attention import paged_attention_cuda

            if k_pool.dtype == torch.float32:
                q4 = q4.float()
            out = paged_attention_cuda(q4.contiguous(), k_pool, v_pool,
                                       block_tables, lengths)
            counts["paged_attention"] += 1
        return out.reshape(B, 1, H, hd).to(q.dtype)
    counts["plain"] += 1
    if quantized:
        out = kref.quant_paged_attention_ref(q, k_pool, v_pool, k_scale, v_scale,
                                             block_tables, lengths)
    else:
        out = kref.paged_attention_ref(q, k_pool, v_pool, block_tables, lengths)
    return out.to(q.dtype)


def fused_qkv_paged_decode(
    x: torch.Tensor,             # (B, D) post-norm hidden, one token per row
    wq, wk, wv,                  # quant.pack.Packed projection weights
    k_pool, v_pool,              # quantized paged blocks (pre-write)
    k_scale, v_scale,            # (NB, bs, KV) f32
    block_tables: torch.Tensor,  # (B, nb) int32
    lengths: torch.Tensor,       # (B,) int32 — lengths BEFORE the new token
    qmax,                        # 0-d f32 — this layer's KV code ceiling
    *,
    rope_theta: float,
    num_heads: int,
    num_kv_heads: int,
):
    """Fused bit-serial QKV + RoPE + KV-quantize + paged attention.

    Returns ``(attn (B, 1, H, hd) in x.dtype, k_codes, v_codes, k_sc,
    v_sc)``: the new token's codes (nibble-packed for a uint8 pool) and
    scales, which the caller scatters into the pool (write-then-attend ≡
    the kernel's attend-with-the-new-token-last).  The RoPE rows are
    computed here, in torch, and passed to the kernel."""
    from repro_torch.models.common import rope_cos_sin

    B = x.shape[0]
    H, KV = num_heads, num_kv_heads
    hd = wq.scale.shape[-1] // H
    cos, sin = rope_cos_sin(lengths, hd, rope_theta)          # (B, hd/2)
    if _on_cuda(x):
        from repro_torch.kernels.fused_decode import fused_qkv_paged_decode_cuda

        qmax = torch.as_tensor(qmax, dtype=torch.float32, device=x.device)
        out, kc, vc, ks, vs = fused_qkv_paged_decode_cuda(
            x.contiguous(), wq, wk, wv, k_pool, v_pool, k_scale, v_scale,
            block_tables, lengths, cos, sin, qmax, H)
        counts["fused_qkv_paged_decode"] += 1
        return out.reshape(B, 1, H, hd).to(x.dtype), kc, vc, ks, vs
    counts["plain"] += 1
    out, kc, vc, ks, vs = kref.fused_qkv_paged_decode_ref(
        x, wq, wk, wv, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
        cos, sin, qmax, H, KV)
    return out.to(x.dtype), kc, vc, ks, vs
