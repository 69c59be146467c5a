"""Launch wrapper for the hand-written Hopper fused QKV + quantized paged
decode kernel (``csrc/fused_decode.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/fused_decode.py::fused_qkv_paged_decode_pallas``: the
bit-serial q/k/v projections off the packed planes, RoPE from the passed
cos/sin rows, ``kv_quantize`` of the new K/V (codes and scales returned
for the caller to scatter) and attention over the pre-write quantized
pool with the new token folded in last.  One C entry point makes two
launches (projection across column tiles, then one CTA per (row, KV
head)); the source note says why.  ``fused_attend_cuda`` runs the second
launch alone on projections the caller gives, so it can be held bitwise
against the plain version.  These wrappers check device, types, shapes
and contiguity, allocate outputs and scratch and launch on the current
stream; they never fall back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import MAX_GROUP
from repro_torch.kernels.paged_attention_quant import check_quant_pool

_ACT = {torch.float32: 0, torch.bfloat16: 1}


def _outputs(B, KV, G, hd, pool, dev):
    hds = pool.shape[-1]
    return (torch.empty((B, KV, G, hd), dtype=torch.float32, device=dev),
            torch.empty((B, KV, hds), dtype=pool.dtype, device=dev),
            torch.empty((B, KV, hds), dtype=pool.dtype, device=dev),
            torch.empty((B, KV), dtype=torch.float32, device=dev),
            torch.empty((B, KV), dtype=torch.float32, device=dev))


def _attend_checks(B, num_heads, k_pool, v_pool, k_scale, v_scale, block_tables,
                   lengths, cos, sin, qmax, hd, dev):
    KV = k_pool.shape[2]
    if num_heads % KV or num_heads // KV > MAX_GROUP:
        raise ValueError(f"{num_heads} heads over {KV} KV heads not supported")
    packed4 = check_quant_pool(k_pool, v_pool, k_scale, v_scale, KV, hd)
    nb = block_tables.shape[1]
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if tuple(block_tables.shape) != (B, nb) or tuple(lengths.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, hd // 2):
            raise ValueError(f"{name} must be float32 ({B}, {hd // 2}), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if qmax.dtype != torch.float32 or qmax.numel() != 1:
        raise TypeError("qmax must be one float32 element")
    tensors = (k_pool, v_pool, k_scale, v_scale, block_tables, lengths, cos, sin, qmax)
    if any(t.device != dev for t in tensors):
        raise ValueError("the fused decode needs every tensor on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the fused decode needs contiguous inputs")
    return KV, packed4, nb


def fused_attend_cuda(proj: torch.Tensor, act_dtype: torch.dtype, k_pool, v_pool,
                      k_scale, v_scale, block_tables, lengths, cos, sin,
                      qmax: torch.Tensor, num_heads: int):
    """Phase (B) alone: ``proj`` (B, H*hd + 2*KV*hd) f32 projections ->
    ``(out (B, KV, G, hd) f32, k_codes, v_codes (B, KV, hds), k_sc,
    v_sc (B, KV) f32)``, as :func:`fused_qkv_paged_decode_cuda`."""
    dev = proj.device
    if dev.type != "cuda" or proj.dtype != torch.float32 or not proj.is_contiguous():
        raise ValueError("proj must be a contiguous float32 CUDA tensor")
    if act_dtype not in _ACT:
        raise TypeError(f"activation dtype {act_dtype} not supported")
    B, ntot = proj.shape
    KV = k_pool.shape[2]
    hd = ntot // (num_heads + 2 * KV)
    if hd * (num_heads + 2 * KV) != ntot:
        raise ValueError(f"proj width {ntot} is not (H + 2*KV) * hd")
    KV, packed4, nb = _attend_checks(B, num_heads, k_pool, v_pool, k_scale, v_scale,
                                     block_tables, lengths, cos, sin, qmax, hd, dev)
    build.require_sm90(dev)
    G = num_heads // KV
    outs = _outputs(B, KV, G, hd, k_pool, dev)
    err = build.library("fused_decode").fused_attend_launch(
        proj.data_ptr(), _ACT[act_dtype], k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), cos.data_ptr(), sin.data_ptr(), qmax.data_ptr(),
        *(t.data_ptr() for t in outs), packed4, B, KV, G, hd, k_pool.shape[1], nb,
        hd ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"fused_attend (B={B}, KV={KV}, G={G}, hd={hd})")
    return outs


def fused_qkv_paged_decode_cuda(x: torch.Tensor, wq, wk, wv, k_pool, v_pool,
                                k_scale, v_scale, block_tables, lengths, cos, sin,
                                qmax: torch.Tensor, num_heads: int):
    """``x`` (B, D) bf16 or f32; ``wq``/``wk``/``wv`` ``Packed`` with
    planes (bits, D/8, N) uint8 and scale (1, N) f32; quantized pools and
    scales as ``paged_attention_quant_cuda``; ``lengths`` (B,) int32
    before the new token; ``cos``/``sin`` (B, hd/2) f32 RoPE rows at
    ``lengths``; ``qmax`` one f32 element on the card.  Returns ``(out
    (B, KV, G, hd) f32, k_codes, v_codes (B, KV, hds) in the pool's dtype,
    k_sc, v_sc (B, KV) f32)``."""
    dev = x.device
    if dev.type != "cuda" or x.dtype not in _ACT or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous bf16/f32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    B, D = x.shape
    H = num_heads
    KV = k_pool.shape[2]
    hd = wq.scale.shape[-1] // H
    for name, w, n in (("wq", wq, H * hd), ("wk", wk, KV * hd), ("wv", wv, KV * hd)):
        if not 2 <= w.bits <= 8 or tuple(w.planes.shape) != (w.bits, D // 8, n):
            raise ValueError(f"{name} planes {tuple(w.planes.shape)} at {w.bits} bits "
                             f"!= ({w.bits}, {D // 8}, {n})")
        if (w.planes.dtype != torch.uint8 or w.scale.dtype != torch.float32
                or w.scale.numel() != n):
            raise TypeError(f"{name} must be uint8 planes with {n} float32 scales")
        if (w.planes.device != dev or w.scale.device != dev
                or not (w.planes.is_contiguous() and w.scale.is_contiguous())):
            raise ValueError(f"{name} must be contiguous on {dev}")
    if D % 8:
        raise ValueError(f"d_model {D} must be a multiple of 8")
    KV, packed4, nb = _attend_checks(B, H, k_pool, v_pool, k_scale, v_scale,
                                     block_tables, lengths, cos, sin, qmax, hd, dev)
    build.require_sm90(dev)
    G = H // KV
    proj = torch.empty((B, (H + 2 * KV) * hd), dtype=torch.float32, device=dev)
    outs = _outputs(B, KV, G, hd, k_pool, dev)
    err = build.library("fused_decode").fused_decode_launch(
        x.data_ptr(), _ACT[x.dtype], wq.planes.data_ptr(), wq.scale.data_ptr(), wq.bits,
        wk.planes.data_ptr(), wk.scale.data_ptr(), wk.bits,
        wv.planes.data_ptr(), wv.scale.data_ptr(), wv.bits, proj.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        qmax.data_ptr(), *(t.data_ptr() for t in outs), packed4, B, D, KV, G, hd,
        k_pool.shape[1], nb, hd ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"fused_qkv_paged_decode (B={B}, D={D}, H={H}, KV={KV}, "
                     f"hd={hd}, bits={wq.bits}/{wk.bits}/{wv.bits})")
    return outs
