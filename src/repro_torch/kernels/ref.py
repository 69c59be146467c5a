"""Plain torch versions of the hand-written kernels' functions (port of
the matching ``repro.kernels.ref`` oracles).

They are what a CPU tensor runs through ``kernels.ops``, and what the
tests and ``chip_smoke.py`` hold each CUDA kernel against.  Nothing on
the main path calls them when the tensors live on a card.
"""
from __future__ import annotations

import torch

from repro_torch.quant.pack import (kv_dequantize, kv_pack_int4, kv_quantize,
                                    kv_unpack_int4, unpack_bitplanes)
from repro_torch.quant.wrpn import fake_quant as _fake_quant
from repro_torch.quant.wrpn import tensor_scale


def fake_quant_ref(w: torch.Tensor, bits, scale: torch.Tensor) -> torch.Tensor:
    """WRPN mid-tread QDQ with an externally supplied per-tensor scale,
    op for op ``repro.quant.wrpn.fake_quant``; ``bits`` an int or an
    int32 tensor on ``w``'s device."""
    return _fake_quant(w, bits, scale=scale)


def fake_quant_group_ref(ws, bits):
    """Each tensor's ``tensor_scale`` and its QDQ at ``bits[i]``, tensor by
    tensor -> (the QDQ tensors, the f32 vector of scales)."""
    scales = [tensor_scale(w) for w in ws]
    outs = [fake_quant_ref(w, bits[i], s) for i, (w, s) in enumerate(zip(ws, scales))]
    return outs, torch.stack(scales)


def fake_quant_group_bwd_ref(ws, gs, scales: torch.Tensor) -> list:
    """The clipped STE, tensor by tensor (``repro.quant.wrpn._fq_bwd``):
    ``g * inside``, with |w| compared in f32 against the scale, as jnp
    promotes a bf16 |w| against the f32 scale."""
    return [g * (w.abs().float() <= scales[i]).to(g.dtype)
            for i, (w, g) in enumerate(zip(ws, gs))]


def dequant_ref(packed: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed bitplanes (bits, K//8, N) + scale (1, N) -> float32 (K, N)."""
    n = float(2 ** (bits - 1) - 1) if bits > 1 else 1.0
    return unpack_bitplanes(packed, bits).float() / n * scale


def qmm_ref(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
            bits: int) -> torch.Tensor:
    """y = x @ dequant(packed).  x: (M, K) float; out: (M, N) float32."""
    return x.float() @ dequant_ref(packed, scale, bits)


def paged_attention_ref(
    q: torch.Tensor,             # (B, 1, H, hd) — one new token per sequence
    k_pool: torch.Tensor,        # (NB, bs, KV, hd) — one layer's paged blocks
    v_pool: torch.Tensor,        # (NB, bs, KV, hd)
    block_tables: torch.Tensor,  # (B, nb) int32 physical block ids
    lengths: torch.Tensor,       # (B,) valid tokens per sequence
) -> torch.Tensor:
    """Gather each sequence's pages into a contiguous (B, nb*bs, KV, hd)
    view, then run the exact :func:`models.common.decode_attention`
    math.  Returns (B, 1, H, hd) in ``q``'s dtype.  A row of length 0
    gives the uniform average over its pages, as the reference oracle
    does; the kernel returns zeros there, and such rows are never read."""
    from repro_torch.models.common import decode_attention

    B, nb = block_tables.shape
    bs = k_pool.shape[1]
    bt = block_tables.long()
    kg = k_pool[bt].reshape(B, nb * bs, *k_pool.shape[2:])
    vg = v_pool[bt].reshape(B, nb * bs, *v_pool.shape[2:])
    return decode_attention(q, kg, vg, lengths)


def gather_dequant(pool: torch.Tensor, scale: torch.Tensor,
                   bt: torch.Tensor) -> torch.Tensor:
    """Gather a row's pages of a quantized pool (int8, or nibble-packed
    uint8) and its scales -> f32 values (B, nb*bs, KV, hd)."""
    B, nb = bt.shape
    bs = pool.shape[1]
    codes = pool[bt].reshape(B, nb * bs, *pool.shape[2:])
    if pool.dtype == torch.uint8:
        codes = kv_unpack_int4(codes)
    return kv_dequantize(codes, scale[bt].reshape(B, nb * bs, scale.shape[2]))


def quant_paged_attention_ref(
    q: torch.Tensor,             # (B, 1, H, hd)
    k_pool: torch.Tensor,        # (NB, bs, KV, hd) int8 | (NB, bs, KV, hd//2) u8
    v_pool: torch.Tensor,        # same container as k_pool
    k_scale: torch.Tensor,       # (NB, bs, KV) float32
    v_scale: torch.Tensor,       # (NB, bs, KV) float32
    block_tables: torch.Tensor,  # (B, nb) int32
    lengths: torch.Tensor,       # (B,) int32
) -> torch.Tensor:
    """Decode attention over quantized KV blocks: gather codes and scales,
    dequantize (``codes * scale`` in f32, bitwise what an oracle pool
    stores), then the :func:`decode_attention` math.  (B, 1, H, hd) in
    ``q``'s dtype; a row of length 0 averages its pages, as the reference
    oracle does."""
    from repro_torch.models.common import decode_attention

    bt = block_tables.long()
    return decode_attention(q, gather_dequant(k_pool, k_scale, bt),
                            gather_dequant(v_pool, v_scale, bt), lengths)


def finish_projection(proj: torch.Tensor, wq, wk, wv) -> torch.Tensor:
    """Plain twin of the fused decode's attend prologue: the projection
    launch's output ``proj`` (splits, B, ntot) -> the finished (B, ntot)
    projections: the raw partials summed in split order, then ``/ n *
    scale`` of each column's matrix.  One split is already finished."""
    if proj.shape[0] == 1:
        return proj[0]
    s = proj[0]
    for p in proj[1:]:
        s = s + p
    n = torch.cat([torch.full((w.scale.numel(),), float(2 ** (w.bits - 1) - 1),
                              device=proj.device) for w in (wq, wk, wv)])
    scale = torch.cat([w.scale.reshape(-1) for w in (wq, wk, wv)])
    return s / n * scale


def fused_decode_attend_ref(
    proj: torch.Tensor,          # (B, H*hd + 2*KV*hd) f32: q | k | v projections
    k_pool, v_pool,              # quantized blocks (pre-write)
    k_scale, v_scale,            # (NB, bs, KV) f32
    block_tables: torch.Tensor,  # (B, nb) int32
    lengths: torch.Tensor,       # (B,) int32 — length BEFORE the new token
    cos: torch.Tensor,           # (B, hd/2) f32 RoPE rows at lengths[b]
    sin: torch.Tensor,
    qmax,                        # 0-d f32: this layer's KV code ceiling
    num_heads: int, num_kv_heads: int, act_dtype: torch.dtype,
):
    """Everything of the fused decode after the q/k/v projections: round
    them to ``act_dtype``, RoPE (rounded again), ``kv_quantize`` the new
    K/V, attend over the pre-write pool with the new token's QDQ value
    spliced at ``min(len, Tc - 1)``.  Returns ``(attn (B, 1, H, hd) in
    act_dtype, k_codes, v_codes, k_sc (B, KV), v_sc (B, KV))``, codes
    nibble-packed when the pool is uint8."""
    from repro_torch.models.common import decode_attention, rope_rotate

    B = proj.shape[0]
    H, KV = num_heads, num_kv_heads
    hd = proj.shape[1] // (H + 2 * KV)
    q, k, v = proj.to(act_dtype).split([H * hd, KV * hd, KV * hd], dim=1)
    cos, sin = cos[:, None, :], sin[:, None, :]
    q = rope_rotate(q.reshape(B, H, hd), cos, sin).to(act_dtype)
    k = rope_rotate(k.reshape(B, KV, hd), cos, sin).to(act_dtype)
    k_codes, k_sc = kv_quantize(k, qmax)                     # (B, KV, hd)
    v_codes, v_sc = kv_quantize(v.reshape(B, KV, hd), qmax)
    bt = block_tables.long()
    Tc = bt.shape[1] * k_pool.shape[1]
    kg = gather_dequant(k_pool, k_scale, bt)
    vg = gather_dequant(v_pool, v_scale, bt)
    slot = torch.clamp(lengths.long(), max=Tc - 1)
    rows = torch.arange(B, device=proj.device)
    kg[rows, slot] = kv_dequantize(k_codes, k_sc)
    vg[rows, slot] = kv_dequantize(v_codes, v_sc)
    eff_len = torch.clamp(lengths + 1, max=Tc)
    out = decode_attention(q[:, None], kg, vg, eff_len)
    if k_pool.dtype == torch.uint8:
        k_codes, v_codes = kv_pack_int4(k_codes), kv_pack_int4(v_codes)
    return out, k_codes, v_codes, k_sc, v_sc


def fused_qkv_paged_decode_ref(
    x: torch.Tensor,             # (B, D) post-norm hidden, one token per row
    wq, wk, wv,                  # quant.pack.Packed projection weights
    k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
    cos: torch.Tensor, sin: torch.Tensor, qmax,
    num_heads: int, num_kv_heads: int,
):
    """Composed plain version of the fused decode kernel (twin of the
    reference's ``fused_qkv_paged_decode_ref``): the q/k/v projections
    with :func:`qmm_ref`, then :func:`fused_decode_attend_ref`.  The RoPE
    rows are the caller's: ``models.common.rope_cos_sin(lengths, ...)``."""
    proj = torch.cat([qmm_ref(x, w.planes, w.scale, w.bits) for w in (wq, wk, wv)],
                     dim=1)
    return fused_decode_attend_ref(proj, k_pool, v_pool, k_scale, v_scale,
                                   block_tables, lengths, cos, sin, qmax,
                                   num_heads, num_kv_heads, x.dtype)
