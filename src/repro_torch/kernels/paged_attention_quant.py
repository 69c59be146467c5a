"""Launch wrapper for the hand-written Hopper paged decode attention over
quantized KV blocks (``csrc/paged_attention_quant.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py::paged_attention_quant_pallas``: one
decode query per row over int8 codes (or nibble-packed uint8 at uniform
int4) with per-(token, KV head) f32 scales, dequantized in registers as
``codes * scale``; f32 online softmax; out ``(B, KV, G, hd)`` f32, zeros
for a row of length 0.  The source note says what bounds it and how its
design answers that.  This wrapper checks device, types, shapes and
contiguity, takes the split-KV plan of the fp kernel
(``paged_attention.split_plan``), allocates the output and the split
workspace and launches on the current stream; it never falls back to the
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (HEAD_DIMS, MAX_GROUP, arrival_counters,
                                                 split_plan, split_workspace_numel)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CONTAINERS = {torch.int8: 0, torch.uint8: 1}   # int8 codes / packed int4


def check_quant_pool(k_pool, v_pool, k_scale, v_scale, KV: int, hd: int,
                     head_dims=HEAD_DIMS) -> int:
    """Validate a quantized pool pair and its scales against (KV, hd), hd
    one of ``head_dims``; return the container flag (1 = nibble-packed
    uint8)."""
    if k_pool.dtype not in CONTAINERS or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"quantized pools must both be int8 or uint8, got "
                        f"{k_pool.dtype} / {v_pool.dtype}")
    packed4 = CONTAINERS[k_pool.dtype]
    NB, bs, KVk, hds = k_pool.shape
    if (KVk, hds) != (KV, hd // 2 if packed4 else hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool {tuple(k_pool.shape)} / {tuple(v_pool.shape)} does "
                         f"not hold KV={KV}, hd={hd} as {k_pool.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("k_scale and v_scale must be float32")
    if tuple(k_scale.shape) != (NB, bs, KV) or v_scale.shape != k_scale.shape:
        raise ValueError(f"scales {tuple(k_scale.shape)} / {tuple(v_scale.shape)} "
                         f"!= {(NB, bs, KV)}")
    if hd not in head_dims:
        raise ValueError(f"head dim {hd} not supported (want one of {head_dims})")
    return packed4


def paged_attention_quant_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor, block_tables: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """``q`` (B, KV, G, hd) bf16 or f32; pools (NB, bs, KV, hd) int8 or
    (NB, bs, KV, hd/2) uint8; scales (NB, bs, KV) f32; ``block_tables``
    (B, nb) int32; ``lengths`` (B,) int32 -> (B, KV, G, hd) float32."""
    dev = q.device
    tensors = (q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("paged_attention_quant_cuda needs CUDA tensors on one device")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    B, KV, G, hd = q.shape
    packed4 = check_quant_pool(k_pool, v_pool, k_scale, v_scale, KV, hd)
    NB, bs = k_pool.shape[:2]
    nb = block_tables.shape[1]
    if tuple(block_tables.shape) != (B, nb) or tuple(lengths.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    if G > MAX_GROUP:
        raise ValueError(f"group {G} > {MAX_GROUP} not supported")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_quant_cuda needs contiguous inputs")
    build.require_sm90(dev)
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=dev)
    pps, splits = split_plan(nb)
    n_ws = split_workspace_numel(B, KV, G, hd, splits)
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev) if n_ws else None
    arrived = arrival_counters(dev, B * KV) if n_ws else None
    err = build.library("paged_attention_quant").paged_attention_quant_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if arrived is None else arrived.data_ptr(), _DTYPES[q.dtype], packed4, B, KV,
        G, hd, bs, nb, pps, hd ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"paged_attention_quant (B={B}, KV={KV}, G={G}, hd={hd}, "
                     f"bs={bs}, {'int4' if packed4 else 'int8'})")
    return out
