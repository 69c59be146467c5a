"""Launch wrapper for the hand-written Hopper paged decode attention
kernel (``csrc/paged_attention.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py::paged_attention_pallas``: one decode
query per row over fp paged KV through a block table, f32 online softmax,
out ``(B, KV, G, hd)`` f32, zeros for a row of length 0.  The source note
in ``csrc/paged_attention.cu`` says what bounds it and how its design
answers that.  This wrapper checks device, types, shapes and contiguity,
picks the split-KV plan (:func:`split_plan`), allocates the output and
the split workspace and launches on the current stream; it never falls
back to the plain version.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 96, 128)
MAX_GROUP = 128  # query heads per KV head (4 per warp, 32 warps)
MAX_SPLITS = 16  # split-KV CTAs per (row, KV head)


def split_plan(nb: int) -> tuple[int, int]:
    """``(pages_per_split, splits)`` for a block table ``nb`` pages wide:
    one page per split up to ``MAX_SPLITS`` pages, then the fewest pages
    per split that keep ``MAX_SPLITS`` splits.  It reads the table's width
    only: the lengths live on the device, and reading them would put a
    host sync in every layer of every decode step."""
    pps = max(1, math.ceil(nb / MAX_SPLITS))
    return pps, math.ceil(nb / pps)


_counters: dict[torch.device, torch.Tensor] = {}
MAX_ROWS_HEADS = 1 << 16  # arrival counters per device: rows x KV heads of a launch


def arrival_counters(dev: torch.device, n: int) -> torch.Tensor:
    """int32 arrival counters of the split-KV kernels, one per (row, KV
    head): zeroed once here, and left zero by every launch (the last split
    CTA of a row and head resets its counter).  One buffer per device,
    allocated at its first use at its full size and never reallocated: a
    captured CUDA graph keeps the pointer it was captured with.  It is not
    allocated while a graph is captured (it would live in the graph's
    private pool), and a launch of more than ``MAX_ROWS_HEADS`` rows x
    heads raises."""
    if n > MAX_ROWS_HEADS:
        raise ValueError(f"{n} (row, KV head) pairs > MAX_ROWS_HEADS = {MAX_ROWS_HEADS}")
    buf = _counters.get(dev)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the split-KV arrival counters must be allocated "
                               "before a CUDA graph is captured")
        buf = torch.zeros(MAX_ROWS_HEADS, dtype=torch.int32, device=dev)
        _counters[dev] = buf
    return buf


def split_workspace_numel(B: int, KV: int, G: int, hd: int, splits: int) -> int:
    """f32 elements of the split workspace (``csrc/split_kv.cuh``): the
    partial accumulators (B, KV, S, G, hd), then (m, l) per head."""
    return B * KV * splits * G * (hd + 2) if splits > 1 else 0


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_tables: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """``q`` (B, KV, G, hd); pools (NB, bs, KV, hd) of q's dtype;
    ``block_tables`` (B, nb) int32; ``lengths`` (B,) int32 ->
    (B, KV, G, hd) float32."""
    dev = q.device
    tensors = (q, k_pool, v_pool, block_tables, lengths)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("paged_attention_cuda needs CUDA tensors on one device")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"q and both pools must share bf16 or f32, got "
                        f"{q.dtype} / {k_pool.dtype} / {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    B, KV, G, hd = q.shape
    NB, bs, KVk, hdk = k_pool.shape
    nb = block_tables.shape[1]
    if (KVk, hdk) != (KV, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool {tuple(k_pool.shape)} / {tuple(v_pool.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if tuple(block_tables.shape) != (B, nb) or tuple(lengths.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    if hd not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"head dim {hd} (want one of {HEAD_DIMS}) or group "
                         f"{G} (max {MAX_GROUP}) not supported")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda needs contiguous inputs")
    build.require_sm90(dev)
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=dev)
    pps, splits = split_plan(nb)
    n_ws = split_workspace_numel(B, KV, G, hd, splits)
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev) if n_ws else None
    arrived = arrival_counters(dev, B * KV) if n_ws else None
    err = build.library("paged_attention").paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if arrived is None else arrived.data_ptr(), _DTYPES[q.dtype], B, KV,
        G, hd, bs, nb, pps, hd ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"paged_attention (B={B}, KV={KV}, G={G}, hd={hd}, bs={bs})")
    return out
