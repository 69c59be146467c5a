"""Launch wrapper for the hand-written Hopper fused QKV + quantized paged
decode kernel (``csrc/fused_decode.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/fused_decode.py::fused_qkv_paged_decode_pallas``: the
bit-serial q/k/v projections off the packed planes, RoPE from the passed
cos/sin rows, ``kv_quantize`` of the new K/V (codes and scales returned
for the caller to scatter) and attention over the pre-write quantized
pool with the new token folded in last.  One C entry point makes two
launches: (A) the projection across column tiles and K splits
(:func:`project_plan`), (B) one CTA per (row, KV head, split) of the
pre-write pages plus one for the new token (:func:`attend_plan`); the
source note says why.  ``fused_project_cuda`` runs (A) alone and
``fused_attend_cuda`` runs (B) alone on finished projections the caller
gives, so it can be held bitwise against the plain version.  These
wrappers check device, types, shapes and contiguity, allocate outputs and
scratch and launch on the current stream; they never fall back to the
plain version.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (MAX_GROUP, MAX_SPLITS, arrival_counters,
                                                 split_workspace_numel)
from repro_torch.kernels.paged_attention_quant import check_quant_pool
from repro_torch.kernels.qmm import BS_COLS, BS_CTAS, BS_ROWS, BS_STEP, bitserial_splits

_ACT = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = BS_STEP        # K rows of one bit-serial step: the unit of (A)'s splits
COLS = BS_COLS         # columns per bit-serial CTA (fused_decode.cu PROJECT_WARPS)
PROJECT_CTAS = BS_CTAS   # launch (A) aims at qmm's bit-serial grid


def attend_plan(nb: int) -> tuple[int, int]:
    """``(pages_per_split, splits)`` of launch (B) for a block table ``nb``
    pages wide: as ``paged_attention.split_plan``, but at most
    ``MAX_SPLITS - 1`` page splits, so that with the new token's partial
    the combine takes at most ``MAX_SPLITS``.  The table's width only."""
    pps = max(1, math.ceil(nb / (MAX_SPLITS - 1)))
    return pps, math.ceil(nb / pps)


class ProjectPlan(NamedTuple):
    """Grid of launch (A): ``col_tiles`` x ``row_tiles`` x ``splits`` CTAs
    of the bit-serial body; split ``s`` walks K steps ``[s * chunks //
    splits, (s + 1) * chunks // splits)`` of ``CHUNK`` rows."""
    col_tiles: int
    row_tiles: int
    chunks: int
    splits: int

    @property
    def ctas(self) -> int:
        return self.col_tiles * self.row_tiles * self.splits

    def k_ranges(self, D: int) -> list[tuple[int, int]]:
        """The K rows ``[lo, hi)`` of each split, in split order."""
        return [(s * self.chunks // self.splits * CHUNK,
                 min(D, (s + 1) * self.chunks // self.splits * CHUNK))
                for s in range(self.splits)]

    def workspace_numel(self, B: int, ntot: int) -> int:
        """f32 elements of (A)'s output: the finished (B, ntot) projections
        at one split, else each split's raw partial (splits, B, ntot)."""
        return self.splits * B * ntot


def project_plan(B: int, D: int, widths) -> ProjectPlan:
    """Launch (A) for ``B`` rows of width ``D`` against matrices of
    ``widths`` columns: the bit-serial body's row tiles (32 rows), its
    ``COLS``-column tiles of each matrix, and the K splits of qmm's rule
    (``kernels.qmm.bitserial_splits``) over all of them."""
    row_tiles = -(-B // BS_ROWS)
    col_tiles = sum(-(-n // COLS) for n in widths)
    chunks = -(-D // CHUNK)
    return ProjectPlan(col_tiles, row_tiles, chunks,
                       bitserial_splits(col_tiles * row_tiles, chunks))


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


def _attend_workspace(B, KV, G, hd, nb, dev):
    """Launch (B)'s plan, partial workspace (S + 1 partials per row and
    KV head) and arrival counters."""
    pps, splits = attend_plan(nb)
    ws = torch.empty(split_workspace_numel(B, KV, G, hd, splits + 1), dtype=torch.float32,
                     device=dev)
    return pps, ws, arrival_counters(dev, B * KV)


def fused_attend_cuda(proj: torch.Tensor, act_dtype: torch.dtype, k_pool, v_pool,
                      k_scale, v_scale, block_tables, lengths, cos, sin,
                      qmax: torch.Tensor, num_heads: int):
    """Phase (B) alone: ``proj`` (B, H*hd + 2*KV*hd) f32 finished
    projections -> ``(out (B, KV, G, hd) f32, k_codes, v_codes (B, KV,
    hds), k_sc, v_sc (B, KV) f32)``, as :func:`fused_qkv_paged_decode_cuda`."""
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
    pps, ws, arrived = _attend_workspace(B, KV, G, hd, nb, dev)
    err = build.library("fused_decode").fused_attend_launch(
        proj.data_ptr(), _ACT[act_dtype], k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), cos.data_ptr(), sin.data_ptr(), qmax.data_ptr(),
        *(t.data_ptr() for t in outs), ws.data_ptr(), arrived.data_ptr(), packed4, B, KV,
        G, hd, k_pool.shape[1], nb, pps, hd ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"fused_attend (B={B}, KV={KV}, G={G}, hd={hd})")
    return outs


def _weight_checks(x: torch.Tensor, wq, wk, wv, H: int, KV: int):
    """Validate x and the three packed matrices; return (B, D, hd)."""
    dev = x.device
    if dev.type != "cuda" or x.dtype not in _ACT or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous bf16/f32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    B, D = x.shape
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
    return B, D, hd


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself, or a copy where (A)'s cp.async of 16-byte pieces of a bf16
    x needs one."""
    return x.clone() if x.dtype == torch.bfloat16 and x.data_ptr() % 16 else x


def _weight_args(wq, wk, wv):
    return [a for w in (wq, wk, wv) for a in (w.planes.data_ptr(), w.scale.data_ptr(), w.bits)]


def fused_project_cuda(x: torch.Tensor, wq, wk, wv, num_heads: int, num_kv_heads: int,
                       splits: int | None = None) -> torch.Tensor:
    """Phase (A) alone: ``x`` (B, D) and the three packed matrices as
    :func:`fused_qkv_paged_decode_cuda` -> (splits, B, H*hd + 2*KV*hd)
    f32: the finished projections at one split, else each split's raw
    partial (``kernels.ref.finish_projection`` finishes them).  ``splits``
    defaults to :func:`project_plan`'s; another count is a test hook, for
    the card tests' sweep over split counts."""
    H, KV = num_heads, num_kv_heads
    B, D, hd = _weight_checks(x, wq, wk, wv, H, KV)
    build.require_sm90(x.device)
    plan = project_plan(B, D, (H * hd, KV * hd, KV * hd))
    splits = plan.splits if splits is None else splits
    if not 1 <= splits <= plan.chunks:
        raise ValueError(f"{splits} K splits of {plan.chunks} chunks")
    proj = torch.empty((splits, B, (H + 2 * KV) * hd), dtype=torch.float32, device=x.device)
    x = _aligned(x)
    err = build.library("fused_decode").fused_project_launch(
        x.data_ptr(), _ACT[x.dtype], *_weight_args(wq, wk, wv), proj.data_ptr(), B, D,
        H * hd, KV * hd, splits, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"fused_project (B={B}, D={D}, H={H}, KV={KV}, hd={hd}, "
                     f"splits={splits})")
    return proj


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
    H = num_heads
    KV = k_pool.shape[2]
    B, D, hd = _weight_checks(x, wq, wk, wv, H, KV)
    KV, packed4, nb = _attend_checks(B, H, k_pool, v_pool, k_scale, v_scale,
                                     block_tables, lengths, cos, sin, qmax, hd, dev)
    build.require_sm90(dev)
    G = H // KV
    ntot = (H + 2 * KV) * hd
    plan = project_plan(B, D, (H * hd, KV * hd, KV * hd))
    proj = torch.empty(plan.workspace_numel(B, ntot), dtype=torch.float32, device=dev)
    outs = _outputs(B, KV, G, hd, k_pool, dev)
    pps, ws, arrived = _attend_workspace(B, KV, G, hd, nb, dev)
    x = _aligned(x)
    err = build.library("fused_decode").fused_decode_launch(
        x.data_ptr(), _ACT[x.dtype], *_weight_args(wq, wk, wv), proj.data_ptr(), plan.splits,
        k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        qmax.data_ptr(), *(t.data_ptr() for t in outs), ws.data_ptr(), arrived.data_ptr(),
        packed4, B, D, KV, G, hd, k_pool.shape[1], nb, pps, hd ** -0.5,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"fused_qkv_paged_decode (B={B}, D={D}, H={H}, KV={KV}, "
                     f"hd={hd}, bits={wq.bits}/{wk.bits}/{wv.bits})")
    return outs
