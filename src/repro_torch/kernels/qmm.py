"""Launch wrapper for the hand-written Hopper qmm kernel (``csrc/qmm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/qmm.py::qmm_pallas``:
``y[M, N] = x[M, K] @ dequant(planes[bits, K//8, N], scale[1, N])`` in
f32, with a bit-serial body (decode rows) and a dequant body (prefill
chunks).  The source note in ``csrc/qmm.cu`` says what bounds each body
on the card and how its design answers that.  This wrapper checks device,
types, shapes and contiguity, picks the dequant body's split-K plan
(:func:`dequant_plan`), allocates the output and the split-K workspace
and launches on the current stream; it never falls back to the plain
version.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

PATHS = {"bitserial": 0, "dequant": 1}
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132        # streaming multiprocessors of an H100 SXM
TILE_N = 64      # weight columns per CTA of the wgmma dequant body (wgmma's M)
TILE_K = 64      # K per pipeline stage
STAGES = 5       # ring slots per warpgroup
SMEM_MAX = 232448  # dynamic shared memory a CTA may use (bytes)
SPLIT_STEPS = 12   # K steps a split keeps at least, beyond one CTA per SM


def dequant_smem(token_tile: int, bits: int, kgroups: int) -> int:
    """Shared memory of the dequant body: a ring of ``STAGES`` slots (x
    tile, plane tile padded to 1 KiB) per warpgroup, and 1 KiB of
    alignment slack (``TcSmem`` in ``csrc/qmm.cu``)."""
    planes = bits * (TILE_K // 8) * TILE_N
    slot = token_tile * TILE_K * 2 + -(-planes // 1024) * 1024
    return kgroups * STAGES * slot + 1024


class DequantPlan(NamedTuple):
    """Grid of the wgmma dequant body (bf16 x): ``col_tiles`` x ``splits``
    x ``token_tiles`` CTAs of ``kgroups`` warpgroups, which share out the
    K steps of their split; split ``s`` covers K steps ``[s * chunks //
    splits, (s + 1) * chunks // splits)`` of ``TILE_K``."""
    token_tile: int
    token_tiles: int
    kgroups: int
    col_tiles: int
    chunks: int
    splits: int

    @property
    def ctas(self) -> int:
        return self.col_tiles * self.splits * self.token_tiles

    def k_ranges(self) -> list[tuple[int, int]]:
        """The K range ``[lo, hi)`` of each split, in split order."""
        return [(s * self.chunks // self.splits * TILE_K,
                 (s + 1) * self.chunks // self.splits * TILE_K)
                for s in range(self.splits)]

    def workspace_bytes(self, M: int, N: int) -> int:
        """f32 partial sums, (splits, M, N), when the K loop is split."""
        return 4 * self.splits * M * N if self.splits > 1 else 0


def dequant_plan(M: int, K: int, N: int, bits: int = 4) -> DequantPlan:
    """Token tiles of 64 rows up to M = 128, of 256 above, and 64-column
    tiles.  Two warpgroups per CTA share out its K steps (one at a
    256-token tile, whose registers allow no more, and one when the grid
    already gives every SM four CTAs).  Below one CTA per SM the K loop is
    split: enough for one CTA per SM, and up to as many as an SM holds at
    once while a split keeps ``SPLIT_STEPS`` K steps.  Settings from chip
    runs of the variants at glm4-9b's shapes (PERF.md)."""
    token_tile = 64 if M <= 128 else 256
    token_tiles = -(-M // token_tile)
    chunks = -(-K // TILE_K)
    col_tiles = -(-N // TILE_N)
    tiles = col_tiles * token_tiles
    kgroups = 1 if token_tile == 256 or tiles >= 4 * SMS else 2
    while kgroups > 1 and dequant_smem(token_tile, bits, kgroups) > SMEM_MAX:
        kgroups //= 2
    splits = 1
    if tiles < SMS:
        per_sm = 4 if token_tile == 64 else 1     # CTAs an SM holds at once
        splits = max(math.ceil(SMS / tiles),
                     min(math.ceil(per_sm * SMS / tiles), chunks // SPLIT_STEPS))
        splits = min(splits, chunks)
    return DequantPlan(token_tile, token_tiles, kgroups, col_tiles, chunks, splits)


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
    token_tile, kgroups, splits, ws = 0, 1, 1, None
    if path == "dequant" and x.dtype == torch.bfloat16:
        if x.data_ptr() % 16:      # cp.async copies 16-byte pieces of x
            x = x.clone()
        plan = dequant_plan(M, K, N, bits)
        token_tile, kgroups, splits = plan.token_tile, plan.kgroups, plan.splits
        if splits > 1:
            ws = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
    err = build.library("qmm").qmm_launch(
        x.data_ptr(), _X_DTYPES[x.dtype], planes.data_ptr(), scale.data_ptr(),
        y.data_ptr(), None if ws is None else ws.data_ptr(), M, K, N, bits,
        PATHS[path], token_tile, kgroups, splits,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"qmm_{path} (M={M}, K={K}, N={N}, bits={bits})")
    return y
