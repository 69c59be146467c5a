"""Launch wrapper for the hand-written Hopper qmm kernel (``csrc/qmm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/qmm.py::qmm_pallas``:
``y[M, N] = x[M, K] @ dequant(planes[bits, K//8, N], scale[1, N])`` in
f32, with a bit-serial body (decode rows) and a dequant body (prefill
chunks).  The source notes in ``csrc/qmm.cu`` and ``csrc/bitserial.cuh``
say what bounds each body on the card and how its design answers that.
This wrapper checks device, types, shapes and contiguity, picks the
body's split-K plan (:func:`bitserial_plan`, :func:`dequant_plan`),
allocates the output and the split-K workspace and launches on the
current stream; it never falls back to the plain version.
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
# the bit-serial body (csrc/bitserial.cuh)
BS_WARPS = 4         # warps per CTA, 16 weight columns each
BS_COLS = 16 * BS_WARPS
BS_STEP = 128        # K per pipeline stage (16 packed byte rows)
BS_STAGES = 4        # ring slots
BS_ROWS = 32         # x rows per CTA; more rows take more row tiles
BS_PAD = 16          # bytes after each staged plane row
BS_CTAS = 3 * SMS    # the grid the split rule aims at
BS_MIN_STEPS = 2     # K steps a split keeps at least
BS_MAX_SPLITS = 16   # qmm's splits of a tile form one thread-block cluster (H100: <= 16)


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


def bitserial_splits(tiles: int, steps: int) -> int:
    """K splits of the bit-serial body over ``tiles`` CTAs (column x row
    tiles) and ``steps`` K steps: as many as bring the grid to about
    ``BS_CTAS`` (three CTAs per SM), each split keeping at least
    ``BS_MIN_STEPS`` whole steps, and at most ``BS_MAX_SPLITS``; one where
    the tiles already fill it.  The fused decode's projection launch takes
    the same rule."""
    if tiles >= BS_CTAS:
        return 1
    return max(1, min(-(-BS_CTAS // tiles), steps // BS_MIN_STEPS, BS_MAX_SPLITS))


def bitserial_smem(M: int, bits: int, warps: int = BS_WARPS) -> int:
    """Dynamic shared memory of the bit-serial body: ``BS_STAGES`` slots of
    the x rows (whole n8 tiles of a row tile, 2 * BS_STEP bytes each) and
    ``bits`` planes x 16 byte rows of the column tile, each row padded by
    ``BS_PAD`` (``slot_bytes`` in ``csrc/bitserial.cuh``)."""
    nt = -(-min(M, BS_ROWS) // 8)
    return BS_STAGES * (nt * 8 * 2 * BS_STEP + bits * 16 * (16 * warps + BS_PAD))


class BitserialPlan(NamedTuple):
    """Grid of the bit-serial body (bf16 x): ``col_tiles`` x ``splits`` x
    ``row_tiles`` CTAs of ``warps`` warps (16 columns each, all of a row
    tile's up to ``BS_ROWS`` rows); split ``s`` covers K steps ``[s * steps
    // splits, (s + 1) * steps // splits)`` of ``BS_STEP``.  qmm launches a
    tile's splits as one cluster, which sums them in split order: no
    workspace."""
    warps: int
    col_tiles: int
    row_tiles: int
    steps: int
    splits: int

    @property
    def ctas(self) -> int:
        return self.col_tiles * self.splits * self.row_tiles

    def k_ranges(self, K: int) -> list[tuple[int, int]]:
        """The K range ``[lo, hi)`` of each split, in split order."""
        return [(s * self.steps // self.splits * BS_STEP,
                 min(K, (s + 1) * self.steps // self.splits * BS_STEP))
                for s in range(self.splits)]


def bitserial_plan(M: int, K: int, N: int, bits: int = 4,
                   warps: int | None = None) -> BitserialPlan:
    """Row tiles of ``BS_ROWS`` rows (one at decode's M <= 32: the planes
    are read once per call), column tiles of ``16 * warps`` columns and the
    split rule of :func:`bitserial_splits`.  ``BS_WARPS`` warps per CTA,
    halved (down to one) while even the most splits would leave SMs
    without a CTA, as at N = 256.  ``bits`` sizes nothing here (see
    :func:`bitserial_smem`); a given ``warps`` is the ablation's hook."""
    row_tiles = -(-M // BS_ROWS)
    steps = -(-K // BS_STEP)
    if warps is None:
        warps = BS_WARPS
        while (warps > 1 and -(-N // (16 * warps)) * row_tiles
               * max(1, min(steps // BS_MIN_STEPS, BS_MAX_SPLITS)) < SMS):
            warps //= 2
    col_tiles = -(-N // (16 * warps))
    return BitserialPlan(warps, col_tiles, row_tiles, steps,
                         bitserial_splits(col_tiles * row_tiles, steps))


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
    token_tile, groups, splits, ws = 0, 1, 1, None
    if x.dtype == torch.bfloat16:
        if x.data_ptr() % 16:      # cp.async copies 16-byte pieces of x
            x = x.clone()
        if path == "dequant":
            dplan = dequant_plan(M, K, N, bits)
            token_tile, groups, splits = dplan.token_tile, dplan.kgroups, dplan.splits
            if splits > 1:
                ws = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
        else:
            bplan = bitserial_plan(M, K, N, bits)
            groups, splits = bplan.warps, bplan.splits
    err = build.library("qmm").qmm_launch(
        x.data_ptr(), _X_DTYPES[x.dtype], planes.data_ptr(), scale.data_ptr(),
        y.data_ptr(), None if ws is None else ws.data_ptr(), M, K, N, bits,
        PATHS[path], token_tile, groups, splits,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"qmm_{path} (M={M}, K={K}, N={N}, bits={bits})")
    return y
