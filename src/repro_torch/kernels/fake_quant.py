"""Launch wrappers and the launch plan of the hand-written Hopper WRPN
fake-quant kernels (``csrc/fake_quant.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/fake_quant.py::fake_quant_pallas``: the per-tensor WRPN
quantize-dequantize, bitwise equal to ``kernels.ref.fake_quant_ref``.  Two
bodies:

- :func:`fake_quant_cuda`, the flat kernel: one tensor at a scale the
  caller gives (``bits`` and ``scale`` as device scalars).
- :func:`fake_quant_group_cuda`, the QAT path's forward: every weight of
  a forward in one launch, each tensor's scale ``max(max|w|, eps)`` taken
  in the launch (one thread-block cluster per tensor, planned by
  :func:`fake_quant_group_plan`), and :func:`fake_quant_group_bwd_cuda`,
  the clipped STE of all of them in one more launch.

The source note in ``csrc/fake_quant.cu`` says what bounds them and how
the design answers that.  The wrappers check device, types, shapes and
contiguity, allocate the outputs and launch on the current stream; they
never fall back to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# csrc/fake_quant.cu's constants (fake_quant_group_limits reports them)
THREADS = 256          # threads per CTA, both grouped kernels
MAX_VECS = 8           # 16-byte vectors a forward thread holds in registers
BWD_VECS = 1           # 16-byte vectors a backward thread handles: more CTAs were faster
GROUP_MAX = 102        # tensors per launch: the backward's descriptors fill 4 KB
MAX_CLUSTER = 8        # the portable cluster size
FWD_PARAM_BYTES = (24, 24)    # (header, per tensor) of the forward's parameters
BWD_PARAM_BYTES = (16, 40)    # the same for the backward
PARAM_CAP = 4096              # bytes of kernel parameters a launch may take


class GroupPlan(NamedTuple):
    """How a group of tensors is launched.

    ``cluster`` CTAs of ``threads`` threads per tensor; ``vecs`` 16-byte
    vectors per thread at most (``vecs * 16 / element size`` elements)
    for the tensors that stay in registers; ``second_read`` the tensors
    whose run of vectors per CTA exceeds ``MAX_VECS`` a thread, which the
    kernel reads twice (once for the max, once for the QDQ);
    ``launches`` the [start, stop) tensor ranges of the launches (at most
    ``GROUP_MAX`` tensors each); per launch, ``ctas`` of the forward,
    ``bwd_ctas`` of the backward and ``param_bytes`` (forward, backward)
    of kernel parameters."""
    cluster: int
    threads: int
    vecs: int
    second_read: tuple
    launches: tuple
    ctas: tuple
    bwd_ctas: tuple
    param_bytes: tuple


def _per_vector(dtype: torch.dtype) -> int:
    if dtype not in _DTYPES:
        raise TypeError(f"the fake-quant kernels take f32 or bf16 weights, got {dtype}")
    return 16 // torch.empty((), dtype=dtype).element_size()


def fake_quant_group_plan(numels, dtype: torch.dtype) -> GroupPlan:
    """The launch plan of a group of tensors of ``numels`` elements each,
    all of ``dtype``.  The cluster is the smallest (1, 2, 4 or 8 CTAs)
    that leaves the largest tensor one 16-byte vector a thread, up to 8:
    the CTAs' serial work, mostly the QDQ's division, is what the launch
    waits on, and more CTAs per tensor were faster at every group measured
    (``scripts/kernel_ablation.py fq``).  Every LeNet and ResNet-20 group
    stays in registers and is read once; a tensor beyond 8 CTAs'
    registers is read twice."""
    numels = [int(n) for n in numels]
    if not numels or min(numels) <= 0:
        raise ValueError(f"a group needs one or more non-empty tensors, got numels {numels}")
    per = _per_vector(dtype)
    held = THREADS * MAX_VECS * per            # elements one CTA holds in registers
    cluster = next((c for c in (1, 2, 4, 8) if max(numels) <= c * THREADS * per), MAX_CLUSTER)
    resident = [n for n in numels if n <= cluster * held]
    vecs = max((math.ceil(math.ceil(math.ceil(n / per) / cluster) / THREADS)
                for n in resident), default=MAX_VECS)
    launches = tuple((s, min(s + GROUP_MAX, len(numels)))
                     for s in range(0, len(numels), GROUP_MAX))
    bwd_chunk = THREADS * BWD_VECS * per
    return GroupPlan(
        cluster=cluster, threads=THREADS, vecs=vecs,
        second_read=tuple(i for i, n in enumerate(numels) if n > cluster * held),
        launches=launches,
        ctas=tuple((b - a) * cluster for a, b in launches),
        bwd_ctas=tuple(sum(-(-n // bwd_chunk) for n in numels[a:b]) for a, b in launches),
        param_bytes=tuple((FWD_PARAM_BYTES[0] + FWD_PARAM_BYTES[1] * (b - a),
                           BWD_PARAM_BYTES[0] + BWD_PARAM_BYTES[1] * (b - a))
                          for a, b in launches))


def _check(what: str, tensors) -> torch.dtype:
    if not tensors:
        raise ValueError(f"{what} needs one or more tensors")
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} needs every tensor on one CUDA device")
    dtype = tensors[0].dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{what} takes tensors of one dtype, f32 or bf16, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    if any(not t.is_contiguous() or t.numel() == 0 for t in tensors):
        raise ValueError(f"{what} needs contiguous, non-empty tensors")
    return dtype


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _numels(tensors):
    return (ctypes.c_int64 * len(tensors))(*(t.numel() for t in tensors))


@functools.cache
def _eps(dtype: torch.dtype) -> float:
    """``tensor_scale``'s floor as it is taken in ``dtype``: bf16(1e-8)
    for bf16 weights, as f32."""
    from repro_torch.quant.wrpn import EPS

    return float(torch.tensor(EPS, dtype=dtype))


def group_launch(ws, outs, bits: torch.Tensor, scale: torch.Tensor, cluster: int) -> None:
    """One launch of the grouped forward over ``ws`` (at most
    ``GROUP_MAX``): ``outs[i]`` and ``scale[i]`` written; ``bits`` and
    ``scale`` hold one entry per tensor (views into the group's vectors).
    No checks: the callers make them."""
    dtype = ws[0].dtype
    err = build.library("fake_quant").fake_quant_group_launch(
        _pointers(ws), _pointers(outs), _numels(ws), len(ws), bits.data_ptr(),
        scale.data_ptr(), _eps(dtype), _DTYPES[dtype], cluster,
        torch.cuda.current_stream(ws[0].device).cuda_stream)
    build.check(err, f"fake_quant_group ({len(ws)} tensors, {dtype}, cluster {cluster})")


def fake_quant_group_cuda(ws, bits: torch.Tensor):
    """``ws``: contiguous tensors of one dtype (f32 or bf16) on one card;
    ``bits``: int32 (len(ws),) on that card -> (the QDQ of each tensor at
    its own scale, the f32 (len(ws),) scales, launches made)."""
    dtype = _check("fake_quant_group_cuda", ws)
    dev = ws[0].device
    if bits.device != dev or bits.dtype != torch.int32 or bits.shape != (len(ws),):
        raise ValueError(f"bits must be int32 ({len(ws)},) on {dev}, got {bits.dtype} "
                         f"{tuple(bits.shape)} on {bits.device}")
    build.require_sm90(dev)
    plan = fake_quant_group_plan([w.numel() for w in ws], dtype)
    outs = [torch.empty_like(w) for w in ws]
    scale = torch.empty(len(ws), dtype=torch.float32, device=dev)
    for a, b in plan.launches:
        group_launch(ws[a:b], outs[a:b], bits[a:], scale[a:], plan.cluster)
    return outs, scale, len(plan.launches)


def fake_quant_group_bwd_cuda(ws, gs, scale: torch.Tensor):
    """The clipped STE of a group: ``gs[i] * (|ws[i]| <= scale[i])`` as a
    product in f32 rounded to the dtype, for contiguous ``ws`` and ``gs``
    of one dtype on one card and the forward's f32 ``scale`` -> (grads,
    launches made)."""
    dtype = _check("fake_quant_group_bwd_cuda", [*ws, *gs])
    dev = ws[0].device
    if len(gs) != len(ws) or any(g.shape != w.shape for g, w in zip(gs, ws)):
        raise ValueError("fake_quant_group_bwd_cuda needs one gradient of each weight's shape")
    if scale.device != dev or scale.dtype != torch.float32 or scale.shape != (len(ws),):
        raise ValueError(f"scale must be f32 ({len(ws)},) on {dev}")
    build.require_sm90(dev)
    plan = fake_quant_group_plan([w.numel() for w in ws], dtype)
    grads = [torch.empty_like(g) for g in gs]
    lib = build.library("fake_quant")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for a, b in plan.launches:
        err = lib.fake_quant_group_bwd_launch(
            _pointers(ws[a:b]), _pointers(gs[a:b]), _pointers(grads[a:b]), _numels(ws[a:b]),
            b - a, scale[a:].data_ptr(), _DTYPES[dtype], stream)
        build.check(err, f"fake_quant_group_bwd ({b - a} tensors, {dtype})")
    return grads, len(plan.launches)


def fake_quant_cuda(w: torch.Tensor, bits: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """``w`` contiguous f32 or bf16 (any shape, flat to the kernel);
    ``bits`` one int32 and ``scale`` one f32, both on ``w``'s device ->
    the QDQ of ``w`` in its dtype."""
    dev = w.device
    if dev.type != "cuda" or bits.device != dev or scale.device != dev:
        raise ValueError("fake_quant_cuda needs w, bits and scale on one CUDA device")
    if w.dtype not in _DTYPES:
        raise TypeError(f"fake_quant_cuda takes f32 or bf16 weights, got {w.dtype}")
    if bits.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError(f"bits must be int32 and scale f32, got {bits.dtype} / {scale.dtype}")
    if bits.numel() != 1 or scale.numel() != 1:
        raise ValueError(f"bits {tuple(bits.shape)} and scale {tuple(scale.shape)} "
                         f"must hold one value each")
    if not w.is_contiguous():
        raise ValueError("fake_quant_cuda needs a contiguous w")
    build.require_sm90(dev)
    out = torch.empty_like(w)
    if w.numel() == 0:
        return out
    vectorized = int(w.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    err = build.library("fake_quant").fake_quant_launch(
        w.data_ptr(), out.data_ptr(), bits.data_ptr(), scale.data_ptr(), w.numel(),
        _DTYPES[w.dtype], vectorized, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"fake_quant (shape {tuple(w.shape)}, {w.dtype})")
    return out
