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
not.  Every bump takes a lock and also lands in the bumping thread's
:func:`recording` blocks, so a capture in one thread takes back its own
ticks and no launch another thread makes meanwhile.

These wrappers own the shape normalisation the kernels do not: batch
dims are flattened to rows and restored after.  Ragged edges (N or K not
a multiple of the tile, as at d_ff = 13696) are masked inside the
kernels, so nothing is padded here.

``fake_quant_group`` is the QAT quantizer's forward and
``fake_quant_group_bwd`` its STE (``quant.wrpn.fake_quant_ste_group``):
one launch each per QAT forward and backward.  ``fake_quant_group_col``
and ``fake_quant_group_col_bwd`` are the same pair at per-column scales
over stacked ``(L, K, N)`` leaves with per-layer bits: the LM QAT path's
(``quant.qat.quantize_params``); ``fake_quant_group_col_max`` and
``fake_quant_group_col_qdq`` are its forward's two passes apart, for leaves
whose scales are reduced across tensor-parallel ranks in between.  ``fake_quant`` is the flat kernel, for a
scale the caller gives.

Meta tensors (shapes with no storage: ``launch.specs`` builds a model's
stand-ins there) take a third branch: each op returns empty outputs of
the kernel's shapes and dtypes on meta, launches nothing, counts nothing
in ``counts``, and charges its kernel's contract cost -- the flops and
the bytes the kernel itself must read and write, as the bounds in
``PERF.md`` reckon them -- to every :func:`charging` block of the
calling thread (``launch.op_costs.count_costs`` holds one).  The plain
version's internals, which dequantize a whole weight, are never what is
charged.  The CUDA branch does no more host work for it.

Quantized KV: ``paged_attention`` takes the quantized-block kernel when
scales are passed, and ``fused_qkv_paged_decode`` runs the fused QKV +
RoPE + KV-quantize + attention kernel.  The reference gates its fused
Pallas kernel on the packed planes fitting 8 MiB of TPU VMEM; the Hopper
kernel streams the planes from device memory, so on the card the fused
op always launches it.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from repro_torch.kernels import ref as kref

counts = {"qmm_bitserial": 0, "qmm_dequant": 0, "paged_attention": 0,
          "paged_attention_quant": 0, "fused_qkv_paged_decode": 0, "fake_quant": 0,
          "fake_quant_group": 0, "fake_quant_group_bwd": 0, "fake_quant_group_col": 0,
          "fake_quant_group_col_max": 0, "fake_quant_group_col_qdq": 0,
          "fake_quant_group_col_bwd": 0, "plain": 0}


_lock = threading.Lock()
_local = threading.local()


def reset_counts() -> None:
    with _lock:
        for key in counts:
            counts[key] = 0


def _bump(key: str, n: int = 1) -> None:
    with _lock:
        counts[key] += n
    for rec in getattr(_local, "recorders", ()):
        rec[key] = rec.get(key, 0) + n


def add_counts(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (key -> launches) to ``counts``."""
    for key, n in delta.items():
        _bump(key, times * n)


@contextlib.contextmanager
def recording():
    """-> a dict that collects the counts THIS thread bumps inside the
    block (nested blocks each collect), whatever other threads launch
    meanwhile."""
    rec: dict = {}
    stack = getattr(_local, "recorders", ())
    _local.recorders = (*stack, rec)
    try:
        yield rec
    finally:
        _local.recorders = stack


@contextlib.contextmanager
def charging(sink):
    """Inside the block, every kernel entry point THIS thread calls on
    meta tensors calls ``sink(kernel, flops, nbytes)`` with its contract
    cost (nested blocks each receive it)."""
    stack = getattr(_local, "sinks", ())
    _local.sinks = (*stack, sink)
    try:
        yield
    finally:
        _local.sinks = stack


def _route(t: torch.Tensor) -> str:
    """``"cuda"`` (launch the kernel), ``"cpu"`` (its plain version) or
    ``"meta"`` (shapes only: :func:`_stand_in`)."""
    kind = t.device.type
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return kind


def _stand_in(kernel: str, flops: float, nbytes: float, *outputs):
    """Charge ``kernel``'s contract cost to this thread's :func:`charging`
    blocks and return a list of empty meta tensors of ``outputs`` ((shape,
    dtype) pairs) in place of what it would write."""
    for sink in getattr(_local, "sinks", ()):
        sink(kernel, float(flops), float(nbytes))
    return [torch.empty(shape, dtype=dtype, device="meta") for shape, dtype in outputs]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _kv_rows(k_pool, block_tables, k_scale) -> int:
    """Bytes of the K and V rows (and scales) a block table addresses:
    every slot of its pages, since a meta tensor holds no lengths; the
    count XLA's analysis of the reference's decode step makes too."""
    B, nb = block_tables.shape
    NB, bs, KV, hds = k_pool.shape
    rows = B * nb * bs * KV
    per_row = hds * k_pool.element_size() + (4 if k_scale is not None else 0)
    return 2 * rows * per_row


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
    route = _route(w)
    if route == "cuda":
        from repro_torch.kernels.fake_quant import fake_quant_cuda

        out = fake_quant_cuda(w2.contiguous(), bits, scale)
        _bump("fake_quant")
    elif route == "meta":
        (out,) = _stand_in("fake_quant", 0, 2 * _nbytes(w2) + 4, (w2.shape, w2.dtype))
    else:
        out = kref.fake_quant_ref(w2, bits, scale)
        _bump("plain")
    return out.reshape(shape)


def fake_quant_group(ws, bits):
    """WRPN QDQ of every tensor of ``ws`` at its own per-tensor scale
    ``max(max|w|, eps)`` (``tensor_scale``), tensor i at ``bits[i]`` (an
    int32 vector on the tensors' device).  Returns (the QDQ tensors, the
    f32 vector of scales).  On CUDA: one grouped launch (more only past
    ``GROUP_MAX`` tensors), counted per launch."""
    route = _route(ws[0])
    if route == "cuda":
        from repro_torch.kernels.fake_quant import fake_quant_group_cuda

        outs, scales, launches = fake_quant_group_cuda([w.contiguous() for w in ws], bits)
        _bump("fake_quant_group", launches)
        return outs, scales
    if route == "meta":
        *outs, scales = _stand_in("fake_quant_group", 0, 2 * _nbytes(*ws) + 8 * len(ws),
                                  *((w.shape, w.dtype) for w in ws),
                                  ((len(ws),), torch.float32))
        return outs, scales
    _bump("plain")
    return kref.fake_quant_group_ref(ws, bits)


def fake_quant_group_bwd(ws, gs, scales: torch.Tensor) -> list:
    """The clipped STE of a group: ``gs[i] * (|ws[i]| <= scales[i])`` in
    each gradient's dtype.  On CUDA: one launch for the group."""
    route = _route(gs[0])
    if route == "meta":
        return _stand_in("fake_quant_group_bwd", 0, _nbytes(*ws) + 2 * _nbytes(*gs) + 4 * len(ws),
                         *((g.shape, g.dtype) for g in gs))
    if route == "cuda":
        from repro_torch.kernels.fake_quant import fake_quant_group_bwd_cuda

        grads, launches = fake_quant_group_bwd_cuda([w.contiguous() for w in ws],
                                                    [g.contiguous() for g in gs], scales)
        _bump("fake_quant_group_bwd", launches)
        return grads
    _bump("plain")
    return kref.fake_quant_group_bwd_ref(ws, gs, scales)


def fake_quant_group_col(ws, bits):
    """WRPN QDQ of every leaf of ``ws`` at its per-column scales
    ``max(max_k |w[..., k, n]|, eps)``, leaf i at ``bits[i]`` (an int32
    tensor on the leaves' device: one value per layer of the leading dims,
    one per stacked layer of an expert bank ``(L, E, K, N)``, or one;
    ``kernels.ref.col_bits_view``).  Returns (the QDQ leaves, the f32 scales as ``(..., 1, N)``).
    On CUDA: one grouped call of two kernels, a max pass and the QDQ (more
    only past ``COL_MAX`` leaves), counted once a call."""
    route = _route(ws[0])
    if route == "cuda":
        from repro_torch.kernels.fake_quant import fake_quant_group_col_cuda

        outs, scales, launches = fake_quant_group_col_cuda([w.contiguous() for w in ws], bits)
        _bump("fake_quant_group_col", launches)
        return outs, scales
    if route == "meta":
        col = [(*w.shape[:-2], 1, w.shape[-1]) for w in ws]
        made = _stand_in("fake_quant_group_col", 0,
                         2 * _nbytes(*ws) + 4 * sum(math.prod(c) for c in col) + _nbytes(*bits),
                         *((w.shape, w.dtype) for w in ws),
                         *((c, torch.float32) for c in col))
        return made[:len(ws)], made[len(ws):]
    _bump("plain")
    return kref.fake_quant_group_col_ref(ws, bits)


def fake_quant_group_col_max(ws) -> list:
    """The per-column scales of every leaf of ``ws`` alone,
    ``fake_quant_group_col``'s max pass: f32 ``(..., 1, N)``.  On CUDA: one
    launch (more only past ``COL_MAX`` leaves)."""
    route = _route(ws[0])
    if route == "cuda":
        from repro_torch.kernels.fake_quant import fake_quant_group_col_max_cuda

        scales, launches = fake_quant_group_col_max_cuda([w.contiguous() for w in ws])
        _bump("fake_quant_group_col_max", launches)
        return scales
    if route == "meta":
        col = [(*w.shape[:-2], 1, w.shape[-1]) for w in ws]
        return _stand_in("fake_quant_group_col_max", 0,
                         _nbytes(*ws) + 4 * sum(math.prod(c) for c in col),
                         *((c, torch.float32) for c in col))
    _bump("plain")
    return kref.fake_quant_group_col_max_ref(ws)


def fake_quant_group_col_qdq(ws, bits, scales) -> list:
    """``fake_quant_group_col``'s QDQ pass alone, at given f32 ``(..., 1,
    N)`` scales (a row-parallel leaf's, reduced across ranks).  On CUDA: one
    launch."""
    route = _route(ws[0])
    if route == "cuda":
        from repro_torch.kernels.fake_quant import fake_quant_group_col_qdq_cuda

        outs, launches = fake_quant_group_col_qdq_cuda([w.contiguous() for w in ws], bits,
                                                       scales)
        _bump("fake_quant_group_col_qdq", launches)
        return outs
    if route == "meta":
        return _stand_in("fake_quant_group_col_qdq", 0,
                         2 * _nbytes(*ws) + _nbytes(*scales) + _nbytes(*bits),
                         *((w.shape, w.dtype) for w in ws))
    _bump("plain")
    return kref.fake_quant_group_col_qdq_ref(ws, bits, scales)


def fake_quant_group_col_bwd(ws, gs, scales) -> list:
    """The per-column clipped STE of a group: ``gs[i] * (|ws[i]| <=
    scales[i])`` in each gradient's dtype.  On CUDA: one launch."""
    route = _route(gs[0])
    if route == "meta":
        return _stand_in("fake_quant_group_col_bwd", 0,
                         _nbytes(*ws) + 2 * _nbytes(*gs) + _nbytes(*scales),
                         *((g.shape, g.dtype) for g in gs))
    if route == "cuda":
        from repro_torch.kernels.fake_quant import fake_quant_group_col_bwd_cuda

        grads, launches = fake_quant_group_col_bwd_cuda(
            [w.contiguous() for w in ws], [g.contiguous() for g in gs], scales)
        _bump("fake_quant_group_col_bwd", launches)
        return grads
    _bump("plain")
    return kref.fake_quant_group_col_bwd_ref(ws, gs, scales)


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
    route = _route(x)
    if route == "cuda":
        from repro_torch.kernels.qmm import qmm_cuda

        out = qmm_cuda(x2.contiguous(), packed, scale.reshape(1, N), bits, path)
        _bump("qmm_" + path)
    elif route == "meta":
        # planes (bits * K * N / 8 bytes), scale, x read; y (f32) written
        (out,) = _stand_in("qmm_" + path, 2 * M * K * N,
                           _nbytes(packed, scale, x2) + 4 * M * N, ((M, N), torch.float32))
    else:
        out = kref.qmm_ref(x2, packed, scale, bits)
        _bump("plain")
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
    route = _route(q)
    if route == "meta":
        # q·k and p·v over every slot the table addresses; f32 out
        T = block_tables.shape[1] * k_pool.shape[1]
        (out,) = _stand_in("paged_attention_quant" if quantized else "paged_attention",
                           4 * B * H * hd * T,
                           _nbytes(q, block_tables, lengths)
                           + _kv_rows(k_pool, block_tables, k_scale) + 4 * B * H * hd,
                           ((B, KV, H // KV, hd), torch.float32))
        return out.reshape(B, 1, H, hd).to(q.dtype)
    if route == "cuda":
        q4 = q.reshape(B, KV, H // KV, hd)
        if quantized:
            from repro_torch.kernels.paged_attention_quant import (
                paged_attention_quant_cuda)

            out = paged_attention_quant_cuda(q4.contiguous(), k_pool, v_pool, k_scale,
                                             v_scale, block_tables, lengths)
            _bump("paged_attention_quant")
        else:
            from repro_torch.kernels.paged_attention import paged_attention_cuda

            if k_pool.dtype == torch.float32:
                q4 = q4.float()
            out = paged_attention_cuda(q4.contiguous(), k_pool, v_pool,
                                       block_tables, lengths)
            _bump("paged_attention")
        return out.reshape(B, 1, H, hd).to(q.dtype)
    _bump("plain")
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
    route = _route(x)
    if route == "meta":
        # launch (A): the three projections off their planes; launch (B):
        # q·k and p·v over every slot the table addresses and the new
        # token, the new token's codes and scales written
        D, G, hds = x.shape[1], H // KV, k_pool.shape[-1]
        T = block_tables.shape[1] * k_pool.shape[1]
        out, kc, vc, ks, vs = _stand_in(
            "fused_qkv_paged_decode",
            2 * B * D * (H + 2 * KV) * hd + 4 * B * H * hd * (T + 1),
            _nbytes(x, wq.planes, wq.scale, wk.planes, wk.scale, wv.planes, wv.scale,
                    block_tables, lengths, cos, sin)
            + _kv_rows(k_pool, block_tables, k_scale) + 4 * B * H * hd
            + 2 * B * KV * (hds * k_pool.element_size() + 4),
            ((B, KV, G, hd), torch.float32), ((B, KV, hds), k_pool.dtype),
            ((B, KV, hds), k_pool.dtype), ((B, KV), torch.float32), ((B, KV), torch.float32))
        return out.reshape(B, 1, H, hd).to(x.dtype), kc, vc, ks, vs
    if route == "cuda":
        from repro_torch.kernels.fused_decode import fused_qkv_paged_decode_cuda

        qmax = torch.as_tensor(qmax, dtype=torch.float32, device=x.device)
        out, kc, vc, ks, vs = fused_qkv_paged_decode_cuda(
            x.contiguous(), wq, wk, wv, k_pool, v_pool, k_scale, v_scale,
            block_tables, lengths, cos, sin, qmax, H)
        _bump("fused_qkv_paged_decode")
        return out.reshape(B, 1, H, hd).to(x.dtype), kc, vc, ks, vs
    _bump("plain")
    out, kc, vc, ks, vs = kref.fused_qkv_paged_decode_ref(
        x, wq, wk, wv, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
        cos, sin, qmax, H, KV)
    return out.to(x.dtype), kc, vc, ks, vs
