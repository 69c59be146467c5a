"""Mixture-of-Experts FFN with sort-based dispatch (torch port of
``repro.models.moe``).

Top-k routing over softmax gates, renormalized over the selected k; each
sequence's (token, choice) pairs are sorted by expert (stably, so token
order is the priority) and scattered into an (E, C, D) capacity buffer.
Choices past an expert's capacity ``C`` are dropped (the residual carries
them); serving passes ``no_drop`` and sizes ``C = S·k``, so nothing drops.

What differs from the reference, and why:

- ``jax.lax.top_k`` breaks ties toward the lower expert index;
  ``torch.topk`` on CUDA promises no order.  :func:`_route` takes a
  stable descending sort instead.
- The reference scatters with ``mode="drop"`` to an out-of-range row
  ``E·C``; torch raises there.  :func:`_dispatch` allocates ``E·C + 1``
  rows and slices the sentinel off, with no boolean-mask indexing (it
  would wait on the device and break a captured graph).
- The reference combines with ``.at[src].add``: the contributions of a
  token summed into zeros in sorted order (ascending expert id) in x's
  dtype.  ``index_add_`` on CUDA uses atomics, whose order varies from
  run to run, so :func:`_undispatch` gathers each token's k contributions
  and adds them in that same order with no atomics: a captured step is
  bitwise the eager one.
- A packed bank (``Packed`` planes ``(E, bits, K/8, N)``) is not
  dequantized whole, as the reference does at entry: each expert's
  product runs through ``kernels.ops.qmm`` on its own planes (the
  bit-serial body at decode's rows, the dequant body at a prefill
  chunk's), the same function ``x @ dequant(bank)``.  A dense bank stays
  ``torch.einsum``, as the reference leaves it to XLA.

The reference's expert-parallel ``_moe_ep`` needs a mesh and comes with
ROADMAP.md queue 1, item 11; nothing on one card takes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import swiglu
from repro_torch.quant.pack import Packed


def init_moe(gen: torch.Generator, E: int, D: int, F: int, dtype=torch.bfloat16,
             device=None) -> dict:
    """Router f32 (D, E); banks wg/wu (E, D, F) and wd (E, F, D) in ``dtype``."""
    s_in, s_out = D ** -0.5, F ** -0.5

    def draw(shape, s):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * s

    return {"router": draw((D, E), s_in), "wg": draw((E, D, F), s_in).to(dtype),
            "wu": draw((E, D, F), s_in).to(dtype), "wd": draw((E, F, D), s_out).to(dtype)}


def _route(x: torch.Tensor, router: torch.Tensor, k: int):
    """-> (gates (..., E) f32, gate_k (..., k) renormalized, idx_k (..., k)).
    f32 logits and softmax; top-k by a stable descending sort (ties to the
    lower expert index, as ``jax.lax.top_k``)."""
    logits = x.float() @ router.float()
    gates = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    gate_k, idx_k = vals[..., :k], idx[..., :k]
    gate_k = gate_k / torch.clamp(gate_k.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, gate_k, idx_k


def _dispatch(x: torch.Tensor, idx_k: torch.Tensor, E: int, C: int, k: int):
    """Per-sequence sort-based dispatch, batched over the rows of ``x``
    (B, T, D) -> (buf (B, E, C, D), meta = (order, src, dst, valid), each
    (B, T·k)).  ``dst`` is ``e·C + slot``, or the sentinel ``E·C`` for a
    dropped choice."""
    B, T, D = x.shape
    flat_e = idx_k.reshape(B, T * k)
    se, order = torch.sort(flat_e, dim=-1, stable=True)        # priority = token order
    src = order // k
    experts = torch.arange(E, device=x.device).expand(B, E).contiguous()
    first = torch.searchsorted(se, experts, side="left")        # (B, E)
    pos = torch.arange(T * k, device=x.device)[None, :] - first.gather(1, se)
    valid = pos < C
    dst = torch.where(valid, se * C + pos, E * C)
    xs = x.gather(1, src[..., None].expand(B, T * k, D)) * valid[..., None].to(x.dtype)
    buf = x.new_zeros((B, E * C + 1, D))
    buf.scatter_(1, dst[..., None].expand(B, T * k, D), xs)     # row E·C: the sentinel
    return buf[:, :E * C].reshape(B, E, C, D), (order, src, dst, valid)


def _undispatch(y_e: torch.Tensor, gate_k: torch.Tensor, meta, T: int, k: int):
    """(B, E, C, D) expert outputs -> (B, T, D): each token's k gated
    contributions, summed into zeros in ascending expert id (the
    reference's scatter-add order) in y's dtype."""
    order, src, dst, valid = meta
    B, E, C, D = y_e.shape
    dt = y_e.dtype
    y_flat = y_e.reshape(B, E * C, D)
    y_sorted = (y_flat.gather(1, torch.clamp(dst, max=E * C - 1)[..., None].expand(B, T * k, D))
                * valid[..., None].to(dt))
    gate_sorted = gate_k.reshape(B, T * k).gather(1, order).to(dt)
    contrib = y_sorted * gate_sorted[..., None]                  # (B, T·k, D), sorted order
    # sorted position of each (token, choice); a token's choices in
    # ascending sorted position are its experts in ascending id
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(T * k, device=order.device).expand(B, T * k))
    pos_tok = inv.reshape(B, T, k).sort(dim=-1).values.reshape(B, T * k)
    c = contrib.gather(1, pos_tok[..., None].expand(B, T * k, D)).reshape(B, T, k, D)
    y = torch.zeros((B, T, D), dtype=dt, device=y_e.device)
    for i in range(k):
        y = y + c[:, :, i]
    return y


def _bank(x: torch.Tensor, w, dtype) -> torch.Tensor:
    """(E, M, K) rows of each expert through its matrix of the bank ``w``
    -> (E, M, N) in ``dtype``: on a packed bank one ``kernels.ops.qmm``
    per expert, the f32 products stacked and cast once; an einsum on a
    dense one."""
    if isinstance(w, Packed):
        return torch.stack([kops.qmm(x[e], w.planes[e], w.scale[e], bits=w.bits)
                            for e in range(x.shape[0])]).to(dtype)
    return torch.einsum("emk,ekn->emn", x, w)


def _expert_ffn(bufe: torch.Tensor, p: dict, dtype) -> torch.Tensor:
    """(B, E, C, D) dispatch buffer -> (B, E, C, D): every expert's
    SwiGLU, in the reference's dtype order (each product rounded to
    ``dtype``, the SiLU in f32).  The buffer is permuted once to
    (E, B·C, D), so each expert's matrix multiplies all its rows at once."""
    B, E, C, D = bufe.shape
    xe = bufe.permute(1, 0, 2, 3).reshape(E, B * C, D)
    h = swiglu(_bank(xe, p["wg"], dtype), _bank(xe, p["wu"], dtype))
    return _bank(h, p["wd"], dtype).reshape(E, B, C, D).permute(1, 0, 2, 3)


def _aux_loss(gates: torch.Tensor, idx_k: torch.Tensor, E: int, k: int) -> torch.Tensor:
    """The load-balancing loss E · Σ_e mean gate_e · share of choices_e.
    The counts come from a compare-and-sum (exact, no atomics, and no
    host sync as ``bincount`` would make)."""
    me = gates.reshape(-1, E).mean(dim=0)
    hits = idx_k.reshape(-1, 1) == torch.arange(E, device=idx_k.device)
    ce = hits.sum(dim=0).float() / max(idx_k.numel(), 1)
    return E * torch.sum(me * ce)


def moe_ffn(x: torch.Tensor, p: dict, *, k: int, capacity_factor: float = 1.25,
            no_drop: bool = False):
    """x (B, S, D) -> (output (B, S, D) in x's dtype, aux loss f32 0-d).
    Capacity ``C = S·k`` under ``no_drop``, else ``ceil(S·k·cf / E)``,
    then at least 8 and a multiple of 8 (the reference's arithmetic)."""
    B, S, D = x.shape
    E = p["router"].shape[1]
    gates, gate_k, idx_k = _route(x, p["router"], k)
    aux = _aux_loss(gates, idx_k, E, k)
    C = S * k if no_drop else int(-(-S * k * capacity_factor // E))
    C = max(8, -(-C // 8) * 8)
    bufe, meta = _dispatch(x, idx_k, E, C, k)
    y_e = _expert_ffn(bufe, p, x.dtype)
    y = _undispatch(y_e, gate_k, meta, S, k)
    return y.to(x.dtype), aux


class RouteLog:
    """While on, records every routing decision :func:`moe_ffn` makes: per
    call, each token's chosen experts (B, S, k) and the gap between its
    k-th and (k+1)-th gate (B, S).  For checks that hold one run's routing
    against another's; eager calls only (a captured graph records nothing
    at replay)."""

    def __init__(self):
        self.idx, self.gaps = [], []

    def __enter__(self):
        global _route
        self._orig = orig = _route

        def route(x, router, k):
            gates, gate_k, idx_k = orig(x, router, k)
            top = gates.sort(dim=-1, descending=True).values
            self.idx.append(idx_k.reshape(x.shape[0], -1, k))
            self.gaps.append((top[..., k - 1] - top[..., k]).reshape(x.shape[0], -1))
            return gates, gate_k, idx_k

        _route = route
        return self

    def __exit__(self, *exc):
        global _route
        _route = self._orig
