"""Shared building blocks (torch port of ``repro.models.common``): the
packed-or-dense linear, norms, RoPE, chunk and decode attention, and the
initializers.

Plain functions over tensors, each repeating the reference's dtype
discipline (f32 inside norms, RoPE and softmax; results cast back to the
activation dtype), so the port and the reference agree to rounding.
The sharding helpers (``constrain`` and friends) have no counterpart on
one card and are dropped.  The large plain products here stay
``torch.matmul``/``einsum``, as the reference left them to XLA: every
Pallas kernel of the reference is a hand-written CUDA kernel behind
``kernels.ops``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_NEG = -1e30  # finite "-inf" so masked softmax rows stay NaN-free


def apply_linear(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w where w is a dense tensor or a Packed bitplane weight."""
    from repro_torch.kernels import ops as kops
    from repro_torch.quant.pack import Packed

    if isinstance(w, Packed):
        return kops.qmm(x, w.planes, w.scale, bits=w.bits).to(x.dtype)
    return x @ w


# ---------------------------------------------------------------------------
# initializers (explicit generator and device)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, scale: float | None = None,
               device=None) -> torch.Tensor:
    s = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * s).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.float()).to(gate.dtype) * up


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,) float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin (..., head_dim/2) float32 of each (int) position."""
    ang = positions[..., None].float() * rope_freqs(head_dim, theta, device=positions.device)
    return torch.cos(ang), torch.sin(ang)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the halves of ``x`` (..., hd) in float32; cos/sin broadcast
    to (..., hd/2).  The fused decode kernel repeats this arithmetic."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S) int32."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta)   # (..., S, hd/2)
    return rope_rotate(x, cos[..., None, :], sin[..., None, :]).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def chunk_attention(
    q: torch.Tensor,        # (B, C, H, hd) — one fixed-shape prompt chunk
    k_ctx: torch.Tensor,    # (B, T, KV, hd) — already-cached context
    v_ctx: torch.Tensor,    # (B, T, KV, hd)
    ctx_pos: torch.Tensor,  # (B, T) absolute token index per context slot, -1 = empty
    k_new: torch.Tensor,    # (B, C, KV, hd) — this chunk's keys (pre-write)
    v_new: torch.Tensor,    # (B, C, KV, hd)
    q_pos: torch.Tensor,    # (B, C) absolute token index per query
) -> torch.Tensor:
    """Chunked-prefill attention: queries attend [context cache ; own
    chunk], masked purely in absolute token positions; f32 masked softmax,
    the same arithmetic as :func:`decode_attention`."""
    B, C, H, hd = q.shape
    KV = k_new.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf = q.reshape(B, C, KV, G, hd).float()

    def scores(k):
        return torch.einsum("bckgh,btkh->bkgct", qf, k.float()) * scale

    def mask(key_pos):  # (B, Tk) -> (B, 1, 1, C, Tk)
        ok = (key_pos[:, None, :] >= 0) & (key_pos[:, None, :] <= q_pos[:, :, None])
        return ok[:, None, None]

    s = torch.cat(
        [torch.where(mask(ctx_pos), scores(k_ctx), _NEG),
         torch.where(mask(q_pos), scores(k_new), _NEG)], dim=-1)
    p = torch.softmax(s, dim=-1)
    v = torch.cat([v_ctx, v_new], dim=1).float()
    o = torch.einsum("bkgct,btkh->bckgh", p, v)
    return o.reshape(B, C, H, hd).to(q.dtype)


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, hd) — single new token
    k_cache: torch.Tensor,  # (B, T, KV, hd)
    v_cache: torch.Tensor,  # (B, T, KV, hd)
    length: torch.Tensor,   # (B,) valid prefix lengths
) -> torch.Tensor:
    """One-step attention against a contiguous KV cache."""
    B, T, KV, hd = k_cache.shape
    H = q.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,btkh->bkgt", qf, k_cache.float()) * scale
    pos = torch.arange(T, device=q.device)[None, :]
    valid = pos < length.to(q.device)[:, None]
    s = torch.where(valid[:, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkh->bkgh", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)
