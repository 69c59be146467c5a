"""Mamba-style selective SSM branch of the Hymba hybrid blocks (torch port
of ``repro.models.mamba``).

Diagonal selective state space: per channel d with state size N,

    h_t = exp(Δ_t · A) ⊙ h_{t-1} + (Δ_t · B_t) · x_t
    y_t = C_t · h_t + D ⊙ x_t

with input-dependent Δ (low-rank), B, C.  A sequence runs in chunks of
``chunk`` tokens: inside a chunk the recurrence is the reference's
log-depth ``jax.lax.associative_scan`` over ``(decay, input)`` pairs,
repeated here with the same odd/even combine tree (:func:`_assoc_scan`),
and the chunks run in order, each carrying the previous chunk's last
state.  :func:`mamba_step` is the one-token update of the decode step.

These are plain torch ops: the reference runs them as jnp outside any
Pallas kernel.  Only the two projections in and the one out are weight
matmuls (``apply_linear``, the ``qmm`` kernel when packed).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import apply_linear, dense_init


def init_mamba(gen: torch.Generator, D: int, Di: int, N: int, ks: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """One layer's SSM params, drawn from ``gen`` (the reference's shapes,
    dtypes and constant leaves)."""
    R = max(8, D // 16)  # dt low-rank
    f32 = torch.float32
    conv = torch.randn((ks, Di), generator=gen, dtype=f32, device=device) * ks ** -0.5
    A = torch.arange(1, N + 1, dtype=f32, device=device)
    return {
        "in_x": dense_init(gen, D, Di, dtype, device=device),
        "in_z": dense_init(gen, D, Di, dtype, device=device),
        "conv": conv,
        "w_B": dense_init(gen, Di, N, f32, device=device),
        "w_C": dense_init(gen, Di, N, f32, device=device),
        "dt1": dense_init(gen, Di, R, f32, device=device),
        "dt2": dense_init(gen, R, Di, f32, device=device),
        "dt_bias": torch.full((Di,), -4.0, dtype=f32, device=device),  # softplus(-4) ~ .018
        "A_log": torch.log(A).expand(Di, N).contiguous(),
        "D_skip": torch.ones((Di,), dtype=f32, device=device),
        "out": dense_init(gen, Di, D, dtype, scale=Di ** -0.5, device=device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(xb: torch.Tensor, conv: torch.Tensor, init_state=None):
    """Depthwise causal conv, kernel (ks, Di), over xb (B, S, Di) after the
    ``ks - 1`` carried inputs ``init_state``.  Returns (out in xb's dtype,
    the last ``ks - 1`` inputs)."""
    ks = conv.shape[0]
    B, S, Di = xb.shape
    if init_state is None:
        init_state = torch.zeros((B, ks - 1, Di), dtype=xb.dtype, device=xb.device)
    xpad = torch.cat([init_state.to(xb.dtype), xb], dim=1)
    out = torch.zeros((B, S, Di), dtype=torch.float32, device=xb.device)
    for j in range(ks):  # ks = 4
        out = out + conv[j] * xpad[:, j:j + S].float()
    return out.to(xb.dtype), xpad[:, -(ks - 1):]


def _ssm_features(xc: torch.Tensor, p: dict):
    """(Δ, B_t, C_t) from the conv'd activation, in f32."""
    xf = xc.float()
    dt = _softplus(xf @ p["dt1"] @ p["dt2"] + p["dt_bias"])  # (B, S, Di)
    return dt, xf @ p["w_B"], xf @ p["w_C"]


def _combine(e1, e2):
    a1, u1 = e1
    a2, u2 = e2
    return a1 * a2, a2 * u1 + u2


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along dim 1 (len(a) - len(b) in {0, 1})."""
    shape = list(a.shape)
    shape[1] = a.shape[1] + b.shape[1]
    out = a.new_empty(shape)
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _assoc_scan(elems):
    """Inclusive scan of ``(decay, input)`` pairs along dim 1 with
    :func:`_combine`, in the combine order of ``jax.lax.associative_scan``:
    adjacent pairs reduced, the half-length scan recursed, the even
    positions filled in from it."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:-1:2] for e in elems], [e[:, 1::2] for e in elems])
    odd = _assoc_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _chunk_step(h, dtc, xcc, Bc, Cc, A):
    """One chunk of the selective scan from state ``h`` (B, Di, N) ->
    (the chunk's last state, y (B, c, Di) f32)."""
    decay = torch.exp(dtc[..., None] * A)                        # (B, c, Di, N)
    u = (dtc * xcc.float())[..., None] * Bc[:, :, None, :]
    acum, ucum = _assoc_scan([decay, u])
    hs = acum * h[:, None] + ucum                                # (B, c, Di, N)
    return hs[:, -1], torch.einsum("bcdn,bcn->bcd", hs, Cc)


def mamba_forward(x: torch.Tensor, p: dict, *, chunk: int = 64,
                  return_state: bool = False, init_state: dict | None = None,
                  valid=None):
    """x: (B, S, D), already normalized.  Returns (y (B, S, D), state or
    None).

    ``init_state`` ({"h", "conv"}, as returned here) continues a cached
    sequence.  ``valid`` (a (B,) or (1,) int tensor of per-row lengths)
    sets the Δ of positions >= valid to zero, so a fixed-shape chunk's
    padding neither decays nor drives the state, and the returned conv
    state ends at the last valid token."""
    B, S, D = x.shape
    xb = apply_linear(x, p["in_x"])            # (B, S, Di)
    z = apply_linear(x, p["in_z"])
    conv0 = init_state["conv"] if init_state is not None else None
    xc, _ = _causal_conv(xb, p["conv"], init_state=conv0)
    xc = F.silu(xc.float()).to(x.dtype)
    dt, Bm, Cm = _ssm_features(xc, p)
    if valid is not None:
        valid = valid.reshape(-1).to(x.device)
        keep = torch.arange(S, device=x.device)[None, :] < valid[:, None]
        dt = dt * keep[..., None]
    A = -torch.exp(p["A_log"])                 # (Di, N), negative
    Di, N = A.shape

    c = min(chunk, S)
    Sp = -(-S // c) * c
    nc = Sp // c
    pad = Sp - S
    xs, dts, Bs, Cs = (F.pad(a, (0, 0, 0, pad)).reshape(B, nc, c, a.shape[-1])
                       for a in (xc, dt, Bm, Cm))
    h = (init_state["h"].float() if init_state is not None
         else torch.zeros((B, Di, N), dtype=torch.float32, device=x.device))
    # under autograd each chunk is recomputed in the backward, as the
    # reference's jax.checkpoint'ed chunk step: only the chunk boundaries'
    # states are kept, not every level's (B, c, Di, N) terms
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xc, dt, Bm, Cm, A, h))
    ys = []
    for i in range(nc):
        args = (h, dts[:, i], xs[:, i], Bs[:, i], Cs[:, i], A)
        h, yc = (checkpoint(_chunk_step, *args, use_reentrant=False) if remat
                 else _chunk_step(*args))
        ys.append(yc)
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + p["D_skip"] * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = apply_linear(y, p["out"])
    if not return_state:
        return out, None
    ks = p["conv"].shape[0]
    if valid is not None or init_state is not None:
        # the last ks - 1 inputs of [carried conv state ; valid prefix]
        prev = (conv0.to(xb.dtype) if conv0 is not None
                else torch.zeros((B, ks - 1, Di), dtype=xb.dtype, device=x.device))
        xpad = torch.cat([prev, xb], dim=1)
        end = valid if valid is not None else torch.full((1,), S, device=x.device)
        idx = end.long()[:, None] + torch.arange(ks - 1, device=x.device)[None, :]
        conv_state = torch.gather(xpad, 1, idx.expand(B, ks - 1)[..., None].expand(B, ks - 1, Di))
    elif S < ks - 1:
        conv_state = F.pad(xb, (0, 0, ks - 1 - S, 0))
    else:
        conv_state = xb[:, -(ks - 1):]
    return out, {"h": h, "conv": conv_state}


def mamba_step(x: torch.Tensor, p: dict, state: dict):
    """One-token decode.  x: (B, 1, D); state: {h (B, Di, N) f32, conv
    (B, ks - 1, Di)}.  Returns (y (B, 1, D), the new state)."""
    xb = apply_linear(x, p["in_x"])            # (B, 1, Di)
    z = apply_linear(x, p["in_z"])
    xc, conv_state = _causal_conv(xb, p["conv"], init_state=state["conv"])
    xc = F.silu(xc.float()).to(x.dtype)
    dt, Bm, Cm = _ssm_features(xc, p)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt[:, 0, :, None] * A)   # (B, Di, N)
    u = (dt[:, 0] * xc[:, 0].float())[..., None] * Bm[:, 0, None, :]
    h = decay * state["h"] + u
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0]) + p["D_skip"] * xc[:, 0].float()
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    return apply_linear(y, p["out"])[:, None, :], {"h": h, "conv": conv_state}

