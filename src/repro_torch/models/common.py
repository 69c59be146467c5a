"""Shared building blocks (torch port of ``repro.models.common``): the
packed-or-dense linear, norms, RoPE and M-RoPE, the training path's
blocked (flash) attention and sequence-chunked cross-entropy, chunk and
decode attention, and the initializers.

Plain functions over tensors, each repeating the reference's dtype
discipline (f32 inside norms, RoPE and softmax; results cast back to the
activation dtype), so the port and the reference agree to rounding.
The sharding helpers (``constrain`` and friends) have no counterpart:
under tensor parallelism the model reads the active ``dist.tp`` context
instead (the vocab-parallel cross-entropy in :func:`chunked_ce`).  The
large plain products here stay ``torch.matmul``/``einsum``, as the
reference left them to XLA: every
Pallas kernel of the reference is a hand-written CUDA kernel behind
``kernels.ops``.
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_NEG = -1e30  # finite "-inf" so masked softmax rows stay NaN-free


def apply_linear(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w where w is a dense tensor or a Packed bitplane weight.  A
    dense product of two dtypes runs in the wider one, as jnp promotes
    ``x @ w`` (RWKV feeds f32 token-shift mixes to bf16 weights)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.quant.pack import Packed

    if isinstance(w, Packed):
        return kops.qmm(x, w.planes, w.scale, bits=w.bits).to(x.dtype)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


# ---------------------------------------------------------------------------
# initializers (explicit generator and device)
# ---------------------------------------------------------------------------


def generator(device: torch.device, seed: int) -> torch.Generator | None:
    """The init's generator on ``device`` seeded with ``seed``; None on the
    meta device, where a tensor has a shape and no values and nothing is
    drawn (``launch.specs`` builds its stand-ins there)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


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
# RoPE and M-RoPE
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


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: three position streams (t, h, w) rotate
    disjoint sections of each head's half-dim.

    x: (B, S, H, hd); positions3: (3, B, S) int; ``sections`` splits the
    half-dim (summing to hd // 2, e.g. hd 128 -> (16, 24, 24)): frequency
    i takes the stream of the section it falls in."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)                 # (hd/2,)
    idx = torch.arange(hd // 2, device=x.device)
    # section id of each frequency, 0 / 1 / 2, against the bounds as host
    # numbers (no host-to-device copy: a captured decode step runs this)
    sec_id = sum((idx >= b).long() for b in itertools.accumulate(sections))
    pos_sel = positions3.float()[sec_id]                          # (hd/2, B, S)
    ang = torch.movedim(pos_sel, 0, -1) * inv                     # (B, S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    return rope_rotate(x, cos, sin).to(x.dtype)


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
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Chunked-prefill attention: queries attend [context cache ; own
    chunk], masked purely in absolute token positions, so one code covers
    linear caches, ring caches (slot s holds the youngest token = s mod T)
    and paged gathers; ``window`` also drops keys ``window`` or more
    positions back.  The chunk's keys come from ``k_new``, never the
    cache, so a ring slot the chunk is about to overwrite is not read.
    f32 masked softmax, the same arithmetic as :func:`decode_attention`."""
    B, C, H, hd = q.shape
    KV = k_new.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf = q.reshape(B, C, KV, G, hd).float()

    def scores(k):
        return torch.einsum("bckgh,btkh->bkgct", qf, k.float()) * scale

    def mask(key_pos):  # (B, Tk) -> (B, 1, 1, C, Tk)
        ok = (key_pos[:, None, :] >= 0) & (key_pos[:, None, :] <= q_pos[:, :, None])
        if window is not None:
            ok &= q_pos[:, :, None] - key_pos[:, None, :] < window
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


# ---------------------------------------------------------------------------
# sequence-chunked cross-entropy (the readout never materializes full logits)
# ---------------------------------------------------------------------------


def _ce_chunk(readout_fn, hc, lc, vc):
    from repro_torch.dist import tp as tpm

    logits = readout_fn(hc)
    tp = tpm.split("vocab")
    if tp is not None:                  # this rank's vocab columns
        logz, tgt = tpm.vocab_ce(logits, lc, tp)
        return torch.sum((logz - tgt) * vc), torch.sum(torch.square(logz) * vc)
    logz = torch.logsumexp(logits, dim=-1)
    # the label's logit: a gather, equal to the reference's masked sum over
    # the vocab (one term, the rest zeros)
    tgt = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return torch.sum((logz - tgt) * vc), torch.sum(torch.square(logz) * vc)


def chunked_ce(readout_fn, h: torch.Tensor, labels: torch.Tensor, chunk: int = 512):
    """Mean next-token CE and mean logz² over (B, S) tokens.

    ``readout_fn(h_chunk) -> logits_f32``.  Each sequence chunk runs under
    ``torch.utils.checkpoint``, so only one (B, chunk, V) logits block is
    live at a time and the backward recomputes it; the chunk sums are
    added in order, as the reference's scan carries them."""
    B, S, _ = h.shape
    c = min(chunk, S)
    Sp = -(-S // c) * c
    hp = F.pad(h, (0, 0, 0, Sp - S))
    lp = F.pad(labels, (0, Sp - S))
    valid = F.pad(torch.ones((B, S), dtype=torch.float32, device=h.device), (0, Sp - S))
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    z2_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(Sp // c):
        sl = slice(i * c, (i + 1) * c)
        nll_c, z2_c = checkpoint(_ce_chunk, readout_fn, hp[:, sl], lp[:, sl], valid[:, sl],
                                 use_reentrant=False)
        nll_sum = nll_sum + nll_c
        z2_sum = z2_sum + z2_c
    n = float(B * S)
    return nll_sum / n, z2_sum / n


# ---------------------------------------------------------------------------
# blocked (flash-style) attention: O(S * chunk) memory, manual backward
# ---------------------------------------------------------------------------


def _tile_mask(q_pos, k_pos, S: int, causal: bool, window):
    mask = (k_pos < S)[None, :]
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    return mask


def _tile_dead(qi: int, ki: int, cq: int, ck: int, causal: bool, window) -> bool:
    """Every (query, key) pair of the tile is masked.  Such a tile leaves
    the online-softmax carries and every gradient exactly as they were
    (p = 0, correction 1), so skipping it changes no bit of the result;
    the reference computes it and masks it whole."""
    if causal and ki * ck > qi * cq + cq - 1:
        return True
    return window is not None and qi * cq - (ki * ck + ck - 1) >= window


def _flash_fwd_blocks(qb, kb, vb, S, causal, window, cq, ck):
    """qb: (B,nq,cq,KV,G,hd); kb/vb: (B,nk,ck,KV,hd).
    -> out (B,nq,cq,KV,G,hd) f32, lse (B,nq,cq,KV,G) f32."""
    B, nq, _, KV, G, hd = qb.shape
    nk = kb.shape[1]
    scale = hd ** -0.5
    dev = qb.device
    outs, lses = [], []
    for qi in range(nq):
        q_tile = qb[:, qi].float()
        q_pos = qi * cq + torch.arange(cq, device=dev)
        acc = torch.zeros((B, cq, KV, G, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, cq, KV, G), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, cq, KV, G), dtype=torch.float32, device=dev)
        for ki in range(nk):
            if _tile_dead(qi, ki, cq, ck, causal, window):
                continue
            k_pos = ki * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bqkgh,bckh->bqkgc", q_tile, kb[:, ki].float()) * scale
            mask5 = _tile_mask(q_pos, k_pos, S, causal, window)[None, :, None, None, :]
            s = torch.where(mask5, s, _NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.where(mask5, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bqkgc,bckh->bqkgh", p, vb[:, ki].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-20))
        lses.append(m + torch.log(torch.clamp(l, min=1e-20)))
    return torch.stack(outs, 1), torch.stack(lses, 1)


class _Flash(torch.autograd.Function):
    """Flash attention over blocked q/k/v with the reference's manual
    backward (``repro.models.common._flash_vjp_bwd``): the probability of
    every (q-block, kv-block) tile is recomputed from the saved logsumexp,
    never saved."""

    @staticmethod
    def forward(ctx, qb, kb, vb, S, causal, window, cq, ck):
        out, lse = _flash_fwd_blocks(qb, kb, vb, S, causal, window, cq, ck)
        ctx.save_for_backward(qb, kb, vb, out, lse)
        ctx.cfg = (S, causal, window, cq, ck)
        return out

    @staticmethod
    def backward(ctx, g):
        qb, kb, vb, out, lse = ctx.saved_tensors
        S, causal, window, cq, ck = ctx.cfg
        B, nq, _, KV, G, hd = qb.shape
        nk = kb.shape[1]
        scale = hd ** -0.5
        dev = qb.device
        g = g.float()
        Drow = torch.sum(g * out, dim=-1)                     # (B,nq,cq,KV,G)
        lse_safe = torch.where(lse <= _NEG / 2, 1e30, lse)    # padded rows -> p = 0
        dq = torch.zeros(qb.shape, dtype=torch.float32, device=dev)
        dks, dvs = [], []
        for ki in range(nk):
            k_pos = ki * ck + torch.arange(ck, device=dev)
            kf = kb[:, ki].float()
            vf = vb[:, ki].float()
            dk = torch.zeros((B, ck, KV, hd), dtype=torch.float32, device=dev)
            dv = torch.zeros((B, ck, KV, hd), dtype=torch.float32, device=dev)
            for qi in range(nq):
                if _tile_dead(qi, ki, cq, ck, causal, window):
                    continue
                q_pos = qi * cq + torch.arange(cq, device=dev)
                qf = qb[:, qi].float()
                g_tile = g[:, qi]
                s = torch.einsum("bqkgh,bckh->bqkgc", qf, kf) * scale
                mask5 = _tile_mask(q_pos, k_pos, S, causal, window)[None, :, None, None, :]
                p = torch.where(mask5, torch.exp(s - lse_safe[:, qi][..., None]), 0.0)
                dv = dv + torch.einsum("bqkgc,bqkgh->bckh", p, g_tile)
                dp = torch.einsum("bqkgh,bckh->bqkgc", g_tile, vf)
                ds = p * (dp - Drow[:, qi][..., None]) * scale
                dk = dk + torch.einsum("bqkgc,bqkgh->bckh", ds, qf)
                dq[:, qi] += torch.einsum("bqkgc,bckh->bqkgh", ds, kf)
            dks.append(dk)
            dvs.append(dv)
        dk = torch.stack(dks, 1).to(kb.dtype)
        dv = torch.stack(dvs, 1).to(vb.dtype)
        return dq.to(qb.dtype), dk, dv, None, None, None, None, None


def blocked_attention(
    q: torch.Tensor,        # (B, S, H, hd)
    k: torch.Tensor,        # (B, S, KV, hd)
    v: torch.Tensor,        # (B, S, KV, hd)
    *,
    causal: bool = True,
    window: int | None = None,   # sliding-window size (None = full)
    q_chunk: int = 512,
    kv_chunk: int = 512,
) -> torch.Tensor:
    """Flash attention (forward: online softmax over KV chunks; backward:
    the manual tile recompute).  GQA and a sliding window.  Never
    materializes (S, S); a tile is O(B * q_chunk * kv_chunk * H / KV)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    assert H % KV == 0, (H, KV)
    G = H // KV
    cq = min(q_chunk, S)
    ck = min(kv_chunk, S)
    Sq = -(-S // cq) * cq
    Sk = -(-S // ck) * ck
    qp = F.pad(q, (0, 0, 0, 0, 0, Sq - S))
    kp = F.pad(k, (0, 0, 0, 0, 0, Sk - S))
    vp = F.pad(v, (0, 0, 0, 0, 0, Sk - S))
    qb = qp.reshape(B, Sq // cq, cq, KV, G, hd)
    kb = kp.reshape(B, Sk // ck, ck, KV, hd)
    vb = vp.reshape(B, Sk // ck, ck, KV, hd)
    out = _Flash.apply(qb, kb, vb, S, causal, window, cq, ck)
    out = out.reshape(B, Sq, KV * G, hd)[:, :S]
    return out.to(q.dtype)
