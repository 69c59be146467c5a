"""RWKV6 ("Finch"), torch port of ``repro.models.rwkv``: an attention-free
LM with data-dependent diagonal decay.

Per head (dims K = V = head_dim) the wkv recurrence is

    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    o_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)

with ``w_t = exp(-exp(w0 + tanh(x W_a) W_b))`` in (0, 1), input-dependent.
:func:`wkv6_chunked` evaluates it chunk-parallel, as the reference does:
within a chunk of length c the pairwise decay products ``exp(L_{t-1} -
L_i)`` (L the cumulative log-decay) are <= 1 by construction, and across
chunks the (K, V) state is carried.  Here every chunk's in-chunk terms are
formed at once and only the carry runs chunk by chunk.  :func:`wkv6_step`
is the one-token update of the decode step.  Both are plain torch: the
reference runs them as jnp outside any Pallas kernel.

Quantizable groups per layer: the five time-mix projections and the
three channel-mix matrices; the decay LoRA (W_a, W_b), the bonus u and the
token-shift mixes stay fp.  Every weight matmul goes through
``models.common.apply_linear`` -> ``kernels.ops.qmm`` when packed.

Serving: the state is O(1) per sequence (``wkv`` (L, B, H, hd, hd) f32
and the token-shift rows ``x_tm``/``x_cm`` (L, B, 1, D)), so a paged pool
holds it as slot rows with no blocks.  ``decode_step`` writes every state
leaf in place (a captured step binds them by address); the chunk body
(``prefill_chunk``, ``verify_chunk``) writes its rows in place too, and a
row's first chunk (start 0) starts from zero state, whatever a previous
occupant left there.

Training (``loss``) is not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import not_ported, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (apply_linear, dense_init, embed_init,
                                       rms_norm)
from repro_torch.models.model import QuantGroup
from repro_torch.models.transformer import _index
from repro_torch.quant.pack import QDQ


def wkv6_chunked(r, k, v, logw, u, state0, chunk: int = 16):
    """r/k/v/logw: (B, S, H, K); u: (H, K); state0: (B, H, K, V).

    Returns (out (B, S, H, V), state (B, H, K, V)), f32 throughout.  The
    sequence is padded to a multiple of the chunk with k = v = 0 and
    log-decay 0 (no decay), which leaves the state as it was."""
    B, S, H, K = r.shape
    c = min(chunk, S)
    Sp = -(-S // c) * c
    nc = Sp // c

    def chunks(a):  # (B, nc, c, H, K) f32
        return F.pad(a.float(), (0, 0, 0, 0, 0, Sp - S)).reshape(B, nc, c, H, a.shape[-1])

    rc, kc, vc, lwc = chunks(r), chunks(k), chunks(v), chunks(logw)
    L = torch.cumsum(lwc, dim=2)                        # inclusive
    Lprev = L - lwc                                     # exclusive (L_{t-1})
    q = rc * torch.exp(Lprev)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    diff = Lprev[:, :, :, None] - L[:, :, None]         # (B, nc, t, i, H, K)
    Dm = torch.exp(torch.where(tri[:, :, None, None], diff, -math.inf))
    A = torch.einsum("bnthk,bnihk,bntihk->bntih", rc, kc, Dm)
    Adiag = torch.einsum("bnthk,hk,bnthk->bnth", rc, u, kc)
    eye = torch.eye(c, dtype=torch.float32, device=r.device)
    A = A + eye[:, :, None] * Adiag[:, :, :, None, :]
    out = torch.einsum("bntih,bnihv->bnthv", A, vc)     # in-chunk terms
    L_last = L[:, :, -1]                                # (B, nc, H, K)
    kmod = kc * torch.exp(L_last[:, :, None] - L)
    kv = torch.einsum("bnchk,bnchv->bnhkv", kmod, vc)
    decay = torch.exp(L_last)[..., None]
    state = state0.float()
    inter = []
    for i in range(nc):                                 # the carry, chunk by chunk
        inter.append(torch.einsum("bchk,bhkv->bchv", q[:, i], state))
        state = state * decay[:, i] + kv[:, i]
    out = out + torch.stack(inter, dim=1)
    return out.reshape(B, Sp, H, -1)[:, :S], state


def wkv6_step(r, k, v, logw, u, state):
    """One token: r/k/v/logw (B, H, K); state (B, H, K, V)."""
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    o = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    return o, state * torch.exp(logw)[..., None] + kv


class RWKV6LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.d_model % cfg.hd:
            raise ValueError("d_model must divide head_dim")
        self.cfg = cfg
        self.H = cfg.d_model // cfg.hd

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0, device=None) -> dict:
        """Random params in the stacked layout (``blocks`` one dict of
        ``(L, ...)`` leaves), drawn layer by layer from a
        ``torch.Generator`` seeded with ``seed`` on ``device`` (the card
        unless ``device="cpu"``).  To compare with the reference, carry
        its params over with ``repro_torch.convert``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        cfg, dt, f32 = self.cfg, self.dtype, torch.float32
        L, D, Fd, R = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.wkv_lora_rank

        def mu():
            return torch.rand((D,), generator=gen, dtype=f32, device=device)

        def layer():
            return {
                "ln1": torch.ones((D,), dtype=f32, device=device),
                "ln2": torch.ones((D,), dtype=f32, device=device),
                "tm": {
                    "mu_r": mu(), "mu_k": mu(), "mu_v": mu(), "mu_g": mu(), "mu_w": mu(),
                    **{m: dense_init(gen, D, D, dt, device=device)
                       for m in ("wr", "wk", "wv", "wg", "wo")},
                    "w0": torch.full((D,), 1.0, dtype=f32, device=device),
                    "wa": dense_init(gen, D, R, f32, device=device),
                    "wb": torch.randn((R, D), generator=gen, dtype=f32, device=device) * 0.01,
                    "u": torch.zeros((self.H, cfg.hd), dtype=f32, device=device),
                    "gn": torch.ones((D,), dtype=f32, device=device),
                },
                "cm": {
                    "mu_k": mu(), "mu_r": mu(),
                    "wk": dense_init(gen, D, Fd, dt, device=device),
                    "wv": dense_init(gen, Fd, D, dt, scale=Fd ** -0.5, device=device),
                    "wr": dense_init(gen, D, D, dt, device=device),
                },
            }

        def stack(trees):
            if isinstance(trees[0], dict):
                return {k: stack([t[k] for t in trees]) for k in trees[0]}
            return torch.stack(trees)

        return {
            "embed": embed_init(gen, cfg.vocab_size, D, dt, device),
            "blocks": stack([layer() for _ in range(L)]),
            "final_norm": torch.ones((D,), dtype=f32, device=device),
            "lm_head": dense_init(gen, D, cfg.vocab_size, dt, device=device),
        }

    # ------------------------------------------------------------- sublayers
    def _decay(self, xw, tm):
        lw = tm["w0"] + torch.tanh(xw.float() @ tm["wa"]) @ tm["wb"]
        return -torch.exp(torch.clamp(lw, -8.0, 6.0))  # log-decay in (-e^6, 0)

    def _time_mix(self, x, xprev, p, state0=None, valid=None):
        """x: (B, S, D); xprev the previous tokens' x.  Returns (out,
        state).  ``valid`` ((B,) or (1,) int tensor) masks positions >=
        valid out of the state update (k -> 0, log-decay -> 0), so a
        fixed-shape chunk's padding leaves the carried state as if the
        chunk had ended at ``valid``."""
        cfg, H, hd = self.cfg, self.H, self.cfg.hd
        B, S, D = x.shape
        tm = p["tm"]

        def lerp(m):  # bf16 difference, f32 product: the reference's promotion
            return x + (xprev - x) * m

        r = apply_linear(lerp(tm["mu_r"]), tm["wr"]).reshape(B, S, H, hd)
        k = apply_linear(lerp(tm["mu_k"]), tm["wk"]).reshape(B, S, H, hd)
        v = apply_linear(lerp(tm["mu_v"]), tm["wv"]).reshape(B, S, H, hd)
        g = F.silu(apply_linear(lerp(tm["mu_g"]), tm["wg"]).float())
        logw = self._decay(lerp(tm["mu_w"]), tm).reshape(B, S, H, hd)
        if valid is not None:
            keep = (torch.arange(S, device=x.device)[None, :]
                    < valid.reshape(-1)[:, None])[:, :, None, None]
            k = torch.where(keep, k, torch.zeros_like(k))
            logw = torch.where(keep, logw, torch.zeros_like(logw))
        if state0 is None:
            state0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        if S == 1:
            o, state = wkv6_step(r[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
                                 logw[:, 0], tm["u"], state0)
            o = o[:, None]
        else:
            o, state = wkv6_chunked(r, k, v, logw, tm["u"], state0, cfg.chunk_size)
        # per-head group norm (the variance as jnp.var takes it)
        oh = o.reshape(B, S, H, hd)
        mean = torch.mean(oh, -1, keepdim=True)
        var = torch.mean(torch.square(oh - mean), -1, keepdim=True)
        o = ((oh - mean) * torch.rsqrt(var + 1e-5)).reshape(B, S, D) * tm["gn"]
        o = (o * g).to(x.dtype)
        return apply_linear(o, tm["wo"]), state

    def _channel_mix(self, x, xprev, p):
        cm = p["cm"]

        def lerp(m):
            return x + (xprev - x) * m

        kx = apply_linear(lerp(cm["mu_k"]), cm["wk"])
        kx = torch.square(F.relu(kx.float())).to(x.dtype)
        val = apply_linear(kx, cm["wv"])
        gate = torch.sigmoid(apply_linear(lerp(cm["mu_r"]), cm["wr"]).float())
        return (gate * val.float()).to(x.dtype)

    def _shift(self, x, last=None):
        """The previous-token stream; ``last`` (B, 1, D) is the prefix's
        final token (zeros without one)."""
        init = torch.zeros_like(x[:, :1]) if last is None else last.to(x.dtype)
        return torch.cat([init, x[:, :-1]], dim=1)

    def _layer(self, x, p, *, tm_state=None, x_tm_last=None, x_cm_last=None):
        eps = self.cfg.norm_eps
        h1 = rms_norm(x, p["ln1"], eps)
        tm_out, tm_state = self._time_mix(h1, self._shift(h1, x_tm_last), p, tm_state)
        x = x + tm_out
        h2 = rms_norm(x, p["ln2"], eps)
        x = x + self._channel_mix(h2, self._shift(h2, x_cm_last), p)
        return x, (tm_state, h1[:, -1:], h2[:, -1:])

    # ------------------------------------------------------------- embed/out
    def _embed(self, params, tokens):
        emb = params["embed"]
        if isinstance(emb, QDQ):  # serving embed: the quantize-dequantized table
            emb = emb.value
        return F.embedding(tokens.long(), emb)

    def _readout(self, params, h):
        return apply_linear(h, params["lm_head"]).float()

    def _layer_slice(self, params, l: int):
        """Per-layer param view: stacked dict or the serving layout's list."""
        blocks = params["blocks"]
        if isinstance(blocks, list):
            return blocks[l]
        return _index(blocks, l)

    # ------------------------------------------------------------- forwards
    def forward(self, params, tokens=None, embeds=None, positions=None,
                remat: str = "none", return_hidden: bool = False):
        """Teacher-forced forward -> (logits f32 | final hidden, aux 0).
        No positions: RWKV has none.  ``remat`` is accepted for the
        model protocol; this forward keeps every activation."""
        cfg = self.cfg
        h = embeds.to(self.dtype) if embeds is not None else self._embed(params, tokens)
        for l in range(cfg.num_layers):
            h, _ = self._layer(h, self._layer_slice(params, l))
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if return_hidden:
            return h, aux
        return self._readout(params, h), aux

    def loss(self, params, batch, remat: str = "none"):
        raise not_ported("training the ssm family (RWKV6LM.loss)", "slice C, item 9b")

    # --------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int, dtype=None, device=None) -> dict:
        """O(1) state per row (``max_len`` unused): ``wkv`` (L, B, H, hd,
        hd) f32 and the token-shift rows ``x_tm``/``x_cm`` (L, B, 1, D)."""
        cfg = self.cfg
        device = resolve_device(device)
        dtype = dtype or self.dtype
        L, D = cfg.num_layers, cfg.d_model
        return {
            "wkv": torch.zeros((L, batch, self.H, cfg.hd, cfg.hd), dtype=torch.float32,
                               device=device),
            "x_tm": torch.zeros((L, batch, 1, D), dtype=dtype, device=device),
            "x_cm": torch.zeros((L, batch, 1, D), dtype=dtype, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device),
        }

    def decode_step(self, params, cache, tokens, positions=None):
        """One token for every row.  tokens: (B, 1) int.  Returns (logits
        (B, 1, V) f32, cache): the state leaves are written in place,
        ``length`` is a new tensor, one larger."""
        cfg = self.cfg
        cache = dict(cache)
        h = self._embed(params, tokens)                      # (B, 1, D)
        wkv, x_tm, x_cm = cache["wkv"], cache["x_tm"], cache["x_cm"]
        for l in range(cfg.num_layers):
            h, (st, xtm, xcm) = self._layer(h, self._layer_slice(params, l), tm_state=wkv[l],
                                            x_tm_last=x_tm[l], x_cm_last=x_cm[l])
            wkv[l].copy_(st)
            x_tm[l].copy_(xtm)
            x_cm[l].copy_(xcm)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        cache["length"] = cache["length"] + 1
        return self._readout(params, h), cache

    def prefill(self, params, tokens=None, embeds=None, max_len: int | None = None):
        """Forward over whole prompts collecting each layer's state
        (``max_len`` unused: the state is O(1) in sequence length).
        Returns (last-token logits (B, 1, V) f32, cache)."""
        cfg = self.cfg
        h = embeds.to(self.dtype) if embeds is not None else self._embed(params, tokens)
        B, S, _ = h.shape
        states = []
        for l in range(cfg.num_layers):
            h, st = self._layer(h, self._layer_slice(params, l))
            states.append(st)
        sts, xtms, xcms = (torch.stack(x) for x in zip(*states))
        hn = rms_norm(h, params["final_norm"], cfg.norm_eps)
        cache = {"wkv": sts, "x_tm": xtms.to(self.dtype), "x_cm": xcms.to(self.dtype),
                 "length": torch.full((B,), S, dtype=torch.int32, device=h.device)}
        return self._readout(params, hn[:, -1:]), cache

    def _chunk_body(self, params, cache, tokens, rows, starts, valids):
        """Fixed-shape chunk forward over pooled-cache rows: each lane
        continues its row's carried state (a row's first chunk, start 0,
        from zero state; padding masked out of the update) and writes it
        back in place.  ``tokens`` (B, C), garbage past each lane's
        ``valid``; ``rows``/``starts``/``valids`` (B,).  Returns
        (final-norm hidden (B, C, D), cache)."""
        cfg = self.cfg
        cache = dict(cache)
        h = self._embed(params, tokens)                      # (B, C, D)
        B = h.shape[0]
        rows = rows.long()
        continuing = (starts > 0)[:, None, None]
        last_idx = torch.clamp(valids - 1, min=0).long()[:, None, None].expand(B, 1, h.shape[2])
        wkv, x_tm, x_cm = cache["wkv"], cache["x_tm"], cache["x_cm"]
        for l in range(cfg.num_layers):
            p = self._layer_slice(params, l)
            h1 = rms_norm(h, p["ln1"], cfg.norm_eps)
            xtm0 = torch.where(continuing, x_tm[l, rows], 0).to(x_tm.dtype)
            wkv0 = torch.where(continuing[..., None], wkv[l, rows], 0.0)
            tm_out, st = self._time_mix(h1, self._shift(h1, xtm0), p, state0=wkv0,
                                        valid=valids)
            h = h + tm_out
            h2 = rms_norm(h, p["ln2"], cfg.norm_eps)
            xcm0 = torch.where(continuing, x_cm[l, rows], 0).to(x_cm.dtype)
            h = h + self._channel_mix(h2, self._shift(h2, xcm0), p)
            wkv[l, rows] = st
            x_tm[l, rows] = torch.gather(h1, 1, last_idx).to(x_tm.dtype)
            x_cm[l, rows] = torch.gather(h2, 1, last_idx).to(x_cm.dtype)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        length = cache["length"].clone()
        length[rows] = (starts + valids).to(length.dtype)
        cache["length"] = length
        return h, cache

    def prefill_chunk(self, params, cache, tokens, seq: int, start: int, valid: int):
        """One fixed-shape prompt chunk into pool row ``seq``.  Returns
        (logits (1, 1, V) f32 for the last valid token, cache)."""
        dev = tokens.device

        def one(v):
            return torch.tensor([v], dtype=torch.int32, device=dev)

        h, cache = self._chunk_body(params, cache, tokens, one(seq), one(start), one(valid))
        return self._readout(params, h[:, valid - 1:valid]), cache

    def verify_chunk(self, params, cache, tokens, starts, valids):
        """Score a speculative window for every pool row in one call.
        ``tokens`` (B, C): lane r is pool row r; a dead lane has valid 0.
        Returns (logits (B, C, V) f32 at every position, cache with each
        live row's state advanced through its window)."""
        B = tokens.shape[0]
        rows = torch.arange(B, dtype=torch.int32, device=tokens.device)
        h, cache = self._chunk_body(params, cache, tokens, rows, starts, valids)
        return self._readout(params, h), cache

    # ------------------------------------------------------------ quant API
    def quant_groups(self, seq_len: int = 4096) -> list[QuantGroup]:
        cfg = self.cfg
        D, Fd = cfg.d_model, cfg.d_ff
        groups: list[QuantGroup] = []

        def add(name, path, layer, shape, macs_per_token):
            groups.append(QuantGroup(name, path, layer, tuple(shape),
                                     math.prod(shape), int(macs_per_token * seq_len)))

        add("embed", ("embed",), None, (cfg.vocab_size, D), 0)
        for l in range(cfg.num_layers):
            pre, base = f"L{l:02d}.", ("blocks",)
            for m in ("wr", "wk", "wv", "wg", "wo"):
                add(pre + f"tm.{m}", base + ("tm", m), l, (D, D), D * D)
            add(pre + "cm.wk", base + ("cm", "wk"), l, (D, Fd), D * Fd)
            add(pre + "cm.wv", base + ("cm", "wv"), l, (Fd, D), D * Fd)
            add(pre + "cm.wr", base + ("cm", "wr"), l, (D, D), D * D)
        add("lm_head", ("lm_head",), None, (D, cfg.vocab_size), D * cfg.vocab_size)
        return groups

    def frozen_bits(self) -> dict[str, int]:
        out = {}
        for g in self.quant_groups():
            if any(g.name.startswith(p) or p in g.name for p in self.cfg.frozen_at_8):
                out[g.name] = 8
        return out
