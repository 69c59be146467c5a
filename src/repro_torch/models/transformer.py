"""TransformerLM, the dense, moe, vlm, audio and hybrid families (torch
port of ``repro.models.transformer``).

Ported: ``init`` (stacked training layout), the teacher-forced training
``forward`` and ``loss`` (blocked flash attention with its manual
backward, sequence-chunked cross-entropy, ``remat`` none / full / dots
through ``torch.utils.checkpoint``), the paged serving path —
fixed-shape chunked prefill (``prefill_chunk`` over ``_chunk_body``),
the speculative verifier (``verify_chunk``, the same body over every pool
row) and the one-token ``decode_step`` over a ``PagedCachePool`` with fp
blocks, quantized KV blocks (int8, or nibble-packed int4) or the fp32
kv-oracle — the slot path (the full-prompt ``prefill`` into a contiguous
cache, and ``decode_step`` over it, as ``SlotCachePool`` and the static
loop use them), sliding-window (ring) caches on both paths, and the
quantization API (``quant_groups``, ``kv_quant_groups``,
``frozen_bits``).  Every packed matmul goes through ``apply_linear`` ->
``kernels.ops.qmm``, every paged decode attention through
``kernels.ops.paged_attention``, and a quantized-KV decode step with
packed q/k/v through ``kernels.ops.fused_qkv_paged_decode``, so on the
card the hand-written Hopper kernels carry the whole path.  A windowed
layer never takes the fused op (it writes at ``min(length, Tc - 1)``,
not at the ring slot), as the reference takes it only without a window.

Ring caches (``cfg.sliding_window``): a sequence's cache holds
``cache_len(max_len) = min(max_len, window)`` tokens, token position p at
slot ``p % Tc``; decode writes at ``length % Tc`` and attends the
``min(length + 1, Tc)`` live slots, and a chunk reads its context at the
positions its ring slots hold and writes at ``positions % Tc``.

The hybrid family (hymba): each layer runs attention and a Mamba SSM
branch (``models.mamba``) in parallel on the same normed input and mixes
them with a learned per-layer weight, as the reference does:
``x + mix * (attn(x) - x) + (1 - mix) * ssm(x)`` with the subtraction and
``mix = sigmoid(p["mix"])`` in the activation dtype.  The SSM state is
O(1) per row (``ssm_h`` (L, B, Di, N) f32, ``ssm_conv`` (L, B, ks - 1,
Di)): the decode step writes it in place, and the chunk body carries each
row's state (a row's first chunk, start 0, from zero state).

The MoE family (moonshot, maverick): a "sub" is one attention + FFN
residual block, and ``moe_interleave`` subs make a superblock whose last
sub routes over experts (``models.moe``; maverick's ``shared`` dense MLP
beside it), the others dense.  Layer ``l`` is sub ``l % n_sub``, index
``l // n_sub``.  Serving routes drop-free (``exact``: ``decode_step`` and
the chunk body); the training ``forward`` and the full-prompt ``prefill``
drop choices past capacity, as the reference's do.  Positions: ``rope``,
``mrope`` (qwen2-vl: three streams (t, h, w) over sections of the
half-dim; a (B, S) position is broadcast to all three) and ``abs_sin``
(musicgen: sinusoids added to the embedding, no rotation).  The vlm and
audio frontends are stubs, as in the reference: ``forward`` and
``prefill`` take precomputed ``embeds``.  The fused decode op rotates by
RoPE, so it is taken only under ``rope``.

Params are plain dicts of tensors with the reference's structure: the
training layout stacks each repeated leaf along a leading axis of
``L_super = num_layers // n_sub`` in ``params["blocks"][s]``, one stacked
subtree per sub ``s``; the serving layout (``train.serve.
quantize_for_serving``) holds a per-layer list there, with ``Packed``
matrices (an expert bank's planes with a leading E axis) and a ``QDQ``
embedding.

Not ported yet (raises ``NotImplementedError`` naming its ROADMAP item):
training every family but dense (``loss``).
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import not_ported, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import gather_dequant
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.common import (
    apply_linear,
    apply_mrope,
    apply_rope,
    blocked_attention,
    chunk_attention,
    chunked_ce,
    decode_attention,
    dense_init,
    embed_init,
    rms_norm,
    swiglu,
)
from repro_torch.models.model import QuantGroup
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.quant.pack import (QDQ, Packed, kv_dequantize, kv_pack_int4,
                                    kv_qdq, kv_quantize)


def _index(tree, i: int):
    """Slice layer ``i`` out of a stacked params subtree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, L: int) -> list:
    """A stacked params subtree -> L per-layer subtrees, each leaf unbound
    once (its backward stacks the layers' gradients in one copy)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, L) for k, v in tree.items()}
        return [{k: parts[k][l] for k in tree} for l in range(L)]
    return list(torch.unbind(tree, 0))


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: save the outputs of the weight matmuls (the 2-D
    ``mm`` products, as ``dots_with_no_batch_dims_saveable`` saves dots
    without batch dims) and recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class TransformerLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family == "ssm":
            raise ValueError("use RWKV6LM for family='ssm'")
        self.cfg = cfg
        self.n_sub = cfg.moe_interleave if cfg.num_experts else 1
        if cfg.num_layers % self.n_sub:
            raise ValueError("num_layers must divide moe_interleave")
        self.L_super = cfg.num_layers // self.n_sub

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0, device=None) -> dict:
        """Random params in the stacked training layout, drawn layer by
        layer from a ``torch.Generator`` seeded with ``seed`` on
        ``device`` (the card unless ``device="cpu"``): one stacked
        subtree of ``L_super`` layers per sub, the MoE sub last.  torch
        cannot reproduce ``jax.random``: to compare with the reference,
        carry the reference's params over with ``repro_torch.convert``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        cfg, dt = self.cfg, self.dtype
        L, D, H, KV, hd, Fd = (self.L_super, cfg.d_model, cfg.num_heads,
                               cfg.num_kv_heads, cfg.hd, cfg.d_ff)
        shapes = {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
                  "wo": (H * hd, D)}
        mlp = {"wg": (D, Fd), "wd": (Fd, D)}
        if cfg.act == "swiglu":
            mlp["wu"] = (D, Fd)
        scales = {"wo": (H * hd) ** -0.5, "wd": Fd ** -0.5}

        def stack(table):
            out = {}
            for name, (din, dout) in table.items():
                w = torch.empty((L, din, dout), dtype=dt, device=device)
                for l in range(L):
                    w[l] = dense_init(gen, din, dout, dt, scales.get(name), device)
                out[name] = w
            return out

        def stack_moe():
            E = cfg.num_experts
            out = {"router": torch.empty((L, D, E), dtype=torch.float32, device=device),
                   "wg": torch.empty((L, E, D, Fd), dtype=dt, device=device),
                   "wu": torch.empty((L, E, D, Fd), dtype=dt, device=device),
                   "wd": torch.empty((L, E, Fd, D), dtype=dt, device=device)}
            for l in range(L):
                for name, w in init_moe(gen, E, D, Fd, dt, device).items():
                    out[name][l] = w
            return out

        subs = []
        for s in range(self.n_sub):
            ones = torch.ones((L, D), dtype=torch.float32, device=device)
            blocks = {"ln1": ones, "ln2": ones.clone(), "attn": stack(shapes)}
            if cfg.num_experts and s == self.n_sub - 1:
                blocks["moe"] = stack_moe()
                if cfg.shared_expert:
                    blocks["shared"] = stack(mlp)
            else:
                blocks["mlp"] = stack(mlp)
            if cfg.family == "hybrid":
                ssm = [mamba_mod.init_mamba(gen, D, cfg.ssm_expand * D, cfg.ssm_state,
                                            cfg.ssm_conv, dt, device) for _ in range(L)]
                blocks["ssm"] = {k: torch.stack([m[k] for m in ssm]) for k in ssm[0]}
                blocks["mix"] = torch.full((L,), 0.5, dtype=torch.float32, device=device)
            subs.append(blocks)
        params = {
            "embed": embed_init(gen, cfg.vocab_size, D, dt, device),
            "blocks": subs,
            "final_norm": torch.ones((D,), dtype=torch.float32, device=device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, D, cfg.vocab_size, dt, device=device)
        return params

    # ------------------------------------------------------------- sublayers
    def _fused_decode_attn(self, h, p, cache, layer):
        """Quantized-KV decode with packed q/k/v: bit-serial QKV + RoPE +
        KV-quantize + paged attention in one op
        (``kernels.ops.fused_qkv_paged_decode``), then the new token's
        codes and scales written into the pool in place.  Writing after
        attending is write-then-attend: the op folds the new token in from
        its own quantized values."""
        cfg = self.cfg
        kc, vc, length = cache["k"][layer], cache["v"][layer], cache["length"]
        ksc, vsc = cache["k_scale"][layer], cache["v_scale"][layer]
        bt = cache["block_tables"]                          # (B, nb)
        out, k_codes, v_codes, k_sc, v_sc = kops.fused_qkv_paged_decode(
            h[:, 0], p["attn"]["wq"], p["attn"]["wk"], p["attn"]["wv"],
            kc, vc, ksc, vsc, bt, length, cache["kv_qmax"][layer],
            rope_theta=cfg.rope_theta, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads)
        phys, sub = self._write_slot(bt, length, kc.shape[1])
        kc[phys, sub] = k_codes
        vc[phys, sub] = v_codes
        ksc[phys, sub] = k_sc
        vsc[phys, sub] = v_sc
        return out

    def _slot(self, length, Tc: int):
        """Each row's cache slot for its new token: ``length % Tc`` in a
        ring, else ``min(length, Tc - 1)``."""
        if self.cfg.sliding_window is not None:
            return (length % Tc).long()
        return torch.clamp(length, max=Tc - 1).long()

    def _write_slot(self, bt, length, bs: int):
        """(physical block, offset) of each row's new token: its logical
        slot (:meth:`_slot`) through the block table."""
        slot = self._slot(length, bt.shape[1] * bs)
        phys = bt.long().gather(1, (slot // bs)[:, None])[:, 0]
        return phys, slot % bs

    def _rotate(self, t, positions):
        """Rotate q or k (B, S, heads, hd) by the config's positions:
        RoPE, or M-RoPE over (3, B, S) streams (a (B, S) position is
        broadcast to all three, as the reference does); ``abs_sin`` and
        ``none`` rotate nothing."""
        cfg = self.cfg
        if cfg.rope == "rope":
            return apply_rope(t, positions, cfg.rope_theta)
        if cfg.rope == "mrope":
            if positions.ndim == 2:
                positions = positions[None].expand(3, *positions.shape)
            return apply_mrope(t, positions, cfg.rope_theta, cfg.mrope_sections)
        return t

    def _attn(self, x, p, positions, cache, layer):
        """Residual attention sublayer.  ``cache=None``: the full sequence
        through :func:`blocked_attention` (training).  Else one-token
        decode over the paged pool: write the new K/V into its owning
        block, then attend by block table (``kernels.ops.paged_attention``).
        A quantized pool with packed q/k/v, no window and RoPE positions
        takes the fused op instead.  A contiguous cache (no block tables:
        the slot pool, the static loop) is written at the row's slot and
        attended with :func:`decode_attention`, as the reference does it
        (no kernel)."""
        cfg = self.cfg
        B, S, D = x.shape
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        if cache is None:           # the training forward: the full sequence
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            q = self._rotate(apply_linear(h, p["attn"]["wq"]).reshape(B, S, H, hd), positions)
            k = self._rotate(apply_linear(h, p["attn"]["wk"]).reshape(B, S, KV, hd), positions)
            v = apply_linear(h, p["attn"]["wv"]).reshape(B, S, KV, hd)
            out = blocked_attention(q, k, v, causal=True, window=cfg.sliding_window,
                                    q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
            return x + apply_linear(out.reshape(B, S, H * hd), p["attn"]["wo"])
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if (S == 1 and "k_scale" in cache and cfg.sliding_window is None
                and cfg.rope == "rope"
                and all(isinstance(p["attn"][m], Packed) for m in ("wq", "wk", "wv"))):
            out = self._fused_decode_attn(h, p, cache, layer)
            return x + apply_linear(out.reshape(B, S, H * hd), p["attn"]["wo"])
        q = apply_linear(h, p["attn"]["wq"]).reshape(B, S, H, hd)
        k = apply_linear(h, p["attn"]["wk"]).reshape(B, S, KV, hd)
        v = apply_linear(h, p["attn"]["wv"]).reshape(B, S, KV, hd)
        q, k = self._rotate(q, positions), self._rotate(k, positions)
        kc, vc, length = cache["k"][layer], cache["v"][layer], cache["length"]
        if "block_tables" not in cache:
            # contiguous (B, T, KV, hd) rows, written in place at the slot
            Tc = kc.shape[1]
            rows = torch.arange(B, device=x.device)
            slot = self._slot(length, Tc)
            kc[rows, slot] = k[:, 0].to(kc.dtype)
            vc[rows, slot] = v[:, 0].to(vc.dtype)
            out = decode_attention(q, kc, vc, torch.clamp(length + 1, max=Tc))
            return x + apply_linear(out.reshape(B, S, H * hd), p["attn"]["wo"])
        bt = cache["block_tables"]                          # (B, nb) int32
        phys, sub = self._write_slot(bt, length, kc.shape[1])
        eff_len = torch.clamp(length + 1, max=bt.shape[1] * kc.shape[1]).to(torch.int32)
        # the reference rebuilds the pool functionally
        # (cache["k"].at[layer].set(...)); here the new token is written
        # into the pool where it lies
        if "k_scale" in cache:
            # quantized blocks, unfused (dense q/k/v): quantize the new
            # token, write codes + per-(token, head) scales, attend with
            # dequantization in the kernel
            qmax = cache["kv_qmax"][layer]
            k_codes, k_sc = kv_quantize(k[:, 0], qmax)
            v_codes, v_sc = kv_quantize(v[:, 0], qmax)
            if kc.dtype == torch.uint8:  # nibble-packed uniform int4
                k_codes, v_codes = kv_pack_int4(k_codes), kv_pack_int4(v_codes)
            ksc, vsc = cache["k_scale"][layer], cache["v_scale"][layer]
            kc[phys, sub] = k_codes
            vc[phys, sub] = v_codes
            ksc[phys, sub] = k_sc
            vsc[phys, sub] = v_sc
            out = kops.paged_attention(q, kc, vc, bt, eff_len, ksc, vsc)
        else:
            if "kv_qmax" in cache:
                # fp-KV oracle: store the quantize-dequantize value, exactly
                # what the quantized read path reconstructs, in f32 blocks
                qmax = cache["kv_qmax"][layer]
                k_w, v_w = kv_qdq(k[:, 0], qmax), kv_qdq(v[:, 0], qmax)
            else:
                k_w, v_w = k[:, 0], v[:, 0]
            kc[phys, sub] = k_w.to(kc.dtype)
            vc[phys, sub] = v_w.to(vc.dtype)
            out = kops.paged_attention(q, kc, vc, bt, eff_len)
        out = apply_linear(out.reshape(B, S, H * hd), p["attn"]["wo"])
        return x + out

    def _ffn(self, x, p, exact: bool = False):
        """Residual FFN sublayer -> (x + y, aux loss f32, or None for a
        dense sub).  A MoE sub routes over its experts (``exact``:
        drop-free, the serving paths), with maverick's shared dense MLP
        beside it."""
        cfg = self.cfg
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if "moe" not in p:
            return x + self._dense_mlp(h, p["mlp"]), None
        y, aux = moe_ffn(h, p["moe"], k=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor, no_drop=exact)
        if "shared" in p:
            y = y + self._dense_mlp(h, p["shared"])
        return x + y, aux

    def _dense_mlp(self, h, p):
        g = apply_linear(h, p["wg"])
        if self.cfg.act == "swiglu":
            z = swiglu(g, apply_linear(h, p["wu"]))
        else:
            z = F.gelu(g.float(), approximate="tanh").to(h.dtype)
        return apply_linear(z, p["wd"])

    def _ssm_branch(self, x, p, cache=None, layer=None):
        """The hybrid SSM branch on ``ln1(x)``: the whole sequence
        (``cache=None``), or one decode token over the row's state, which
        is written back in place."""
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        if cache is None:
            y, _ = mamba_mod.mamba_forward(h, p["ssm"], chunk=self.cfg.chunk_size)
            return y
        ssm_h, ssm_conv = cache["ssm_h"][layer], cache["ssm_conv"][layer]
        y, st = mamba_mod.mamba_step(h, p["ssm"], {"h": ssm_h, "conv": ssm_conv})
        ssm_h.copy_(st["h"])
        ssm_conv.copy_(st["conv"])
        return y

    def _combine(self, x, attn_out, s, p):
        """Hymba's parallel mix: ``x + mix * (attn_out - x) + (1 - mix) *
        s``, the subtraction and ``mix`` in x's dtype, as the reference."""
        a = attn_out - x
        mix = torch.sigmoid(p["mix"]).to(x.dtype)
        return x + mix * a + (1.0 - mix) * s

    def _mixer(self, x, p, positions, cache=None, layer=None):
        """The token mixer of one layer: attention, and for the hybrid
        family the SSM branch beside it."""
        out = self._attn(x, p, positions, cache, layer)
        if self.cfg.family != "hybrid":
            return out
        return self._combine(x, out, self._ssm_branch(x, p, cache, layer), p)

    # ------------------------------------------------------------- embed/out
    def _embed_in(self, params, tokens, embeds=None):
        """Token embeddings, or the caller's precomputed ``embeds`` (the
        vlm and audio frontends are stubs) in the model dtype."""
        if embeds is not None:
            return embeds.to(self.dtype)
        emb = params["embed"]
        if isinstance(emb, QDQ):  # serving embed: the quantize-dequantized table
            emb = emb.value
        return F.embedding(tokens.long(), emb)

    def _add_abs_sin(self, h, positions):
        """``abs_sin`` positions: ``h`` + sinusoids of the (B, S)
        positions (or the first of three streams), cast to h's dtype."""
        if self.cfg.rope != "abs_sin":
            return h
        p2 = positions if positions.ndim == 2 else positions[0]
        return h + self._abs_sin(p2, h.shape[-1]).to(h.dtype)

    def _abs_sin(self, positions, D: int):
        """Sinusoids (..., D) f32 of int positions: sin then cos of
        ``position * 10000^(-i / (D/2))``."""
        half = D // 2
        freq = torch.exp(-math.log(10_000.0)
                         * torch.arange(half, dtype=torch.float32, device=positions.device)
                         / half)
        ang = positions[..., None].float() * freq
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

    def _readout(self, params, h):
        w = params.get("lm_head")
        if w is None:
            emb = params["embed"]
            w = (emb.value if isinstance(emb, QDQ) else emb).T
        return apply_linear(h, w).float()

    # ------------------------------------------------------------- forwards
    def _sub_forward(self, h, p, positions):
        """One token-mixer + FFN residual block of the training forward ->
        (h, aux or None); a MoE sub drops choices past capacity."""
        return self._ffn(self._mixer(h, p, positions), p)

    def _positions(self, B: int, S: int, device):
        """Default (B, S) positions ``arange(S)``; (3, B, S) for M-RoPE,
        the same position in every stream."""
        pos = torch.arange(S, dtype=torch.int32, device=device)[None, :].expand(B, S)
        return pos[None].expand(3, B, S) if self.cfg.rope == "mrope" else pos

    def forward(self, params, tokens=None, embeds=None, positions=None,
                remat: str = "none", return_hidden: bool = False):
        """Teacher-forced forward -> (logits f32 | final hidden, aux loss).

        The stacked layers run in order, each leaf unbound once.
        ``remat``: ``"none"`` keeps every activation for autograd,
        ``"full"`` recomputes each layer in the backward
        (``torch.utils.checkpoint``), ``"dots"`` recomputes all but the
        weight matmuls' outputs."""
        cfg = self.cfg
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be none, full or dots, got {remat!r}")
        h = self._embed_in(params, tokens, embeds)
        B, S, _ = h.shape
        if positions is None:
            positions = self._positions(B, S, h.device)
        h = self._add_abs_sin(h, positions)
        kwargs = {}
        if remat == "dots":
            kwargs["context_fn"] = partial(create_selective_checkpoint_contexts, _dots_policy)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        subs = [_unstack(b, self.L_super) for b in params["blocks"]]
        for i in range(self.L_super):
            for sub in subs:          # the superblock: layer i * n_sub + s
                if remat == "none":
                    h, a = self._sub_forward(h, sub[i], positions)
                else:
                    h, a = checkpoint(self._sub_forward, h, sub[i], positions,
                                      use_reentrant=False, **kwargs)
                if a is not None:
                    aux = aux + a
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        if return_hidden:
            return h, aux
        return self._readout(params, h), aux

    def loss(self, params, batch, remat: str = "none"):
        """Mean next-token CE (+ 1e-4 * mean logz² + 1e-2 * aux), the
        readout in rematerialized sequence chunks (:func:`chunked_ce`), so
        the (tokens x vocab) f32 logits never materialize whole.  Returns
        (loss, {"nll", "aux"}), all 0-d f32 tensors on the device."""
        if self.cfg.family != "dense":
            raise not_ported(f"training the {self.cfg.family} family (TransformerLM.loss)",
                             "slice C, item 9b")
        h, aux = self.forward(params, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                              positions=batch.get("positions"), remat=remat,
                              return_hidden=True)
        nll, z2 = chunked_ce(lambda hc: self._readout(params, hc), h, batch["labels"])
        return nll + 1e-4 * z2 + 1e-2 * aux, {"nll": nll, "aux": aux}

    # --------------------------------------------------------------- decode

    def cache_len(self, max_len: int) -> int:
        """Tokens a sequence's cache holds: the window for a ring."""
        w = self.cfg.sliding_window
        return min(max_len, w) if w else max_len

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None) -> dict:
        """Contiguous per-row cache of ``cache_len(max_len)`` tokens; the
        paged pool reads its leaf shapes and dtypes as the template for its
        blocks.  The hybrid family adds its O(1) SSM state per row."""
        cfg = self.cfg
        device = resolve_device(device)
        dtype = dtype or self.dtype
        L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
        T = self.cache_len(max_len)
        cache = {
            "k": torch.zeros((L, batch, T, KV, hd), dtype=dtype, device=device),
            "v": torch.zeros((L, batch, T, KV, hd), dtype=dtype, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device),
        }
        if cfg.family == "hybrid":
            Di, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
            cache["ssm_h"] = torch.zeros((L, batch, Di, N), dtype=torch.float32, device=device)
            cache["ssm_conv"] = torch.zeros((L, batch, cfg.ssm_conv - 1, Di), dtype=dtype,
                                            device=device)
        return cache

    def prefill(self, params, tokens=None, embeds=None, max_len: int | None = None):
        """Forward over whole prompts, building a contiguous cache sized for
        ``max_len`` total tokens (prompt + decode budget).  Returns
        (last-token logits (B, 1, V) f32, cache).  Per layer over the
        serving layout: each layer's K/V is captured for the cache (the
        last ``Tc`` tokens; a ring rolls them so that position p sits at
        slot ``p % Tc``; the hybrid family's SSM state too), then the layer
        runs as the training forward."""
        cfg = self.cfg
        h = self._embed_in(params, tokens, embeds)
        B, S, _ = h.shape
        KV, hd = cfg.num_kv_heads, cfg.hd
        positions = self._positions(B, S, h.device)
        h = self._add_abs_sin(h, positions)
        cache = self.init_cache(B, max(S, max_len or 0, 1), device=h.device)
        Tc = cache["k"].shape[2]
        Tmin = min(S, Tc)
        # element i of the last Tmin tokens is position S - Tmin + i
        shift = (S - Tmin) % Tc if cfg.sliding_window is not None else 0
        for l in range(cfg.num_layers):
            p = self._layer_slice(params, l)
            hn = rms_norm(h, p["ln1"], cfg.norm_eps)
            k = self._rotate(apply_linear(hn, p["attn"]["wk"]).reshape(B, S, KV, hd),
                             positions)
            v = apply_linear(hn, p["attn"]["wv"]).reshape(B, S, KV, hd)
            for key, new in (("k", k), ("v", v)):
                rows = cache[key][l]                       # (B, Tc, KV, hd)
                rows[:, :Tmin] = new[:, S - Tmin:].to(rows.dtype)
                if shift:
                    rows.copy_(torch.roll(rows, shift, dims=1))
            out = self._attn(h, p, positions, None, None)
            if cfg.family == "hybrid":
                y, st = mamba_mod.mamba_forward(hn, p["ssm"], chunk=cfg.chunk_size,
                                                return_state=True)
                cache["ssm_h"][l] = st["h"]
                cache["ssm_conv"][l] = st["conv"].to(cache["ssm_conv"].dtype)
                out = self._combine(h, out, y, p)
            h, _ = self._ffn(out, p)     # a MoE sub drops, as the reference's prefill
        cache["length"] = torch.full((B,), S, dtype=torch.int32, device=h.device)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        return self._readout(params, h[:, -1:]), cache

    def _layer_slice(self, params, l: int):
        """Layer ``l``'s params (sub ``l % n_sub``, index ``l // n_sub``):
        a view into the stacked tree, or the serving layout's list entry."""
        stacked = params["blocks"][l % self.n_sub]
        if isinstance(stacked, list):  # serving layout: per-layer list
            return stacked[l // self.n_sub]
        return _index(stacked, l // self.n_sub)

    def decode_step(self, params, cache, tokens, positions=None):
        """One token for every pool row.  tokens: (B, 1) int.

        Returns (logits (B, 1, V) f32, cache).  The pool's K/V leaves (and
        the hybrid family's SSM state) are written in place; ``length`` is
        a new tensor, one larger."""
        cfg = self.cfg
        cache = dict(cache)
        h = self._embed_in(params, tokens)
        if positions is None:
            positions = cache["length"][:, None]
        h = self._add_abs_sin(h, positions)
        for l in range(cfg.num_layers):
            p = self._layer_slice(params, l)
            h = self._mixer(h, p, positions, cache, l)
            h, _ = self._ffn(h, p, exact=True)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = self._readout(params, h)
        cache["length"] = cache["length"] + 1
        return logits, cache

    # ----------------------------------------------------- chunked prefill
    def _chunk_attn(self, x, p, positions, cache, layer, rows, starts, valids):
        """Chunk attention sublayer against the paged pool, batched over
        pool ``rows``: each lane's queries attend [that row's cached pages ;
        the chunk itself], then the chunk's valid K/V are written into the
        owning blocks (padding lanes are not written)."""
        cfg = self.cfg
        B, C, D = x.shape
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q = apply_linear(h, p["attn"]["wq"]).reshape(B, C, H, hd)
        k = apply_linear(h, p["attn"]["wk"]).reshape(B, C, KV, hd)
        v = apply_linear(h, p["attn"]["wv"]).reshape(B, C, KV, hd)
        q, k = self._rotate(q, positions), self._rotate(k, positions)

        kc, vc = cache["k"][layer], cache["v"][layer]      # (NB, bs, KV, hd[/2])
        bt = cache["block_tables"][rows.long()].long()     # (B, nb)
        bs = kc.shape[1]
        nb = bt.shape[1]
        Tc = nb * bs
        quant = "k_scale" in cache
        oracle = not quant and "kv_qmax" in cache
        if quant:
            # dequantize the gathered context: codes · per-(token, head)
            # scale, the same f32 values an oracle pool stores
            ksc, vsc = cache["k_scale"][layer], cache["v_scale"][layer]
            k_ctx = gather_dequant(kc, ksc, bt)
            v_ctx = gather_dequant(vc, vsc, bt)
        else:
            k_ctx = kc[bt].reshape(B, Tc, KV, hd)          # gathered copies
            v_ctx = vc[bt].reshape(B, Tc, KV, hd)
        # the pool stores QDQ values, so in-chunk keys attend through the
        # same quantize-dequantize: a token scored inside a chunk then
        # matches the same token scored one decode step later
        k_att, v_att = k, v
        if quant or oracle:
            qmax = cache["kv_qmax"][layer]
            k_codes, k_sc = kv_quantize(k, qmax)           # (B, C, KV, hd), (B, C, KV)
            v_codes, v_sc = kv_quantize(v, qmax)
            k_att, v_att = kv_dequantize(k_codes, k_sc), kv_dequantize(v_codes, v_sc)
        window = cfg.sliding_window
        s_idx = torch.arange(Tc, device=x.device)[None, :]
        if window is None:
            ctx_pos = torch.where(s_idx < starts[:, None], s_idx, -1)
        else:
            # ring: slot s holds the youngest token p = s (mod Tc), p < start
            p_tok = starts[:, None] - 1 - ((starts[:, None] - 1 - s_idx) % Tc)
            ctx_pos = torch.where(p_tok >= 0, p_tok, -1)
        out = chunk_attention(q, k_ctx, v_ctx, ctx_pos, k_att, v_att, positions,
                              window=window)

        i_idx = torch.arange(C, device=x.device)[None, :]
        logical = positions if window is None else positions % Tc
        blk = bt.gather(1, torch.clamp(logical // bs, 0, nb - 1).long())
        keep = i_idx < valids[:, None]                     # (B, C)
        if window is not None and C > Tc:
            # a chunk longer than the ring: only its last Tc tokens land
            # (each slot once, the youngest token of it)
            keep &= i_idx >= valids[:, None] - Tc
        sub = (logical % bs).long()
        # in place, as in _attn (the reference scatters with mode="drop")
        phys, sub = blk[keep], sub[keep]
        if quant:
            if kc.dtype == torch.uint8:
                k_codes, v_codes = kv_pack_int4(k_codes), kv_pack_int4(v_codes)
            kc[phys, sub] = k_codes[keep]
            vc[phys, sub] = v_codes[keep]
            ksc[phys, sub] = k_sc[keep]
            vsc[phys, sub] = v_sc[keep]
        else:
            # the oracle writes the QDQ values it attended; fp writes raw k/v
            kc[phys, sub] = k_att[keep].to(kc.dtype)
            vc[phys, sub] = v_att[keep].to(vc.dtype)

        out = apply_linear(out.reshape(B, C, H * hd), p["attn"]["wo"])
        return x + out

    def _chunk_ssm(self, x, p, cache, layer, rows, starts, valids):
        """The hybrid SSM branch over a chunk, carrying each row's cached
        state (zero on a row's first chunk, start 0: a new admission may
        reuse a row whose previous occupant's state is still there),
        padding masked out of the update; the new state is written back in
        place."""
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        rows = rows.long()
        ssm_h, ssm_conv = cache["ssm_h"], cache["ssm_conv"]
        continuing = (starts > 0)[:, None, None]
        state = {"h": torch.where(continuing, ssm_h[layer, rows], 0.0),
                 "conv": torch.where(continuing, ssm_conv[layer, rows], 0).to(ssm_conv.dtype)}
        y, st = mamba_mod.mamba_forward(h, p["ssm"], chunk=self.cfg.chunk_size,
                                        return_state=True, init_state=state, valid=valids)
        ssm_h[layer, rows] = st["h"]
        ssm_conv[layer, rows] = st["conv"].to(ssm_conv.dtype)
        return y

    def _chunk_body(self, params, cache, tokens, rows, starts, valids):
        """Fixed-shape chunk forward over pooled-cache rows.  ``tokens``
        (B, C), garbage past each lane's ``valid``; ``rows``/``starts``/
        ``valids`` (B,) map batch lane -> pool row / tokens already cached
        / live chunk length.  Returns (final-norm hidden (B, C, D), cache)."""
        cfg = self.cfg
        cache = dict(cache)
        B, C = tokens.shape
        h = self._embed_in(params, tokens)
        positions = starts[:, None] + torch.arange(C, dtype=torch.int32,
                                                   device=h.device)[None, :]
        h = self._add_abs_sin(h, positions)
        for l in range(cfg.num_layers):
            p = self._layer_slice(params, l)
            out = self._chunk_attn(h, p, positions, cache, l, rows, starts, valids)
            if cfg.family == "hybrid":
                s = self._chunk_ssm(h, p, cache, l, rows, starts, valids)
                out = self._combine(h, out, s, p)
            h, _ = self._ffn(out, p, exact=True)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        length = cache["length"].clone()
        length[rows.long()] = (starts + valids).to(length.dtype)
        cache["length"] = length
        return h, cache

    def prefill_chunk(self, params, cache, tokens, seq: int, start: int, valid: int):
        """One fixed-shape prompt chunk into pooled-cache row ``seq``.

        ``tokens``: (1, C) int, garbage past ``valid``; ``start`` tokens of
        this sequence are already cached.  Returns (logits (1, 1, V) f32
        for the last valid token, cache) — the hidden state is sliced
        before the vocab readout."""
        dev = tokens.device

        def one(v):
            return torch.tensor([v], dtype=torch.int32, device=dev)

        h, cache = self._chunk_body(params, cache, tokens, one(seq),
                                    one(start), one(valid))
        logits = self._readout(params, h[:, valid - 1:valid])
        return logits, cache

    def verify_chunk(self, params, cache, tokens, starts, valids):
        """Score a speculative window for EVERY pool row in one batched
        fixed-shape call.  ``tokens`` (B, C): lane r is pool row r, [last
        fed token, draft_1..draft_k, padding]; ``starts``/``valids`` (B,)
        (valid 0 marks a dead lane: nothing of it is written).  Returns
        (logits (B, C, V) f32 at every position — index j scores the
        continuation after ``tokens[:, :j+1]`` — and the cache, with the
        target's K/V written for every valid position of the window).

        It runs eagerly: the chunk write selects its valid lanes with a
        boolean mask, which waits on the device."""
        B = tokens.shape[0]
        rows = torch.arange(B, dtype=torch.int32, device=tokens.device)
        h, cache = self._chunk_body(params, cache, tokens, rows, starts, valids)
        return self._readout(params, h), cache

    # ------------------------------------------------------------ quant API
    def quant_groups(self, seq_len: int = 4096) -> list[QuantGroup]:
        """Ordered weight groups for the ReLeQ episode (embed first,
        lm_head last, matching the paper's layer walk)."""
        cfg = self.cfg
        D, H, KV, hd, Fd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_ff
        groups: list[QuantGroup] = []

        def add(name, path, layer, shape, macs_per_token):
            groups.append(QuantGroup(name, path, layer, tuple(shape),
                                     math.prod(shape), int(macs_per_token * seq_len)))

        add("embed", ("embed",), None, (cfg.vocab_size, D), 0)
        for l in range(cfg.num_layers):
            s, i, pre = l % self.n_sub, l // self.n_sub, f"L{l:02d}."
            base = ("blocks", s)
            add(pre + "attn.wq", base + ("attn", "wq"), i, (D, H * hd), D * H * hd)
            add(pre + "attn.wk", base + ("attn", "wk"), i, (D, KV * hd), D * KV * hd)
            add(pre + "attn.wv", base + ("attn", "wv"), i, (D, KV * hd), D * KV * hd)
            add(pre + "attn.wo", base + ("attn", "wo"), i, (H * hd, D), D * H * hd)
            if cfg.num_experts and s == self.n_sub - 1:
                E, k = cfg.num_experts, cfg.experts_per_token
                active = D * Fd * k  # per token, per matrix; the router is no group
                add(pre + "moe.wg", base + ("moe", "wg"), i, (E, D, Fd), active)
                add(pre + "moe.wu", base + ("moe", "wu"), i, (E, D, Fd), active)
                add(pre + "moe.wd", base + ("moe", "wd"), i, (E, Fd, D), active)
                if cfg.shared_expert:
                    for m, sh in (("wg", (D, Fd)), ("wu", (D, Fd)), ("wd", (Fd, D))):
                        add(pre + f"shared.{m}", base + ("shared", m), i, sh, D * Fd)
            else:
                add(pre + "mlp.wg", base + ("mlp", "wg"), i, (D, Fd), D * Fd)
                if cfg.act == "swiglu":
                    add(pre + "mlp.wu", base + ("mlp", "wu"), i, (D, Fd), D * Fd)
                add(pre + "mlp.wd", base + ("mlp", "wd"), i, (Fd, D), D * Fd)
            if cfg.family == "hybrid":
                Di = cfg.ssm_expand * D
                add(pre + "ssm.in_x", base + ("ssm", "in_x"), i, (D, Di), D * Di)
                add(pre + "ssm.in_z", base + ("ssm", "in_z"), i, (D, Di), D * Di)
                add(pre + "ssm.out", base + ("ssm", "out"), i, (Di, D), D * Di)
        if not cfg.tie_embeddings:
            add("lm_head", ("lm_head",), None, (D, cfg.vocab_size), D * cfg.vocab_size)
        return groups

    def kv_quant_groups(self, seq_len: int = 4096) -> list[QuantGroup]:
        """Per-layer KV-cache bitwidth groups: one pseudo-group per layer
        named ``kv.L{l:02d}`` whose "weights" are the K+V token activations
        a sequence of ``seq_len`` stores for that layer.  ``n_macs=0``: KV
        bits buy cache bytes, not multiply precision.  ``path=("kv", l)``
        is virtual: the serving pool's ``kv_bits`` consumes these groups,
        never the params."""
        cfg = self.cfg
        kv_hd = cfg.num_kv_heads * cfg.hd
        return [QuantGroup(f"kv.L{l:02d}", ("kv", l), l,
                           (seq_len, cfg.num_kv_heads, cfg.hd),
                           2 * seq_len * kv_hd, 0)
                for l in range(cfg.num_layers)]

    def frozen_bits(self) -> dict[str, int]:
        """Groups the agent may not touch (kept at 8 bits), per config."""
        out = {}
        for g in self.quant_groups():
            if any(g.name.startswith(p) or p in g.name for p in self.cfg.frozen_at_8):
                out[g.name] = 8
        return out
