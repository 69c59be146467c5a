"""TransformerLM, dense family (torch port of ``repro.models.transformer``).

Ported: ``init`` (stacked training layout), the paged serving path —
fixed-shape chunked prefill (``prefill_chunk`` over ``_chunk_body``) and
the one-token ``decode_step`` over a ``PagedCachePool`` with fp blocks,
quantized KV blocks (int8, or nibble-packed int4) or the fp32 kv-oracle
— and the quantization API (``quant_groups``, ``kv_quant_groups``,
``frozen_bits``).  Every packed matmul goes through ``apply_linear`` ->
``kernels.ops.qmm``, every decode attention through
``kernels.ops.paged_attention``, and a quantized-KV decode step with
packed q/k/v through ``kernels.ops.fused_qkv_paged_decode``, so on the
card the hand-written Hopper kernels carry the whole path.

Params are plain dicts of tensors with the reference's structure: the
training layout stacks each repeated leaf along a leading layer axis in
``params["blocks"][0]``; the serving layout (``train.serve.
quantize_for_serving``) holds a per-layer list there, with ``Packed``
matrices and a ``QDQ`` embedding.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): MoE, hybrid and other families, M-RoPE and absolute-sinusoid
positions, sliding-window (ring) caches, the speculative
``verify_chunk``, and the full-sequence ``forward`` / ``prefill``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import not_ported, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import gather_dequant
from repro_torch.models.common import (
    apply_linear,
    apply_rope,
    chunk_attention,
    dense_init,
    embed_init,
    rms_norm,
    swiglu,
)
from repro_torch.models.model import QuantGroup
from repro_torch.quant.pack import (QDQ, Packed, kv_dequantize, kv_pack_int4,
                                    kv_qdq, kv_quantize)


def _index(tree, i: int):
    """Slice layer ``i`` out of a stacked params subtree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


class TransformerLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise not_ported(f"model family {cfg.family!r}", "slice C, item 9")
        if cfg.rope != "rope":
            raise not_ported(f"positions {cfg.rope!r}", "slice C, item 9")
        if cfg.sliding_window is not None:
            raise not_ported("sliding-window (ring) paged caches",
                             "slice A, item 3 (rest)")
        self.cfg = cfg

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0, device=None) -> dict:
        """Random params in the stacked training layout, drawn layer by
        layer from a ``torch.Generator`` seeded with ``seed`` on
        ``device`` (the card unless ``device="cpu"``).  torch cannot
        reproduce ``jax.random``: to compare with the reference, carry the
        reference's params over with ``repro_torch.convert``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        cfg, dt = self.cfg, self.dtype
        L, D, H, KV, hd, Fd = (cfg.num_layers, cfg.d_model, cfg.num_heads,
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

        ones = torch.ones((L, D), dtype=torch.float32, device=device)
        blocks = {"ln1": ones, "ln2": ones.clone(), "attn": stack(shapes),
                  "mlp": stack(mlp)}
        params = {
            "embed": embed_init(gen, cfg.vocab_size, D, dt, device),
            "blocks": [blocks],
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

    @staticmethod
    def _write_slot(bt, length, bs: int):
        """(physical block, offset) of each row's new token: logical slot
        ``min(length, Tc - 1)`` through the block table."""
        Tc = bt.shape[1] * bs
        slot = torch.clamp(length, max=Tc - 1).long()
        phys = bt.long().gather(1, (slot // bs)[:, None])[:, 0]
        return phys, slot % bs

    def _attn(self, x, p, positions, cache, layer):
        """Residual attention sublayer, one-token decode over the paged
        pool: write the new K/V into its owning block, then attend by block
        table (``kernels.ops.paged_attention``).  A quantized pool with
        packed q/k/v takes the fused op instead."""
        cfg = self.cfg
        B, S, D = x.shape
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        if "block_tables" not in cache:
            raise not_ported("slot-pool decode", "slice A, item 3 (rest)")
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if (S == 1 and "k_scale" in cache
                and all(isinstance(p["attn"][m], Packed) for m in ("wq", "wk", "wv"))):
            out = self._fused_decode_attn(h, p, cache, layer)
            return x + apply_linear(out.reshape(B, S, H * hd), p["attn"]["wo"])
        q = apply_linear(h, p["attn"]["wq"]).reshape(B, S, H, hd)
        k = apply_linear(h, p["attn"]["wk"]).reshape(B, S, KV, hd)
        v = apply_linear(h, p["attn"]["wv"]).reshape(B, S, KV, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        kc, vc, length = cache["k"][layer], cache["v"][layer], cache["length"]
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

    def _ffn(self, x, p):
        h = rms_norm(x, p["ln2"], self.cfg.norm_eps)
        return x + self._dense_mlp(h, p["mlp"])

    def _dense_mlp(self, h, p):
        g = apply_linear(h, p["wg"])
        if self.cfg.act == "swiglu":
            z = swiglu(g, apply_linear(h, p["wu"]))
        else:
            z = F.gelu(g.float(), approximate="tanh").to(h.dtype)
        return apply_linear(z, p["wd"])

    # ------------------------------------------------------------- embed/out
    def _embed_in(self, params, tokens):
        emb = params["embed"]
        if isinstance(emb, QDQ):  # serving embed: the quantize-dequantized table
            emb = emb.value
        return F.embedding(tokens.long(), emb)

    def _readout(self, params, h):
        w = params.get("lm_head")
        if w is None:
            emb = params["embed"]
            w = (emb.value if isinstance(emb, QDQ) else emb).T
        return apply_linear(h, w).float()

    # --------------------------------------------------------------- decode
    def forward(self, *args, **kwargs):
        raise not_ported("the full-sequence training forward", "slice B, item 8")

    def prefill(self, *args, **kwargs):
        raise not_ported("full-prompt prefill (slot pool)", "slice A, item 3 (rest)")

    def verify_chunk(self, *args, **kwargs):
        raise not_ported("the speculative verifier", "slice A, item 7")

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None) -> dict:
        """Contiguous per-row cache; the paged pool reads its leaf shapes
        and dtypes as the template for its blocks."""
        cfg = self.cfg
        device = resolve_device(device)
        dtype = dtype or self.dtype
        L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
        return {
            "k": torch.zeros((L, batch, max_len, KV, hd), dtype=dtype, device=device),
            "v": torch.zeros((L, batch, max_len, KV, hd), dtype=dtype, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device),
        }

    def _layer_slice(self, params, l: int):
        """Per-layer param view: stacked tree or pre-unrolled serving list."""
        stacked = params["blocks"][0]
        if isinstance(stacked, list):  # serving layout: per-layer list
            return stacked[l]
        return _index(stacked, l)

    def decode_step(self, params, cache, tokens, positions=None):
        """One token for every pool row.  tokens: (B, 1) int.

        Returns (logits (B, 1, V) f32, cache).  The pool's K/V leaves are
        written in place; ``length`` is a new tensor, one larger."""
        cfg = self.cfg
        cache = dict(cache)
        h = self._embed_in(params, tokens)
        if positions is None:
            positions = cache["length"][:, None]
        for l in range(cfg.num_layers):
            p = self._layer_slice(params, l)
            h = self._attn(h, p, positions, cache, l)
            h = self._ffn(h, p)
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
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

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
        s_idx = torch.arange(Tc, device=x.device)[None, :]
        ctx_pos = torch.where(s_idx < starts[:, None], s_idx, -1)
        out = chunk_attention(q, k_ctx, v_ctx, ctx_pos, k_att, v_att, positions)

        i_idx = torch.arange(C, device=x.device)[None, :]
        blk = bt.gather(1, torch.clamp(positions // bs, 0, nb - 1).long())
        keep = i_idx < valids[:, None]                     # (B, C)
        sub = (positions % bs).long()
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
        for l in range(cfg.num_layers):
            p = self._layer_slice(params, l)
            h = self._chunk_attn(h, p, positions, cache, l, rows, starts, valids)
            h = self._ffn(h, p)
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
            pre, base = f"L{l:02d}.", ("blocks", 0)
            add(pre + "attn.wq", base + ("attn", "wq"), l, (D, H * hd), D * H * hd)
            add(pre + "attn.wk", base + ("attn", "wk"), l, (D, KV * hd), D * KV * hd)
            add(pre + "attn.wv", base + ("attn", "wv"), l, (D, KV * hd), D * KV * hd)
            add(pre + "attn.wo", base + ("attn", "wo"), l, (H * hd, D), D * H * hd)
            add(pre + "mlp.wg", base + ("mlp", "wg"), l, (D, Fd), D * Fd)
            if cfg.act == "swiglu":
                add(pre + "mlp.wu", base + ("mlp", "wu"), l, (D, Fd), D * Fd)
            add(pre + "mlp.wd", base + ("mlp", "wd"), l, (Fd, D), D * Fd)
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
