#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA H100.  Run from the repository root: ``python3 chip_smoke.py``.

Phases, each of which fails the run (non-zero exit, no result line):

1. Device and build: print the card (``nvidia-smi`` name and power
   limit) and the torch/CUDA versions, then build every kernel from
   ``src/repro_torch/csrc`` with nvcc for sm_90a (one nvcc per source, all
   at once) and print ptxas' register/shared-memory report.
2. Kernels against their plain versions at the main paths' shapes, after
   ``torch.cuda.synchronize()``: qmm bit-serial at M in {1, 4, 16} and
   dequant at M in {64, 256} for every glm4-9b (K, N, bits), plus bits
   {2, 3, 8} at (4096, 4096); fp and quantized (int8, packed int4) paged
   attention at B=4, KV=2, G=16, hd=128, bs=16 with lengths {1, 16, 17,
   300} and {41, 58, 73, 96} and shuffled blocks.  Pass when
   max|kernel - plain| <= 1e-4 * max|plain| (both are f32 sums taken in
   different orders).  The fused QKV + paged decode at the same shapes
   (D=4096, 4-bit q/k/v, int8 and int4 pools): its projections sum in
   another order than the plain version's dequant-form matmul, so a new
   K/V code on a rounding edge may move by one: scales within 2^-7
   relative, codes within +-1 (the differing count is printed), output
   within 2e-2 * max|plain|; its attention launch alone, fed the plain
   version's own projections, gives codes and scales bitwise (output
   within 1e-2 * max|plain|: the plain version rounds it to bf16).  For
   each shape: kernel, plain and library yardstick times (median of
   per-launch CUDA-event times, L2 flushed before each launch) and the
   bound from bytes and operations.
3. Three paths end to end, each through the launcher's continuous path at
   glm4-9b's published widths (40 layers, d_model 4096, vocab 151552),
   random weights from seed 0, 8 requests, 4 rows, block 16, prompts of
   40-64 tokens, prefill chunk 64, gen 16-32, greedy:
   a. ``--bits 4``, fp KV blocks: qmm bit-serial, qmm dequant and fp
      paged attention;
   b. ``--bits 4 --kv-bits 4``: the fused QKV + paged decode over packed
      int4 blocks;
   c. ``--bits 16 --kv-bits 8``: dense bf16 q/k/v, quantized paged
      attention over int8 blocks.
   Launch counters are zeroed just before each path and read just after;
   every request must complete, each path's kernels must have launched and
   the plain-version counter must be 0.
4. Output checks: re-prefilling request 0's prompt on path a's weights
   gives finite (1, 1, 151552) logits whose argmax is the token the run
   emitted; and a small model with head dim 128 gives the same logits on
   the card (kernels) as on the CPU (plain versions) within 2e-2 *
   max|cpu| (bf16 activations round differently on each side), with fp,
   int4 and int8 KV blocks.

5. Where the time goes (read only, after the checks): for each path, four
   requests decode on its served model; a few decode steps are timed by
   the host clock, then a few more are traced with ``torch.profiler`` to
   split the device time by kernel and give the device's idle share.

The last lines are the card's nvidia-smi line, one JSON object with the
per-kernel numbers, and ``{"ok": true, "device": {...}}``.  Per-shape
details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
TOL = 1e-4
# (memory bytes/s, dense bf16 flop/s) from NVIDIA's data sheets
CARD_PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12),
              "H100": (3.35e12, 989e12), "H200": (4.8e12, 989e12)}
GLM4_QMM = [  # (name, K, N, bits, calls per decode step / prefill chunk)
    ("wq/wo", 4096, 4096, 4, 80), ("wk/wv", 4096, 256, 4, 80),
    ("wg/wu", 4096, 13696, 4, 80), ("wd", 13696, 4096, 4, 40),
    ("lm_head", 4096, 151552, 8, 1),
]
EXTRA_BITS = [("wq@2b", 4096, 4096, 2, 0), ("wq@3b", 4096, 4096, 3, 0),
              ("wq@8b", 4096, 4096, 8, 0)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_peaks(name: str):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return key, peaks
    return "H100", CARD_PEAKS["H100"]


class Timer:
    """Median per-launch time in ms from CUDA events, with the 50 MB L2
    flushed (a 256 MB memset) before every launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, iters: int = 15, warmup: int = 2) -> float:
        torch = self.torch
        times = []
        for i in range(iters + warmup):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if i >= warmup:
                times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peaks) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / peaks[0], flops / peaks[1]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def check_qmm(torch, timer, peaks, rows):
    from repro_torch.kernels.qmm import qmm_cuda
    from repro_torch.kernels.ref import dequant_ref, qmm_ref
    from repro_torch.quant.pack import pack_weight

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for name, K, N, bits, _ in GLM4_QMM + EXTRA_BITS:
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        planes, scale = pack_weight(w, bits)
        dense = dequant_ref(planes, scale, bits).to(torch.bfloat16)  # yardstick
        del w
        for path, Ms in (("bitserial", (1, 4, 16)), ("dequant", (64, 256))):
            for M in Ms:
                x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                got = qmm_cuda(x, planes, scale, bits, path)
                torch.cuda.synchronize()
                plain = qmm_ref(x, planes, scale, bits)
                err = (got - plain).abs().max().item()
                ref_max = plain.abs().max().item()
                if not math.isfinite(err) or err > TOL * ref_max:
                    fail(f"qmm_{path} {name} M={M}: max|kernel-plain| {err:.3g} "
                         f"> {TOL} * {ref_max:.3g}")
                worst = max(worst, err)
                nbytes = M * K * 2 + planes.numel() + N * 4 + M * N * 4
                b_ms, b_by = bound_ms(nbytes, 2.0 * M * K * N, peaks)
                row = {"kernel": f"qmm_{path}", "shape": name, "M": M, "K": K,
                       "N": N, "bits": bits, "max_abs_err": err,
                       "rel_err": err / ref_max,
                       "ms": timer(lambda: qmm_cuda(x, planes, scale, bits, path)),
                       "plain_ms": timer(lambda: qmm_ref(x, planes, scale, bits), iters=5),
                       "library_ms": timer(lambda: torch.matmul(x, dense)),
                       "bound_ms": b_ms, "bound_by": b_by}
                rows.append(row)
                print(f"  qmm_{path:9s} {name:8s} M={M:3d} K={K:5d} N={N:6d} "
                      f"b={bits} err={err:.2e} (rel {row['rel_err']:.1e}) "
                      f"kernel={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                      f"matmul={row['library_ms']:.4f} bound={b_ms:.4f} ms")
                del got, plain
        del planes, scale, dense
        torch.cuda.empty_cache()
    return worst


KV_LENGTHS = (("ragged", [1, 16, 17, 300]), ("main", [41, 58, 73, 96]))


def quant_pools(torch, NB, bs, KV, hd, kv_bits, gen):
    from repro_torch.quant.pack import kv_pack_int4, kv_quantize

    qmax = float(2 ** (kv_bits - 1) - 1)
    out = []
    for _ in range(2):
        codes, scale = kv_quantize(torch.randn((NB, bs, KV, hd), generator=gen,
                                               device="cuda"), qmax)
        out.append((kv_pack_int4(codes) if kv_bits == 4 else codes, scale))
    (kc, ks), (vc, vs) = out
    return kc, vc, ks, vs, qmax


def block_tables(torch, B, nb, seed):
    import numpy as np

    NB = B * nb + 1
    perm = np.random.default_rng(seed).permutation(NB - 1) + 1
    return NB, torch.from_numpy(perm[:B * nb].reshape(B, nb)).to("cuda", torch.int32)


def sdpa_over_pages(torch, q, kg, vg, lengths):
    """The library yardstick: SDPA over pages gathered (and, for a
    quantized pool, dequantized) beforehand, heads expanded."""
    import torch.nn.functional as F

    B, T, KV, hd = kg.shape
    G = q.shape[2] // KV
    kg = kg.repeat_interleave(G, dim=2).transpose(1, 2)
    vg = vg.repeat_interleave(G, dim=2).transpose(1, 2)
    mask = (torch.arange(T, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask)


def check_paged_attention(torch, timer, peaks, rows):
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.ref import paged_attention_ref

    B, KV, G, hd, bs = 4, 2, 16, 128, 16
    H = KV * G
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for label, lengths in KV_LENGTHS:
        nb = -(-max(lengths) // bs)
        NB, bt = block_tables(torch, B, nb, len(label))
        q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
        kp = torch.randn((NB, bs, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
        vp = torch.randn((NB, bs, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q4 = q.reshape(B, KV, G, hd)
        got = paged_attention_cuda(q4, kp, vp, bt, ln).reshape(B, 1, H, hd)
        torch.cuda.synchronize()
        plain = paged_attention_ref(q.float(), kp.float(), vp.float(), bt, ln)
        err = (got - plain).abs().max().item()
        ref_max = plain.abs().max().item()
        if not math.isfinite(err) or err > TOL * ref_max:
            fail(f"paged_attention {label}: max|kernel-plain| {err:.3g} > {TOL} * {ref_max:.3g}")
        worst = max(worst, err)
        library = sdpa_over_pages(torch, q, kp[bt.long()].reshape(B, nb * bs, KV, hd),
                                  vp[bt.long()].reshape(B, nb * bs, KV, hd), ln)
        live = sum(lengths)
        nbytes = q.numel() * 2 + live * KV * hd * 2 * 2 + bt.numel() * 4 + B * 4 + B * H * hd * 4
        b_ms, b_by = bound_ms(nbytes, 4.0 * live * H * hd, peaks)
        row = {"kernel": "paged_attention", "shape": label, "lengths": lengths,
               "B": B, "KV": KV, "G": G, "hd": hd, "bs": bs, "max_abs_err": err,
               "rel_err": err / ref_max,
               "ms": timer(lambda: paged_attention_cuda(q4, kp, vp, bt, ln)),
               "plain_ms": timer(lambda: paged_attention_ref(q, kp, vp, bt, ln)),
               "library_ms": timer(library), "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        print(f"  paged_attention {label:6s} lengths={lengths} err={err:.2e} "
              f"(rel {row['rel_err']:.1e}) kernel={row['ms']:.4f} "
              f"plain={row['plain_ms']:.4f} sdpa={row['library_ms']:.4f} "
              f"bound={b_ms:.4f} ms")
    return worst


def check_paged_attention_quant(torch, timer, peaks, rows):
    from repro_torch.kernels.paged_attention_quant import paged_attention_quant_cuda
    from repro_torch.kernels.ref import gather_dequant, quant_paged_attention_ref

    B, KV, G, hd, bs = 4, 2, 16, 128, 16
    H = KV * G
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for kv_bits, container in ((8, "int8"), (4, "int4")):
        for label, lengths in KV_LENGTHS:
            nb = -(-max(lengths) // bs)
            NB, bt = block_tables(torch, B, nb, len(label))
            kc, vc, ks, vs, _ = quant_pools(torch, NB, bs, KV, hd, kv_bits, gen)
            ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
            q4 = q.reshape(B, KV, G, hd)
            got = paged_attention_quant_cuda(q4, kc, vc, ks, vs, bt, ln).reshape(B, 1, H, hd)
            torch.cuda.synchronize()
            plain = quant_paged_attention_ref(q.float(), kc, vc, ks, vs, bt, ln)
            err = (got - plain).abs().max().item()
            ref_max = plain.abs().max().item()
            if not math.isfinite(err) or err > TOL * ref_max:
                fail(f"paged_attention_quant {container} {label}: max|kernel-plain| "
                     f"{err:.3g} > {TOL} * {ref_max:.3g}")
            worst = max(worst, err)
            live = sum(lengths)
            hds = kc.shape[-1]
            nbytes = (q.numel() * 2 + live * KV * (hds + 4) * 2 + bt.numel() * 4 + B * 4
                      + B * H * hd * 4)
            b_ms, b_by = bound_ms(nbytes, 4.0 * live * H * hd, peaks)
            bl = bt.long()
            library = sdpa_over_pages(torch, q, gather_dequant(kc, ks, bl).to(torch.bfloat16),
                                      gather_dequant(vc, vs, bl).to(torch.bfloat16), ln)
            row = {"kernel": "paged_attention_quant", "shape": label, "container": container,
                   "lengths": lengths, "B": B, "KV": KV, "G": G, "hd": hd, "bs": bs,
                   "max_abs_err": err, "rel_err": err / ref_max,
                   "ms": timer(lambda: paged_attention_quant_cuda(q4, kc, vc, ks, vs, bt, ln)),
                   "plain_ms": timer(lambda: quant_paged_attention_ref(q, kc, vc, ks, vs, bt, ln)),
                   "library_ms": timer(library), "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            print(f"  paged_attention_quant {container} {label:6s} err={err:.2e} "
                  f"(rel {row['rel_err']:.1e}) kernel={row['ms']:.4f} "
                  f"plain={row['plain_ms']:.4f} sdpa={row['library_ms']:.4f} "
                  f"bound={b_ms:.4f} ms")
    return worst


def check_fused_decode(torch, timer, peaks, rows):
    from repro_torch.kernels.fused_decode import (fused_attend_cuda,
                                                  fused_qkv_paged_decode_cuda)
    from repro_torch.kernels.ref import (dequant_ref, fused_decode_attend_ref,
                                         fused_qkv_paged_decode_ref, gather_dequant,
                                         qmm_ref)
    from repro_torch.models.common import rope_cos_sin
    from repro_torch.quant.pack import Packed, kv_unpack_int4, pack_weight

    B, KV, G, hd, bs, D = 4, 2, 16, 128, 16, 4096
    H = KV * G
    gen = torch.Generator(device="cuda").manual_seed(3)
    ws = []
    for n in (H * hd, KV * hd, KV * hd):
        planes, scale = pack_weight(torch.randn((D, n), generator=gen, device="cuda")
                                    * D ** -0.5, 4)
        ws.append(Packed(planes, scale, 4))
    dense = torch.cat([dequant_ref(w.planes, w.scale, w.bits) for w in ws],
                      dim=1).to(torch.bfloat16)                  # yardstick only
    worst = 0.0
    for kv_bits, container in ((8, "int8"), (4, "int4")):
        unpack = kv_unpack_int4 if kv_bits == 4 else (lambda c: c)
        for label, lengths in KV_LENGTHS:
            nb = -(-(max(lengths) + 1) // bs)    # the new token fits: len <= Tc - 1
            NB, bt = block_tables(torch, B, nb, len(label) + 7)
            kc, vc, ks, vs, qmax = quant_pools(torch, NB, bs, KV, hd, kv_bits, gen)
            ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            x = torch.randn((B, D), generator=gen, device="cuda").to(torch.bfloat16)
            cos, sin = rope_cos_sin(ln, hd, 1e4)
            qm = torch.tensor(qmax, device="cuda")
            args = (kc, vc, ks, vs, bt, ln, cos, sin, qm)
            got = fused_qkv_paged_decode_cuda(x, *ws, *args, H)
            torch.cuda.synchronize()
            plain = fused_qkv_paged_decode_ref(x, *ws, *args, H, KV)
            out, po = got[0].reshape(B, 1, H, hd), plain[0].float()
            err = (out - po).abs().max().item()
            ref_max = po.abs().max().item()
            what = f"fused_qkv_paged_decode {container} {label}"
            if not math.isfinite(err) or err > 2e-2 * ref_max:
                fail(f"{what}: max|kernel-plain| {err:.3g} > 2e-2 * {ref_max:.3g}")
            for g, p in zip(got[3:], plain[3:]):
                if not ((g - p).abs() <= 2.0 ** -7 * p.abs()).all():
                    fail(f"{what}: a new-token scale differs by more than 2^-7 relative")
            n_diff, n_codes = 0, 0
            for g, p in zip(got[1:3], plain[1:3]):
                d = (unpack(g).int() - unpack(p).int()).abs()
                if d.max().item() > 1:
                    fail(f"{what}: a new-token code differs by {d.max().item()}")
                n_diff += int((d > 0).sum())
                n_codes += d.numel()
            proj = torch.cat([qmm_ref(x, w.planes, w.scale, w.bits) for w in ws], dim=1)
            got_b = fused_attend_cuda(proj, torch.bfloat16, *args, H)
            torch.cuda.synchronize()
            plain_b = fused_decode_attend_ref(proj, *args, H, KV, torch.bfloat16)
            if not all(torch.equal(g, p) for g, p in zip(got_b[1:], plain_b[1:])):
                fail(f"{what}: the attention launch alone gives other codes or scales "
                     f"than the plain version on the same projections")
            err_b = (got_b[0].reshape(B, 1, H, hd) - plain_b[0].float()).abs().max().item()
            if not math.isfinite(err_b) or err_b > 1e-2 * plain_b[0].float().abs().max().item():
                fail(f"{what}: the attention launch alone differs by {err_b:.3g}")
            worst = max(worst, err)
            live = sum(lengths)
            hds = kc.shape[-1]
            w_bytes = sum(w.planes.numel() + w.scale.numel() * 4 for w in ws)
            nbytes = (x.numel() * 2 + w_bytes + live * KV * (hds + 4) * 2 + bt.numel() * 4
                      + B * 4 + 2 * cos.numel() * 4 + 4 + B * H * hd * 4 + 2 * B * KV * (hds + 4))
            flops = 2.0 * B * D * dense.shape[1] + 4.0 * (live + B) * H * hd
            b_ms, b_by = bound_ms(nbytes, flops, peaks)
            bl = bt.long()
            attn = sdpa_over_pages(torch, torch.randn((B, 1, H, hd), device="cuda",
                                                      dtype=torch.bfloat16),
                                   gather_dequant(kc, ks, bl).to(torch.bfloat16),
                                   gather_dequant(vc, vs, bl).to(torch.bfloat16), ln + 1)

            def composed():
                torch.matmul(x, dense)
                attn()

            row = {"kernel": "fused_qkv_paged_decode", "shape": label, "container": container,
                   "lengths": lengths, "B": B, "D": D, "KV": KV, "G": G, "hd": hd, "bs": bs,
                   "bits": [w.bits for w in ws], "max_abs_err": err, "rel_err": err / ref_max,
                   "codes_differing": n_diff, "codes": n_codes, "attend_alone_err": err_b,
                   "ms": timer(lambda: fused_qkv_paged_decode_cuda(x, *ws, *args, H)),
                   "plain_ms": timer(lambda: fused_qkv_paged_decode_ref(x, *ws, *args, H, KV)),
                   "library_ms": timer(composed),
                   "library": "sum: torch.matmul by dense bf16 wq|wk|wv + SDPA over "
                              "pre-gathered dequantized pages",
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            print(f"  fused_qkv_paged_decode {container} {label:6s} err={err:.2e} "
                  f"(rel {row['rel_err']:.1e}) codes differing {n_diff}/{n_codes} "
                  f"attend-alone err={err_b:.2e} kernel={row['ms']:.4f} "
                  f"plain={row['plain_ms']:.4f} matmul+sdpa (sum)={row['library_ms']:.4f} "
                  f"bound={b_ms:.4f} ms")
    return worst


def per_step(rows, kernel, pick):
    """Sum the per-shape numbers over one main-path step:
    ``pick(row) -> calls`` of that shape per step."""
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bound_by = set()
    for row in rows:
        n = pick(row) if row["kernel"] == kernel else 0
        if n:
            for key in out:
                out[key] += n * row[key]
            bound_by.add(row["bound_by"])
    out["bound_by"] = "operations" if bound_by == {"operations"} else "bytes"
    return out


def serve_path(torch, label, flags, need, built=None):
    """Serve the cell's workload through the launcher with ``flags``; the
    launch counters are zeroed just before and read just after.  ``built``
    reuses (cfg, model, sparams, policy) of the same ``--bits``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher

    args = launcher.parse_args([
        "--arch", "glm4-9b", "--no-smoke", "--device", "cuda",
        "--requests", "8", "--num-slots", "4", "--block-size", "16",
        "--prompt-len", "64", "--min-prompt-len", "40", "--prefill-chunk", "64",
        "--gen", "32", "--temperature", "0", *flags])
    t0 = time.perf_counter()
    cfg, model, sparams, policy = built or launcher.build(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    widths = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
              cfg.hd, cfg.d_ff, cfg.vocab_size)
    if widths != (40, 4096, 32, 2, 128, 13696, 151552):
        fail(f"glm4-9b widths {widths} are not the published ones")
    print(f"[{label}] glm4-9b serving params ready in {setup_s:.1f} s "
          f"(avg policy {policy.average_bits():.2f} bits, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    engine = launcher.continuous(args, cfg, model, sparams, policy)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = dict(ops.counts)
    m = engine.metrics()
    work = launcher.synthetic_workload(args, cfg.vocab_size)
    for r in m["requests"]:
        want = work[r["id"]][1]
        if r["state"] != "finished" or r["new_tokens"] != want:
            fail(f"[{label}] request {r['id']} ended {r['state']} with "
                 f"{r['new_tokens']}/{want} tokens")
    for key in need:
        if counts[key] <= 0:
            fail(f"[{label}] the path launched no {key} kernel: {counts}")
    if counts["plain"] != 0:
        fail(f"[{label}] the path took the plain version {counts['plain']} times on CUDA")
    print(f"[{label}] served {len(work)} requests: tokens/s={m['tokens_per_s']:.2f} "
          f"decode_step_p50={m['decode_step_p50_ms']:.3f} ms "
          f"p99={m['decode_step_p99_ms']:.3f} ms decode_steps={m['decode_steps']} "
          f"tokens={m['tokens_total']} wall={wall_s:.2f} s "
          f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[{label}] tokens per request: {[r['new_tokens'] for r in m['requests']]}")
    print(f"[{label}] launch counts on the path: {counts}")
    return {"args": args, "cfg": cfg, "model": model, "sparams": sparams,
            "policy": policy, "engine": engine, "work": work, "counts": counts,
            "metrics": m, "setup_s": setup_s, "wall_s": wall_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def check_outputs(torch, cfg, model, sparams, engine, work):
    """Full width: request 0 re-prefilled gives finite logits whose argmax
    is the emitted first token.  Small width: card vs CPU logits, with fp,
    int4 and int8 KV blocks."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    prompt = np.asarray(work[0][0], np.int32)
    pool = engine.pool
    seq = pool.alloc_seq()
    pool.ensure(seq, len(prompt) + 1)
    C = engine.prefill_chunk
    buf = np.zeros((1, C), np.int32)
    buf[0, :len(prompt)] = prompt
    logits, _ = model.prefill_chunk(sparams, pool.step_cache(),
                                    torch.from_numpy(buf).cuda(), seq, 0, len(prompt))
    pool.free_seq(seq)
    if tuple(logits.shape) != (1, 1, cfg.vocab_size) or not torch.isfinite(logits).all():
        fail(f"full-width logits shape {tuple(logits.shape)} or not finite")
    if int(logits[0, 0].argmax()) != engine.output(0)[0]:
        fail("re-prefilled request 0 does not reproduce its first token")

    small = dataclasses.replace(get_config("glm4-9b", smoke=True), num_layers=2,
                                d_model=256, num_heads=4, num_kv_heads=2,
                                head_dim=128, d_ff=688, vocab_size=1000)
    sm = build_model(small)
    params = sm.init(seed=5, device="cpu")
    for kv_bits in (None, 4, 8):
        small_model_card_vs_cpu(torch, sm, params, kv_bits)


def small_model_card_vs_cpu(torch, sm, params, kv_bits):
    from repro_torch.quant.qat import policy_for
    from repro_torch.serve.cache import PagedCachePool
    from repro_torch.train.serve import quantize_for_serving

    outs = {}
    for dev in ("cuda", "cpu"):
        sp = quantize_for_serving(sm, params, policy_for(sm, 4), device=dev)
        pool = PagedCachePool(sm, 2, 48, block_size=16, device=dev, kv_bits=kv_bits)
        for n in (37, 20):
            pool.ensure(pool.alloc_seq(), n + 4)
        res = []
        toks = torch.tensor([[7, 3, 11, 2] * 12], dtype=torch.int32)
        for seq, n in ((0, 37), (1, 20)):
            for lo in range(0, n, 16):
                valid = min(16, n - lo)
                lg, cache = sm.prefill_chunk(sp, pool.step_cache(),
                                             toks[:, lo:lo + 16].to(dev), seq, lo, valid)
                pool.accept(cache)
                res.append(lg.float().cpu())
        feed = torch.tensor([[1], [2]], dtype=torch.int32)
        for _ in range(3):
            lg, cache = sm.decode_step(sp, pool.step_cache(), feed.to(dev))
            pool.accept(cache)
            res.append(lg.float().cpu())
        outs[dev] = torch.cat([r.reshape(-1) for r in res])
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    scale = outs["cpu"].abs().max().item()
    kv = f"kv_bits={kv_bits}" if kv_bits else "fp KV"
    if not math.isfinite(err) or err > 2e-2 * scale:
        fail(f"small model ({kv}): card vs CPU logits differ by {err:.3g} > 2e-2 * {scale:.3g}")
    print(f"small model (hd 128, {kv}): card vs CPU logits max diff {err:.3e} "
          f"({err / scale:.2e} of max)")


def profile_decode(torch, engine, work, timed=4, traced=4):
    """Decode-only steps on 4 running rows: host-clock step time, then a
    torch.profiler trace for device time by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for prompt, _ in work[:4]:
        engine.submit(prompt, timed + traced + 4)
    engine.step()                      # admission + first decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            engine.step()
        torch.cuda.synchronize()
    engine.run_until_drained()
    fams: dict[str, float] = {}
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # kernels only: CPU ops
            continue                           # would count them twice
        us = ev.self_device_time_total
        if us <= 0:
            continue
        name = ev.key
        fam = ("qmm" if "qmm_" in name else "fused_qkv_paged_decode"
               if "fused_project" in name or "fused_attend" in name
               else "paged_attention_quant" if "paged_attention_quant" in name
               else "paged_attention" if "paged_attention" in name
               else "memcpy/memset" if "emcpy" in name or "emset" in name
               else "torch matmul" if any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet"))
               else "other torch kernels")
        fams[fam] = fams.get(fam, 0.0) + us / traced / 1e3
        top.append((us / traced / 1e3, ev.count // traced, name[:70]))
    busy = sum(fams.values())
    if busy <= 0:
        print("  where the time goes: the profiler saw no device time (not measured)")
        return {"step_ms": step_ms, "device_ms": None}
    print(f"  decode step (4 rows, host clock, untraced) = {step_ms:.2f} ms; "
          f"device busy {busy:.2f} ms/step -> idle share {1 - busy / step_ms:.3f}")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"    {fam:22s} {ms:8.3f} ms/step")
    for ms, n, name in sorted(top, reverse=True)[:8]:
        print(f"    top: {ms:8.3f} ms/step  {n:4d} launches/step  {name}")
    return {"step_ms": step_ms, "device_ms": busy, "families_ms": fams,
            "idle_share": 1 - busy / step_ms}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on the card only")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"cannot import repro_torch from {ROOT / 'src'}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- phase 1: device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi gave no output"
    name = torch.cuda.get_device_name(0)
    card, peaks = card_peaks(name)
    print(f"card: {smi_line}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, "
          f"sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}; "
          f"bounds use the {card} peaks {peaks[0] / 1e12:.2f} TB/s, "
          f"{peaks[1] / 1e12:.0f} TFLOP/s bf16")
    build.require_sm90(torch.device("cuda"))
    t0 = time.perf_counter()
    build.build_all()
    for src in build.SOURCES:
        build.library(src)
    print(f"built {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for src, log in build.ptxas_info.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # ---- phase 2: kernels against their plain versions
    timer = Timer(torch)
    rows: list[dict] = []
    print("phase 2: kernels against their plain versions (times in ms)")
    qmm_err = check_qmm(torch, timer, peaks, rows)
    pa_err = check_paged_attention(torch, timer, peaks, rows)
    paq_err = check_paged_attention_quant(torch, timer, peaks, rows)
    fused_err = check_fused_decode(torch, timer, peaks, rows)
    del timer
    torch.cuda.empty_cache()

    # ---- phases 3-5, path a (fp KV blocks): serve, check outputs, profile
    print("phase 3a: glm4-9b serving end to end, --bits 4, fp KV blocks")
    fp = serve_path(torch, "fp KV", ["--bits", "4"],
                    ("qmm_bitserial", "qmm_dequant", "paged_attention"))
    check_outputs(torch, fp["cfg"], fp["model"], fp["sparams"], fp["engine"], fp["work"])
    print("phase 5a: decode step breakdown, fp KV blocks")
    breakdown = {"fp KV": profile_decode(torch, fp["engine"], fp["work"])}

    # ---- path b: the same 4-bit weights over packed int4 KV blocks
    print("phase 3b: glm4-9b serving end to end, --bits 4 --kv-bits 4 (fused decode)")
    built = tuple(fp[k] for k in ("cfg", "model", "sparams", "policy"))
    fp_summary = {k: fp[k] for k in ("metrics", "counts", "setup_s", "wall_s", "peak_mem_gib")}
    del fp
    int4 = serve_path(torch, "int4 KV", ["--bits", "4", "--kv-bits", "4"],
                      ("qmm_bitserial", "qmm_dequant", "fused_qkv_paged_decode"), built)
    print("phase 5b: decode step breakdown, int4 KV blocks")
    breakdown["int4 KV"] = profile_decode(torch, int4["engine"], int4["work"])
    del built, int4["engine"], int4["sparams"], int4["model"]
    torch.cuda.empty_cache()

    # ---- path c: dense bf16 q/k/v over int8 KV blocks (fresh ~19 GB weights)
    print("phase 3c: glm4-9b serving end to end, --bits 16 --kv-bits 8 (dense q/k/v)")
    int8 = serve_path(torch, "int8 KV", ["--bits", "16", "--kv-bits", "8"],
                      ("qmm_bitserial", "paged_attention_quant"))
    print("phase 5c: decode step breakdown, int8 KV blocks")
    breakdown["int8 KV"] = profile_decode(torch, int8["engine"], int8["work"])

    calls = {name: n for name, _, _, _, n in GLM4_QMM}
    decode = per_step(rows, "qmm_bitserial",
                      lambda r: calls.get(r["shape"], 0) if r["M"] == 4 else 0)
    prefill = per_step(rows, "qmm_dequant",
                       lambda r: calls.get(r["shape"], 0)
                       if r["M"] == 64 and r["shape"] != "lm_head" else 0)
    attn = per_step(rows, "paged_attention", lambda r: 40 if r["shape"] == "main" else 0)

    def main_int(container):
        return lambda r: 40 if r["shape"] == "main" and r["container"] == container else 0

    attn_q = per_step(rows, "paged_attention_quant", main_int("int8"))
    fused = per_step(rows, "fused_qkv_paged_decode", main_int("int4"))
    counts = {"fp KV": fp_summary["counts"], "int4 KV": int4["counts"], "int8 KV": int8["counts"]}
    kernels = [
        {"name": "qmm_bitserial", "route": "cuda", "source": "src/repro_torch/csrc/qmm.cu",
         "replaces": "src/repro/kernels/qmm.py:78",
         "launches": counts["fp KV"]["qmm_bitserial"], "max_abs_err": qmm_err, **decode},
        {"name": "qmm_dequant", "route": "cuda", "source": "src/repro_torch/csrc/qmm.cu",
         "replaces": "src/repro/kernels/qmm.py:57",
         "launches": counts["fp KV"]["qmm_dequant"], "max_abs_err": qmm_err, **prefill},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:37",
         "launches": counts["fp KV"]["paged_attention"], "max_abs_err": pa_err, **attn},
        {"name": "paged_attention_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention_quant.cu",
         "replaces": "src/repro/kernels/paged_attention.py:117",
         "launches": counts["int8 KV"]["paged_attention_quant"], "max_abs_err": paq_err,
         **attn_q},
        {"name": "fused_qkv_paged_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_decode.cu",
         "replaces": "src/repro/kernels/fused_decode.py:63",
         "launches": counts["int4 KV"]["fused_qkv_paged_decode"], "max_abs_err": fused_err,
         **fused},
    ]
    serve = {label: {"metrics": {k: v for k, v in r["metrics"].items() if k != "requests"},
                     "requests": r["metrics"]["requests"], "counts": r["counts"],
                     "setup_s": r["setup_s"], "wall_s": r["wall_s"],
                     "peak_mem_gib": r["peak_mem_gib"]}
             for label, r in (("fp KV", fp_summary), ("int4 KV", int4), ("int8 KV", int8))}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "card": smi_line, "torch": torch.__version__, "cuda": torch.version.cuda,
        "peaks": {"bytes_per_s": peaks[0], "bf16_flops": peaks[1]},
        "per_shape": rows, "per_step": kernels,
        "per_step_note": "qmm_bitserial: one decode step at M=4 (280 layer calls + "
                         "lm_head); qmm_dequant: one 64-token prefill chunk (280 "
                         "layer calls); paged_attention, paged_attention_quant (int8) "
                         "and fused_qkv_paged_decode (int4): 40 calls at the 'main' "
                         "lengths; fused library_ms is a sum (matmul + SDPA)",
        "serve": serve, "decode_breakdown": breakdown,
        "total_s": time.perf_counter() - t_start}, indent=1, default=str))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
