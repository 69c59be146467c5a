#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA H100.  Run from the repository root: ``python3 chip_smoke.py``.

Phases, each of which fails the run (non-zero exit, no result line):

1. Device and build: print the card (``nvidia-smi`` name and power
   limit) and the torch/CUDA versions, then build every kernel from
   ``src/repro_torch/csrc`` with nvcc for sm_90a (one nvcc per source, all
   at once) and print ptxas' register/shared-memory report and, where
   ``cuobjdump`` exists, the qmm library's count of ``HGMMA``
   (tensor-core) instructions: its dequant body must have some.
2. Kernels against their plain versions at the main paths' shapes, after
   ``torch.cuda.synchronize()``: qmm bit-serial at M in {1, 4, 16, 32} and
   dequant at M in {64, 256} for every glm4-9b (K, N, bits), plus bits
   {2, 3, 8} at (4096, 4096); fp and quantized (int8, packed int4) paged
   attention at B=4, KV=2, G=16, hd=128, bs=16 with lengths {1, 16, 17,
   300} and {41, 58, 73, 96} and shuffled blocks.  Pass when
   max|kernel - plain| <= 1e-4 * max|plain| (both are f32 sums taken in
   different orders); both qmm bodies and fp paged attention must also give
   bitwise-equal outputs on two calls (split-K and split-KV sum their
   partials in a fixed order), and the fp attention's split plan must
   launch more than B * KV CTAs at the main lengths; the quantized
   attention too, both.  The fused QKV + paged decode at the same shapes
   (D=4096, 4-bit q/k/v, int8 and int4 pools): its projections sum in
   another order than the plain version's dequant-form matmul, so a new
   K/V code on a rounding edge may move by one: scales within 2^-7
   relative, codes within +-1 (the differing count is printed), output
   within 2e-2 * max|plain|; its attention launch alone, fed the plain
   version's own projections, gives codes and scales bitwise (output
   within 1e-2 * max|plain|: the plain version rounds it to bf16); its two
   launches run apart, the projection's split partials finished by the
   plain twin between them, give the whole op's outputs, codes and scales
   bitwise; two calls give bitwise-equal outputs, codes and scales, and its
   attention launch runs more than B * KV CTAs.  Its projection launch (A) and its
   attention launch (B) are timed alone as well as together.  The
   WRPN fake-quant at every ResNet-20 and LeNet weight shape, glm4-9b's
   wg (4096, 13696) and a ragged (7, 300), bits 1-8, 16 and 32, f32 and
   bf16: bitwise (max|kernel - plain| == 0), and the STE's forward and
   gradient mask bitwise against the plain ones.  The grouped fake-quant
   of the QAT path (one launch per forward that takes every layer's
   max|w| scale too, one for the STE backward) at the LeNet and ResNet-20
   groups, f32 and bf16, bits vectors cycling through 1-8, 16 and 32,
   with an all-zero, a NaN and a near-eps tensor, and at a ResNet-20
   group holding glm4-9b's wg: outputs, scales and gradients bit pattern
   for bit pattern against the plain versions; timed per QAT forward and
   backward against the same work by the library, the flat path it
   replaces and the bound.  For each shape: kernel,
   plain and library yardstick times (median of per-launch CUDA-event
   times, L2 flushed before each launch, the start event held behind a
   device spin that covers the wrapper's host work) and the bound from
   bytes and operations.
3. Five paths end to end.  Three serve through the launcher's continuous
   path at glm4-9b's published widths (40 layers, d_model 4096, vocab
   151552), random weights from seed 0, 8 requests, 4 rows, block 16,
   prompts of 40-64 tokens, prefill chunk 64, gen 16-32, greedy:
   a. ``--bits 4``, fp KV blocks: qmm bit-serial, qmm dequant and fp
      paged attention;
   b. ``--bits 4 --kv-bits 4``: the fused QKV + paged decode over packed
      int4 blocks;
   c. ``--bits 16 --kv-bits 8``: dense bf16 q/k/v, quantized paged
      attention over int8 blocks.
   Each serves through the launcher's defaults: the decode step captured
   in a CUDA graph, tokens selected on the device by a second graph, the
   one-step lookahead.  Each prints the sampler and pipeline counters and
   the graph captures, and fails unless the lookahead ran
   (``lookahead_steps > 0``), every decode step was a lookahead or a
   bubble, and the decode step was captured once (``recompiles == 0``).
   a'. path a again with ``--host-sampling`` on the same params: its
      greedy streams must equal path a's bitwise; tokens/s, step p50 and
      TTFT print beside path a's.
   a''. path a's workload through a ``ServeEngine`` that runs
      ``model.decode_step`` eagerly and samples on the host (no graph):
      the captured decode step's witness at full width, its greedy
      streams bitwise path a's.  Then a' and a once more, in that order,
      so that each path is timed both first and second.
   Two run the ReLeQ search, every QAT forward through one grouped
   fake-quant launch and every backward through one grouped STE launch
   (no flat fake-quant launch):
   d. the quickstart twin (``repro_torch.launch.quickstart``) on LeNet at
      the reference quickstart's steps: pretrain 300, 30 episodes with 2
      retrain steps, long retrain 150;
   e. ResNet-20 at full width (20 quantized layers, 268,336 weights,
      cifar-like 32x32x3, batch 128, validation 2 x 256): pretrain
      ``RESNET20_PRETRAIN`` steps,
      ``RESNET20_EPISODES`` episodes in ``episode_end`` mode with 2
      retrain steps, long retrain 200 at the best policy.
   Launch counters are zeroed just before each path and read just after;
   every request must complete, each path's kernels must have launched and
   the plain-version counter must be 0; the serving paths print the p50
   and max time to first token; the fp accuracy of d and e must
   clear the floors below, and their search records must be whole.
4. Output checks: re-prefilling request 0's prompt on path a's weights
   gives finite (1, 1, 151552) logits whose argmax is the token the run
   emitted; a small model with head dim 128 gives the same logits on the
   card (kernels) as on the CPU (plain versions) within 2e-2 * max|cpu|
   (bf16 activations round differently on each side), with fp, int4 and
   int8 KV blocks; the same model served by ``ServeEngine`` on the CPU
   with host sampling and on the card twice, with host sampling and with
   the defaults (graphs, device sampling, lookahead) (6 requests on 4
   rows, prompts of 9-40 tokens, 36 greedy tokens each, block 16), gives
   the same greedy streams with fp, int4 and int8 KV blocks, or diverges
   only where the CPU's top-2 logit margin is within 2e-2 * max|logit|
   (the first divergence and its margin are printed); and one ResNet-20
   QAT step at a mixed policy from
   path e's params gives the same params on the card as on the CPU within
   1e-4 * max|param| (f32 convolutions, TF32 off, summed in other orders)
   and the same validation accuracy.

5. Where the time goes (read only, after the checks): for each serving
   path, four requests decode on its served model, through the served
   engine (graphs, device sampling, lookahead) and through a
   host-sampling engine on the same params; a few decode steps are timed
   by the host clock, then a few more are traced with ``torch.profiler``
   to split the device time by kernel and give the device's idle share
   (the fused decode's two launches as two families, the sampler graph's
   argmax as its own).  The two sampler graphs (the argmax every served
   cell takes, and the full temperature / top-k / top-p sampler) are
   timed alone at (4, 151552).  The same for ResNet-20 QAT train steps, with the runtime
   calls per step that can block the host (stream and device syncs,
   memcpys).

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
# dense f32 operations per second outside the tensor cores (data sheets)
F32_PEAKS = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H100": 67e12, "H200": 67e12}
FQ_BITS = (1, 2, 3, 4, 5, 6, 7, 8, 16, 32)
FQ_EXTRA = [("glm4-9b wg", (4096, 13696)), ("ragged", (7, 300))]
FQ_OPS = 7                 # f32 operations per element: div, 2 compares, mul, rint, div, mul
QAT_BITS = (2, 3, 4, 5, 6, 8, 32)   # the mixed policy of phases 4e and 5e, layer i at i % 7
LENET_FP_ACC_MIN = 0.80    # the port on the CPU reaches 0.873 at the same 300 steps
RESNET20_PRETRAIN = 600      # the port on the CPU leaves chance level at 350-450 steps
RESNET20_FP_ACC_MIN = 0.90   # ... and reaches 1.0000 at 500 and 600 steps (PERF.md)
RESNET20_EPISODES = 110      # about 30 s of search on the card


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
    flushed (a 256 MB memset) before every launch.
    The start event is enqueued behind a device-side spin
    (``torch.cuda._sleep``) that outlasts the host's work from there to
    the launch itself (the wrapper's Python checks), so the timed window
    holds the launch and not the host: the spin is measured with two more
    events, and a sample whose host enqueue took longer than its spin is
    dropped and retaken with a spin twice as long (up to ~16 ms; a
    function that waits on the device itself is then timed as it is, and
    counted in ``uncovered``)."""

    CYCLES = 2_000_000          # ~1 ms at the H100's SM clock
    MAX_CYCLES = 32_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
        self.retaken = 0
        self.uncovered = 0

    def __call__(self, fn, iters: int = 15, warmup: int = 2) -> float:
        torch = self.torch
        times = []
        cycles = self.CYCLES
        while len(times) < iters + warmup:
            self.flush.zero_()
            spin0 = torch.cuda.Event(enable_timing=True)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            spin0.record()
            torch.cuda._sleep(cycles)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if host_ms >= spin0.elapsed_time(start):
                if cycles < self.MAX_CYCLES:
                    cycles *= 2
                    self.retaken += 1
                    continue
                self.uncovered += 1      # fn waits on the device itself
            times.append(start.elapsed_time(end))
        return statistics.median(times[warmup:])


def tensor_core_count(build):
    """HGMMA instructions in the qmm library, the one with a tensor-core
    body, from ``cuobjdump -sass`` (None where the tool is missing)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("  cuobjdump not found: HGMMA count not measured")
        return None
    sass = subprocess.run([tool, "-sass", str(build.library_path("qmm"))], capture_output=True,
                          text=True, timeout=300).stdout
    count = sum("HGMMA" in line for line in sass.splitlines())
    print(f"  HGMMA instructions in libqmm (cuobjdump -sass): {count}")
    return count


def bound_ms(nbytes: float, flops: float, peaks) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / peaks[0], flops / peaks[1]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def check_qmm(torch, timer, peaks, rows):
    from repro_torch.kernels.qmm import bitserial_plan, dequant_plan, qmm_cuda
    from repro_torch.kernels.ref import dequant_ref, qmm_ref
    from repro_torch.quant.pack import pack_weight

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for name, K, N, bits, _ in GLM4_QMM + EXTRA_BITS:
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        planes, scale = pack_weight(w, bits)
        dense = dequant_ref(planes, scale, bits).to(torch.bfloat16)  # yardstick
        del w
        for path, Ms in (("bitserial", (1, 4, 16, 32)), ("dequant", (64, 256))):
            for M in Ms:
                x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                got = qmm_cuda(x, planes, scale, bits, path)
                again = qmm_cuda(x, planes, scale, bits, path)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail(f"qmm_{path} {name} M={M}: two calls differ")
                plain = qmm_ref(x, planes, scale, bits)
                err = (got - plain).abs().max().item()
                ref_max = plain.abs().max().item()
                if not math.isfinite(err) or err > TOL * ref_max:
                    fail(f"qmm_{path} {name} M={M}: max|kernel-plain| {err:.3g} "
                         f"> {TOL} * {ref_max:.3g}")
                worst = max(worst, err)
                nbytes = M * K * 2 + planes.numel() + N * 4 + M * N * 4
                b_ms, b_by = bound_ms(nbytes, 2.0 * M * K * N, peaks)
                plan = (dequant_plan if path == "dequant" else bitserial_plan)(M, K, N, bits)
                row = {"kernel": f"qmm_{path}", "shape": name, "M": M, "K": K,
                       "N": N, "bits": bits, "max_abs_err": err,
                       "plan": plan._asdict(),
                       "rel_err": err / ref_max,
                       "ms": timer(lambda: qmm_cuda(x, planes, scale, bits, path)),
                       "plain_ms": timer(lambda: qmm_ref(x, planes, scale, bits), iters=5),
                       "library_ms": timer(lambda: torch.matmul(x, dense)),
                       "bound_ms": b_ms, "bound_by": b_by}
                rows.append(row)
                print(f"  qmm_{path:9s} {name:8s} M={M:3d} K={K:5d} N={N:6d} "
                      f"b={bits} err={err:.2e} (rel {row['rel_err']:.1e}) "
                      f"kernel={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                      f"matmul={row['library_ms']:.4f} bound={b_ms:.4f} ms"
                      + (f" [{plan.ctas} CTAs of {plan.kgroups} warpgroups, "
                         f"{plan.splits} K splits, bitwise on 2 calls]" if path == "dequant"
                         else f" [{plan.ctas} CTAs of {plan.warps} warps, {plan.splits} K "
                              f"splits, bitwise on 2 calls]"))
                del got, again, plain
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
    from repro_torch.kernels.paged_attention import paged_attention_cuda, split_plan
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
        again = paged_attention_cuda(q4, kp, vp, bt, ln).reshape(B, 1, H, hd)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"paged_attention {label}: two calls differ")
        pps, splits = split_plan(nb)
        if label == "main" and splits <= 1:
            fail(f"paged_attention {label}: {B * KV * splits} CTAs, not more than B * KV")
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
               "pages_per_split": pps, "splits": splits, "ctas": B * KV * splits,
               "rel_err": err / ref_max,
               "ms": timer(lambda: paged_attention_cuda(q4, kp, vp, bt, ln)),
               "plain_ms": timer(lambda: paged_attention_ref(q, kp, vp, bt, ln)),
               "library_ms": timer(library), "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        print(f"  paged_attention {label:6s} lengths={lengths} err={err:.2e} "
              f"(rel {row['rel_err']:.1e}) kernel={row['ms']:.4f} "
              f"plain={row['plain_ms']:.4f} sdpa={row['library_ms']:.4f} "
              f"bound={b_ms:.4f} ms [{B * KV * splits} CTAs: {splits} splits of {pps} "
              f"page(s), bitwise on 2 calls]")
    return worst


def check_paged_attention_quant(torch, timer, peaks, rows):
    from repro_torch.kernels.paged_attention import split_plan
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
            again = paged_attention_quant_cuda(q4, kc, vc, ks, vs, bt, ln).reshape(B, 1, H, hd)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"paged_attention_quant {container} {label}: two calls differ")
            pps, splits = split_plan(nb)
            if label == "main" and splits <= 1:
                fail(f"paged_attention_quant {container} {label}: {B * KV * splits} CTAs, "
                     f"not more than B * KV")
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
                   "max_abs_err": err, "rel_err": err / ref_max, "pages_per_split": pps,
                   "splits": splits, "ctas": B * KV * splits,
                   "ms": timer(lambda: paged_attention_quant_cuda(q4, kc, vc, ks, vs, bt, ln)),
                   "plain_ms": timer(lambda: quant_paged_attention_ref(q, kc, vc, ks, vs, bt, ln)),
                   "library_ms": timer(library), "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            print(f"  paged_attention_quant {container} {label:6s} err={err:.2e} "
                  f"(rel {row['rel_err']:.1e}) kernel={row['ms']:.4f} "
                  f"plain={row['plain_ms']:.4f} sdpa={row['library_ms']:.4f} "
                  f"bound={b_ms:.4f} ms [{B * KV * splits} CTAs: {splits} splits of {pps} "
                  f"page(s), bitwise on 2 calls]")
    return worst


def check_fused_decode(torch, timer, peaks, rows):
    from repro_torch.kernels.fused_decode import (attend_plan, fused_attend_cuda,
                                                  fused_project_cuda,
                                                  fused_qkv_paged_decode_cuda, project_plan)
    from repro_torch.kernels.ref import (dequant_ref, finish_projection,
                                         fused_decode_attend_ref, fused_qkv_paged_decode_ref,
                                         gather_dequant, qmm_ref)
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
            again = fused_qkv_paged_decode_cuda(x, *ws, *args, H)
            torch.cuda.synchronize()
            what = f"fused_qkv_paged_decode {container} {label}"
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{what}: two calls differ in out, codes or scales")
            pps, splits = attend_plan(nb)
            pplan = project_plan(B, D, [w.scale.numel() for w in ws])
            if label == "main" and splits <= 1:     # page splits, besides the new token's CTA
                fail(f"{what}: {B * KV * (splits + 1)} attend CTAs over {splits} page split")
            plain = fused_qkv_paged_decode_ref(x, *ws, *args, H, KV)
            out, po = got[0].reshape(B, 1, H, hd), plain[0].float()
            err = (out - po).abs().max().item()
            ref_max = po.abs().max().item()
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
            # the whole op sums (A)'s split partials in (B)'s prologue: the
            # two launches run apart, the partials finished by the plain
            # twin in between, must give the same out, codes and scales
            staged = fused_attend_cuda(finish_projection(fused_project_cuda(x, *ws, H, KV), *ws),
                                       torch.bfloat16, *args, H)
            torch.cuda.synchronize()
            if not all(torch.equal(g, p) for g, p in zip(got, staged)):
                fail(f"{what}: the whole op differs from its two launches run apart "
                     f"({pplan.splits} K splits)")
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

            # each launch alone: (A) the split-K projection, (B) the attend
            # launch on finished projections; their bounds split the bytes.
            # (A)'s bound writes the finished (B, ntot) projections once:
            # its split workspace is the design's cost, not the function's
            p_bytes = x.numel() * 2 + w_bytes + B * dense.shape[1] * 4
            pb_ms, _ = bound_ms(p_bytes, 2.0 * B * D * dense.shape[1], peaks)
            ab_ms, _ = bound_ms(nbytes - x.numel() * 2 - w_bytes + proj.numel() * 4,
                                4.0 * (live + B) * H * hd, peaks)
            alone = {"project_ms": timer(lambda: fused_project_cuda(x, *ws, H, KV)),
                     "project_library_ms": timer(lambda: torch.matmul(x, dense)),
                     "project_bound_ms": pb_ms,
                     "attend_ms": timer(lambda: fused_attend_cuda(proj, torch.bfloat16, *args,
                                                                  H)),
                     "attend_library_ms": timer(attn), "attend_bound_ms": ab_ms}

            row = {"kernel": "fused_qkv_paged_decode", "shape": label, "container": container,
                   "lengths": lengths, "B": B, "D": D, "KV": KV, "G": G, "hd": hd, "bs": bs,
                   "bits": [w.bits for w in ws], "max_abs_err": err, "rel_err": err / ref_max,
                   "codes_differing": n_diff, "codes": n_codes, "attend_alone_err": err_b,
                   "project_plan": pplan._asdict(), "project_ctas": pplan.ctas,
                   "pages_per_split": pps, "splits": splits, "attend_ctas": B * KV * (splits + 1),
                   **alone,
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
                  f"bound={b_ms:.4f} ms; bitwise on 2 calls and with its launches apart")
            print(f"    (A) projection alone {row['project_ms']:.4f} ms (matmul "
                  f"{row['project_library_ms']:.4f}, bound {pb_ms:.4f}) [{pplan.ctas} CTAs: "
                  f"{pplan.splits} K splits]; (B) attend alone {row['attend_ms']:.4f} ms (sdpa "
                  f"{row['attend_library_ms']:.4f}, bound {ab_ms:.4f}) [{B * KV * (splits + 1)} "
                  f"CTAs: {splits} splits of {pps} page(s) + the new token]")
    return worst


def weight_shapes(net: str):
    """(layer, shape) of every quantized weight of ``net``, in the port's
    layout (OIHW convs, (n_in, n_out) fc)."""
    from repro_torch.cnn.models import build_cnn

    params = build_cnn(net).init(0, device="cpu")
    return [(name, tuple(p["w"].shape)) for name, p in params.items()]


def check_fake_quant(torch, timer, peaks, rows):
    """The fake-quant kernel against its plain version, bitwise, at every
    ResNet-20 and LeNet weight shape, glm4-9b's wg and a ragged shape,
    bits 1-8, 16 and 32, f32 and bf16; the STE's forward and gradient
    mask against the plain ones.  Times at bits 4."""
    from repro_torch.kernels.fake_quant import fake_quant_cuda
    from repro_torch.kernels.ref import fake_quant_ref
    from repro_torch.quant.wrpn import _levels, fake_quant_ste, tensor_scale

    f32_peak = next((v for k, v in F32_PEAKS.items() if k in torch.cuda.get_device_name(0)),
                    F32_PEAKS["H100"])
    resnet = weight_shapes("resnet20")
    calls = {}
    for _, shape in resnet:
        calls[shape] = calls.get(shape, 0) + 1
    shapes = [("resnet20", shape) for shape in calls]
    shapes += [("lenet", shape) for _, shape in weight_shapes("lenet")] + FQ_EXTRA
    bits_vec = torch.tensor(FQ_BITS, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    for label, shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            w = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            scale = tensor_scale(w)
            what = f"fake_quant {label} {shape} {str(dtype)[6:]}"
            for i, bits in enumerate(FQ_BITS):
                got = fake_quant_cuda(w, bits_vec[i], scale)
                torch.cuda.synchronize()
                plain = fake_quant_ref(w, bits_vec[i], scale)
                err = (got.float() - plain.float()).abs().max().item()
                if not torch.equal(got, plain):
                    fail(f"{what} bits={bits}: kernel != plain (max diff {err:.3g})")
                worst = max(worst, err)
            if label != "glm4-9b wg":     # the STE: kernel forward, plain backward
                cot = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for bits in (2, 4, 32):
                    leaf = w.clone().requires_grad_(True)
                    out = fake_quant_ste(leaf, torch.tensor(bits, dtype=torch.int32,
                                                            device="cuda"))
                    (g,) = torch.autograd.grad(out, leaf, cot)
                    mask = (w.abs().float() <= scale).to(dtype)
                    if not (torch.equal(out, fake_quant_ref(w, bits, scale))
                            and torch.equal(g, cot * mask)):
                        fail(f"{what}: the STE's forward or gradient mask differs "
                             f"from the plain version at bits={bits}")
            b4 = bits_vec[3]
            n = float(_levels(b4))
            lib_scale = float(scale) / n
            esize = w.element_size()
            b_ms, b_by = bound_ms(2 * w.numel() * esize + 8, FQ_OPS * w.numel(),
                                  (peaks[0], f32_peak))
            row = {"kernel": "fake_quant", "shape": label, "dims": list(shape),
                   "dtype": str(dtype)[6:], "calls_per_forward":
                   calls.get(shape, 0) if label == "resnet20" and dtype == torch.float32 else 0,
                   "bits_checked": list(FQ_BITS), "max_abs_err": 0.0,
                   "ms": timer(lambda: fake_quant_cuda(w, b4, scale)),
                   "plain_ms": timer(lambda: fake_quant_ref(w, b4, scale), iters=5),
                   "library_ms": timer(lambda: torch.fake_quantize_per_tensor_affine(
                       w, lib_scale, 0, -int(n), int(n))),
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            print(f"  {what:42s} bitwise at bits {FQ_BITS[0]}..{FQ_BITS[-1]} "
                  f"kernel={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                  f"fake_quantize_per_tensor_affine={row['library_ms']:.4f} "
                  f"bound={b_ms:.6f} ms")
            del w
    return worst


def same_bits(torch, a, b) -> bool:
    """Equal dtype, shape and bit patterns (the sign of zero and NaN held)."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def fq_group_inputs(torch, net, dtype, gen, extra=()):
    """The quantized weights of ``net`` in the QAT order, then ``extra``
    shapes; a -0.0 and a 0.0 in each; gradients with +-inf, NaN and a
    negative value in each."""
    ws, gs = [], []
    for shape in [shape for _, shape in weight_shapes(net)] + list(extra):
        w = torch.randn(shape, generator=gen, device="cuda")
        w.view(-1)[:2] = torch.tensor([-0.0, 0.0], device="cuda")
        g = torch.randn(shape, generator=gen, device="cuda")
        g.view(-1)[:4] = torch.tensor([float("inf"), float("nan"), -3.0, float("-inf")],
                                      device="cuda")
        ws.append(w.to(dtype))
        gs.append(g.to(dtype))
    return ws, gs


def fq_edge_tensors(torch, dtype):
    """An all-zero tensor (the eps floor), one holding a NaN, and one whose
    max sits where the floor's dtype decides the scale (f32 just above
    1e-8, bf16 just below it)."""
    near = 1.0005e-8 if dtype == torch.float32 else 9.95e-9
    nan = torch.randn((33, 7), generator=torch.Generator().manual_seed(4))
    nan[3, 2] = float("nan")
    ws = [torch.zeros((5, 9)), nan, torch.linspace(-1, 1, 301) * near]
    return ([w.to("cuda", dtype) for w in ws],
            [torch.linspace(-2, 2, w.numel()).reshape(w.shape).to("cuda", dtype) for w in ws])


def check_fake_quant_group(torch, timer, peaks, rows):
    """The grouped forward and STE backward against their plain versions,
    bit pattern for bit pattern: the LeNet and ResNet-20 groups (plus the
    edge tensors) in f32 and bf16 at bits vectors cycling through 1-8, 16
    and 32 from three offsets, and a ResNet-20 group holding glm4-9b's wg
    (read twice).  Times per QAT forward and backward (the ResNet-20 and
    LeNet groups at the mixed policy QAT_BITS) against the same work by
    the library (20 x ``abs().amax()`` + ``fake_quantize_per_tensor_affine``),
    the parent's flat path (20 x ``tensor_scale`` + the flat kernel), the
    flat kernel alone at given scales, the plain versions and the bound."""
    from repro_torch.kernels.fake_quant import (fake_quant_cuda, fake_quant_group_bwd_cuda,
                                                fake_quant_group_cuda, fake_quant_group_plan)
    from repro_torch.kernels.ref import fake_quant_group_bwd_ref, fake_quant_group_ref
    from repro_torch.quant.wrpn import _levels, tensor_scale

    f32_peak = next((v for k, v in F32_PEAKS.items() if k in torch.cuda.get_device_name(0)),
                    F32_PEAKS["H100"])
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(net, dtype, ()) for net in ("lenet", "resnet20")
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [("resnet20+wg", dtype, [FQ_EXTRA[0][1]]) for dtype in (torch.float32, torch.bfloat16)]
    for net, dtype, extra in cases:
        ws, gs = fq_group_inputs(torch, net.split("+")[0], dtype, gen, extra)
        if not extra:
            ew, eg = fq_edge_tensors(torch, dtype)
            ws, gs = ws + ew, gs + eg
        plan = fake_quant_group_plan([w.numel() for w in ws], dtype)
        what = f"fake_quant_group {net} {str(dtype)[6:]} ({len(ws)} tensors)"
        for offset in range(3 if not extra else 1):
            bits = torch.tensor([FQ_BITS[(i + offset) % len(FQ_BITS)]
                                 for i in range(len(ws))], dtype=torch.int32, device="cuda")
            outs, scales, _ = fake_quant_group_cuda(ws, bits)
            grads, _ = fake_quant_group_bwd_cuda(ws, gs, scales)
            torch.cuda.synchronize()
            want, want_s = fake_quant_group_ref(ws, bits)
            if not same_bits(torch, scales, want_s):
                fail(f"{what}: the scales differ from tensor_scale's")
            for i, (o, p) in enumerate(zip(outs, want)):
                if not same_bits(torch, o, p):
                    fail(f"{what}: tensor {i} {tuple(ws[i].shape)} at bits {int(bits[i])} "
                         f"differs from the plain version")
            for i, (g, p) in enumerate(zip(grads, fake_quant_group_bwd_ref(ws, gs, want_s))):
                if not same_bits(torch, g, p):
                    fail(f"{what}: the STE gradient of tensor {i} differs from the plain one")
            del outs, grads, want
        print(f"  {what:46s} forward and backward bitwise at 3 bits offsets"
              if not extra else
              f"  {what:46s} forward and backward bitwise; tensors read twice: "
              f"{list(plan.second_read)}")
        if extra:
            del ws, gs
            torch.cuda.empty_cache()
            continue
        ws, gs = ws[:-3], gs[:-3]          # the net's weights alone: one QAT forward
        bits = torch.tensor([QAT_BITS[i % len(QAT_BITS)] for i in range(len(ws))],
                            dtype=torch.int32, device="cuda")
        plan = fake_quant_group_plan([w.numel() for w in ws], dtype)
        outs, scales, _ = fake_quant_group_cuda(ws, bits)
        numel = sum(w.numel() for w in ws)
        esize = ws[0].element_size()
        n4 = int(_levels(torch.tensor(4)))
        zp = torch.zeros((), dtype=torch.int32, device="cuda")
        given = [tensor_scale(w) for w in ws]

        def library():
            for w in ws:
                torch.fake_quantize_per_tensor_affine(w, w.abs().amax().float() / n4, zp,
                                                       -n4, n4)

        def flat_path():
            for i, w in enumerate(ws):
                fake_quant_cuda(w, bits[i], tensor_scale(w))

        def flat_given():
            for i, w in enumerate(ws):
                fake_quant_cuda(w, bits[i], given[i])

        b_ms, b_by = bound_ms(2 * numel * esize + 8 * len(ws), (FQ_OPS + 2) * numel,
                              (peaks[0], f32_peak))
        fwd = {"kernel": "fake_quant_group", "shape": net, "dtype": str(dtype)[6:],
               "tensors": len(ws), "numel": numel, "plan": plan._asdict(),
               "calls_per_forward": 1 if net == "resnet20" and dtype == torch.float32 else 0,
               "max_abs_err": 0.0,
               "ms": timer(lambda: fake_quant_group_cuda(ws, bits)),
               "plain_ms": timer(lambda: fake_quant_group_ref(ws, bits), iters=5),
               "library_ms": timer(library),
               "library": "sum over the layers: abs().amax() + fake_quantize_per_tensor_affine "
                          "(tensor scale, bits 4)",
               "flat_path_ms": timer(flat_path), "flat_given_scale_ms": timer(flat_given),
               "bound_ms": b_ms, "bound_by": b_by}
        bb_ms, bb_by = bound_ms(3 * numel * esize + 4 * len(ws), 3 * numel, (peaks[0], f32_peak))
        bwd = {"kernel": "fake_quant_group_bwd", "shape": net, "dtype": str(dtype)[6:],
               "tensors": len(ws), "numel": numel, "bwd_ctas": plan.bwd_ctas,
               "calls_per_forward": fwd["calls_per_forward"], "max_abs_err": 0.0,
               "ms": timer(lambda: fake_quant_group_bwd_cuda(ws, gs, scales)),
               "plain_ms": timer(lambda: fake_quant_group_bwd_ref(ws, gs, scales)),
               "library_ms": None, "bound_ms": bb_ms, "bound_by": bb_by}
        rows += [fwd, bwd]
        label = f"fake_quant_group {net} {str(dtype)[6:]} ({len(ws)} layers)"
        print(f"  {label:46s} per QAT forward: group={fwd['ms']:.4f} "
              f"[{plan.ctas[0]} CTAs in clusters of {plan.cluster}] flat path (scale + "
              f"kernel)={fwd['flat_path_ms']:.4f} flat at given scales="
              f"{fwd['flat_given_scale_ms']:.4f} library (amax + fake_quantize)="
              f"{fwd['library_ms']:.4f} plain={fwd['plain_ms']:.4f} bound={b_ms:.6f} ms")
        print(f"  {'':46s} per QAT backward: group={bwd['ms']:.4f} [{plan.bwd_ctas[0]} CTAs] "
              f"plain (abs, <=, to, mul per layer)={bwd['plain_ms']:.4f} bound={bb_ms:.6f} ms")
        del ws, gs, outs
    return 0.0


def releq_quickstart(torch):
    """Phase 3d: the quickstart twin on LeNet at the reference
    quickstart's steps, on the card, with its own zeroed counters."""
    from repro_torch.kernels import ops
    from repro_torch.launch import quickstart

    ops.reset_counts()
    t0 = time.perf_counter()
    out = quickstart.main(["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.counts)
    check_qat_counts("lenet quickstart", counts)
    if not out["fp_acc"] >= LENET_FP_ACC_MIN:
        fail(f"[lenet quickstart] fp accuracy {out['fp_acc']:.4f} < {LENET_FP_ACC_MIN}")
    check_search_record("lenet quickstart", out["task"], out["result"], 30, out["rel_acc"])
    print(f"[lenet quickstart] wall {wall:.2f} s ({out['wall']}), launch counts {counts}")
    return {"fp_acc": out["fp_acc"], "best_bits": out["bits"], "avg_bits": out["avg_bits"],
            "rel_acc": out["rel_acc"], "stripes_speedup": out["stripes_speedup"],
            "tvm_cpu_speedup": out["tvm_cpu_speedup"],
            "energy_reduction": out["energy_reduction"], "wall_s": out["wall"],
            "total_s": wall, "counts": counts}


def check_qat_counts(label, counts):
    """Every QAT forward and backward went through the grouped kernels:
    no flat fake-quant launch, no plain call."""
    if (counts["fake_quant_group"] <= 0 or counts["fake_quant_group_bwd"] <= 0
            or counts["fake_quant"] != 0 or counts["plain"] != 0):
        fail(f"[{label}] grouped fake-quant launches / flat launches / plain calls: {counts}")


def check_search_record(label, task, res, episodes, rel_acc):
    """The search record is whole and consistent, and the long retrain's
    relative accuracy is a finite positive number."""
    if len(res.episodes) != episodes or set(res.best_bits) != set(task.names):
        fail(f"[{label}] search record has {len(res.episodes)} episodes, "
             f"best bits {res.best_bits}")
    if res.best_reward != max(e["reward"] for e in res.episodes):
        fail(f"[{label}] best reward is not the best episode's")
    for name, b in task.frozen.items():
        if res.best_bits[name] != b:
            fail(f"[{label}] frozen layer {name} left {b} bits")
    if not (math.isfinite(rel_acc) and rel_acc > 0):
        fail(f"[{label}] relative accuracy after the long retrain is {rel_acc}")


def timed(fn, spent: dict, key: str):
    """``fn`` adding its wall time (to the device's end) to ``spent[key]``."""
    import torch

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        spent[key] += time.perf_counter() - t0
        return out

    return wrapper


def releq_resnet20(torch):
    """Phase 3e: the ReLeQ search at ResNet-20's full width on the card:
    pretrain, search (episode_end, 2 retrain steps), long retrain."""
    import numpy as np

    from repro_torch.cnn import CNNTask
    from repro_torch.core import costmodel as cm
    from repro_torch.core.search import ReLeQSearch
    from repro_torch.kernels import ops

    ops.reset_counts()
    wall = {}
    t0 = time.perf_counter()
    task = CNNTask("resnet20", seed=0, device="cuda")
    n_w = sum(g.n_weights for g in task.groups)
    if len(task.groups) != 20 or n_w != 268_336:
        fail(f"resnet20 has {len(task.groups)} quantized layers and {n_w} weights, "
             f"not 20 and 268,336")
    fp_acc = task.pretrain(RESNET20_PRETRAIN)
    torch.cuda.synchronize()
    wall["pretrain_s"] = time.perf_counter() - t0
    if not fp_acc >= RESNET20_FP_ACC_MIN:
        fail(f"[resnet20] fp accuracy {fp_acc:.4f} < {RESNET20_FP_ACC_MIN}")
    t0 = time.perf_counter()
    factory = task.make_env_factory(retrain_steps=2, eval_mode="episode_end")
    search = ReLeQSearch(factory, seed=0, device="cuda")
    spent = {"short_retrain_s": 0.0, "ppo_update_s": 0.0}
    task.evaluate_bits = timed(task.evaluate_bits, spent, "short_retrain_s")
    search.ppo.update = timed(search.ppo.update, spent, "ppo_update_s")
    res = search.run(RESNET20_EPISODES)
    torch.cuda.synchronize()
    wall["search_s"] = time.perf_counter() - t0
    wall.update(spent)
    wall["acting_and_env_s"] = wall["search_s"] - sum(spent.values())
    bits = res.best_bits
    t0 = time.perf_counter()
    rel = task.long_retrain(bits, steps=200)
    torch.cuda.synchronize()
    wall["long_retrain_s"] = time.perf_counter() - t0
    counts = dict(ops.counts)
    check_qat_counts("resnet20", counts)
    check_search_record("resnet20", task, res, RESNET20_EPISODES, rel)
    vec = [bits[n] for n in task.names]
    out = {"fp_acc": fp_acc, "best_bits": bits, "best_reward": res.best_reward,
           "avg_bits": float(np.mean(vec)),
           "avg_bits_searched": res.average_bits([n for n in task.names
                                                  if n not in task.frozen]),
           "rel_acc": rel,
           "stripes_speedup": cm.speedup_vs_8bit(cm.stripes_time, vec, task.groups),
           "tvm_cpu_speedup": cm.speedup_vs_8bit(cm.tvm_cpu_time, vec, task.groups),
           "energy_reduction": cm.energy_reduction_vs_8bit(vec, task.groups),
           "episodes": RESNET20_EPISODES, "cache": res.cache_stats, "wall_s": wall,
           "pretrain_steps_per_s": RESNET20_PRETRAIN / wall["pretrain_s"],
           "long_retrain_steps_per_s": 200 / wall["long_retrain_s"],
           "episodes_per_s": RESNET20_EPISODES / wall["search_s"], "counts": counts}
    print(f"[resnet20] fp accuracy {fp_acc:.4f} (floor {RESNET20_FP_ACC_MIN}); "
          f"best bits {vec}; avg bits {out['avg_bits']:.2f} "
          f"({out['avg_bits_searched']:.2f} over the 18 searched layers); "
          f"relative accuracy after the long retrain {rel:.4f}")
    print(f"[resnet20] Stripes speedup {out['stripes_speedup']:.2f}x, TVM-CPU speedup "
          f"{out['tvm_cpu_speedup']:.2f}x, Stripes energy reduction "
          f"{out['energy_reduction']:.2f}x vs 8-bit")
    print(f"[resnet20] wall: pretrain {wall['pretrain_s']:.2f} s "
          f"({out['pretrain_steps_per_s']:.1f} train steps/s), search "
          f"{wall['search_s']:.2f} s ({out['episodes_per_s']:.2f} episodes/s: short retrains "
          f"{wall['short_retrain_s']:.2f} s, PPO updates {wall['ppo_update_s']:.2f} s, "
          f"acting and env {wall['acting_and_env_s']:.2f} s; cache {res.cache_stats}), "
          f"long retrain {wall['long_retrain_s']:.2f} s "
          f"({out['long_retrain_steps_per_s']:.1f} steps/s); launch counts {counts}")
    return task, out


def resnet_step_card_vs_cpu(torch, task):
    """Phase 4: one ResNet-20 QAT train step at a fixed mixed policy from
    the same (pretrained) params, on the card (kernel) and on the CPU
    (plain version): params within 1e-4 * max|param|, equal accuracies."""
    from repro_torch.cnn import CNNTask

    bits = {n: QAT_BITS[i % len(QAT_BITS)] for i, n in enumerate(task.names)}
    cpu = CNNTask("resnet20", seed=0, device="cpu")
    cpu.params = {n: {k: t.cpu() for k, t in p.items()} for n, p in task.params.items()}
    cpu.mom = cpu._zeros_like(cpu.params)
    card = CNNTask("resnet20", seed=0, device="cuda")
    card.params, card.mom = task.params, card._zeros_like(task.params)
    pg, _ = card.train(1, bits)
    pc, _ = cpu.train(1, bits)
    top = max(t.abs().max().item() for p in pc.values() for t in p.values())
    err = max((pg[n][k].cpu() - pc[n][k]).abs().max().item() for n in pc for k in pc[n])
    if not err <= 1e-4 * top:
        fail(f"resnet20 train step: card vs CPU params differ by {err:.3g} > 1e-4 * {top:.3g}")
    acc_g, acc_c = card.accuracy(pg, bits), cpu.accuracy(pc, bits)
    if acc_g != acc_c:
        fail(f"resnet20 train step: card accuracy {acc_g} != CPU accuracy {acc_c}")
    print(f"resnet20 QAT step (bits {list(bits.values())}): card vs CPU params max diff "
          f"{err:.3e} ({err / top:.2e} of max|param|); accuracy {acc_g:.4f} on both")
    return {"max_abs_err": err, "rel_err": err / top, "accuracy": acc_g}


def profile_qat_step(torch, task, timed=5, traced=3):
    """Phase 5: ResNet-20 QAT train steps at a mixed policy: host-clock
    step time, then a torch.profiler trace for device time by family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bits = {n: QAT_BITS[i % len(QAT_BITS)] for i, n in enumerate(task.names)}
    t0 = time.perf_counter()
    for i in range(timed):                            # the numpy batch synthesis alone
        task.data.batch(task.batch, 1_000_000 + i, "train")
    batch_ms = (time.perf_counter() - t0) / timed * 1e3
    params, mom = task.train(2, bits)                 # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, mom = task.train(timed, bits, params, mom)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        task.train(traced, bits, params, mom)
        torch.cuda.synchronize()
    fams: dict[str, float] = {}
    launches: dict[str, float] = {}
    host = {"cudaStreamSynchronize": 0.0, "cudaDeviceSynchronize": 0.0, "cudaMemcpyAsync": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA and ev.key in host:
            host[ev.key] += ev.count / traced       # the runtime calls that can block the host
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        name = ev.key
        fam = ("fake_quant" if "fake_quant" in name
               else "memcpy/memset" if "emcpy" in name or "emset" in name
               else "convolution" if any(k in name.lower() for k in (
                   "conv", "xmma", "cudnn", "implicit_gemm", "wgrad", "dgrad", "fprop",
                   "nchwtonhwc", "nhwctonchw"))
               else "other torch kernels")
        fams[fam] = fams.get(fam, 0.0) + ev.self_device_time_total / traced / 1e3
        launches[fam] = launches.get(fam, 0) + ev.count / traced
    busy = sum(fams.values())
    if busy <= 0:
        print("  QAT step: the profiler saw no device time (not measured)")
        return {"step_ms": step_ms, "batch_synthesis_ms": batch_ms, "device_ms": None}
    print(f"  resnet20 QAT step (batch {task.batch}, host clock, untraced) = {step_ms:.2f} ms, "
          f"of which {batch_ms:.2f} ms synthesize the numpy batch; device busy "
          f"{busy:.3f} ms/step -> idle share {1 - busy / step_ms:.3f}")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"    {fam:22s} {ms:8.3f} ms/step {launches[fam]:6.1f} launches/step")
    print("    host runtime calls per step: " + ", ".join(f"{k} {v:.1f}" for k, v in host.items())
          + " (the trace's last cudaDeviceSynchronize is the harness's)")
    return {"step_ms": step_ms, "batch_synthesis_ms": batch_ms, "device_ms": busy,
            "families_ms": fams, "launches_per_step": launches,
            "host_calls_per_step": host, "idle_share": 1 - busy / step_ms}


def per_step(rows, kernel, pick, extra=()):
    """Sum the per-shape numbers (and the ``extra`` keys) over one
    main-path step: ``pick(row) -> calls`` of that shape per step."""
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    out.update({key: 0.0 for key in extra})
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
    pl, captures = m["pipeline"], engine.graph_captures
    print(f"[{label}] sampler={'device' if m['sampler']['device'] else 'host'} "
          f"fallbacks={m['sampler']['fallbacks']} pipeline={'on' if pl['enabled'] else 'off'} "
          f"lookahead_steps={pl['lookahead_steps']} bubbles={pl['bubbles']} "
          f"recompiles={m['recompiles']} graph captures={captures} (host s, shared "
          f"samplers since the process began: "
          f"{ {k: round(v, 4) for k, v in engine.graph_capture_seconds.items()} })")
    if m["recompiles"] != 0 or captures["decode"] != 1:
        fail(f"[{label}] the decode step was captured {captures['decode']} times "
             f"({m['recompiles']} re-captures): want one capture")
    if not args.host_sampling:
        if pl["lookahead_steps"] <= 0:
            fail(f"[{label}] the pipeline never looked ahead")
        if pl["lookahead_steps"] + pl["bubbles"] != m["decode_steps"]:
            fail(f"[{label}] lookahead {pl['lookahead_steps']} + bubbles {pl['bubbles']} "
                 f"!= decode steps {m['decode_steps']}")
    print(f"[{label}] served {len(work)} requests: tokens/s={m['tokens_per_s']:.2f} "
          f"decode_step_p50={m['decode_step_p50_ms']:.3f} ms "
          f"p99={m['decode_step_p99_ms']:.3f} ms decode_steps={m['decode_steps']} "
          f"tokens={m['tokens_total']} wall={wall_s:.2f} s "
          f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ttft = sorted(r["ttft_s"] for r in m["requests"])
    print(f"[{label}] time to first token: p50 {statistics.median(ttft):.4f} s, "
          f"max {ttft[-1]:.4f} s over {len(ttft)} requests")
    print(f"[{label}] tokens per request: {[r['new_tokens'] for r in m['requests']]}")
    print(f"[{label}] launch counts on the path: {counts}")
    return {"args": args, "cfg": cfg, "model": model, "sparams": sparams,
            "policy": policy, "engine": engine, "work": work, "counts": counts,
            "metrics": m, "setup_s": setup_s, "wall_s": wall_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def check_outputs(torch, cfg, model, sparams, engine, work):
    """Full width: request 0 re-prefilled gives finite logits whose argmax
    is the emitted first token.  Small width: card vs CPU logits and served
    greedy streams, with fp, int4 and int8 KV blocks."""
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
    streams = {}
    for kv_bits in (None, 4, 8):
        small_model_card_vs_cpu(torch, sm, params, kv_bits)
        streams[f"kv_bits={kv_bits}"] = served_streams_card_vs_cpu(torch, sm, params, kv_bits)
    return streams


STREAM_GEN = 36          # greedy tokens per request: past two 16-token block edges


def served_streams_card_vs_cpu(torch, sm, params, kv_bits):
    """The small model served by the port's ServeEngine on the card
    (kernels) and on the CPU (plain versions, host sampling): 6 requests
    on 4 rows, greedy.  On the card twice: with host sampling, and with
    the defaults (captured decode step, device sampling, lookahead).  Each
    card run gives the CPU's streams, or a first divergence where the
    CPU's top-2 logit margin is within the bf16 logit bound (2e-2 *
    max|logit|)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.quant.qat import policy_for
    from repro_torch.serve import ServeEngine
    from repro_torch.train.serve import quantize_for_serving

    rng = np.random.default_rng(9)
    work = [(rng.integers(0, sm.cfg.vocab_size, int(n)), STREAM_GEN)
            for n in (9, 40, 17, 31, 24, 16)]
    host = {"sample_device": False, "pipeline": False}
    runs = {}
    for name, dev, kw in (("card, host sampling", "cuda", host),
                          ("card, device sampling + pipeline", "cuda", {}),
                          ("cpu", "cpu", host)):
        sp = quantize_for_serving(sm, params, policy_for(sm, 4), device=dev)
        eng = ServeEngine(sm, sp, num_slots=4, max_len=40 + STREAM_GEN + 1, block_size=16,
                          prefill_chunk=16, device=dev, kv_bits=kv_bits, **kw)
        margins = {}
        for prompt, n in work:
            req = eng.requests[eng.submit(prompt, n)]
            margins[req.request_id] = store = []

            def select(row, _orig=req.select_token, _store=store):
                top = np.sort(np.asarray(row, np.float64))[-2:]
                _store.append((float(top[1] - top[0]), float(np.abs(row).max())))
                return _orig(row)

            req.select_token = select
        ops.reset_counts()
        eng.run_until_drained()
        if dev == "cuda":
            torch.cuda.synchronize()
            if ops.counts["plain"] != 0 or ops.counts["qmm_bitserial"] <= 0:
                fail(f"served streams (kv_bits={kv_bits}, {name}): launch counts {ops.counts}")
            m = eng.metrics()
            if m["recompiles"] != 0 or (not kw and m["pipeline"]["lookahead_steps"] <= 0):
                fail(f"served streams (kv_bits={kv_bits}, {name}): recompiles "
                     f"{m['recompiles']}, pipeline {m['pipeline']}")
        runs[name] = ([eng.output(r) for r in range(len(work))], margins)
    kv = f"kv_bits={kv_bits}" if kv_bits else "fp KV"
    out = {"requests": len(work), "tokens_per_request": STREAM_GEN}
    for name in ("card, host sampling", "card, device sampling + pipeline"):
        diverged = out[name] = []
        for rid in range(len(work)):
            got, want = runs[name][0][rid], runs["cpu"][0][rid]
            if len(got) != STREAM_GEN or len(want) != STREAM_GEN:
                fail(f"served streams ({kv}, {name}): request {rid} emitted {len(got)} / "
                     f"{len(want)} tokens")
            if got == want:
                continue
            i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            margin, top = runs["cpu"][1][rid][i]
            print(f"  served streams ({kv}, {name}): request {rid} first diverges at token "
                  f"{i} (card {got[i]}, cpu {want[i]}); CPU top-2 margin {margin:.4g}, "
                  f"bound 2e-2 * {top:.4g} = {2e-2 * top:.4g}")
            diverged.append({"request": rid, "token": i, "margin": margin,
                             "bound": 2e-2 * top})
            if margin > 2e-2 * top:
                fail(f"served streams ({kv}, {name}): request {rid} diverged at token {i} "
                     f"where the CPU's top-2 margin {margin:.4g} exceeds 2e-2 * max|logit| "
                     f"= {2e-2 * top:.4g}")
        print(f"served streams ({kv}, {name}): {len(work)} requests x {STREAM_GEN} greedy "
              f"tokens, card vs CPU: {len(work) - len(diverged)} equal, {len(diverged)} "
              f"diverged within the bound")
    return out


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


def host_engine(r, **kw):
    """A fresh engine on a serving path's model and params that samples on
    the host without the pipeline (``--host-sampling``); ``kw`` goes to
    ``ServeEngine``."""
    from repro_torch.serve import ServeEngine

    a = r["args"]
    kv = {}
    if a.kv_bits:
        kv["kv_bits"] = a.kv_bits[0] if len(a.kv_bits) == 1 else a.kv_bits
    return ServeEngine(r["model"], r["sparams"], num_slots=a.num_slots,
                       max_len=a.prompt_len + a.gen + 1, block_size=a.block_size,
                       prefill_chunk=a.prefill_chunk, sample_device=False, pipeline=False,
                       device="cuda", **kv, **kw)


def eager_witness(torch, r):
    """Path a's workload on its params through an engine that runs
    ``model.decode_step`` eagerly and samples on the host: the captured
    decode step's witness at full width.  The launch counters are zeroed
    just before and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import SamplingParams

    a = r["args"]
    engine = host_engine(r, decode_fn=r["model"].decode_step)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    launcher.drive(engine, r["work"], a.arrival_every, SamplingParams(temperature=a.temperature))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts, m = dict(ops.counts), engine.metrics()
    if engine.graph_captures["decode"] != 0:
        fail("[fp KV, eager] the eager decode step was captured")
    if counts["plain"] != 0 or counts["paged_attention"] <= 0:
        fail(f"[fp KV, eager] launch counts {counts}")
    print(f"[fp KV, eager] served {len(r['work'])} requests: tokens/s={m['tokens_per_s']:.2f} "
          f"decode_step_p50={m['decode_step_p50_ms']:.3f} ms decode_steps={m['decode_steps']} "
          f"tokens={m['tokens_total']} wall={wall_s:.2f} s")
    print(f"[fp KV, eager] launch counts on the path: {counts}")
    return {"engine": engine, "metrics": m, "counts": counts, "setup_s": 0.0,
            "wall_s": wall_s, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def profile_paths(torch, label, r):
    """Phase 5 for one cell: the served engine (captured decode step,
    device sampling, lookahead) and a host-sampling engine on the same
    params."""
    out = {}
    for path, engine in (("pipeline", r["engine"]), ("host sampling", host_engine(r))):
        print(f"  [{label}, {path}]")
        out[path] = profile_decode(torch, engine, r["work"])
    return out


def sampler_graph_times(torch, V, B=4, reps=20):
    """The two sampler graphs alone at (B, V): per replay, by CUDA events
    (median) and by the profiler's device time.  ``greedy`` is the bare
    argmax the engine takes when every row is greedy (every served cell);
    ``full`` the temperature / top-k / top-p sampler."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.request import Request, SamplingParams
    from repro_torch.serve.sampler import greedy_rows, row_arrays, sample_rows

    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((B, V), generator=gen, device="cuda") * 3
    arrs = row_arrays(B, [(i, Request(i, [1], 8, SamplingParams(0.9, 50, 0.9, i)))
                          for i in range(B)])
    params = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a).cuda()
              for a in arrs]
    pos = torch.arange(B, dtype=torch.int32, device="cuda")
    out = {}
    for name, fn in (("greedy", lambda: greedy_rows(logits)),
                     ("full", lambda: sample_rows(logits, *params, pos))):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.self_device_time_total > 0) / reps / 1e3
        out[name] = {"events_ms": statistics.median(times), "device_ms": dev or None}
        print(f"  sampler graph ({name}, {B} x {V}): {statistics.median(times):.4f} ms "
              f"per replay by events, device {dev:.4f} ms")
    return out


def profile_decode(torch, engine, work, timed=4, traced=4):
    """Decode-only steps on 4 running rows: host-clock step time, then a
    torch.profiler trace for device time by kernel family (the sampler
    graph's argmax as its own)."""
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
        fam = ("sampler graph" if "ArgMax" in name
               else "qmm" if "qmm_" in name else "fused_project" if "fused_project" in name
               else "fused_attend" if "fused_attend" in name
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

    def phase(title: str) -> None:
        print(f"{title} [{time.perf_counter() - t_start:.1f} s]")

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
    if tensor_core_count(build) == 0:
        fail("the qmm library has no HGMMA instruction")

    # ---- phase 2: kernels against their plain versions
    timer = Timer(torch)
    rows: list[dict] = []
    phase("phase 2: kernels against their plain versions (times in ms)")
    qmm_err = check_qmm(torch, timer, peaks, rows)
    pa_err = check_paged_attention(torch, timer, peaks, rows)
    paq_err = check_paged_attention_quant(torch, timer, peaks, rows)
    fused_err = check_fused_decode(torch, timer, peaks, rows)
    fq_err = check_fake_quant(torch, timer, peaks, rows)
    fqg_err = check_fake_quant_group(torch, timer, peaks, rows)
    print(f"timer: {timer.retaken} samples retaken behind a longer spin, "
          f"{timer.uncovered} timed with host work inside")
    del timer
    torch.cuda.empty_cache()

    # ---- phases 3-5, path a (fp KV blocks): serve, check outputs, profile
    phase("phase 3a: glm4-9b serving end to end, --bits 4, fp KV blocks")
    fp_flags, fp_host_flags = ["--bits", "4"], ["--bits", "4", "--host-sampling"]
    fp_need = ("qmm_bitserial", "qmm_dequant", "paged_attention")
    fp = serve_path(torch, "fp KV", fp_flags, fp_need)
    built = tuple(fp[k] for k in ("cfg", "model", "sparams", "policy"))
    phase("phase 3a': the same, --host-sampling (no device sampler, no pipeline)")
    fp_host = serve_path(torch, "fp KV, host sampling", fp_host_flags, fp_need, built)
    phase("phase 3a'': the same, eager decode step and host sampling (the graphs' witness)")
    fp_eager = eager_witness(torch, fp)
    phase("phase 3a, other order: --host-sampling first, then the default path again")
    fp_host2 = serve_path(torch, "fp KV, host sampling, 2nd", fp_host_flags, fp_need, built)
    fp2 = serve_path(torch, "fp KV, 2nd", fp_flags, fp_need, built)
    fp_runs = {"3a": ("fp KV", fp), "3a'": ("fp KV, host sampling", fp_host),
               "3a''": ("fp KV, eager", fp_eager),
               "3a' 2nd": ("fp KV, host sampling, 2nd", fp_host2), "3a 2nd": ("fp KV, 2nd", fp2)}
    for label, (_, r) in fp_runs.items():
        for rid in range(len(fp["work"])):
            if r["engine"].output(rid) != fp["engine"].output(rid):
                fail(f"[{label}] request {rid} gave {r['engine'].output(rid)}, "
                     f"3a gave {fp['engine'].output(rid)}")
        m = r["metrics"]
        ttft = statistics.median(q["ttft_s"] for q in m["requests"])
        print(f"  {label:8s}: tokens/s {m['tokens_per_s']:.2f}, decode step p50 "
              f"{m['decode_step_p50_ms']:.3f} ms, decode steps {m['decode_steps']}, "
              f"TTFT p50 {ttft:.4f} s")
    print("  greedy streams of 3a', 3a'' (eager decode step) and of both paths served "
          "again in the other order equal 3a's bitwise")
    fp_runs = {cell: {k: r[k] for k in ("metrics", "counts", "setup_s", "wall_s",
                                        "peak_mem_gib")}
               for cell, r in fp_runs.values()}
    del fp_host, fp_eager, fp_host2, fp2
    streams = check_outputs(torch, fp["cfg"], fp["model"], fp["sparams"], fp["engine"],
                            fp["work"])
    phase("phase 5a: decode step breakdown, fp KV blocks")
    breakdown = {"fp KV": profile_paths(torch, "fp KV", fp),
                 "sampler graphs": sampler_graph_times(torch, fp["cfg"].vocab_size)}

    # ---- path b: the same 4-bit weights over packed int4 KV blocks
    phase("phase 3b: glm4-9b serving end to end, --bits 4 --kv-bits 4 (fused decode)")
    del fp
    int4 = serve_path(torch, "int4 KV", ["--bits", "4", "--kv-bits", "4"],
                      ("qmm_bitserial", "qmm_dequant", "fused_qkv_paged_decode"), built)
    phase("phase 5b: decode step breakdown, int4 KV blocks")
    breakdown["int4 KV"] = profile_paths(torch, "int4 KV", int4)
    del built, int4["engine"], int4["sparams"], int4["model"]
    torch.cuda.empty_cache()

    # ---- path c: dense bf16 q/k/v over int8 KV blocks (fresh ~19 GB weights)
    phase("phase 3c: glm4-9b serving end to end, --bits 16 --kv-bits 8 (dense q/k/v)")
    int8 = serve_path(torch, "int8 KV", ["--bits", "16", "--kv-bits", "8"],
                      ("qmm_bitserial", "paged_attention_quant"))
    phase("phase 5c: decode step breakdown, int8 KV blocks")
    breakdown["int8 KV"] = profile_paths(torch, "int8 KV", int8)
    del int8["engine"], int8["sparams"], int8["model"]
    torch.cuda.empty_cache()

    # ---- the ReLeQ search loop: LeNet quickstart twin, ResNet-20 at full width.
    # Deterministic cuDNN algorithms: ResNet-20's early training is chaotic
    # (the step at which it leaves chance level moves with the summation
    # order), so the accuracy floors below need a run that repeats.
    torch.backends.cudnn.deterministic = True
    phase("phase 3d: the quickstart twin on LeNet (pretrain 300, 30 episodes, long retrain 150)")
    lenet = releq_quickstart(torch)
    phase(f"phase 3e: ReLeQ search on ResNet-20 at full width (pretrain {RESNET20_PRETRAIN}, "
          f"{RESNET20_EPISODES} episodes at episode_end, long retrain 200)")
    task, resnet = releq_resnet20(torch)
    phase("phase 4e: one ResNet-20 QAT step, card against CPU")
    resnet["card_vs_cpu"] = resnet_step_card_vs_cpu(torch, task)
    phase("phase 5e: ResNet-20 QAT step breakdown")
    qat_breakdown = profile_qat_step(torch, task)

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
    fused = per_step(rows, "fused_qkv_paged_decode", main_int("int4"),
                     [f"{launch}_{key}" for launch in ("project", "attend")
                      for key in ("ms", "library_ms", "bound_ms")])
    fq = per_step(rows, "fake_quant", lambda r: r["calls_per_forward"])
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    fqg, fqg_bwd = ({k: r[k] for k in keys} for r in rows
                    if r["kernel"].startswith("fake_quant_group") and r["calls_per_forward"])
    counts = {"fp KV": fp_runs["fp KV"]["counts"], "int4 KV": int4["counts"],
              "int8 KV": int8["counts"]}
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
        {"name": "fake_quant", "route": "cuda", "source": "src/repro_torch/csrc/fake_quant.cu",
         "replaces": "src/repro/kernels/fake_quant.py:33",
         "launches": resnet["counts"]["fake_quant"], "max_abs_err": fq_err, **fq},
        {"name": "fake_quant_group", "route": "cuda", "source": "src/repro_torch/csrc/fake_quant.cu",
         "replaces": "src/repro/kernels/fake_quant.py:33",
         "launches": resnet["counts"]["fake_quant_group"], "max_abs_err": fqg_err, **fqg},
        {"name": "fake_quant_group_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/fake_quant.cu",
         "replaces": "src/repro/quant/wrpn.py:78",
         "launches": resnet["counts"]["fake_quant_group_bwd"], "max_abs_err": fqg_err,
         **fqg_bwd},
    ]
    serve = {label: {"metrics": {k: v for k, v in r["metrics"].items() if k != "requests"},
                     "requests": r["metrics"]["requests"], "counts": r["counts"],
                     "setup_s": r["setup_s"], "wall_s": r["wall_s"],
                     "peak_mem_gib": r["peak_mem_gib"]}
             for label, r in (*fp_runs.items(), ("int4 KV", int4), ("int8 KV", int8))}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "card": smi_line, "torch": torch.__version__, "cuda": torch.version.cuda,
        "peaks": {"bytes_per_s": peaks[0], "bf16_flops": peaks[1]},
        "per_shape": rows, "per_step": kernels,
        "per_step_note": "qmm_bitserial: one decode step at M=4 (280 layer calls + "
                         "lm_head); qmm_dequant: one 64-token prefill chunk (280 "
                         "layer calls); paged_attention, paged_attention_quant (int8) "
                         "and fused_qkv_paged_decode (int4): 40 calls at the 'main' "
                         "lengths; fused library_ms is a sum (matmul + SDPA), its "
                         "project_* and attend_* keys time launch (A) and launch (B) "
                         "alone against matmul and SDPA; "
                         "fake_quant: one ResNet-20 QAT forward (20 calls, f32, the flat "
                         "kernel at given scales; no longer on the QAT path); "
                         "fake_quant_group / fake_quant_group_bwd: one ResNet-20 QAT forward / "
                         "backward (one launch each, f32, bits QAT_BITS); the backward has no "
                         "library call",
        "serve": serve, "decode_breakdown": breakdown, "served_streams": streams,
        "releq": {"lenet_quickstart": lenet, "resnet20": resnet,
                  "qat_step_breakdown": qat_breakdown},
        "total_s": time.perf_counter() - t_start}, indent=1, default=str))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
