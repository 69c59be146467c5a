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
   attention launch (B) are timed alone as well as together.
   h2o-danube-3-4b's decode attention (KV 8, G 4, head dim 120, bs 16)
   over ring tables (each row a full, shuffled set of 256 blocks: a
   4096-token ring) at lengths {1, 17, 4095, 4096} and at the served
   steady state (4 full rings): fp with bf16 pools, quantized with int8
   codes (120-byte rows) and packed int4 (60-byte rows), within 1e-4 *
   max|plain| and bitwise across two calls, timed beside the plain
   version, SDPA over the gathered pages and the bound; qmm bit-serial at
   M in {1, 4} and dequant at M = 256 at every danube (K, N) at 4 bits,
   and the lm_head at the 8 bits it is served at.  The same two attention
   rows at hymba-1.5b's decode shape (KV 5, G 5, hd 64, bs 16) over
   1024-token ring tables (lengths {1, 17, 1023, 1024} and four full
   rings; bf16, int8 and int4), and qmm bit-serial at M = 4 and dequant
   at M = 256 at every rwkv6-1.6b and hymba-1.5b (K, N) (RWKV's f32
   activations where its path feeds them; K 1600, N 320 and hymba's
   32001-wide lm_head among them).  The moe, vlm and audio families'
   shapes: qmm bit-serial at M = 32 and dequant at M = 384 at
   moonshot's expert (K 2048, N 1408) and (1408, 2048), at M = 4 and 64
   at its projections and 8-bit lm_head (N 163840), at qwen2-vl's
   (K 3584, N 18944 and back, N 152064) and musicgen's (N 8192, a
   2048-wide lm_head); both paged kernels at G 1 (KV 16, hd 128; KV 32,
   hd 64) and G 7 (KV 4, hd 128) at lengths {1, 17, 100, 112} and the
   served {41, 58, 73, 96}; the fused decode at moonshot's H 16 over KV
   16 (G 1), hd 128, D 2048.  The
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
   replaces and the bound.  The per-column grouped fake-quant of the LM
   QAT path (every stacked (L, K, N) leaf at max|w| over K per column,
   per-layer bits; one launch forward, one STE backward) at the 4-layer
   glm4-9b cell's nine leaves (bf16 and f32) and at LeNet's weight shapes
   with a ragged (3, 7, 300), a leaf with an all-zero column, one with a
   NaN and one near eps (bits cycling through 1-8, 16 and 32): outputs,
   scales and gradients bit pattern for bit pattern; timed per QAT forward
   and backward of the cell against the library (per layer
   ``abs().amax(dim=-2)`` + ``fake_quantize_per_channel_affine``, and its
   autograd backward), the plain versions and the bound.  For each shape: kernel,
   plain and library yardstick times (median of per-launch CUDA-event
   times, L2 flushed before each launch, the start event held behind a
   device spin that covers the wrapper's host work) and the bound from
   bytes and operations.
3. Eleven paths end to end.  Three serve through the launcher's continuous
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
   one-step lookahead, the prefix cache (no hits on random prompts).  Each
   prints the sampler, pipeline and prefix-cache counters and the graph
   captures, and fails unless the lookahead ran (``lookahead_steps >
   0``), every decode step was a lookahead or a bubble, and the decode
   step was captured once (``recompiles == 0``).
   a'. path a again with ``--host-sampling`` on the same params: its
      greedy streams must equal path a's bitwise; tokens/s, step p50 and
      TTFT print beside path a's.
   a''. path a's workload through a ``ServeEngine`` that runs
      ``model.decode_step`` eagerly and samples on the host (no graph):
      the captured decode step's witness at full width, its greedy
      streams bitwise path a's.  Then a' and a once more, in that order,
      so that each path is timed both first and second.
   f. ``--tenants 2 --prompt-len 256 --requests 8 --num-slots 4 --gen 32``
      on path a's params: two tenants share a 192-token system prompt (12
      full blocks), up to 288 tokens a sequence; served with the prefix
      cache and with ``--no-prefix-cache``.  Fails unless 6 of 8 lookups
      hit with 1,152 hit tokens, the cache takes fewer prefill launches,
      and the greedy streams agree (a divergence only at a flagged tie:
      the top-2 margin of the card's eager prefill of prompt + emitted
      within 2e-2 * max|logit|).
   g. the reference benchmark's concurrency gate: 2 tenants, 8 requests
      on 8 rows sharing the whole 192-token prefix of 256-token prompts,
      gen 8, one arrival a step, 75 blocks; fails unless the pools' cache
      bytes are equal and the sharing engine's peak of running rows is
      above the baseline's.
   h. path a's workload and params with ``--spec-k 4 --draft-bits 2``
      (the 2-bit self-draft's decode step is a second captured graph, the
      verify an eager chunk): greedy streams path a's up to flagged ties,
      the draft's graph captured once, the target's at most once, neither
      again.
   i. (after c) glm4-9b params snapped to the 2-bit grid, served at 4 bits
      with the 2-bit draft and without on the cell's workload: acceptance,
      per-token decode time and tokens/s of both, and one spec step's
      breakdown (the draft's decode steps and the eager verify: host
      clock, CUDA-event span, device busy time under the profiler,
      launches).
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
   Two run the LM QAT path at glm4-9b's published widths (d_model 4096,
   32 heads over 2 KV heads, head dim 128, d_ff 13696, vocab 151552),
   depth cut to 4 layers (2,057,306,112 quantized weights), random
   weights from seed 0, sequences of 4096, global batch 2:
   j. ``repro_torch.launch.train``'s path (``Trainer`` +
      ``make_train_step``, ``--remat full --lr 3e-4``): 20 steps at
      uniform 8 bits, then 5 at a mixed policy (group i at
      QAT_BITS[i % 7], embed and lm_head frozen at 8); fails unless every
      loss is finite, the mean of the last 5 uniform steps is below the
      mean of the first 5, and every step made exactly one per-column
      forward and one backward launch and no plain call; prints step p50,
      tokens/s and peak memory;
   k. ``launch/lm_search.py --lockstep``'s path on j's params:
      ``make_lm_env_factory(finetune_steps=2)`` at ``episode_end``, 4
      episodes; fails unless the record is whole, every accuracy proxy is
      finite and positive, and the memo's stats are there.
   Four serve h2o-danube-3-4b at its published widths (24 layers,
   d_model 3840, 32 heads over 8 KV heads of 120 dims, d_ff 10240, vocab
   32000, a 4096-token sliding window), random weights from seed 0,
   ``--bits 4``, 4 requests of 4032-4160 prompt tokens (``--prefill-chunk
   256``) and 48-96 new ones on 4 rows, block 16: max_len 4257, so each
   row's cache is a ring of the window's 4096 tokens, and some rows wrap
   inside prefill, the others in decode:
   l. fp ring blocks: ``paged_attention`` at head dim 120 launched, the
      fused decode and the plain versions never, 0 recaptures, the prefix
      cache off;
   m. ``--kv-bits 8``: the unfused ``paged_attention_quant`` (a windowed
      layer never takes the fused decode, whose write is not a ring's);
   n. ``--cache slot``: the slot pool, each prompt prefilled whole and
      spliced into its row; greedy streams l's up to flagged ties (the
      rule of f); then ``--mode static`` (batch 4, 4160-token prompts
      from ``--seed``, 96 greedy steps): prefill seconds and ms per
      token-step, its streams a paged engine's on the same prompts up to
      flagged ties.
   Six serve the recurrent families at their published widths, random
   weights from seed 0, ``--bits 4``: rwkv6-1.6b (24 layers, d_model
   2048, 32 wkv heads of 64, d_ff 7168, vocab 65536: O(1) state rows, no
   KV blocks) and hymba-1.5b (32 layers, d_model 1600, 25 heads over 5 KV
   heads of 64, d_ff 5504, vocab 32001, a Mamba branch of 3200 channels
   with state 16, a 1024-token window):
   o. rwkv6-1.6b on path a's traffic, then on l's (4 prompts of
      4032-4160 tokens in 256-token chunks, 48-96 new): qmm launched, no
      paged kernel, the pool without blocks or prefix cache; the bytes of
      a row's state;
   p. hymba-1.5b, fp ring blocks: 4 requests of 960-1200 prompt tokens
      in 256-token chunks and 48-96 new ones on 4 rows (max_len 1297, a
      ring of 1024: some rows wrap in prefill, the others in decode):
      ``paged_attention`` at G 5 launched, the fused decode never;
   q. p with ``--kv-bits 8``: the unfused ``paged_attention_quant``;
   r. o's first mix and p's traffic at a quarter of the published depth
      (6 and 8 layers, the widths published: at full depth the eager
      verify windows and replays below took 134 s) with and without spec
      k 4 and the 2-bit draft, through an
      engine of the script's own that watches the draft and verify
      calls: acceptance, fix-ups (at least one), the fix-up's CUDA-event
      span beside the window verify's and the device busy time of the
      first of each (``torch.profiler``), each stream replayed on its
      own path, the proposals the budget and hymba's ring cap left; then
      rwkv6-1.6b at full depth on params snapped to the 2-bit grid;
   s. the paper's baselines: after d, every LeNet policy over bits {2,
      3, 4, 6, 8} without retraining (625 points), the Pareto frontier
      and the distance of d's policy from it; after e, the ADMM selector
      on e's ResNet-20 at 4.0 average bits (its squared errors through
      the flat fake-quant kernel, 140 launches), its bits equal to a CPU
      run's on the same weights.
   Three serve the moe, vlm and audio families at their published widths
   and depth through the launcher on path a's traffic, random weights
   from seed 0, ``--bits 4``:
   t. moonshot-v1-16b-a3b (48 layers, d_model 2048, 16 heads over 16 KV
      of 128, 64 experts top-6 of d_ff 1408 in every layer, vocab
      163840): fp KV (``paged_attention`` at G 1), then ``--kv-bits 4``
      (the fused decode at G 1); every expert's product one qmm launch
      (bit-serial at a decode step's 32 rows, dequant at a chunk's 384);
      prints step p50, tokens/s, TTFT p50, weight bytes, the peaks while
      building and serving and the launches of one graphed step;
   u. qwen2-vl-7b (28 layers, d_model 3584, 28 heads over 4 KV of 128: G
      7, M-RoPE, d_ff 18944, vocab 152064): fp KV, then ``--kv-bits 8``
      (the unfused quantized attention: M-RoPE never takes the fused
      decode, which rotates by RoPE);
   v. musicgen-large (48 layers, d_model 2048, 32 heads over 32 KV of 64:
      G 1, absolute sinusoids, GELU d_ff 8192, vocab 2048): fp KV.
   Each full-width cell's request 0 prefilled again gives finite logits
   whose argmax is its first token.
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
   (the first divergence and its margin are printed); the same model on a
   two-tenant workload with the prefix cache, and with ``--spec-k 4
   --draft-bits 2``, on the card (defaults) and on the CPU (host
   sampling), under the same rule, with equal hit counts; and one ResNet-20
   QAT step at a mixed policy from
   path e's params gives the same params on the card as on the CPU within
   1e-4 * max|param| (f32 convolutions, TF32 off, summed in other orders)
   and the same validation accuracy; one LM QAT train step (phase 4j,
   ``lm_step_card_vs_cpu`` states its tolerances) on a small model with
   head dim 128 on the card and on the CPU, in f32 and in bf16.  Phase 4l:
   a narrow windowed model of danube's head dim (2 layers, d_model 480,
   4 heads over 2 KV heads of 120, window 64, d_ff 1280, vocab 32000),
   6 requests of 72-100 prompt tokens (past the ring in prefill) and 48
   greedy tokens, served on the card (kernels) and on the CPU (plain
   versions) with fp and int8 ring blocks: streams equal up to flagged
   ties, the ring's kernel launched and the fused decode never.  Phase
   4o: narrow models of the recurrent families (RWKV: 2 layers, d_model
   256, 4 heads of 64, d_ff 896, vocab 65536; hymba: 2 layers, d_model
   320, 5 heads over 1 KV head of 64, window 64, d_ff 1088, vocab 32001)
   served the same way, fp for both and int8 ring blocks for hymba.
   Phase 4t: narrow models of the moe, vlm and audio families (2 layers,
   d_model 256; moonshot's 2 heads over 2 KV of 128 with 16 experts
   top-6, fp and int4 KV; qwen2-vl's 7 heads over 1 KV of 128, fp and
   int8; musicgen's 4 over 4 of 64, fp) served the same way, held to the
   same token bound (a MoE stream's diverging token has its routing
   replayed on the CPU: the smallest gap between a k-th and (k+1)-th gate
   in any layer is printed beside the margin, with the smallest of its
   context, and passes nothing); then the narrow MoE model's captured
   decode step against its eager step over twin pools (fp and int4 KV):
   logits and every pool byte bitwise.

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
   memcpys), and for the 4-layer glm4-9b QAT step (phase 5j: weight
   matmuls, attention tiles, CE chunks, AdamW, fake-quant forward and
   backward).  Phase 5o: the same decode-step trace on 3o's and 3p's
   served engines (the wkv, scan and shift arithmetic falls in "other
   torch kernels").  Phase 5t: the same on 3t's served moonshot engine,
   the router (f32 matmul, softmax) and the dispatch / undispatch (sorts,
   searches, gathers, scatters) as families of their own; qmm's time
   split by graphs of layer 0's 192 expert launches and of its 4
   projection launches, each replayed alone and timed by CUDA events.

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
QMM_MS = (("bitserial", (1, 4, 16, 32)), ("dequant", (64, 256)))
# h2o-danube-3-4b (24 layers, d_model 3840, KV 8 x 120, d_ff 10240, vocab
# 32000): every (K, N) at 4 bits, and the lm_head at the 8 bits it is served at
DANUBE_QMM = [("danube wq/wo", 3840, 3840, 4, 48), ("danube wk/wv", 3840, 960, 4, 48),
              ("danube wg/wu", 3840, 10240, 4, 48), ("danube wd", 10240, 3840, 4, 24),
              ("danube lm_head@4b", 3840, 32000, 4, 0), ("danube lm_head", 3840, 32000, 8, 1)]
DANUBE_MS = (("bitserial", (1, 4)), ("dequant", (256,)))
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


def f32_peak_of(torch) -> float:
    """The card's dense f32 rate outside the tensor cores (F32_PEAKS)."""
    name = torch.cuda.get_device_name(0)
    return next((v for k, v in F32_PEAKS.items() if k in name), F32_PEAKS["H100"])


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


def check_qmm(torch, timer, peaks, rows, shapes=GLM4_QMM + EXTRA_BITS, ms=QMM_MS, seed=0):
    from repro_torch.kernels.qmm import bitserial_plan, dequant_plan, qmm_cuda
    from repro_torch.kernels.ref import dequant_ref, qmm_ref
    from repro_torch.quant.pack import pack_weight

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    for name, K, N, bits, _, *xdt in shapes:
        # bf16 activations, or f32 where the path feeds f32 (RWKV's mixes)
        xdt = torch.float32 if xdt == ["f32"] else torch.bfloat16
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        planes, scale = pack_weight(w, bits)
        dense = dequant_ref(planes, scale, bits).to(xdt)  # yardstick
        del w
        for path, Ms in ms:
            for M in Ms:
                x = torch.randn((M, K), generator=gen, device="cuda").to(xdt)
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
                nbytes = M * K * x.element_size() + planes.numel() + N * 4 + M * N * 4
                # f32 products run outside the tensor cores
                flop_peaks = peaks if xdt == torch.bfloat16 else (peaks[0], f32_peak_of(torch))
                b_ms, b_by = bound_ms(nbytes, 2.0 * M * K * N, flop_peaks)
                # the TPU kernel rounds x to bf16 in its body: the same product's
                # bound with bf16 x on the tensor cores
                b16_ms = bound_ms(nbytes - M * K * (x.element_size() - 2), 2.0 * M * K * N,
                                  peaks)[0]
                plan = (dequant_plan if path == "dequant" else bitserial_plan)(M, K, N, bits)
                row = {"kernel": f"qmm_{path}", "shape": name, "M": M, "K": K,
                       "N": N, "bits": bits, "x_dtype": str(xdt).split(".")[-1],
                       "max_abs_err": err,
                       "plan": plan._asdict(),
                       "rel_err": err / ref_max,
                       "ms": timer(lambda: qmm_cuda(x, planes, scale, bits, path)),
                       "plain_ms": timer(lambda: qmm_ref(x, planes, scale, bits), iters=5),
                       "library_ms": timer(lambda: torch.matmul(x, dense)),
                       "bound_ms": b_ms, "bound_by": b_by, "bound_bf16_ms": b16_ms}
                rows.append(row)
                print(f"  qmm_{path:9s} {name:8s} M={M:3d} K={K:5d} N={N:6d} "
                      f"b={bits} x={row['x_dtype']} err={err:.2e} (rel {row['rel_err']:.1e}) "
                      f"kernel={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                      f"matmul={row['library_ms']:.4f} bound={b_ms:.4f} ms"
                      + (f" (bf16 x: {b16_ms:.4f})" if xdt == torch.float32 else "")
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


# h2o-danube-3-4b's decode attention: KV 8, G 4, head dim 120, blocks of 16,
# a 4096-token ring (256 blocks).  "ring": lengths across the ring's life
# (min(length + 1, Tc) as the decode step passes them); "decode": the
# served cell's steady state, every row's ring full (the per-step row)
RING = {"B": 4, "KV": 8, "G": 4, "hd": 120, "bs": 16, "nb": 256}
RING_LENGTHS = (("hd120 ring", [1, 17, 4095, 4096]), ("hd120 decode", [4096] * 4))
# hymba-1.5b's: KV 5, G 5 (one full warp of 4 heads and one more), head dim
# 64, 1024-token rings (64 blocks of 16)
HYMBA_RING = {"B": 4, "KV": 5, "G": 5, "hd": 64, "bs": 16, "nb": 64}
HYMBA_RING_LENGTHS = (("g5 ring", [1, 17, 1023, 1024]), ("g5 decode", [1024] * 4))


def ring_tables(torch, B, nb, seed):
    """Ring block tables: each row a full, shuffled set of nb blocks of its
    own, so a wrapped row's newest token sits mid-table."""
    import numpy as np

    perm = np.random.default_rng(seed).permutation(B * nb) + 1
    return B * nb + 1, torch.from_numpy(perm.reshape(B, nb)).to("cuda", torch.int32)


def check_ring_attention(torch, timer, peaks, rows, ring=RING, ring_lengths=RING_LENGTHS,
                         seed=21):
    """Rows 2 and 3 at a served ring shape (h2o-danube's head dim 120 by
    default) over ring tables: bf16 pools, int8 codes (hd-byte rows) and
    packed int4 (hd/2-byte rows), against the plain versions within TOL *
    max|plain|, bitwise across two calls; timed with the plain version,
    SDPA over the gathered (dequantized) pages and the bound.  Returns the
    worst errors (fp, quantized)."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda, split_plan
    from repro_torch.kernels.paged_attention_quant import paged_attention_quant_cuda
    from repro_torch.kernels.ref import (gather_dequant, paged_attention_ref,
                                         quant_paged_attention_ref)

    B, KV, G, hd, bs, nb = (ring[k] for k in ("B", "KV", "G", "hd", "bs", "nb"))
    H = KV * G
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"fp": 0.0, "quant": 0.0}
    pps, splits = split_plan(nb)
    for container in ("bf16", "int8", "int4"):
        NB, bt = ring_tables(torch, B, nb, seed=len(container))
        bl = bt.long()
        if container == "bf16":
            kp, vp = (torch.randn((NB, bs, KV, hd), generator=gen, device="cuda")
                      .to(torch.bfloat16) for _ in range(2))
            kg, vg = (p[bl].reshape(B, nb * bs, KV, hd) for p in (kp, vp))
            token_bytes = hd * 2
        else:
            kc, vc, ks, vs, _ = quant_pools(torch, NB, bs, KV, hd, 8 if container == "int8"
                                            else 4, gen)
            kg, vg = (gather_dequant(c, sc, bl).to(torch.bfloat16)
                      for c, sc in ((kc, ks), (vc, vs)))
            token_bytes = kc.shape[-1] + 4
        for label, lengths in ring_lengths:
            q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
            q4 = q.reshape(B, KV, G, hd)
            ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            if container == "bf16":
                kernel, key = "paged_attention", "fp"
                run = (lambda q4=q4, ln=ln: paged_attention_cuda(q4, kp, vp, bt, ln))
                plain_fn = (lambda q=q, ln=ln: paged_attention_ref(q, kp, vp, bt, ln))
            else:
                kernel, key = "paged_attention_quant", "quant"
                run = (lambda q4=q4, ln=ln:
                       paged_attention_quant_cuda(q4, kc, vc, ks, vs, bt, ln))
                plain_fn = (lambda q=q, ln=ln: quant_paged_attention_ref(q, kc, vc, ks, vs,
                                                                           bt, ln))
            got, again = run(), run()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"{kernel} {container} {label}: two calls differ")
            got = got.reshape(B, 1, H, hd)
            plain = (paged_attention_ref(q.float(), kp.float(), vp.float(), bt, ln)
                     if container == "bf16" else
                     quant_paged_attention_ref(q.float(), kc, vc, ks, vs, bt, ln))
            err = (got - plain).abs().max().item()
            ref_max = plain.abs().max().item()
            if not math.isfinite(err) or err > TOL * ref_max:
                fail(f"{kernel} {container} {label}: max|kernel-plain| {err:.3g} > "
                     f"{TOL} * {ref_max:.3g}")
            worst[key] = max(worst[key], err)
            live = sum(lengths)
            nbytes = (q.numel() * 2 + live * KV * token_bytes * 2 + bt.numel() * 4 + B * 4
                      + B * H * hd * 4)
            b_ms, b_by = bound_ms(nbytes, 4.0 * live * H * hd, peaks)
            row = {"kernel": kernel, "shape": label, "container": container,
                   "lengths": lengths, "B": B, "KV": KV, "G": G, "hd": hd, "bs": bs,
                   "max_abs_err": err, "rel_err": err / ref_max, "pages_per_split": pps,
                   "splits": splits, "ctas": B * KV * splits, "ms": timer(run),
                   "plain_ms": timer(plain_fn, iters=5),
                   "library_ms": timer(sdpa_over_pages(torch, q, kg, vg, ln)),
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            print(f"  {kernel} {container} {label} lengths={lengths} err={err:.2e} "
                  f"(rel {row['rel_err']:.1e}) kernel={row['ms']:.4f} "
                  f"plain={row['plain_ms']:.4f} sdpa={row['library_ms']:.4f} "
                  f"bound={b_ms:.4f} ms [{B * KV * splits} CTAs: {splits} splits of {pps} "
                  f"pages, ring table, bitwise on 2 calls]")
        del kg, vg
    return worst["fp"], worst["quant"]


def check_fused_decode(torch, timer, peaks, rows, shape=(4, 2, 16, 128, 16, 4096),
                       theta=1e4, prefix="", seed=3):
    """Row 4 at ``shape`` = (B, KV, G, hd, bs, D): glm4-9b's by default;
    ``prefix`` tags the rows' shape labels."""
    from repro_torch.kernels.fused_decode import (attend_plan, fused_attend_cuda,
                                                  fused_project_cuda,
                                                  fused_qkv_paged_decode_cuda, project_plan)
    from repro_torch.kernels.ref import (dequant_ref, finish_projection,
                                         fused_decode_attend_ref, fused_qkv_paged_decode_ref,
                                         gather_dequant, qmm_ref)
    from repro_torch.models.common import rope_cos_sin
    from repro_torch.quant.pack import Packed, kv_unpack_int4, pack_weight

    B, KV, G, hd, bs, D = shape
    H = KV * G
    gen = torch.Generator(device="cuda").manual_seed(seed)
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
        for label, lengths in ((prefix + name, ln) for name, ln in KV_LENGTHS):
            nb = -(-(max(lengths) + 1) // bs)    # the new token fits: len <= Tc - 1
            NB, bt = block_tables(torch, B, nb, len(label) + 7)
            kc, vc, ks, vs, qmax = quant_pools(torch, NB, bs, KV, hd, kv_bits, gen)
            ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            x = torch.randn((B, D), generator=gen, device="cuda").to(torch.bfloat16)
            cos, sin = rope_cos_sin(ln, hd, theta)
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
            if label.endswith("main") and splits <= 1:  # page splits, besides the new token's CTA
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

    f32_peak = f32_peak_of(torch)
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

    f32_peak = f32_peak_of(torch)
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
        # the library's STE: the backward of fake_quantize_per_tensor_affine at
        # scale max|w| / n, whose mask is |w| <= max|w| as the kernel's is
        leaves = [w.detach().clone().requires_grad_(True) for w in ws]
        lib_outs = [torch.fake_quantize_per_tensor_affine(
            w, (w.abs().amax().float() / n4).detach(), zp, -n4, n4) for w in leaves]

        def library_bwd():
            return torch.autograd.grad(lib_outs, leaves, gs, retain_graph=True)

        grads, _ = fake_quant_group_bwd_cuda(ws, gs, scales)
        lib_same = all(same_bits(torch, a, b) for a, b in zip(grads, library_bwd()))
        bb_ms, bb_by = bound_ms(3 * numel * esize + 4 * len(ws), 3 * numel, (peaks[0], f32_peak))
        bwd = {"kernel": "fake_quant_group_bwd", "shape": net, "dtype": str(dtype)[6:],
               "tensors": len(ws), "numel": numel, "bwd_ctas": plan.bwd_ctas,
               "calls_per_forward": fwd["calls_per_forward"], "max_abs_err": 0.0,
               "ms": timer(lambda: fake_quant_group_bwd_cuda(ws, gs, scales)),
               "plain_ms": timer(lambda: fake_quant_group_bwd_ref(ws, gs, scales)),
               "library_ms": timer(library_bwd),
               "library": "sum over the layers: the backward of "
                          "fake_quantize_per_tensor_affine (scale max|w| / 7)",
               "library_grads_bitwise": lib_same,
               "bound_ms": bb_ms, "bound_by": bb_by}
        rows += [fwd, bwd]
        label = f"fake_quant_group {net} {str(dtype)[6:]} ({len(ws)} layers)"
        print(f"  {label:46s} per QAT forward: group={fwd['ms']:.4f} "
              f"[{plan.ctas[0]} CTAs in clusters of {plan.cluster}] flat path (scale + "
              f"kernel)={fwd['flat_path_ms']:.4f} flat at given scales="
              f"{fwd['flat_given_scale_ms']:.4f} library (amax + fake_quantize)="
              f"{fwd['library_ms']:.4f} plain={fwd['plain_ms']:.4f} bound={b_ms:.6f} ms")
        print(f"  {'':46s} per QAT backward: group={bwd['ms']:.4f} [{plan.bwd_ctas[0]} CTAs] "
              f"plain (abs, <=, to, mul per layer)={bwd['plain_ms']:.4f} library "
              f"(fake_quantize_per_tensor_affine backward)={bwd['library_ms']:.4f} "
              f"[gradients bitwise the kernel's: {lib_same}] bound={bb_ms:.6f} ms")
        del ws, gs, outs, grads, leaves, lib_outs
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
    return out["task"], {"fp_acc": out["fp_acc"], "best_bits": out["bits"],
                         "avg_bits": out["avg_bits"], "rel_acc": out["rel_acc"],
                         "stripes_speedup": out["stripes_speedup"],
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


CELL = ["--requests", "8", "--num-slots", "4", "--block-size", "16", "--prompt-len", "64",
        "--min-prompt-len", "40", "--prefill-chunk", "64", "--gen", "32", "--temperature", "0"]
# phase 3f: two tenants whose requests share a 192-token system prompt (12
# full blocks) in 256-token prompts: up to 288 tokens per sequence
TENANTS = ["--tenants", "2", "--prompt-len", "256", "--requests", "8", "--arrival-every", "2",
           "--num-slots", "4", "--gen", "32", "--prefill-chunk", "64", "--block-size", "16",
           "--temperature", "0"]
SPEC = ["--spec-k", "4", "--draft-bits", "2"]
MARGIN = 2e-2            # a greedy divergence only where top-2 <= MARGIN * max|logit|
# phases 3l-3n: h2o-danube-3-4b, 4 requests of 4032-4160 prompt tokens and
# 48-96 new ones on 4 rows: max_len = 4257 >= the 4096-token window, so the
# ring is the window; some rows wrap inside prefill, the others in decode
DANUBE = ["--requests", "4", "--num-slots", "4", "--block-size", "16", "--prompt-len", "4160",
          "--min-prompt-len", "4032", "--prefill-chunk", "256", "--gen", "96",
          "--temperature", "0"]
# (layers, d_model, heads, KV heads, head dim, d_ff, vocab), sliding window
PUBLISHED = {"glm4-9b": ((40, 4096, 32, 2, 128, 13696, 151552), None),
             "h2o-danube-3-4b": ((24, 3840, 32, 8, 120, 10240, 32000), 4096)}


def serve_path(torch, label, flags, need, built=None, base=CELL, arch="glm4-9b", forbid=(),
               layers=None):
    """Serve ``base`` + ``flags`` of ``arch`` at its published widths
    through the launcher; the launch counters are zeroed just before and
    read just after: every ``need`` kernel must have launched, no
    ``forbid`` one.  ``built`` reuses (cfg, model, sparams, policy) of the
    same ``--bits``; ``layers``, the depth ``built`` was cut to (the
    widths stay the published ones)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher

    args = launcher.parse_args(["--arch", arch, "--no-smoke", "--device", "cuda",
                                *base, *flags])
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, sparams, policy = built or launcher.build(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    build_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    widths = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
              cfg.hd, cfg.d_ff, cfg.vocab_size)
    want, window = PUBLISHED[arch]
    if layers:
        want = (layers, *want[1:])
    if (widths, cfg.sliding_window) != (want, window):
        fail(f"{arch} widths {widths}, window {cfg.sliding_window} are not the published "
             f"ones {(want, window)}")
    print(f"[{label}] {arch} serving params ready in {setup_s:.1f} s "
          f"(avg policy {policy.average_bits():.2f} bits, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated"
          + (f", peak {build_peak_gib:.2f} GiB while building)" if not built else ")"))
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
    for key in forbid:
        if counts[key] != 0:
            fail(f"[{label}] the path launched the {key} kernel {counts[key]} times")
    if counts["plain"] != 0:
        fail(f"[{label}] the path took the plain version {counts['plain']} times on CUDA")
    pl, captures = m["pipeline"], engine.graph_captures
    print(f"[{label}] sampler={'device' if m['sampler']['device'] else 'host'} "
          f"fallbacks={m['sampler']['fallbacks']} pipeline={'on' if pl['enabled'] else 'off'} "
          f"lookahead_steps={pl['lookahead_steps']} bubbles={pl['bubbles']} "
          f"recompiles={m['recompiles']} graph captures={captures} (host s, shared "
          f"samplers since the process began: "
          f"{ {k: round(v, 4) for k, v in engine.graph_capture_seconds.items()} })")
    # with spec the target's decode step runs only in a step where no row
    # can speculate, so it is captured once or, if no such step came, never
    want = (0, 1) if "spec" in m else (1,)
    if m["recompiles"] != 0 or captures["decode"] not in want or captures.get("draft", 1) != 1:
        fail(f"[{label}] the decode steps were captured {captures} times "
             f"({m['recompiles']} re-captures): want one capture each")
    if args.cache == "paged":
        pc = m["prefix_cache"]
        print(f"[{label}] prefix_cache={'on' if pc['enabled'] else 'off'} "
              f"hit_rate={m['prefix_hit_rate']:.4f} "
              f"hits={m['prefix_hits']}/{m['prefix_lookups']} "
              f"lookups hit_tokens={pc['hit_tokens']} cow={pc['cow_copies']} "
              f"evictions={pc['evictions']} cached_blocks={pc['cached_blocks']} "
              f"blocks_shared={m['blocks_shared']:.2f} prefill_launches={m['prefill_launches']} "
              f"block_size={engine.pool.block_size} cache_bytes={engine.pool.cache_bytes()}")
    else:
        print(f"[{label}] slot pool: {engine.pool.num_slots} rows of "
              f"{engine.pool.cache['k'].shape[2]} tokens, "
              f"cache_bytes={engine.pool.cache_bytes()}")
    if "spec" in m:
        sp = m["spec"]
        print(f"[{label}] spec k={sp['k']} draft_bits={args.draft_bits} "
              f"windows={sp['windows']} proposed={sp['proposed']} accepted={sp['accepted']} "
              f"acceptance={sp['acceptance_rate']:.4f} decode_tok_p50="
              f"{m['decode_tok_p50_ms']:.3f} ms; captures target {captures['decode']} / "
              f"draft {captures['draft']}, recaptures target "
              f"{getattr(engine._decode, 'recaptures', 0)} / draft "
              f"{getattr(engine._draft_decode, 'recaptures', 0)}")
    if pl["enabled"]:
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
    return {"args": args, "cfg": cfg, "model": model, "sparams": sparams, "label": label,
            "policy": policy, "engine": engine, "work": work, "counts": counts,
            "metrics": m, "setup_s": setup_s, "wall_s": wall_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "build_peak_gib": None if built else build_peak_gib}


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
    streams.update(served_prefix_spec_card_vs_cpu(torch, sm, params))
    return streams


def served_prefix_spec_card_vs_cpu(torch, sm, params):
    """The small model on a ``--tenants 2`` workload (6 requests on 4 rows,
    40-token prompts whose first 32 tokens are the tenant's, arrivals
    every 2 steps, 36 greedy tokens each, block 16) with prefix caching,
    and once more with ``--spec-k 4 --draft-bits 2``: on the card with the
    engine's defaults and on the CPU with host sampling.  Equal hit
    counts; greedy streams equal, or a first divergence where the CPU's
    top-2 margin (an eager prefill of prompt + emitted) is within MARGIN *
    max|logit|."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.quant.qat import policy_for
    from repro_torch.serve import ServeEngine
    from repro_torch.spec import SpecConfig
    from repro_torch.train.serve import quantize_for_serving

    rng = np.random.default_rng(13)
    heads = rng.integers(0, sm.cfg.vocab_size, (2, 32))
    work = [(np.concatenate([heads[i % 2], rng.integers(0, sm.cfg.vocab_size, 8)]),
             STREAM_GEN) for i in range(6)]
    sps = {dev: quantize_for_serving(sm, params, policy_for(sm, 4), device=dev)
           for dev in ("cuda", "cpu")}
    out = {}
    for cell, kw in (("tenants, prefix cache", {}),
                     ("tenants, spec k=4", {"spec": SpecConfig(k=4, draft_bits=2)})):
        engines = {}
        for dev in ("cuda", "cpu"):
            host = {"sample_device": False, "pipeline": False} if dev == "cpu" else {}
            eng = ServeEngine(sm, sps[dev], num_slots=4, max_len=40 + STREAM_GEN + 1,
                              block_size=16, prefill_chunk=16, device=dev, **host, **kw)
            ops.reset_counts()
            submitted = 0
            while submitted < len(work) or eng.scheduler.has_work():
                while submitted < len(work) and eng.steps >= 2 * submitted:
                    eng.submit(*work[submitted])
                    submitted += 1
                eng.step()
            m = eng.metrics()
            if dev == "cuda":
                torch.cuda.synchronize()
                if ops.counts["plain"] != 0 or ops.counts["qmm_bitserial"] <= 0:
                    fail(f"served streams ({cell}): launch counts {ops.counts}")
                if m["recompiles"] != 0:
                    fail(f"served streams ({cell}): {m['recompiles']} re-captures")
            engines[dev] = (eng, m)
        card, cpu = engines["cuda"][1], engines["cpu"][1]
        if (card["prefix_hits"], card["prefix_lookups"]) != (cpu["prefix_hits"],
                                                             cpu["prefix_lookups"]) \
                or card["prefix_hits"] <= 0:
            fail(f"served streams ({cell}): hits {card['prefix_hits']}/"
                 f"{card['prefix_lookups']} on the card, {cpu['prefix_hits']}/"
                 f"{cpu['prefix_lookups']} on the CPU")
        diverged = compare_streams(
            torch, f"{cell}, card vs CPU", engines["cuda"][0], engines["cpu"][0], work,
            lambda toks: prefill_margin(torch, sm, sps["cpu"], toks, device="cpu", chunk=16))
        out[cell] = {"requests": len(work), "tokens_per_request": STREAM_GEN,
                     "prefix_hits": card["prefix_hits"], "spec": card.get("spec"),
                     "spec_cpu": cpu.get("spec"), "diverged": diverged}
        print(f"served streams ({cell}): hits {card['prefix_hits']}/{card['prefix_lookups']}"
              + (f", spec windows {card['spec']['windows']} (CPU {cpu['spec']['windows']}), "
                 f"acceptance {card['spec']['acceptance_rate']:.4f} (CPU "
                 f"{cpu['spec']['acceptance_rate']:.4f})" if "spec" in card else ""))
    return out


STREAM_GEN = 36          # greedy tokens per request: past two 16-token block edges


def served_streams_card_vs_cpu(torch, sm, params, kv_bits, lens=(9, 40, 17, 31, 24, 16),
                               gen=STREAM_GEN, need=("qmm_bitserial",), forbid=()):
    """The small model served by the port's ServeEngine on the card
    (kernels) and on the CPU (plain versions, host sampling): 6 requests
    of ``lens`` prompt tokens on 4 rows, ``gen`` greedy tokens each.  On
    the card twice: with host sampling, and with the defaults (captured
    decode step, device sampling, lookahead), each launching every
    ``need`` kernel and no ``forbid`` one.  Each card run gives the CPU's
    streams, or a first divergence where the CPU's top-2 logit margin is
    within the bf16 logit bound (2e-2 * max|logit|).  On a MoE model the
    diverging token's routing (the token whose logits chose it, replayed on
    the CPU) is recorded beside the margin: its smallest gap between a k-th
    and (k+1)-th gate in any layer, and the smallest of its context."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.quant.qat import policy_for
    from repro_torch.serve import ServeEngine
    from repro_torch.train.serve import quantize_for_serving

    rng = np.random.default_rng(9)
    work = [(rng.integers(0, sm.cfg.vocab_size, int(n)), gen) for n in lens]
    host = {"sample_device": False, "pipeline": False}
    runs, cpu_sp = {}, None
    for name, dev, kw in (("card, host sampling", "cuda", host),
                          ("card, device sampling + pipeline", "cuda", {}),
                          ("cpu", "cpu", host)):
        sp = quantize_for_serving(sm, params, policy_for(sm, 4), device=dev)
        if dev == "cpu":
            cpu_sp = sp
        eng = ServeEngine(sm, sp, num_slots=4, max_len=max(lens) + gen + 1, block_size=16,
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
            if (ops.counts["plain"] != 0 or any(ops.counts[k] <= 0 for k in need)
                    or any(ops.counts[k] != 0 for k in forbid)):
                fail(f"served streams (kv_bits={kv_bits}, {name}): launch counts {ops.counts}")
            m = eng.metrics()
            if m["recompiles"] != 0 or (not kw and m["pipeline"]["lookahead_steps"] <= 0):
                fail(f"served streams (kv_bits={kv_bits}, {name}): recompiles "
                     f"{m['recompiles']}, pipeline {m['pipeline']}")
        runs[name] = ([eng.output(r) for r in range(len(work))], margins)
    kv = f"kv_bits={kv_bits}" if kv_bits else "fp KV"
    if sm.cfg.family not in ("dense", "hybrid", "ssm"):
        kv += f", {sm.cfg.family}"
    if sm.cfg.sliding_window:
        kv += f", ring of {sm.cfg.sliding_window}, hd {sm.cfg.hd}"
    out = {"requests": len(work), "tokens_per_request": gen}
    for name in ("card, host sampling", "card, device sampling + pipeline"):
        diverged = out[name] = []
        for rid in range(len(work)):
            got, want = runs[name][0][rid], runs["cpu"][0][rid]
            if len(got) != gen or len(want) != gen:
                fail(f"served streams ({kv}, {name}): request {rid} emitted {len(got)} / "
                     f"{len(want)} tokens")
            if got == want:
                continue
            i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            margin, top = runs["cpu"][1][rid][i]
            entry = {"request": rid, "token": i, "margin": margin, "bound": 2e-2 * top}
            route = ""
            if sm.cfg.num_experts:
                entry["route_gap"], entry["route_gap_min"] = route_gaps(
                    torch, sm, cpu_sp, work[rid][0], want[:i])
                route = (f"; gate gap {entry['route_gap']:.4g} at the token, "
                         f"{entry['route_gap_min']:.4g} in its context")
            print(f"  served streams ({kv}, {name}): request {rid} first diverges at token "
                  f"{i} (card {got[i]}, cpu {want[i]}); CPU top-2 margin {margin:.4g}, "
                  f"bound 2e-2 * {top:.4g} = {2e-2 * top:.4g}{route}")
            diverged.append(entry)
            if margin > 2e-2 * top:
                fail(f"served streams ({kv}, {name}): request {rid} diverged at token {i} "
                     f"where the CPU's top-2 margin {margin:.4g} exceeds 2e-2 * max|logit| "
                     f"= {2e-2 * top:.4g}")
        print(f"served streams ({kv}, {name}): {len(work)} requests x {gen} greedy "
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


def fresh_logits(torch, model, sparams, tokens, device="cuda", chunk=64, decoded=0):
    """The f32 logits after ``tokens`` on a fresh one-row pool on
    ``device``: an eager chunked prefill of all of them, or (``decoded``
    = n) of all but the last n, which the decode step then takes one at a
    time, as a served row does."""
    import numpy as np

    from repro_torch.serve.cache import PagedCachePool

    tokens = np.asarray(tokens, np.int32)
    pool = PagedCachePool(model, 1, len(tokens) + 1, block_size=16, device=device,
                          prefix_cache=False)
    seq = pool.alloc_seq()
    pool.ensure(seq, len(tokens) + 1)
    n = len(tokens) - decoded
    for lo in range(0, n, chunk):
        valid = min(chunk, n - lo)
        buf = np.zeros((1, chunk), np.int32)
        buf[0, :valid] = tokens[lo:lo + valid]
        logits, cache = model.prefill_chunk(sparams, pool.step_cache(),
                                            torch.from_numpy(buf).to(device), seq, lo, valid)
        pool.accept(cache)
    for tok in tokens[n:]:
        logits, cache = model.decode_step(sparams, pool.step_cache(),
                                          torch.tensor([[int(tok)]], dtype=torch.int32,
                                                       device=device))
        pool.accept(cache)
    return logits[0, 0].float()


def prefill_margin(torch, model, sparams, tokens, device="cuda", chunk=64):
    """Top-2 logit margin and max|logit| after ``tokens``, from an eager
    chunked prefill on a fresh one-row pool on ``device``."""
    row = fresh_logits(torch, model, sparams, tokens, device, chunk)
    top = row.topk(2).values
    return float(top[0] - top[1]), float(row.abs().max())


def tie_check(row, tok):
    """``tok`` on one f32 logit row: (the row's argmax, the gap from the
    top logit, the tie bound MARGIN * max|logit|)."""
    top = float(row.max())
    return int(row.argmax()), top - float(row[tok]), MARGIN * float(row.abs().max())


class PathReplay:
    """Recomputes served greedy streams on each one's own path: a fresh
    pool of the served pool's shape (rows, blocks, ``kv_bits``), the
    model's calls made eagerly one at a time with the state handled here
    plainly.  A row's numbers depend only on its own tokens and on the
    batch shape, which is the served one's, so the replay computes each
    token as the served engine did, but without its snapshots, graphs or
    lookahead.  A served token must be the replay's argmax, or within
    MARGIN * max|logit| of its top (a flagged tie: the request then leaves
    the replay, since what follows was computed from another token).
    Anything else fails.

    - ``spec(log, outs)`` replays a spec engine's event log (``SpecLog``):
      each window verify from the state the last kept call left, the
      window resolved greedily here, and a fix-up from a copy of that
      state at the lengths this replay accepted;
    - ``decode(upto, outs)`` replays the decode path: the prompt
      prefilled, then one decode step a token, up to token ``upto[rid]``
      of each request."""

    def __init__(self, torch, r, like, label):
        from repro_torch.serve.cache import PagedCachePool

        self.torch, self.model, self.sparams, self.label = torch, r["model"], r["sparams"], label
        self.work, self.chunk = r["work"], r["args"].prefill_chunk
        self.dev = like.device
        self.pool = PagedCachePool(self.model, like.num_seqs, like.max_len,
                                   block_size=like.block_size, kv_bits=like.kv_bits,
                                   prefix_cache=False, device=self.dev)
        self.row, self.n, self.len, self.ties = {}, {}, {}, {}
        self.exact = 0
        self.partial = []   # (window's log index, accepted, proposed) for 0 < accepted < proposed

    def check(self, rid, row, tok):
        top, gap, bound = tie_check(row, tok)
        if top == tok:
            self.exact += 1
            return True
        if gap > bound:
            fail(f"[{self.label}] request {rid} token {self.n[rid]} is {tok}, {gap:.4g} below "
                 f"its own path's top logit ({top}), over the tie bound {bound:.4g}")
        self.ties[rid] = {"token": self.n[rid], "gap": gap, "bound": bound}
        self.drop(rid)
        return False

    def drop(self, rid):
        self.pool.free_seq(self.row.pop(rid))

    def live(self, rid):
        return rid in self.row

    def _lengths(self):
        torch = self.torch
        lengths = torch.zeros((self.pool.num_seqs,), dtype=torch.int32)
        for rid, row in self.row.items():
            lengths[row] = self.len[rid]
        self.pool.cache["length"] = lengths.to(self.dev)

    def admit(self, rid, out):
        import numpy as np

        torch, prompt = self.torch, np.asarray(self.work[rid][0], np.int32)
        seq = self.pool.alloc_seq()
        self.pool.ensure(seq, self.pool.max_len)
        for lo in range(0, len(prompt), self.chunk):
            valid = min(self.chunk, len(prompt) - lo)
            buf = np.zeros((1, self.chunk), np.int32)
            buf[0, :valid] = prompt[lo:lo + valid]
            logits, cache = self.model.prefill_chunk(self.sparams, self.pool.step_cache(),
                                                     torch.from_numpy(buf).to(self.dev), seq, lo, valid)
            self.pool.accept(cache)
        self.row[rid], self.n[rid], self.len[rid] = seq, 0, len(prompt)
        if self.check(rid, logits[0, 0].float().cpu(), out[0]):
            self.n[rid] = 1

    def advance(self, rid, k, out):
        self.n[rid] += k
        self.len[rid] += k
        if self.n[rid] == len(out):
            self.drop(rid)

    def _verify(self, toks, starts, valids):
        torch = self.torch
        self._lengths()
        logits, cache = self.model.verify_chunk(
            self.sparams, self.pool.step_cache(), torch.from_numpy(toks).to(self.dev),
            torch.from_numpy(starts).to(self.dev), torch.from_numpy(valids).to(self.dev))
        self.pool.accept(cache)
        return logits.float().cpu()

    def window(self, idx, ev, outs):
        import numpy as np

        for rid in ev["rids"].values():
            if rid not in self.n:
                self.admit(rid, outs[rid])
        live = {rid: slot for slot, rid in ev["rids"].items() if self.live(rid)}
        if not live:
            return
        B, C = ev["toks"].shape
        toks, starts, valids = (np.zeros((B, C), np.int32), np.zeros((B,), np.int32),
                                np.zeros((B,), np.int32))
        for rid, slot in live.items():
            row, n = self.row[rid], self.n[rid]
            if ev["toks"][slot, 0] != outs[rid][n - 1] or ev["starts"][slot] != self.len[rid]:
                fail(f"[{self.label}] request {rid}: the served window fed token "
                     f"{ev['toks'][slot, 0]} at {ev['starts'][slot]}, its stream has "
                     f"{outs[rid][n - 1]} at {self.len[rid]}")
            toks[row], starts[row], valids[row] = ev["toks"][slot], self.len[rid], ev["valids"][slot]
        snap = {key: self.pool.cache[key].clone() for key in self.pool.recurrent_keys}
        logits = self._verify(toks, starts, valids)
        emitted = {}
        for rid in live:
            row, k, e = self.row[rid], int(valids[self.row[rid]]) - 1, 0
            for j in range(k + 1):
                tok = outs[rid][self.n[rid] + j]
                if not self.check(rid, logits[row, j], tok):
                    break
                e = j + 1
                if j == k or toks[row, j + 1] != tok:
                    break
            if self.live(rid):
                emitted[rid] = e
                if 2 <= e <= k:
                    self.partial.append((idx, e - 1, k))
        if any(e < valids[self.row[rid]] for rid, e in emitted.items()):
            for key, saved in snap.items():
                self.pool.cache[key].copy_(saved)
            valids2 = np.zeros((B,), np.int32)
            for rid, e in emitted.items():
                valids2[self.row[rid]] = e
            self._verify(toks, starts, valids2)
        for rid, e in emitted.items():
            self.advance(rid, e, outs[rid])

    def step(self, rids, outs):
        """One decode step over ``rids`` (each already admitted)."""
        import numpy as np

        torch = self.torch
        live = [rid for rid in rids if self.live(rid)]
        if not live:
            return
        toks = np.zeros((self.pool.num_seqs, 1), np.int32)
        for rid in live:
            toks[self.row[rid], 0] = outs[rid][self.n[rid] - 1]
        self._lengths()
        logits, cache = self.model.decode_step(self.sparams, self.pool.step_cache(),
                                               torch.from_numpy(toks).to(self.dev))
        self.pool.accept(cache)
        logits = logits[:, 0].float().cpu()
        for rid in live:
            if self.check(rid, logits[self.row[rid]], outs[rid][self.n[rid]]):
                self.advance(rid, 1, outs[rid])

    def spec(self, log, outs):
        for idx, ev in enumerate(log):
            if ev["kind"] == "verify":
                self.window(idx, ev, outs)
            elif ev["kind"] == "decode":
                for rid in ev["rids"].values():
                    if rid not in self.n:
                        self.admit(rid, outs[rid])
                self.step(list(ev["rids"].values()), outs)
        self.finish(outs)

    def decode(self, upto, outs):
        """Token ``upto[rid]`` (and every one before it) of each request
        through the decode path, ``num_seqs`` requests at a time."""
        rids, B = sorted(upto), self.pool.num_seqs
        for lo in range(0, len(rids), B):
            group = rids[lo:lo + B]
            for rid in group:
                self.admit(rid, outs[rid])
            while True:
                for rid in group:
                    if self.live(rid) and self.n[rid] > upto[rid]:
                        self.drop(rid)
                if not any(self.live(rid) for rid in group):
                    break
                self.step(group, outs)

    def finish(self, outs):
        short = [rid for rid in outs if rid not in self.ties and self.n.get(rid) != len(outs[rid])]
        if short:
            fail(f"[{self.label}] the replay did not reach the end of requests {short}")
        print(f"  [{self.label}] {self.exact} tokens the argmax of their own path, "
              f"{len(self.ties)} at a flagged tie: {self.ties}")


class SpecLog:
    """Wraps a spec engine's draft step, verify and target decode step to
    log, per verify or decode call, the rows it served (slot -> request)
    and, for a verify, the window it was handed; the first verify after a
    draft roll is the window verify (``kind`` "verify") and a second one
    its fix-up ("fixup").  ``PathReplay.spec`` reads the log."""

    def __init__(self, engine):
        self.engine, self.events, self.open = engine, [], False
        self.draft, self.verify, self.decode = (engine._draft_decode, engine._verify,
                                                engine._decode)
        engine._draft_decode, engine._verify, engine._decode = (
            self._draft_call, self._verify_call, self._decode_call)

    def rids(self):
        return {slot: seq.request.request_id
                for slot, seq in self.engine.scheduler.running.items()}

    def _draft_call(self, *args):
        self.open = False
        return self.draft(*args)

    def _verify_call(self, *args):
        self.events.append({"kind": "fixup" if self.open else "verify", "rids": self.rids(),
                            "args": args[2:5]})
        self.open = True
        return self.verify(*args)

    def _decode_call(self, *args):
        self.events.append({"kind": "decode", "rids": self.rids()})
        return self.decode(*args)

    def numpy(self):
        for ev in self.events:
            if "args" in ev:
                ev["toks"], ev["starts"], ev["valids"] = (a.cpu().numpy() for a in ev.pop("args"))
        return self.events


def first_divergences(label, got, want, n):
    """[(request, index of its first differing token)] of ``got``'s
    greedy streams against ``want``'s, for requests 0..n-1 (each must
    emit as many tokens)."""
    out = []
    for rid in range(n):
        a, b = got.output(rid), want.output(rid)
        if len(a) != len(b):
            fail(f"[{label}] request {rid} emitted {len(a)} tokens, the baseline {len(b)}")
        if a != b:
            out.append((rid, next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)))
    return out


def compare_streams(torch, label, got, want, work, margin_of):
    """``got``'s greedy streams against ``want``'s: equal, or a first
    divergence where ``margin_of(prompt + emitted)`` gives a top-2 margin
    within MARGIN * max|logit|.  Returns the divergences."""
    import numpy as np

    out = []
    for rid, i in first_divergences(label, got, want, len(work)):
        a, b = got.output(rid), want.output(rid)
        margin, top = margin_of(np.concatenate([work[rid][0], np.asarray(b[:i], np.int64)]))
        print(f"  [{label}] request {rid} first diverges at token {i} ({a[i]} against "
              f"{b[i]}); top-2 margin {margin:.4g}, bound {MARGIN} * {top:.4g} = "
              f"{MARGIN * top:.4g}")
        out.append({"request": rid, "token": i, "margin": margin, "bound": MARGIN * top})
        if margin > MARGIN * top:
            fail(f"[{label}] request {rid} diverged at token {i} where the top-2 margin "
                 f"{margin:.4g} exceeds {MARGIN} * max|logit| = {MARGIN * top:.4g}")
    print(f"  [{label}] greedy streams: {len(work) - len(out)} of {len(work)} equal the "
          f"baseline's, {len(out)} diverge at a flagged tie")
    return out


def card_margin(torch, r):
    """``prefill_margin`` on a serving path's params, in its prefill chunks."""
    return lambda toks: prefill_margin(torch, r["model"], r["sparams"], toks,
                                       chunk=r["args"].prefill_chunk)


def cell_summary(r, keys=("tokens_per_s", "decode_step_p50_ms", "decode_tok_p50_ms",
                          "prefill_launches", "prefix_hits", "prefix_lookups",
                          "prefix_hit_rate", "recompiles", "preemptions")):
    m = r["metrics"]
    out = {k: m.get(k) for k in keys}
    out["ttft_p50_s"] = statistics.median(q["ttft_s"] for q in m["requests"])
    out["prefix_cache"] = m.get("prefix_cache")
    out["cache_bytes"] = r["engine"].pool.cache_bytes()
    if "spec" in m:
        out["spec"] = m["spec"]
    out["counts"] = r["counts"]
    return out


def tenant_prefix(torch, built, need):
    """Phase 3f: glm4-9b at its published widths, two tenants sharing a
    192-token system prompt (12 full blocks) in 256-token prompts, 8
    requests on 4 rows, gen 16-32 (up to 288 tokens a sequence): with the
    prefix cache, and again with ``--no-prefix-cache`` on the same params."""
    on = serve_path(torch, "tenants, prefix cache", ["--bits", "4"], need, built, TENANTS)
    off = serve_path(torch, "tenants, no prefix cache", ["--bits", "4", "--no-prefix-cache"],
                     need, built, TENANTS)
    mo, mf = on["metrics"], off["metrics"]
    pc = mo["prefix_cache"]
    for label, r in (("on", on), ("off", off)):
        m = r["metrics"]
        print(f"  3f cache {label}: tokens/s {m['tokens_per_s']:.2f}, TTFT p50 "
              f"{cell_summary(r)['ttft_p50_s']:.4f} s, prefill launches "
              f"{m['prefill_launches']}, hit rate {m['prefix_hit_rate']:.4f}, hits "
              f"{m['prefix_hits']}/{m['prefix_lookups']}, hit tokens "
              f"{m['prefix_cache']['hit_tokens']}, COW {m['prefix_cache']['cow_copies']}, "
              f"evictions {m['prefix_cache']['evictions']}, cached blocks "
              f"{m['prefix_cache']['cached_blocks']}, cache bytes "
              f"{r['engine'].pool.cache_bytes()}, recompiles {m['recompiles']}")
    if (mo["prefix_hits"], mo["prefix_lookups"], pc["hit_tokens"]) != (6, 8, 1152):
        fail(f"[3f] want 6 hits in 8 lookups and 1,152 hit tokens: {mo['prefix_hits']} / "
             f"{mo['prefix_lookups']}, {pc['hit_tokens']}")
    if not mo["prefill_launches"] < mf["prefill_launches"]:
        fail(f"[3f] prefill launches {mo['prefill_launches']} with the cache, "
             f"{mf['prefill_launches']} without")
    if mf["prefix_lookups"] or mf["prefix_cache"]["enabled"]:
        fail("[3f] --no-prefix-cache consulted the trie")
    diverged = compare_streams(torch, "3f cache on vs off", on["engine"], off["engine"],
                               on["work"], card_margin(torch, on))
    return {"on": cell_summary(on), "off": cell_summary(off), "diverged": diverged}


def concurrency_gate(torch, built):
    """Phase 3g: the reference benchmark's gate at full width: 2 tenants, 8
    requests on 8 rows, the whole 192-token prefix shared in 256-token
    prompts, gen 8, one arrival per step, a pool of 2 * 12 + 8 * (17 - 12)
    + 8 + 2 + 1 = 75 blocks; the sharing engine against the one without,
    at equal cache bytes."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine

    cfg, model, sparams, _ = built
    S, plen, gen, bs, n, T = 192, 256, 8, 16, 8, 2
    max_len = plen + gen + 1
    bps = -(-max_len // bs)
    blocks = T * (S // bs) + n * (bps - S // bs) + n + 2 + 1
    sys_prompts = np.random.default_rng(11).integers(0, cfg.vocab_size, (T, S))
    prompts = np.random.default_rng(29).integers(0, cfg.vocab_size, (n, plen))
    for i in range(n):
        prompts[i, :S] = sys_prompts[i % T]
    work = [(prompts[i], gen + 1) for i in range(n)]
    out, engines = {}, {}
    for sharing in (False, True):
        label = "3g sharing" if sharing else "3g baseline"
        eng = ServeEngine(model, sparams, num_slots=n, max_len=max_len, block_size=bs,
                          num_blocks=blocks, prefill_chunk=64, prefix_cache=sharing,
                          device="cuda")
        ops.reset_counts()
        t0 = time.perf_counter()
        submitted = peak = 0
        while submitted < n or eng.scheduler.has_work():
            while submitted < n and eng.steps >= submitted:
                eng.submit(*work[submitted])
                submitted += 1
            eng.step()
            peak = max(peak, eng.num_running)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m, counts = eng.metrics(), dict(ops.counts)
        if any(r["state"] != "finished" or r["new_tokens"] != gen + 1 for r in m["requests"]):
            fail(f"[{label}] a request did not finish with {gen + 1} tokens")
        if m["recompiles"] != 0 or counts["plain"] != 0 or counts["paged_attention"] <= 0:
            fail(f"[{label}] recompiles {m['recompiles']}, launch counts {counts}")
        out[label] = {"peak_running": peak, "cache_bytes": eng.pool.cache_bytes(),
                      "num_blocks": blocks, "tokens_per_s": m["tokens_per_s"],
                      "prefill_launches": m["prefill_launches"],
                      "preemptions": m["preemptions"], "prefix_cache": m["prefix_cache"],
                      "wall_s": wall, "counts": counts}
        print(f"  [{label}] {blocks} blocks, cache bytes {eng.pool.cache_bytes()}, peak running "
              f"rows {peak}, tokens/s {m['tokens_per_s']:.2f}, prefill launches "
              f"{m['prefill_launches']}, preemptions {m['preemptions']}, hits "
              f"{m['prefix_hits']}/{m['prefix_lookups']}, recompiles {m['recompiles']}, "
              f"wall {wall:.2f} s")
        engines[sharing] = eng
    base, shared = out["3g baseline"], out["3g sharing"]
    if base["cache_bytes"] != shared["cache_bytes"]:
        fail(f"[3g] cache bytes differ: {base['cache_bytes']} against {shared['cache_bytes']}")
    if not shared["peak_running"] > base["peak_running"]:
        fail(f"[3g] peak running rows {shared['peak_running']} with sharing, "
             f"{base['peak_running']} without: want more with sharing")
    out["diverged"] = compare_streams(
        torch, "3g sharing vs baseline", engines[True], engines[False], work,
        lambda toks: prefill_margin(torch, model, sparams, toks))
    return out


def spec_cell(torch, fp, need):
    """Phase 3h: 3a's workload and params with ``--spec-k 4 --draft-bits
    2``: greedy streams 3a's, up to flagged ties."""
    r = serve_path(torch, "fp KV, spec", ["--bits", "4", *SPEC], need,
                   tuple(fp[k] for k in ("cfg", "model", "sparams", "policy")))
    diverged = compare_streams(torch, "3h spec vs 3a", r["engine"], fp["engine"], fp["work"],
                               card_margin(torch, fp))
    return {**cell_summary(r), "diverged": diverged}


def snapped_build(torch, arch="glm4-9b", snap=True, layers=None):
    """``arch`` at its published widths (``layers`` deep where given),
    params from seed 0 snapped to the 2-bit grid (``snap_params_to_grid``;
    with ``snap`` False, as drawn), packed at 4 bits: the 2-bit draft's
    levels are exact at 4 bits."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.quant.qat import policy_for
    from repro_torch.spec import snap_params_to_grid
    from repro_torch.train.serve import quantize_for_serving

    t0 = time.perf_counter()
    cfg = get_config(arch, smoke=False)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    if snap:
        params = snap_params_to_grid(model, params, 2)
    policy = policy_for(model, 4)
    sparams = quantize_for_serving(model, params, policy, device="cuda")
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"  {'snapped ' if snap else ''}{arch} params ({cfg.num_layers} layers) packed at "
          f"4 bits in {time.perf_counter() - t0:.1f} s")
    return cfg, model, sparams, policy


class CallClock:
    """Stands in for a function of the engine: per call, the host clock,
    a CUDA-event span and the hand-kernel launches (``kernels.ops``); with
    ``profile`` set, the call runs under ``torch.profiler`` and records its
    device busy time and its CUDA kernel count instead."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.calls, self.profile = torch, fn, [], False

    def __call__(self, *args):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.kernels import ops

        torch = self.torch
        before = dict(ops.counts)
        if self.profile:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = self.fn(*args)
                torch.cuda.synchronize()
            evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0]
            rec = {"device_ms": sum(e.self_device_time_total for e in evs) / 1e3,
                   "kernels": sum(e.count for e in evs)}
        else:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = self.fn(*args)
            end.record()
            rec = {"host_ms": (time.perf_counter() - t0) * 1e3, "events": (start, end)}
        rec["hand_launches"] = sum(n - before[k] for k, n in ops.counts.items() if k != "plain")
        self.calls.append(rec)
        return out


def spec_breakdown(torch, built, steps=3):
    """One spec step's parts (k = 4, 4 rows decoding): the draft's decode
    steps (graph replays) and the eager verify, each by the host clock and
    a CUDA-event span (``steps`` steps), then by device busy time under
    the profiler (one more step)."""
    import numpy as np

    from repro_torch.serve import ServeEngine
    from repro_torch.spec import SpecConfig

    cfg, model, sparams, _ = built
    eng = ServeEngine(model, sparams, num_slots=4, max_len=160, block_size=16,
                      prefill_chunk=64, spec=SpecConfig(k=4, draft_bits=2), device="cuda")
    draft, verify = CallClock(torch, eng._draft_decode), CallClock(torch, eng._verify)
    eng._draft_decode, eng._verify = draft, verify
    rng = np.random.default_rng(5)
    for _ in range(4):
        eng.submit(rng.integers(0, cfg.vocab_size, 64), 80)
    eng.step()                          # admissions, captures and the first window
    eng.step()
    torch.cuda.synchronize()
    out = {}
    for mode in ("timed", "profiled"):
        draft.calls, verify.calls = [], []
        draft.profile = verify.profile = mode == "profiled"
        n = steps if mode == "timed" else 1
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n * 1e3
        rec = {"step_ms": step_ms}
        for name, clock in (("draft", draft), ("verify", verify)):
            calls = clock.calls
            if mode == "timed":
                rec[name] = {"host_ms": sum(c["host_ms"] for c in calls) / n,
                             "event_ms": sum(c["events"][0].elapsed_time(c["events"][1])
                                             for c in calls) / n}
            else:
                rec[name] = {"device_ms": sum(c["device_ms"] for c in calls) / n,
                             "kernels": sum(c["kernels"] for c in calls) // n}
            rec[name]["calls"] = len(calls) // n
            rec[name]["hand_launches"] = sum(c["hand_launches"] for c in calls) // n
        out[mode] = rec
    t, p = out["timed"], out["profiled"]
    print(f"  [3i breakdown] a spec step (4 rows, k 4): {t['step_ms']:.2f} ms host clock; "
          f"draft {t['draft']['calls']} decode steps: host {t['draft']['host_ms']:.3f} ms, "
          f"event span {t['draft']['event_ms']:.3f} ms, device busy "
          f"{p['draft']['device_ms']:.3f} ms, {p['draft']['kernels']} kernels "
          f"({t['draft']['hand_launches']} hand-kernel launches); verify: host "
          f"{t['verify']['host_ms']:.3f} ms, event span {t['verify']['event_ms']:.3f} ms, "
          f"device busy {p['verify']['device_ms']:.3f} ms, {p['verify']['kernels']} kernels "
          f"({t['verify']['hand_launches']} hand-kernel launches)")
    m = eng.metrics()
    if m["recompiles"] != 0 or eng.graph_captures["draft"] != 1:
        fail(f"[3i breakdown] recompiles {m['recompiles']}, captures {eng.graph_captures}")
    eng.run_until_drained()
    return out


class RejectionMargins:
    """Stands in for the engine's verify and reads its logits after each
    call: in every row's window, the proposals, those the target's argmax
    accepts (counted as ``greedy_window`` counts them) and, at the first proposal
    it rejects, the target's top-2 margin, its logit gap from its argmax
    down to the rejected proposal, and max|logit| there."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.calls, self.rejections = torch, fn, 0, []
        self.proposed = self.accepted = 0

    def __call__(self, params, cache, tokens, starts, valids):
        logits, cache = self.fn(params, cache, tokens, starts, valids)
        lg = logits[:, :-1].float()                     # position j scores proposal j + 1
        top = lg.topk(2, dim=-1).values                 # argmax as the engine breaks ties
        prop = tokens[:, 1:].long()
        gap = top[..., 0] - lg.gather(-1, prop[..., None])[..., 0]
        tops, prop, vals, gap, peak, valids = (
            t.cpu().numpy() for t in (lg.argmax(-1), prop, top, gap, lg.abs().amax(-1),
                                      valids))
        for row, valid in enumerate(valids):
            self.proposed += max(int(valid) - 1, 0)
            for j in range(max(int(valid) - 1, 0)):
                if prop[row, j] == tops[row, j]:
                    self.accepted += 1
                    continue
                self.rejections.append({
                    "verify": self.calls, "row": row, "position": j,
                    "draft": int(prop[row, j]), "target": int(tops[row, j]),
                    "margin": float(vals[row, j, 0] - vals[row, j, 1]),
                    "gap": float(gap[row, j]), "bound": MARGIN * float(peak[row, j])})
                break
        self.calls += 1
        return logits, cache


def spec_witness(torch, r):
    """3i's spec workload on the same params through an engine whose draft
    and target decode steps run ``model.decode_step`` eagerly: the two
    captured graphs' witness at full width.  Its greedy streams and its
    window, proposed and accepted counts must equal the graphed run's
    bitwise.  Its verify reads each rejection's margins
    (:class:`RejectionMargins`); a rejection is allowed only where the
    target's gap down to the rejected proposal is within MARGIN *
    max|logit| (the draft's weights equal the target's on the snapped
    grid: only the summation order differs)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import SamplingParams, ServeEngine
    from repro_torch.spec import SpecConfig

    a, graphed = r["args"], r["engine"]
    engine = ServeEngine(r["model"], r["sparams"], num_slots=a.num_slots,
                         max_len=a.prompt_len + a.gen + 1, block_size=a.block_size,
                         prefill_chunk=a.prefill_chunk,
                         spec=SpecConfig(k=a.spec_k, draft_bits=a.draft_bits),
                         decode_fn=r["model"].decode_step, device="cuda")
    witness = RejectionMargins(torch, engine._verify)
    engine._verify = witness
    ops.reset_counts()
    t0 = time.perf_counter()
    launcher.drive(engine, r["work"], a.arrival_every, SamplingParams(temperature=a.temperature))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts, m, mg = dict(ops.counts), engine.metrics(), graphed.metrics()
    caps = engine.graph_captures
    if caps["decode"] or caps.get("draft", 0) or counts["plain"] != 0 or counts["qmm_bitserial"] <= 0:
        fail(f"[3i eager] the eager decode steps were captured {caps}; launch counts {counts}")
    for rid in range(len(r["work"])):
        if engine.output(rid) != graphed.output(rid):
            fail(f"[3i eager] request {rid} gave {engine.output(rid)}, the graphed spec run "
                 f"{graphed.output(rid)}")
    if m["spec"] != mg["spec"]:
        fail(f"[3i eager] spec counts {m['spec']}, the graphed run's {mg['spec']}")
    sp = m["spec"]
    if (witness.proposed, witness.accepted) != (sp["proposed"], sp["accepted"]):
        fail(f"[3i eager] the verify's logits hold {witness.proposed} proposals and accept "
             f"{witness.accepted}: the engine counted {sp}")
    for rej in witness.rejections:
        print(f"  [3i eager] verify {rej['verify']} row {rej['row']} position {rej['position']}: "
              f"draft {rej['draft']} against the target's {rej['target']}; top-2 margin "
              f"{rej['margin']:.4g}, gap to the draft's token {rej['gap']:.4g}, bound "
              f"{rej['bound']:.4g}")
        if rej["gap"] > rej["bound"]:
            fail(f"[3i eager] a rejection at a gap {rej['gap']:.4g} over the tie bound "
                 f"{rej['bound']:.4g}: {rej}")
    gaps = sorted(rej["gap"] for rej in witness.rejections)
    print(f"  [3i eager] greedy streams and spec counts ({sp['windows']} windows, "
          f"{sp['proposed']} proposed, {sp['accepted']} accepted) equal the graphed run's "
          f"bitwise; {len(gaps)} rejections, every one within the tie bound (gaps "
          f"{gaps[0] if gaps else 0:.4g}-{gaps[-1] if gaps else 0:.4g}); tokens/s "
          f"{m['tokens_per_s']:.2f}, wall {wall_s:.2f} s")
    return {"metrics": {k: m[k] for k in ("tokens_per_s", "decode_tok_p50_ms", "spec")},
            "counts": counts, "wall_s": wall_s, "rejections": witness.rejections}


def spec_ceiling(torch, need):
    """Phase 3i: spec decoding's mechanical ceiling at full width: params
    snapped to the 2-bit grid, served at 4 bits with and without a 2-bit
    draft (k = 4) on the cell's workload (8 requests on 4 rows)."""
    built = snapped_build(torch)
    spec = serve_path(torch, "snapped, spec", ["--bits", "4", *SPEC], need, built)
    plain = serve_path(torch, "snapped, no spec", ["--bits", "4"], need, built)
    for label, r in (("spec", spec), ("no spec", plain)):
        m = r["metrics"]
        acc = m["spec"]["acceptance_rate"] if "spec" in m else None
        print(f"  3i {label}: acceptance {acc}, decode_tok_p50 {m['decode_tok_p50_ms']:.3f} ms, "
              f"decode_step_p50 {m['decode_step_p50_ms']:.3f} ms, tokens/s "
              f"{m['tokens_per_s']:.2f}")
    diverged = compare_streams(torch, "3i spec vs no spec", spec["engine"], plain["engine"],
                               plain["work"], card_margin(torch, plain))
    out = {"spec": cell_summary(spec), "no spec": cell_summary(plain), "diverged": diverged,
           "eager": spec_witness(torch, spec)}
    del spec, plain
    out["breakdown"] = spec_breakdown(torch, built)
    return out


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


def profile_decode(torch, engine, work, timed=4, traced=4, family=None):
    """Decode-only steps on 4 running rows: host-clock step time, then a
    torch.profiler trace for device time by kernel family (the sampler
    graph's argmax as its own); ``family(kernel name)`` names a family
    first where it returns one."""
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
        fam = (family and family(name)) or (
               "sampler graph" if "ArgMax" in name
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
            "idle_share": 1 - busy / step_ms, "traced_steps": traced}


# ---- the LM QAT path at glm4-9b's widths (phases 2, 3j, 3k, 4j, 5j) ---------
LM_LAYERS = 4              # depth cut from 40: 40 layers' weights + f32 moments need ~113 GB
LM_WEIGHTS = 2_057_306_112  # quantized: 4 x 203,948,032 + embed and lm_head at 620,756,992
LM_PARAMS = LM_WEIGHTS + 9 * 4096   # + the norm gains: 2 a layer and the final norm
# lr 3e-4: at the launcher's default 3e-3 (the reference's, for its smoke
# models) the loss rose from 12.45 to 16.7 in 20 steps at this width
LM_TRAIN = ["--arch", "glm4-9b", "--no-smoke", "--global-batch", "2", "--seq-len", "4096",
            "--remat", "full", "--bits", "8", "--lr", "3e-4", "--device", "cuda"]
LM_UNIFORM_STEPS, LM_MIXED_STEPS = 20, 5
LM_EPISODES = 4


def lm_cell():
    """glm4-9b at its published widths, depth cut to ``LM_LAYERS``."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("glm4-9b"), num_layers=LM_LAYERS)


def lm_mixed_policy(model):
    """Group i at QAT_BITS[i % 7]; the frozen groups (embed, lm_head) at 8."""
    from repro_torch.quant.policy import QuantPolicy

    groups, frozen = model.quant_groups(), model.frozen_bits()
    return QuantPolicy.from_array(tuple(g.name for g in groups),
                                  [frozen.get(g.name, QAT_BITS[i % len(QAT_BITS)])
                                   for i, g in enumerate(groups)])


def lm_leaves():
    """(path, shape) of the bits map's leaves at the 4-layer cell, in
    quantize_params' order: embed, wq, wk, wv, wo, wg, wu, wd, lm_head."""
    from repro_torch.models import build_model

    out = {}
    for g in build_model(lm_cell()).quant_groups():
        out.setdefault("/".join(map(str, g.path)),
                       g.shape if g.layer is None else (LM_LAYERS, *g.shape))
    return list(out.items())


def col_bits(torch, shapes, offset):
    """Per leaf an int32 bits tensor on the card: FQ_BITS cycling over the
    layers of the leading dims from ``offset``."""
    out = []
    for i, shape in enumerate(shapes):
        L = math.prod(shape[:-2])
        vals = [FQ_BITS[(i + l + offset) % len(FQ_BITS)] for l in range(L)]
        out.append(torch.tensor(vals if len(shape) > 2 else vals[0], dtype=torch.int32,
                                device="cuda"))
    return out


def col_inputs(torch, shapes, dtype, gen, edges=False):
    """Leaves of ``shapes`` with a -0.0 and a 0.0 each, gradients with +-inf,
    NaN and a negative value each; ``edges`` adds a leaf with an all-zero
    column, one with a NaN and one near the eps floor."""
    ws, gs = [], []
    for shape in shapes:
        w = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w.view(-1)[:2] = torch.tensor([-0.0, 0.0], device="cuda", dtype=dtype)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g.view(-1)[:4] = torch.tensor([float("inf"), float("nan"), -3.0, float("-inf")],
                                      device="cuda", dtype=dtype)
        ws.append(w)
        gs.append(g)
    if edges:
        zero_col = torch.randn((2, 40, 24), generator=gen, device="cuda")
        zero_col[1, :, 5] = 0.0
        nan = torch.randn((3, 17, 40), generator=gen, device="cuda")
        nan[2, 3, 11] = float("nan")
        near = 1.0005e-8 if dtype == torch.float32 else 9.95e-9
        tiny = torch.linspace(-1, 1, 2 * 31 * 16, device="cuda").reshape(2, 31, 16) * near
        for w in (zero_col, nan, tiny):
            ws.append(w.to(dtype))
            gs.append(torch.linspace(-2, 2, w.numel(), device="cuda").reshape(w.shape).to(dtype))
    return ws, gs


def check_col_bitwise(torch, what, ws, gs, bits):
    """The per-column pair against its plain versions, bit pattern for bit
    pattern (outputs, scales, gradients); the plain outputs are freed
    before the backward's are made."""
    from repro_torch.kernels.fake_quant import (fake_quant_group_col_bwd_cuda,
                                                fake_quant_group_col_cuda)
    from repro_torch.kernels.ref import fake_quant_group_col_bwd_ref, fake_quant_group_col_ref

    outs, scales, launches = fake_quant_group_col_cuda(ws, bits)
    torch.cuda.synchronize()
    for i, (w, b) in enumerate(zip(ws, bits)):
        (want,), (want_s,) = fake_quant_group_col_ref([w], [b])
        if not same_bits(torch, scales[i], want_s):
            fail(f"{what}: leaf {i} {tuple(w.shape)}: the scales differ from tensor_scale's")
        if not same_bits(torch, outs[i], want):
            fail(f"{what}: leaf {i} {tuple(w.shape)} at bits {b.tolist()} differs from "
                 f"the plain version")
        del want
    del outs
    grads, bwd_launches = fake_quant_group_col_bwd_cuda(ws, gs, scales)
    torch.cuda.synchronize()
    for i in range(len(ws)):
        (want,) = fake_quant_group_col_bwd_ref([ws[i]], [gs[i]], [scales[i]])
        if not same_bits(torch, grads[i], want):
            fail(f"{what}: the STE gradient of leaf {i} {tuple(ws[i].shape)} differs")
        del want
    if (launches, bwd_launches) != (1, 1):
        fail(f"{what}: {launches} forward and {bwd_launches} backward launches, not 1 and 1")


def library_col(torch, ws, bits_host):
    """The library's per-column QDQ of every layer of every leaf:
    ``abs().amax(dim=-2)`` and ``fake_quantize_per_channel_affine`` (axis
    1, scale max|w| / n), on the leaves themselves where it takes their
    dtype, else on f32 copies made here (-> fn, the leaves it takes, the
    dtype it ran in)."""
    def run(leaves):
        outs = []
        for w, bl in zip(leaves, bits_host):
            w3 = w.reshape(-1, *w.shape[-2:])
            for l in range(w3.shape[0]):
                b = bl[l] if len(bl) > 1 else bl[0]
                n = 1 if b < 2 else min((1 << (b - 1)) - 1, 1 << 15)
                s = (w3[l].abs().amax(dim=-2).float() / n).detach()
                zp = torch.zeros(s.shape, dtype=torch.int32, device="cuda")
                outs.append(torch.fake_quantize_per_channel_affine(w3[l], s, zp, 1, -n, n))
        return outs

    try:
        run([w[..., :2, :2].contiguous() for w in ws])
        return run, list(ws), str(ws[0].dtype)[6:]
    except RuntimeError:
        f32 = [w.float() for w in ws]
        return run, f32, "float32 copies (the library refuses bf16)"


def check_fake_quant_col(torch, timer, peaks, rows):
    """Phase 2, the per-column grouped fake-quant of the LM QAT path:
    forward and STE backward bit pattern for bit pattern against the plain
    versions at the 4-layer glm4-9b cell's nine leaves (bf16 and f32; embed
    reduces over 151,552 rows), at LeNet's weight shapes with a ragged
    (3, 7, 300) and the edge leaves (bits cycling through 1-8, 16 and 32
    from three offsets), then timed per QAT forward and backward at the
    cell in bf16 at the mixed policy of phase 3j, against the library
    (per layer: amax + fake_quantize_per_channel_affine, and its autograd
    backward), the plain versions and the bound."""
    from repro_torch.kernels.fake_quant import (fake_quant_col_plan,
                                                fake_quant_group_col_bwd_cuda,
                                                fake_quant_group_col_cuda)
    from repro_torch.kernels.ref import fake_quant_group_col_bwd_ref, fake_quant_group_col_ref
    from repro_torch.models import build_model
    from repro_torch.quant.qat import bits_assignment, bits_to_device

    f32_peak = f32_peak_of(torch)
    gen = torch.Generator(device="cuda").manual_seed(17)
    glm = [shape for _, shape in lm_leaves()]
    small = [shape for _, shape in weight_shapes("lenet")] + [(3, 7, 300)]
    for dtype in (torch.bfloat16, torch.float32):
        ws, gs = col_inputs(torch, small, dtype, gen, edges=True)
        for offset in range(3):
            check_col_bitwise(torch, f"fake_quant_col lenet {str(dtype)[6:]}", ws, gs,
                              col_bits(torch, [w.shape for w in ws], offset))
        print(f"  {'fake_quant_col lenet+ragged ' + str(dtype)[6:]:46s} forward and backward "
              f"bitwise at 3 bits offsets ({len(ws)} leaves incl. zero column, NaN, near eps)")
        del ws, gs
        ws, gs = col_inputs(torch, glm, dtype, gen)
        plan = fake_quant_col_plan([w.shape for w in ws], dtype)
        check_col_bitwise(torch, f"fake_quant_col glm4-9b 4L {str(dtype)[6:]}", ws, gs,
                          col_bits(torch, glm, 0))
        print(f"  {'fake_quant_col glm4-9b 4L ' + str(dtype)[6:]:46s} forward and backward "
              f"bitwise (9 leaves, {plan.ctas[0]} CTAs, K split over {plan.split})")
        del ws, gs
        torch.cuda.empty_cache()
    # timing: one QAT forward and backward of the cell, bf16, phase 3j's mixed policy
    ws, gs = col_inputs(torch, glm, torch.bfloat16, gen)
    model = build_model(lm_cell())
    bmap = bits_assignment(model.quant_groups(), lm_mixed_policy(model))
    bits = list(bits_to_device(bmap, "cuda").values())
    bits_host = [[int(b) for b in v.reshape(-1)] for v in bmap.values()]
    plan = fake_quant_col_plan([w.shape for w in ws], torch.bfloat16)
    numel = sum(w.numel() for w in ws)
    n_scales = sum(math.prod(w.shape[:-2]) * w.shape[-1] for w in ws)
    outs, scales, _ = fake_quant_group_col_cuda(ws, bits)
    lib, lib_leaves, lib_dtype = library_col(torch, ws, bits_host)
    b_ms, b_by = bound_ms(2 * numel * 2 + 4 * n_scales, (FQ_OPS + 2) * numel,
                          (peaks[0], f32_peak))
    fwd = {"kernel": "fake_quant_group_col", "shape": "glm4-9b 4L", "dtype": "bfloat16",
           "leaves": len(ws), "numel": numel, "plan": plan._asdict(), "calls_per_forward": 1,
           "max_abs_err": 0.0,
           "ms": timer(lambda: fake_quant_group_col_cuda(ws, bits), iters=7),
           "plain_ms": timer(lambda: fake_quant_group_col_ref(ws, bits), iters=3, warmup=1),
           "library_ms": timer(lambda: lib(lib_leaves), iters=5, warmup=1),
           "library": f"per layer of each leaf: abs().amax(dim=-2) + "
                      f"fake_quantize_per_channel_affine (axis 1), in {lib_dtype}",
           "bound_ms": b_ms, "bound_by": b_by}
    leaves = [w.detach().requires_grad_(True) for w in lib_leaves]
    lib_outs = lib(leaves)
    lib_gs = []                      # one per layer of each leaf, as the library's outputs
    for w, g in zip(lib_leaves, gs):
        lib_gs += g.to(w.dtype).reshape(-1, *w.shape[-2:]).unbind(0)

    def library_bwd():
        return torch.autograd.grad(lib_outs, leaves, lib_gs, retain_graph=True)

    bb_ms, bb_by = bound_ms(3 * numel * 2 + 4 * n_scales, 3 * numel, (peaks[0], f32_peak))
    bwd = {"kernel": "fake_quant_group_col_bwd", "shape": "glm4-9b 4L", "dtype": "bfloat16",
           "leaves": len(ws), "numel": numel, "calls_per_forward": 1, "max_abs_err": 0.0,
           "ms": timer(lambda: fake_quant_group_col_bwd_cuda(ws, gs, scales), iters=7),
           "plain_ms": timer(lambda: fake_quant_group_col_bwd_ref(ws, gs, scales), iters=3,
                             warmup=1),
           "library_ms": timer(library_bwd, iters=5, warmup=1),
           "library": f"the autograd backward of the library forward, in {lib_dtype}",
           "bound_ms": bb_ms, "bound_by": bb_by}
    rows += [fwd, bwd]
    print(f"  {'fake_quant_col glm4-9b 4L bf16 (9 leaves)':46s} per QAT forward: "
          f"kernel={fwd['ms']:.4f} plain={fwd['plain_ms']:.4f} library={fwd['library_ms']:.4f} "
          f"({lib_dtype}) bound={b_ms:.4f} ms ({b_by})")
    print(f"  {'':46s} per QAT backward: kernel={bwd['ms']:.4f} plain={bwd['plain_ms']:.4f} "
          f"library={bwd['library_ms']:.4f} bound={bb_ms:.4f} ms ({bb_by})")
    del ws, gs, outs, scales, leaves, lib_outs, lib_gs, lib_leaves
    torch.cuda.empty_cache()
    return 0.0


def lm_train(torch):
    """Phase 3j: QAT training at the 4-layer glm4-9b cell through
    ``repro_torch.launch.train``'s path (``setup``: ``Trainer`` +
    ``make_train_step``, ``--remat full``): LM_UNIFORM_STEPS steps at
    uniform 8 bits, then LM_MIXED_STEPS at the mixed policy, each step's
    launches counted apart."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.quant.qat import bits_assignment, bits_to_device

    args = train.parse_args(LM_TRAIN + ["--steps", str(LM_UNIFORM_STEPS)])
    t0 = time.perf_counter()
    run = train.setup(args, lm_cell())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model, trainer = run["model"], run["trainer"]
    n = sum(p.numel() for p in tree_leaves(run["state"]["params"]))
    n_w = sum(g.n_weights for g in model.quant_groups())
    if (n, n_w) != (LM_PARAMS, LM_WEIGHTS):
        fail(f"[lm train] {n:,} params of which {n_w:,} quantized, not {LM_PARAMS:,} "
             f"and {LM_WEIGHTS:,}")
    per_step = []
    inner = trainer.step_fn

    def counted(state, batch, bits_map):
        before = dict(ops.counts)
        out = inner(state, batch, bits_map)
        per_step.append({k: v - before[k] for k, v in ops.counts.items() if v != before[k]})
        return out

    trainer.step_fn = counted
    trainer.log_every = 5
    ops.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.run(run["state"], LM_UNIFORM_STEPS)
    trainer.bits_map = bits_to_device(bits_assignment(model.quant_groups(),
                                                      lm_mixed_policy(model)), "cuda")
    state = trainer.run(state, LM_UNIFORM_STEPS + LM_MIXED_STEPS, start_step=LM_UNIFORM_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.counts)
    losses = [h["loss"] for h in trainer.history]
    dts = [h["dt"] for h in trainer.history]
    if len(losses) != LM_UNIFORM_STEPS + LM_MIXED_STEPS or not all(map(math.isfinite, losses)):
        fail(f"[lm train] losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[LM_UNIFORM_STEPS - 5:LM_UNIFORM_STEPS])
    if not last < first:
        fail(f"[lm train] the loss did not fall: mean of the first 5 {first:.4f}, of the last 5 "
             f"uniform steps {last:.4f}")
    want = {"fake_quant_group_col": 1, "fake_quant_group_col_bwd": 1}
    bad = [i for i, c in enumerate(per_step) if c != want]
    if bad or counts["plain"]:
        fail(f"[lm train] steps {bad} launched {[per_step[i] for i in bad]}, not {want}; "
             f"plain calls {counts['plain']}")
    p50 = statistics.median(dts[2:])
    tokens = 2 * 4096
    out = {"setup_s": setup_s, "wall_s": wall, "losses": losses, "step_s": dts,
           "step_p50_ms": p50 * 1e3, "tokens_per_s": tokens / p50,
           "uniform_p50_ms": statistics.median(dts[2:LM_UNIFORM_STEPS]) * 1e3,
           "mixed_p50_ms": statistics.median(dts[LM_UNIFORM_STEPS:]) * 1e3,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_step": per_step[-1], "counts": counts, "params": n}
    print(f"[lm train] glm4-9b widths, {LM_LAYERS} layers ({n:,} params), batch 2 x 4096, "
          f"remat full: losses {losses[0]:.4f} -> {losses[LM_UNIFORM_STEPS - 1]:.4f} (uniform 8) "
          f"-> {losses[-1]:.4f} (mixed); first-5 mean {first:.4f}, last-5 uniform mean "
          f"{last:.4f}")
    print(f"[lm train] step p50 {out['step_p50_ms']:.1f} ms (uniform {out['uniform_p50_ms']:.1f}, "
          f"mixed {out['mixed_p50_ms']:.1f}), {out['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{out['peak_mem_gib']:.2f} GiB, setup {setup_s:.1f} s; launches per step "
          f"{per_step[-1]}; counts {counts}")
    return run, state, out


def lm_search_phase(torch, model, params):
    """Phase 3k: ``launch/lm_search.py --lockstep``'s path on 3j's params:
    the LM env factory (2 retrain steps from a fresh ``opt.init``, no
    remat, as the reference's factory), ``episode_end``, LM_EPISODES
    episodes."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.launch import lm_search

    data = SyntheticLMData(seed=1, global_batch=2, seq_len=4096, vocab=model.cfg.vocab_size)
    ops.reset_counts()
    t0 = time.perf_counter()
    factory, res = lm_search.search(model, params, data, LM_EPISODES, "cuda", finetune_steps=2,
                                    eval_mode="episode_end", log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.counts)
    names = {g.name for g in model.quant_groups()}
    if len(res.episodes) != LM_EPISODES or set(res.best_bits) != names:
        fail(f"[lm search] {len(res.episodes)} episodes, best bits over "
             f"{len(res.best_bits)} of {len(names)} groups")
    if res.best_reward != max(e["reward"] for e in res.episodes):
        fail("[lm search] best reward is not the best episode's")
    for name, b in model.frozen_bits().items():
        if res.best_bits[name] != b:
            fail(f"[lm search] frozen group {name} left {b} bits")
    accs = [e["acc"] for e in res.episodes]
    if not all(math.isfinite(a) and a > 0 for a in accs):
        fail(f"[lm search] accuracy proxies {accs}")
    if (counts["fake_quant_group_col"] <= 0 or counts["fake_quant_group_col_bwd"] <= 0
            or counts["plain"]):
        fail(f"[lm search] launch counts {counts}")
    stats = res.cache_stats
    if not stats or stats["misses"] < 1:
        fail(f"[lm search] the memo's stats are missing: {stats}")
    out = {"episodes": LM_EPISODES, "wall_s": wall, "episodes_per_s": LM_EPISODES / wall,
           "acc": accs, "rewards": [e["reward"] for e in res.episodes],
           "best_reward": res.best_reward, "avg_bits": res.average_bits(),
           "best_bits": res.best_bits, "cache": stats, "counts": counts}
    print(f"[lm search] {LM_EPISODES} episodes in {wall:.1f} s; acc proxies "
          f"{[round(a, 4) for a in accs]}; best reward {res.best_reward:.4f}, avg bits "
          f"{out['avg_bits']:.2f}; memo {stats}; launch counts {counts}")
    return out


def lm_step_card_vs_cpu(torch):
    """Phase 4j: one LM QAT train step (mixed bits, AdamW lr 1e-3 without
    decay) on the card and on the CPU from the same params, on a small
    model with head dim 128 (2 layers, d_model 256, 4 heads over 2 KV
    heads, vocab 4096, batch 2 x 256, q chunk 64 and kv chunk 128: 4 x 2
    flash tiles).  Tolerances: in f32 (TF32 off) both sides sum the same
    products in other orders: loss and grad norm within 1e-4 relative,
    the grads of the QDQ'd params within 1e-4 of each leaf's max; in bf16
    every activation rounds differently on each side: loss within 2e-2,
    grad norm and grads within 5e-2.  New params: each moves by at most lr
    (Adam's first step), so the two sides differ by at most 2 lr, plus in
    bf16 half a rounding step on each side (at most 2^-7 of the larger
    |p|); the elements that differ by more than 1e-6 are counted and
    printed."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    from repro_torch.quant.qat import bits_assignment, bits_to_device, quantize_params
    from repro_torch.train.train_step import batch_to, make_train_step

    out = {}
    for dtype, tol_loss, tol_grad in (("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-2)):
        cfg = dataclasses.replace(get_config("glm4-9b", smoke=True), num_layers=2, d_model=256,
                                  num_heads=4, num_kv_heads=2, head_dim=128, d_ff=688,
                                  vocab_size=4096, q_chunk=64, kv_chunk=128, dtype=dtype)
        model = build_model(cfg)
        params = model.init(seed=7, device="cpu")
        batch = SyntheticLMData(seed=2, global_batch=2, seq_len=256, vocab=4096).next()
        opt = AdamW(lr=1e-3)
        res = {}
        for dev in ("cuda", "cpu"):
            p = tree_unflatten(params, [t.to(dev) for t in tree_leaves(params)])
            bm = bits_to_device(bits_assignment(model.quant_groups(), lm_mixed_policy(model)), dev)
            leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
            loss, _ = model.loss(quantize_params(tree_unflatten(p, leaves), bm,
                                                 model.quant_groups()), batch_to(batch, dev))
            grads = torch.autograd.grad(loss, leaves)
            state, m = make_train_step(model, opt, remat="full")({"params": p,
                                                                  "opt": opt.init(p)}, batch, bm)
            res[dev] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                        "grads": [g.float().cpu() for g in grads],
                        "params": [t.float().cpu() for t in tree_leaves(state["params"])]}
        a, b = res["cuda"], res["cpu"]
        loss_err = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        gn_err = abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
        g_err = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                    for x, y in zip(a["grads"], b["grads"]))
        p0 = [t.float() for t in tree_leaves(params)]
        slack = 2 ** -7 if dtype == "bfloat16" else 0.0
        over = [float(((x - y).abs() - (2 * opt.lr + 1e-6
                                        + slack * torch.maximum(x.abs(), y.abs()))).max())
                for x, y in zip(a["params"], b["params"])]
        moved = sum(int(((x - y).abs() > 1e-6).sum()) for x, y in zip(a["params"], b["params"]))
        total = sum(t.numel() for t in p0)
        if not (math.isfinite(a["loss"]) and loss_err <= tol_loss and gn_err <= tol_grad
                and g_err <= tol_grad and max(over) <= 0):
            fail(f"[lm step {dtype}] card vs CPU: loss {a['loss']} / {b['loss']} "
                 f"({loss_err:.2e}), grad norm {gn_err:.2e}, grads {g_err:.2e} (tolerances "
                 f"{tol_loss}, {tol_grad}); params past 2 lr by {max(over):.3g}")
        out[dtype] = {"loss_rel_err": loss_err, "grad_norm_rel_err": gn_err,
                      "grads_rel_err": g_err, "params_differing": moved, "params": total}
        print(f"[lm step {dtype}] card vs CPU: loss {a['loss']:.6f} / {b['loss']:.6f} "
              f"({loss_err:.2e}), grad norm {gn_err:.2e}, grads {g_err:.2e} of each leaf's max; "
              f"new params within 2 lr, {moved} of {total} differ by more than 1e-6")
    return out


def _wrap_range(torch, fn, label):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapper


def profile_lm_step(torch, run, state, traced=2):
    """Phase 5j: 4-layer QAT train steps at the mixed policy under
    ``torch.profiler``: device time by family (the per-column fake-quant
    forward and backward by kernel name; the attention tiles, the CE
    chunks and AdamW by the ranges wrapped around ``_Flash``'s forward and
    backward, ``_ce_chunk`` and ``AdamW.update`` here; the weight matmuls
    as the gemm kernels outside them), the idle share against the host
    clock, and the runtime calls per step that can block the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import common
    from repro_torch.optim import adamw

    trainer = run["trainer"]
    step_fn, data, bm = trainer.step_fn, run["data"], trainer.bits_map
    saved = (common._Flash.forward, common._Flash.backward, common._ce_chunk,
             adamw.AdamW.update)
    common._Flash.forward = staticmethod(_wrap_range(torch, saved[0], "lm:attention tiles"))
    common._Flash.backward = staticmethod(_wrap_range(torch, saved[1], "lm:attention tiles"))
    common._ce_chunk = _wrap_range(torch, saved[2], "lm:CE chunks")
    adamw.AdamW.update = _wrap_range(torch, saved[3], "lm:AdamW")
    try:
        state, _ = step_fn(state, data.next(), bm)          # warm, with the ranges on
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(traced):
            state, m = step_fn(state, data.next(), bm)
            float(m["loss"])
        step_ms = (time.perf_counter() - t0) / traced * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(traced):
                state, m = step_fn(state, data.next(), bm)
                float(m["loss"])
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) / traced * 1e3
    finally:
        (common._Flash.forward, common._Flash.backward, common._ce_chunk,
         adamw.AdamW.update) = (staticmethod(saved[0]), staticmethod(saved[1]), saved[2],
                                saved[3])
    busy = 0.0
    by_name: dict[str, float] = {}
    host = {"cudaStreamSynchronize": 0.0, "cudaDeviceSynchronize": 0.0, "cudaMemcpyAsync": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA and ev.key in host:
            host[ev.key] += ev.count / traced
        # the ranges also show on the device timeline (spanning their
        # kernels): only kernels, copies and sets count as busy
        if (ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                and not ev.key.startswith("lm:")):
            busy += ev.self_device_time_total / traced / 1e3
            by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total / traced / 1e3
    if busy <= 0:
        print("  LM QAT step: the profiler saw no device time (not measured)")
        return state, {"step_ms": step_ms, "device_ms": None}

    def is_gemm(name):
        low = name.lower()
        return any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet", "sm90_", "cublas"))

    fams = {"fake-quant forward": sum(v for k, v in by_name.items()
                                      if "fake_quant_col_kernel" in k),
            "fake-quant backward": sum(v for k, v in by_name.items()
                                       if "fake_quant_col_bwd_kernel" in k)}
    linked = 0.0
    try:
        for ev in prof.events():
            kernels = getattr(ev, "kernels", None) or []
            if ev.device_type != DeviceType.CPU or not kernels:
                continue
            label, node = None, ev
            while node is not None and label is None:
                if node.name.startswith("lm:"):
                    label = node.name[3:]
                node = node.cpu_parent
            for k in kernels:
                if "fake_quant_col" in k.name:
                    continue
                ms = k.duration / traced / 1e3
                fam = label or ("weight matmuls" if is_gemm(k.name) else "other torch kernels")
                fams[fam] = fams.get(fam, 0.0) + ms
                linked += ms
    except AttributeError as e:
        print(f"  the profiler's events carry no kernel links ({e}): ranges not measured")
    fams["not linked to an op"] = max(busy - sum(fams.values()), 0.0)
    out = {"step_ms": step_ms, "traced_step_ms": traced_ms, "device_ms": busy,
           "idle_share": 1 - busy / traced_ms, "families_ms": fams,
           "host_calls_per_step": host,
           "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])}
    print(f"  glm4-9b 4L QAT step (batch 2 x 4096, remat full, mixed bits; host clock) = "
          f"{step_ms:.1f} ms untraced, {traced_ms:.1f} ms traced; device busy {busy:.1f} "
          f"ms/step -> idle share {out['idle_share']:.3f} of the traced step")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"    {fam:24s} {ms:9.2f} ms/step ({ms / busy:.3f} of device time)")
    print("    host runtime calls per step: " + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
    return state, out


# ---- h2o-danube-3-4b: ring pools at head dim 120 (phases 3l, 3m, 3n, 4l) -----
DANUBE_ARCH = "h2o-danube-3-4b"


class _Streams:
    """Fixed greedy token rows as ``compare_streams`` reads an engine."""

    def __init__(self, tokens):
        self.tokens = tokens

    def output(self, rid):
        return [int(t) for t in self.tokens[rid]]


def danube_static(torch, built, ring):
    """``--mode static`` at full width (batch 4, 4160-token prompts from
    ``--seed``, 96 greedy steps over a contiguous ring cache), its launch
    counts zeroed just before and read just after; its streams against a
    paged engine's on the same prompts and params (a divergence only at a
    flagged tie)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import ServeEngine

    args = launcher.parse_args(["--arch", DANUBE_ARCH, "--no-smoke", "--device", "cuda",
                                "--mode", "static", "--batch", "4", "--prompt-len", "4160",
                                "--gen", "96", "--bits", "4"])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    res = launcher.static(args, *built)
    torch.cuda.synchronize()
    counts = dict(ops.counts)
    n = args.gen + 1
    if tuple(res["tokens"].shape) != (args.batch, n):
        fail(f"[danube static] tokens of shape {res['tokens'].shape}, want {(args.batch, n)}")
    if counts["plain"] or counts["qmm_dequant"] <= 0 or counts["qmm_bitserial"] <= 0:
        fail(f"[danube static] launch counts {counts}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[danube static] prefill {res['prefill_s']:.3f} s for {args.batch} x "
          f"{args.prompt_len} tokens, {res['ms_per_step']:.3f} ms per token-step over "
          f"{args.gen} steps (the first one captures the step), peak_mem={peak:.2f} GiB; "
          f"launch counts {counts}")
    prompts = launcher.static_prompts(args, built[0].vocab_size)
    work = [(p, n) for p in prompts]
    engine = ServeEngine(built[1], built[2], num_slots=args.batch,
                         max_len=args.prompt_len + n, block_size=16, prefill_chunk=256,
                         device="cuda")
    for p, n in work:
        engine.submit(p, n)
    engine.run_until_drained()
    div = compare_streams(torch, "danube static vs paged", _Streams(res["tokens"]), engine,
                          work, card_margin(torch, ring))
    return {"prefill_s": res["prefill_s"], "ms_per_step": res["ms_per_step"],
            "peak_mem_gib": peak, "counts": counts, "diverged": div}


def danube_serving(torch):
    """Phases 3l, 3m, 3n: h2o-danube-3-4b at its published widths, 4-bit
    weights, through the launcher: fp ring blocks (paged_attention at head
    dim 120), int8 ring blocks (the unfused paged_attention_quant: a
    windowed layer never takes the fused decode), then the slot pool with
    full-prompt prefill (streams 3l's up to flagged ties) and the static
    loop."""
    need = ("qmm_bitserial", "qmm_dequant")
    fused = ("fused_qkv_paged_decode",)
    out = {}
    fp = serve_path(torch, "danube fp KV", ["--bits", "4"], need + ("paged_attention",),
                    base=DANUBE, arch=DANUBE_ARCH, forbid=fused + ("paged_attention_quant",))
    built = tuple(fp[k] for k in ("cfg", "model", "sparams", "policy"))
    pool = fp["engine"].pool
    if fp["metrics"]["prefix_cache"]["enabled"] or pool.length_bound is not None:
        fail("[danube fp KV] the ring pool kept its prefix cache or a length bound")
    if pool.blocks_per_seq * pool.block_size != 4096:
        fail(f"[danube fp KV] ring of {pool.blocks_per_seq} x {pool.block_size} tokens")
    out["3l"] = fp
    phase("phase 3m: h2o-danube-3-4b, --kv-bits 8 ring blocks (unfused quantized attention)")
    out["3m"] = serve_path(torch, "danube int8 KV", ["--bits", "4", "--kv-bits", "8"],
                           need + ("paged_attention_quant",), built, base=DANUBE,
                           arch=DANUBE_ARCH, forbid=fused + ("paged_attention",))
    if out["3m"]["metrics"]["prefix_cache"]["enabled"]:
        fail("[danube int8 KV] the ring pool kept its prefix cache")
    phase("phase 3n: h2o-danube-3-4b, --cache slot (full-prompt prefill) and --mode static")
    slot = serve_path(torch, "danube slot", ["--bits", "4", "--cache", "slot"], need, built,
                      base=DANUBE, arch=DANUBE_ARCH,
                      forbid=fused + ("paged_attention", "paged_attention_quant"))
    slot["diverged"] = compare_streams(torch, "danube slot vs 3l", slot["engine"],
                                       fp["engine"], fp["work"], card_margin(torch, fp))
    out["3n"] = slot
    out["3n static"] = danube_static(torch, built, fp)
    return out


def ring_card_vs_cpu(torch):
    """Phase 4l: a narrow windowed model of h2o-danube's head dim (2
    layers, d_model 480, 4 heads over 2 KV heads of 120, window 64, d_ff
    1280, vocab 32000), prompts of 72-100 tokens (past the ring in
    prefill), 48 greedy tokens: served on the card (kernels) and on the
    CPU (plain versions) with fp and int8 ring blocks, streams equal up to
    flagged ties."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(DANUBE_ARCH), num_layers=2, d_model=480, num_heads=4,
                              num_kv_heads=2, head_dim=120, d_ff=1280, vocab_size=32000,
                              sliding_window=64)
    sm = build_model(cfg)
    params = sm.init(seed=7, device="cpu")
    lens = (72, 100, 85, 91, 77, 96)
    out = {}
    for kv_bits, kernel, other in ((None, "paged_attention", "paged_attention_quant"),
                                   (8, "paged_attention_quant", "paged_attention")):
        out[f"kv_bits={kv_bits}"] = served_streams_card_vs_cpu(
            torch, sm, params, kv_bits, lens=lens, gen=48, need=("qmm_bitserial", kernel),
            forbid=("fused_qkv_paged_decode", other))
    return out


# ---- the recurrent families at their published widths (phases 3o-3s, 4o, 5o) ----
RWKV_ARCH, HYMBA_ARCH = "rwkv6-1.6b", "hymba-1.5b"
# phase 3r's spec checks on drawn weights run a quarter of the published
# depth (24 and 32 layers), at the published widths: their eager verify
# windows and replays take most of the script's time at full depth
SPEC_RECURRENT_LAYERS = {RWKV_ARCH: 6, HYMBA_ARCH: 8}
# (name, K, N, bits, calls per decode step, [x dtype]): rwkv6-1.6b's time-mix
# r/k/v/g, channel-mix r and k take the f32 token-shift mixes; wo and the
# channel-mix v take bf16; the lm_head is served at 8 bits
RWKV_QMM = [("rwkv tm.r/k/v/g, cm.r", 2048, 2048, 4, 120, "f32"),
            ("rwkv tm.wo", 2048, 2048, 4, 24), ("rwkv cm.wk", 2048, 7168, 4, 24, "f32"),
            ("rwkv cm.wv", 7168, 2048, 4, 24), ("rwkv lm_head", 2048, 65536, 8, 1)]
# hymba-1.5b, bf16 activations: K 1600 is 12.5 steps of 128, N 320 five
# heads of k/v, N 32001 planes not 16-byte aligned
HYMBA_QMM = [("hymba wq/wo", 1600, 1600, 4, 64), ("hymba wk/wv", 1600, 320, 4, 64),
             ("hymba wg/wu", 1600, 5504, 4, 64), ("hymba wd", 5504, 1600, 4, 32),
             ("hymba in_x/in_z", 1600, 3200, 4, 64), ("hymba ssm.out", 3200, 1600, 4, 32),
             ("hymba lm_head", 1600, 32001, 8, 1)]
RECURRENT_MS = (("bitserial", (4,)), ("dequant", (256,)))
PUBLISHED.update({RWKV_ARCH: ((24, 2048, 32, 32, 64, 7168, 65536), None),
                  HYMBA_ARCH: ((32, 1600, 25, 5, 64, 5504, 32001), 1024)})
# phase 3p/3q: 4 requests of 960-1200 prompt tokens on 4 rows, 48-96 new
# ones: max_len 1297 > the 1024-token window, so some rows wrap the ring in
# prefill and the others in decode
HYMBA_CELL = ["--requests", "4", "--num-slots", "4", "--block-size", "16", "--prompt-len",
              "1200", "--min-prompt-len", "960", "--prefill-chunk", "256", "--gen", "96",
              "--temperature", "0"]
PAGED = ("paged_attention", "paged_attention_quant", "fused_qkv_paged_decode")


def state_bytes(pool) -> int:
    """Bytes of one row's O(1) recurrent state in a pool."""
    return sum(pool.cache[k].numel() * pool.cache[k].element_size()
               for k in pool.recurrent_keys) // pool.num_slots


def recurrent_serving(torch):
    """Phases 3o, 3p, 3q: rwkv6-1.6b (the glm4 cell's traffic, then
    danube's long prompts) and hymba-1.5b (fp ring blocks, then int8) at
    their published widths through the launcher, 4-bit weights."""
    need = ("qmm_bitserial", "qmm_dequant")
    out = {}
    short = serve_path(torch, "rwkv short", ["--bits", "4"], need, arch=RWKV_ARCH, forbid=PAGED)
    built = tuple(short[k] for k in ("cfg", "model", "sparams", "policy"))
    phase("phase 3o, second mix: rwkv6-1.6b, 4 prompts of 4032-4160 tokens in 256-token chunks")
    long = serve_path(torch, "rwkv long", ["--bits", "4"], need, built, base=DANUBE,
                      arch=RWKV_ARCH, forbid=PAGED)
    for r in (short, long):
        pool = r["engine"].pool
        if pool.blocks_per_seq or pool.cache_bytes() or r["metrics"]["prefix_cache"]["enabled"]:
            fail(f"[{r['label']}] the O(1)-state pool holds blocks or its prefix cache")
        r["state_bytes_per_row"] = state_bytes(pool)
        print(f"[{r['label']}] {pool.recurrent_keys} take {r['state_bytes_per_row']:,} bytes "
              f"a row, whatever the length")
    out["3o"], out["3o long"] = short, long
    phase("phase 3p: hymba-1.5b serving end to end, --bits 4, fp KV ring blocks")
    fp = serve_path(torch, "hymba fp KV", ["--bits", "4"], need + ("paged_attention",),
                    base=HYMBA_CELL, arch=HYMBA_ARCH, forbid=PAGED[1:])
    pool = fp["engine"].pool
    if pool.blocks_per_seq * pool.block_size != 1024 or pool.prefix_cache:
        fail(f"[hymba fp KV] ring of {pool.blocks_per_seq} x {pool.block_size} tokens, "
             f"prefix cache {pool.prefix_cache}")
    fp["state_bytes_per_row"] = state_bytes(pool)
    out["3p"] = fp
    phase("phase 3q: hymba-1.5b, --kv-bits 8 ring blocks (unfused quantized attention)")
    out["3q"] = serve_path(torch, "hymba int8 KV", ["--bits", "4", "--kv-bits", "8"],
                           need + ("paged_attention_quant",),
                           tuple(fp[k] for k in ("cfg", "model", "sparams", "policy")),
                           base=HYMBA_CELL, arch=HYMBA_ARCH,
                           forbid=("paged_attention", "fused_qkv_paged_decode"))
    return out


def spec_recurrent_cut(torch):
    """Phase 3r's spec checks on drawn weights: rwkv6-1.6b on 3o's first
    mix and hymba-1.5b on 3p's traffic, each at the published widths and
    SPEC_RECURRENT_LAYERS deep, served without spec and then through
    ``spec_recurrent``."""
    out = {}
    for name, arch, base, need, forbid in (
            ("rwkv", RWKV_ARCH, CELL, ("qmm_bitserial", "qmm_dequant"), PAGED),
            ("hymba", HYMBA_ARCH, HYMBA_CELL,
             ("qmm_bitserial", "qmm_dequant", "paged_attention"), PAGED[1:])):
        layers = SPEC_RECURRENT_LAYERS[arch]
        cut = serve_path(torch, f"{name} {layers} layers, no spec", ["--bits", "4"],
                         need, snapped_build(torch, arch, snap=False, layers=layers),
                         base=base, arch=arch, forbid=forbid, layers=layers)
        out[name] = spec_recurrent(torch, cut, f"{name} spec")
        out[name]["layers"] = layers
        del cut
        torch.cuda.empty_cache()
    return out


def spec_recurrent(torch, base, label, partial=False):
    """Phase 3r on one served cell: its workload and params through a
    spec engine (k 4, 2-bit draft, the engine's defaults otherwise), the
    draft step and the verify calls watched: per spec step the first
    verify scores the windows and a second one is the fix-up, each timed
    by CUDA events around the call (its device span, host gaps inside
    included), and the first of each traced for its device busy time.

    The spec streams are scored by the chunk path (a verify), the base
    run's by the decode path, and at depth the two paths round apart far
    enough to part streams (PERF.md, 3r).  So each stream is held against
    its own path (``PathReplay``): every spec token against a plain replay
    of the engine's windows, and each base stream up to its first
    divergence from the spec one against a replay of the decode steps.
    Fails unless both hold, a fix-up ran, no plain call or fused launch
    happened, and the draft's step was captured once; with ``partial``,
    also unless some window accepted part of its draft (0 < accepted <
    proposed) and was followed by a fix-up."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import SamplingParams, ServeEngine
    from repro_torch.spec import SpecConfig

    a = base["args"]
    kv = {"kv_bits": a.kv_bits[0]} if a.kv_bits else {}
    engine = ServeEngine(base["model"], base["sparams"], num_slots=a.num_slots,
                         max_len=a.prompt_len + a.gen + 1, block_size=a.block_size,
                         prefill_chunk=a.prefill_chunk, spec=SpecConfig(k=4, draft_bits=2),
                         device="cuda", **kv)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    log = SpecLog(engine)
    calls, draft, verify = [], engine._draft_decode, engine._verify
    busy = {}   # device busy ms of the first window verify and the first fix-up

    def draft_call(*args):
        if not calls or calls[-1]:
            calls.append([])
        return draft(*args)

    def verify_call(*args):
        kind = "fixup" if calls[-1] else "verify"
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        if kind in busy:
            ev[0].record()
            out = verify(*args)
            ev[1].record()
        else:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                ev[0].record()
                out = verify(*args)
                ev[1].record()
                torch.cuda.synchronize()
            busy[kind] = sum(e.self_device_time_total for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA) / 1e3
        calls[-1].append(ev)
        return out

    engine._draft_decode, engine._verify = draft_call, verify_call
    ops.reset_counts()
    t0 = time.perf_counter()
    launcher.drive(engine, base["work"], a.arrival_every, SamplingParams(temperature=0.0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, m = dict(ops.counts), engine.metrics()
    fixups = int(engine.obs.get("spec.fixups").value)
    spans = {"verify": [c[0][0].elapsed_time(c[0][1]) for c in calls if c],
             "fixup": [c[1][0].elapsed_time(c[1][1]) for c in calls if len(c) == 2]}
    if (counts["plain"] or counts["fused_qkv_paged_decode"] or counts["qmm_bitserial"] <= 0
            or counts["qmm_dequant"] <= 0):
        fail(f"[{label}] launch counts {counts}")
    if fixups <= 0 or fixups != len(spans["fixup"]):
        fail(f"[{label}] {fixups} fix-ups counted, {len(spans['fixup'])} seen")
    if m["recompiles"] or engine.graph_captures["draft"] != 1:
        fail(f"[{label}] captures {engine.graph_captures}, recompiles {m['recompiles']}")
    sp = m["spec"]
    print(f"[{label}] spec k=4 draft_bits=2: windows {sp['windows']}, proposed "
          f"{sp['proposed']} of k * windows = {sp['k'] * sp['windows']} (the rest cut by the "
          f"budget or the ring), accepted {sp['accepted']}, acceptance "
          f"{sp['acceptance_rate']:.4f}; {fixups} fix-ups, CUDA-event span p50 "
          f"{statistics.median(spans['fixup']):.3f} ms ({sum(spans['fixup']):.1f} ms in all) "
          f"against the window verify's {statistics.median(spans['verify']):.3f} ms; device "
          f"busy in the first fix-up {busy.get('fixup', float('nan')):.3f} ms, first window "
          f"verify {busy.get('verify', float('nan')):.3f} ms (profiler); "
          f"tokens/s {m['tokens_per_s']:.2f} (no spec {base['metrics']['tokens_per_s']:.2f}), "
          f"decode_tok_p50 {m['decode_tok_p50_ms']:.3f} ms, wall {wall:.2f} s; "
          f"launch counts {counts}")

    work = base["work"]
    outs = {rid: engine.output(rid) for rid in range(len(work))}
    base_outs = {rid: base["engine"].output(rid) for rid in range(len(work))}
    diverged = first_divergences(f"{label} vs no spec", engine, base["engine"], len(work))
    events = log.numpy()
    t0 = time.perf_counter()
    own = PathReplay(torch, base, engine.pool, f"{label}, chunk path replay")
    own.spec(events, outs)
    dec = PathReplay(torch, base, base["engine"].pool, f"{label} base, decode path replay")
    dec.decode(dict(diverged), base_outs)
    print(f"  [{label} base, decode path replay] {dec.exact} tokens the argmax of their own "
          f"path, {len(dec.ties)} at a flagged tie: {dec.ties}")
    replay_s = time.perf_counter() - t0
    partial_fixed = [p for p in own.partial if p[0] + 1 < len(events)
                     and events[p[0] + 1]["kind"] == "fixup"]
    print(f"  [{label}] {len(own.partial)} windows accepted part of their draft "
          f"(0 < accepted < proposed), {len(partial_fixed)} of them followed by a fix-up "
          f"(accepted, proposed: {[p[1:] for p in own.partial[:12]]}); replays {replay_s:.1f} s")
    if len(partial_fixed) != len(own.partial) or (partial and not partial_fixed):
        fail(f"[{label}] partly accepted windows {own.partial}, followed by a fix-up "
             f"{partial_fixed}")
    rows = []
    for rid, i in diverged:
        rows.append({"request": rid, "token": i, "spec": outs[rid][i], "base": base_outs[rid][i],
                     "spec_tie": own.ties.get(rid), "base_tie": dec.ties.get(rid)})
        print(f"  [{label}] request {rid} first diverges at token {i} ({outs[rid][i]} against "
              f"{base_outs[rid][i]}); spec on its chunk path: "
              f"{own.ties.get(rid) or 'the argmax'}; base on its decode path: "
              f"{dec.ties.get(rid) or 'the argmax'}")
    return {"metrics": {k: v for k, v in m.items() if k != "requests"}, "counts": counts,
            "wall_s": wall, "fixups": fixups, "diverged": rows,
            "own_path": {"spec_exact": own.exact, "spec_ties": own.ties,
                         "base_exact": dec.exact, "base_ties": dec.ties, "replay_s": replay_s},
            "partial_windows": len(own.partial), "partial_fixed": len(partial_fixed),
            "verify_span_ms_p50": statistics.median(spans["verify"]),
            "fixup_span_ms_p50": statistics.median(spans["fixup"]),
            "fixup_span_ms_total": sum(spans["fixup"]),
            "verify_device_ms_first": busy.get("verify"), "fixup_device_ms_first": busy.get("fixup"),
            "ttft_p50_s": statistics.median(q["ttft_s"] for q in m["requests"])}


def pareto_lenet(torch, task, bits):
    """Phase 3s (Fig 6): every LeNet policy over bitset (2, 3, 4, 6, 8),
    no retrain, as benchmarks/paper.py enumerates it; the frontier and
    the distance of 3d's ReLeQ point from it."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core.pareto import distance_to_frontier, enumerate_space, pareto_frontier
    from repro_torch.kernels import ops

    ops.reset_counts()
    t0 = time.perf_counter()
    pts = enumerate_space(task.groups, lambda b: task.evaluate_bits(b, retrain_steps=0),
                          bitset=(2, 3, 4, 6, 8))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    front = pareto_frontier(pts)
    point = {"bits": bits, "acc": task.evaluate_bits(bits, retrain_steps=0),
             "quant": cm.state_of_quantization([bits[g.name] for g in task.groups],
                                               task.groups)}
    d = distance_to_frontier(point, front)
    if len(pts) != 625 or not front or not all(math.isfinite(p["acc"]) for p in pts):
        fail(f"[pareto] {len(pts)} points, frontier of {len(front)}")
    counts = dict(ops.counts)
    if counts["plain"] or counts["fake_quant_group"] < 625:
        fail(f"[pareto] launch counts {counts}")
    print(f"[pareto] LeNet: {len(pts)} points in {wall:.2f} s ({wall / len(pts) * 1e3:.2f} ms "
          f"a point), frontier of {len(front)}, ReLeQ point (quant {point['quant']:.4f}, acc "
          f"{point['acc']:.4f}) at distance {d:.4f}; launch counts {counts}")
    return {"points": len(pts), "frontier": len(front), "releq_distance": d, "wall_s": wall,
            "frontier_pts": [(p["quant"], p["acc"]) for p in front], "counts": counts}


def admm_resnet20(torch, task):
    """Phase 3s (Table 4): the ADMM selector on 3e's pretrained ResNet-20
    at 4.0 average bits; its bits must equal a CPU run's on the same
    weights (the plain fake-quant)."""
    from repro_torch.core.admm_baseline import admm_select
    from repro_torch.kernels import ops

    weights = task.weights_by_name()
    ops.reset_counts()
    t0 = time.perf_counter()
    bits = admm_select(task.groups, weights, budget_avg_bits=4.0)
    wall = time.perf_counter() - t0
    counts = dict(ops.counts)
    cpu = admm_select(task.groups, {n: w.cpu() for n, w in weights.items()}, budget_avg_bits=4.0)
    if bits != cpu:
        fail(f"[admm] card bits {bits} != CPU bits {cpu}")
    if counts["fake_quant"] != 7 * len(task.groups) or counts["plain"]:
        fail(f"[admm] launch counts {counts}")
    vec = [bits[g.name] for g in task.groups]
    avg = sum(g.n_weights * b for g, b in zip(task.groups, vec)) / sum(
        g.n_weights for g in task.groups)
    print(f"[admm] ResNet-20 at 4.0 average bits: {vec} (weighted average {avg:.4f}), equal "
          f"to the CPU's; {counts['fake_quant']} fake-quant launches, {wall:.3f} s")
    return {"bits": vec, "weighted_avg_bits": avg, "wall_s": wall, "counts": counts}


def recurrent_card_vs_cpu(torch):
    """Phase 4o: narrow models of both families served on the card and on
    the CPU, 6 prompts of 72-100 tokens and 48 greedy tokens: RWKV (2
    layers, d_model 256, 4 heads of 64, d_ff 896, vocab 65536) and hymba
    (2 layers, d_model 320, 5 heads over 1 KV head of 64, window 64, Di
    640, d_ff 1088, vocab 32001; fp and int8 ring blocks)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    lens = (72, 100, 85, 91, 77, 96)
    rwkv = build_model(dataclasses.replace(get_config(RWKV_ARCH), num_layers=2, d_model=256,
                                           num_heads=4, num_kv_heads=4, d_ff=896))
    hymba = build_model(dataclasses.replace(get_config(HYMBA_ARCH), num_layers=2, d_model=320,
                                            num_heads=5, num_kv_heads=1, d_ff=1088,
                                            sliding_window=64))
    out = {}
    for name, sm, kv_bits, need, forbid in (
            ("rwkv", rwkv, None, ("qmm_bitserial",), PAGED),
            ("hymba fp", hymba, None, ("qmm_bitserial", "paged_attention"), PAGED[1:]),
            ("hymba int8", hymba, 8, ("qmm_bitserial", "paged_attention_quant"),
             ("paged_attention", "fused_qkv_paged_decode"))):
        params = sm.init(seed=11, device="cpu")
        out[name] = served_streams_card_vs_cpu(torch, sm, params, kv_bits, lens=lens, gen=48,
                                               need=need, forbid=forbid)
    return out


# ---- the moe, vlm and audio families at their published widths (phases 3t-3v, 4t, 5t) ----
MOONSHOT_ARCH, QWEN_ARCH, MUSICGEN_ARCH = "moonshot-v1-16b-a3b", "qwen2-vl-7b", "musicgen-large"
PUBLISHED.update({MOONSHOT_ARCH: ((48, 2048, 16, 16, 128, 1408, 163840), None),
                  QWEN_ARCH: ((28, 3584, 28, 4, 128, 18944, 152064), None),
                  MUSICGEN_ARCH: ((48, 2048, 32, 32, 64, 8192, 2048), None)})
# (name, K, N, bits, -): moonshot's experts take 32 rows a decode step (4
# rows x capacity 8) and 384 a 64-token chunk (capacity 64 x 6); the other
# products 4 rows and 64 tokens; lm_heads at the 8 bits they are served at
MOE_EXPERT_QMM = [("moonshot expert wg/wu", 2048, 1408, 4, 0),
                  ("moonshot expert wd", 1408, 2048, 4, 0)]
MOE_EXPERT_MS = (("bitserial", (32,)), ("dequant", (384,)))
MVA_QMM = [("2048x2048 attention", 2048, 2048, 4, 0), ("moonshot lm_head", 2048, 163840, 8, 0),
           ("qwen2-vl wq/wo", 3584, 3584, 4, 0), ("qwen2-vl wk/wv", 3584, 512, 4, 0),
           ("qwen2-vl wg/wu", 3584, 18944, 4, 0), ("qwen2-vl wd", 18944, 3584, 4, 0),
           ("qwen2-vl lm_head", 3584, 152064, 8, 0), ("musicgen wg", 2048, 8192, 4, 0),
           ("musicgen wd", 8192, 2048, 4, 0), ("musicgen lm_head", 2048, 2048, 8, 0)]
MVA_MS = (("bitserial", (4,)), ("dequant", (64,)))
# qmm calls per decode step (fp KV: q, k, v and wo unfused), by shape row
MVA_STEP_CALLS = {
    "moonshot": {"moonshot expert wg/wu": 6144, "moonshot expert wd": 3072,
                 "2048x2048 attention": 192, "moonshot lm_head": 1},
    "qwen2-vl": {"qwen2-vl wq/wo": 56, "qwen2-vl wk/wv": 56, "qwen2-vl wg/wu": 56,
                 "qwen2-vl wd": 28, "qwen2-vl lm_head": 1},
    "musicgen": {"2048x2048 attention": 192, "musicgen wg": 48, "musicgen wd": 48,
                 "musicgen lm_head": 1}}
# decode attention heads: moonshot G 1 at hd 128 (KV 16), musicgen G 1 at
# hd 64 (KV 32), qwen2-vl G 7 at hd 128 (KV 4: a warp's last head slot
# idle); tables of 7 blocks of 16, the served cell's lengths
MVA_HEADS = {"g1 hd128": {"B": 4, "KV": 16, "G": 1, "hd": 128, "bs": 16, "nb": 7},
             "g1 hd64": {"B": 4, "KV": 32, "G": 1, "hd": 64, "bs": 16, "nb": 7},
             "g7 hd128": {"B": 4, "KV": 4, "G": 7, "hd": 128, "bs": 16, "nb": 7}}
MVA_LAYERS = {"g1 hd128": 48, "g1 hd64": 48, "g7 hd128": 28}


def check_mva_kernels(torch, timer, peaks, rows):
    """Phase 2's rows at the moe, vlm and audio families' shapes: qmm at
    moonshot's expert and other products, qwen2-vl's and musicgen's; both
    paged kernels at G 1 (hd 128 and 64) and G 7; the fused decode at
    moonshot's H 16 over KV 16, hd 128, D 2048.  Returns the worst errors
    (qmm, fp attention, quantized attention, fused)."""
    print("  moonshot-v1-16b-a3b's experts (32 rows a decode step, 384 a chunk)")
    qmm_err = check_qmm(torch, timer, peaks, rows, MOE_EXPERT_QMM, MOE_EXPERT_MS, seed=5)
    print("  moonshot's, qwen2-vl-7b's and musicgen-large's other qmm shapes")
    qmm_err = max(qmm_err, check_qmm(torch, timer, peaks, rows, MVA_QMM, MVA_MS, seed=6))
    pa_err = paq_err = 0.0
    for tag, heads in MVA_HEADS.items():
        print(f"  decode attention {tag}: KV {heads['KV']}, G {heads['G']}, hd {heads['hd']}, "
              f"bs 16, tables of {heads['nb']} blocks")
        a, b = check_ring_attention(torch, timer, peaks, rows, heads,
                                    ((f"{tag} lengths", [1, 17, 100, 112]),
                                     (f"{tag} decode", [41, 58, 73, 96])), seed=31)
        pa_err, paq_err = max(pa_err, a), max(paq_err, b)
    print("  the fused decode at moonshot's shape: H 16 over KV 16 (G 1), hd 128, D 2048")
    fused_err = check_fused_decode(torch, timer, peaks, rows, shape=(4, 16, 1, 128, 16, 2048),
                                   theta=5e4, prefix="g1 ", seed=23)
    return qmm_err, pa_err, paq_err, fused_err


def mva_qmm(rows, fam, decode: bool):
    """qmm per decode step (``decode``) or per 64-token chunk of one family,
    from phase 2's rows: experts at 32 / 384 rows, the rest at 4 / 64 (a
    chunk reads out one token: no lm_head)."""
    calls = MVA_STEP_CALLS[fam]

    def pick(r):
        n = calls.get(r["shape"], 0)
        expert = "expert" in r["shape"]
        if decode:
            return n if r["M"] == (32 if expert else 4) else 0
        return n if r["M"] == (384 if expert else 64) and "lm_head" not in r["shape"] else 0

    return per_step(rows, "qmm_bitserial" if decode else "qmm_dequant", pick)


def weight_bytes(sparams) -> int:
    from repro_torch.train.serve import _leaves

    return sum(t.numel() * t.element_size() for t in _leaves(sparams))


def mva_summary(torch, r):
    """A served cell's step p50, tokens/s, TTFT p50, weight bytes, peaks and
    launches per graphed decode step; printed and returned."""
    m = r["metrics"]
    out = {"decode_step_p50_ms": m["decode_step_p50_ms"], "tokens_per_s": m["tokens_per_s"],
           "ttft_p50_s": statistics.median(q["ttft_s"] for q in m["requests"]),
           "weight_bytes": weight_bytes(r["sparams"]), "peak_mem_gib": r["peak_mem_gib"],
           "build_peak_gib": r["build_peak_gib"],
           "launches_per_step": dict(r["engine"]._decode._graph.launches)}
    print(f"[{r['label']}] step p50 {out['decode_step_p50_ms']:.3f} ms, tokens/s "
          f"{out['tokens_per_s']:.2f}, TTFT p50 {out['ttft_p50_s']:.4f} s, weight bytes "
          f"{out['weight_bytes']:,}, peak {out['peak_mem_gib']:.2f} GiB serving"
          + (f" / {out['build_peak_gib']:.2f} GiB building" if out["build_peak_gib"] else "")
          + f"; launches a graphed decode step {out['launches_per_step']}")
    return out


def qmm_split(torch, r, reps=20):
    """Phase 5t's split of qmm device time: layer 0's expert products (64
    experts x wg, wu, wd on 32 rows each, the stacks included) and its four
    attention projections (4 rows), each captured in a graph on the served
    params, replayed ``reps`` times and timed by CUDA events; x 48 layers."""
    from repro_torch.models import moe
    from repro_torch.models.common import apply_linear, swiglu
    from repro_torch.train.serve import _Graph

    cfg, p = r["cfg"], r["sparams"]["blocks"][0][0]
    E, D, dt = cfg.num_experts, cfg.d_model, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(7)
    xe = torch.randn((E, 32, D), generator=gen, device="cuda").to(dt)
    h = torch.randn((4, 1, D), generator=gen, device="cuda").to(dt)

    def experts(x):
        g = swiglu(moe._bank(x, p["moe"]["wg"], dt), moe._bank(x, p["moe"]["wu"], dt))
        return moe._bank(g, p["moe"]["wd"], dt)

    def projections(x):
        return [apply_linear(x, p["attn"][m]) for m in ("wq", "wk", "wv", "wo")]

    out = {}
    for name, fn, arg in (("expert_qmm_ms", experts, xe), ("projection_qmm_ms", projections, h)):
        g = _Graph(fn, [arg])
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            g.graph.replay()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        out[name] = statistics.median(times) * cfg.num_layers
        out[name.replace("_ms", "_launches_per_layer")] = g.launches
        del g
    return out


def moe_family(name):
    """Phase 5t's families beside the defaults: the router (its f32 matmul
    and softmax) and the dispatch / combine (sorts, searches, gathers and
    scatters)."""
    low = name.lower()
    if any(k in low for k in ("sort", "radix", "searchsorted", "scatter", "gather")):
        return "dispatch / undispatch"
    if "softmax" in low or any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return "router"
    return None


def mva_serving(torch):
    """Phases 3t (moonshot-v1-16b-a3b, fp then int4 KV), 5t (its graphed
    decode step profiled), 3u (qwen2-vl-7b, fp then int8 KV) and 3v
    (musicgen-large, fp KV), at published widths and depth through the
    launcher on 3a's traffic, 4-bit weights."""
    need = ("qmm_bitserial", "qmm_dequant")
    out = {}
    fp = serve_path(torch, "moonshot fp KV", ["--bits", "4"], need + ("paged_attention",),
                    arch=MOONSHOT_ARCH, forbid=PAGED[1:])
    cfg = fp["cfg"]
    if (cfg.num_experts, cfg.experts_per_token, cfg.moe_interleave) != (64, 6, 1):
        fail(f"moonshot: {cfg.num_experts} experts top-{cfg.experts_per_token}, "
             f"interleave {cfg.moe_interleave}: not the published 64 top-6 in every layer")
    check_outputs_full(torch, fp)
    out["3t"] = fp
    fp["summary"] = mva_summary(torch, fp)
    phase("phase 5t: moonshot's graphed decode step, device time by family")
    fp["breakdown"] = profile_decode(torch, fp["engine"], fp["work"], family=moe_family)
    fp["breakdown"]["qmm_split"] = split = qmm_split(torch, fp)
    print(f"  qmm alone, 48 layers: experts {split['expert_qmm_ms']:.3f} ms "
          f"({split['expert_qmm_launches_per_layer']} a layer), attention projections "
          f"{split['projection_qmm_ms']:.3f} ms ({split['projection_qmm_launches_per_layer']} "
          f"a layer)")
    phase("phase 3t, int4 KV: moonshot-v1-16b-a3b, --kv-bits 4 (the fused decode at G 1)")
    built = tuple(fp[k] for k in ("cfg", "model", "sparams", "policy"))
    int4 = serve_path(torch, "moonshot int4 KV", ["--bits", "4", "--kv-bits", "4"],
                      need + ("fused_qkv_paged_decode",), built, arch=MOONSHOT_ARCH,
                      forbid=("paged_attention", "paged_attention_quant"))
    int4["summary"] = mva_summary(torch, int4)
    out["3t int4"] = int4
    for r in (fp, int4):
        for key in ("engine", "model", "sparams"):
            r.pop(key, None)
    del built
    torch.cuda.empty_cache()
    phase("phase 3u: qwen2-vl-7b serving end to end, --bits 4, fp KV (M-RoPE, G 7)")
    fp = serve_path(torch, "qwen2-vl fp KV", ["--bits", "4"], need + ("paged_attention",),
                    arch=QWEN_ARCH, forbid=PAGED[1:])
    check_outputs_full(torch, fp)
    fp["summary"] = mva_summary(torch, fp)
    phase("phase 3u, int8 KV: qwen2-vl-7b, --kv-bits 8 (unfused: M-RoPE takes no fused decode)")
    q8 = serve_path(torch, "qwen2-vl int8 KV", ["--bits", "4", "--kv-bits", "8"],
                    need + ("paged_attention_quant",),
                    tuple(fp[k] for k in ("cfg", "model", "sparams", "policy")), arch=QWEN_ARCH,
                    forbid=("paged_attention", "fused_qkv_paged_decode"))
    q8["summary"] = mva_summary(torch, q8)
    out["3u"], out["3u int8"] = fp, q8
    for r in (fp, q8):
        for key in ("engine", "model", "sparams"):
            r.pop(key, None)
    torch.cuda.empty_cache()
    phase("phase 3v: musicgen-large serving end to end, --bits 4, fp KV (sinusoids, G 1, hd 64)")
    mg = serve_path(torch, "musicgen fp KV", ["--bits", "4"], need + ("paged_attention",),
                    arch=MUSICGEN_ARCH, forbid=PAGED[1:])
    check_outputs_full(torch, mg)
    mg["summary"] = mva_summary(torch, mg)
    out["3v"] = mg
    for key in ("engine", "model", "sparams"):
        mg.pop(key, None)
    torch.cuda.empty_cache()
    return out


def check_outputs_full(torch, r):
    """A full-width served cell's request 0 prefilled again on its pool:
    finite logits of the vocab's width whose argmax is its first token."""
    import numpy as np

    model, sparams, engine = r["model"], r["sparams"], r["engine"]
    prompt = np.asarray(r["work"][0][0], np.int32)
    logits = fresh_logits(torch, model, sparams, prompt, chunk=engine.prefill_chunk)
    if logits.shape != (r["cfg"].vocab_size,) or not torch.isfinite(logits).all():
        fail(f"[{r['label']}] full-width logits of shape {tuple(logits.shape)} or not finite")
    if int(logits.argmax()) != engine.output(0)[0]:
        fail(f"[{r['label']}] request 0 prefilled again does not give its first token")


def route_gaps(torch, model, sparams, prompt, emitted, chunk=16):
    """On the CPU: the prompt prefilled in chunks and the emitted tokens
    decoded one at a time, as a served row takes them; returns (the
    smallest gate gap of the last token, i.e. the one whose logits chose
    the next token, the smallest gap of any routing choice in the
    context)."""
    import numpy as np

    from repro_torch.models.moe import RouteLog

    tokens = np.concatenate([prompt, np.asarray(emitted, np.int64)]).astype(np.int32)
    with RouteLog() as log:
        fresh_logits(torch, model, sparams, tokens, device="cpu", chunk=chunk,
                     decoded=len(emitted))
    last = min(float(g[:, -1].min()) for g in log.gaps[-model.cfg.num_layers:])
    return last, min(float(g.min()) for g in log.gaps)


def graphed_twin_replays(torch, sm, sp, kv_bits, device="cuda", replays=8):
    """A model's captured decode step against its eager step over twin
    pools fed the same chunked prefills (60 and 90 tokens) and the same
    tokens.  Returns {"mismatch": None, or the first replay and leaf that
    differ, "counts": [(eager, graphed) ``ops.counts`` a replay],
    "captures": (captures, recaptures), "launches": launches a replay}."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serve.cache import PagedCachePool
    from repro_torch.train.serve import GraphedDecodeStep

    pools = [PagedCachePool(sm, 2, 200, block_size=16, device=device, kv_bits=kv_bits)
             for _ in range(2)]
    graphed = GraphedDecodeStep(sm)
    rng = np.random.default_rng(10)
    for n in (60, 90):
        toks = torch.from_numpy(rng.integers(0, sm.cfg.vocab_size, (1, 32))
                                .astype(np.int32)).to(device)
        for pool in pools:
            seq = pool.alloc_seq()
            if not pool.ensure(seq, n + 1):
                raise RuntimeError(f"twin pool could not hold {n + 1} tokens")
            for lo in range(0, n, 32):
                _, cache = sm.prefill_chunk(sp, pool.step_cache(), toks, seq, lo,
                                            min(32, n - lo))
                pool.accept(cache)
    out = {"mismatch": None, "counts": []}
    for i in range(replays):
        feed = torch.from_numpy(rng.integers(0, sm.cfg.vocab_size, (2, 1))
                                .astype(np.int32)).to(device)
        logits, counts = [], []
        for pool, fn in zip(pools, (sm.decode_step, graphed)):
            ops.reset_counts()
            lg, cache = fn(sp, pool.step_cache(), feed)
            pool.accept(cache)
            torch.cuda.synchronize()
            logits.append(lg.clone())
            counts.append(dict(ops.counts))
        out["counts"].append(tuple(counts))
        if not torch.equal(logits[0], logits[1]):
            out["mismatch"] = f"replay {i}: logits differ from eager"
        for key, leaf in pools[0].cache.items():
            if out["mismatch"] is None and not torch.equal(leaf, pools[1].cache[key]):
                out["mismatch"] = f"replay {i}: pool leaf {key} differs from eager"
        if out["mismatch"]:
            break
    out["captures"] = (graphed.captures, graphed.recaptures)
    out["launches"] = graphed._graph.launches if graphed._graph is not None else None
    return out


def moe_graphed_witness(torch, sm, params):
    """Phase 4t: one narrow MoE model's captured decode step against its
    eager step over twin pools (fp and int4 KV): logits and every pool
    byte bitwise, one capture."""
    from repro_torch.quant.qat import policy_for
    from repro_torch.train.serve import quantize_for_serving

    sp = quantize_for_serving(sm, params, policy_for(sm, 4), device="cuda")
    out = {}
    for kv_bits in (None, 4):
        twin = graphed_twin_replays(torch, sm, sp, kv_bits)
        if twin["mismatch"]:
            fail(f"[4t MoE graphed, kv_bits={kv_bits}] {twin['mismatch']}")
        if twin["captures"] != (1, 0):
            fail(f"[4t MoE graphed] captures, recaptures {twin['captures']}")
        n = len(twin["counts"])
        out[f"kv_bits={kv_bits}"] = {"replays": n, "launches_per_replay": twin["launches"]}
        print(f"  MoE graphed step (kv_bits={kv_bits}): {n} replays, logits and every pool "
              f"byte bitwise the eager step's; launches a replay {twin['launches']}")
    return out


def mva_card_vs_cpu(torch):
    """Phase 4t: narrow models of the three families served on the card and
    on the CPU, 6 prompts of 72-100 tokens and 48 greedy tokens: moonshot
    (2 layers, d_model 256, 2 heads over 2 KV of 128, 16 experts top-6 of
    d_ff 128; fp and int4 KV), qwen2-vl (7 heads over 1 KV of 128: G 7,
    M-RoPE sections (16, 24, 24); fp and int8) and musicgen (4 heads over
    4 KV of 64, GELU d_ff 1024, vocab 2048; fp).  A divergence is allowed
    at a flagged token near-tie (the CPU's top-2 margin within 2e-2 *
    max|logit|); a MoE divergence also records its gate gaps.  Then the
    narrow moonshot's graphed decode step against its eager one, bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    lens = (72, 100, 85, 91, 77, 96)
    moe = build_model(dataclasses.replace(get_config(MOONSHOT_ARCH), num_layers=2, d_model=256,
                                          num_heads=2, num_kv_heads=2, head_dim=128, d_ff=128,
                                          vocab_size=1000, num_experts=16))
    qwen = build_model(dataclasses.replace(get_config(QWEN_ARCH), num_layers=2, d_model=256,
                                           num_heads=7, num_kv_heads=1, head_dim=128, d_ff=688,
                                           vocab_size=1000))
    mg = build_model(dataclasses.replace(get_config(MUSICGEN_ARCH), num_layers=2, d_model=256,
                                         num_heads=4, num_kv_heads=4, d_ff=1024))
    out = {}
    for name, sm, kv_bits, need, forbid in (
            ("moonshot fp", moe, None, ("qmm_bitserial", "paged_attention"), PAGED[1:]),
            ("moonshot int4", moe, 4, ("qmm_bitserial", "fused_qkv_paged_decode"),
             ("paged_attention", "paged_attention_quant")),
            ("qwen2-vl fp", qwen, None, ("qmm_bitserial", "paged_attention"), PAGED[1:]),
            ("qwen2-vl int8", qwen, 8, ("qmm_bitserial", "paged_attention_quant"),
             ("paged_attention", "fused_qkv_paged_decode")),
            ("musicgen fp", mg, None, ("qmm_bitserial", "paged_attention"), PAGED[1:])):
        params = sm.init(seed=13, device="cpu")
        out[name] = served_streams_card_vs_cpu(torch, sm, params, kv_bits, lens=lens, gen=48,
                                               need=need, forbid=forbid)
    out["moe graphed"] = moe_graphed_witness(torch, moe, moe.init(seed=13, device="cpu"))
    return out


T_START = time.perf_counter()


def phase(title: str) -> None:
    print(f"{title} [{time.perf_counter() - T_START:.1f} s]")


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
    print("  h2o-danube-3-4b's decode attention: KV 8, G 4, hd 120, bs 16, 4096-token rings")
    pa120_err, paq120_err = check_ring_attention(torch, timer, peaks, rows)
    print("  h2o-danube-3-4b's qmm shapes")
    qmm_err = max(qmm_err, check_qmm(torch, timer, peaks, rows, DANUBE_QMM, DANUBE_MS, seed=3))
    print("  hymba-1.5b's decode attention: KV 5, G 5, hd 64, bs 16, 1024-token rings")
    pa64_err, paq64_err = check_ring_attention(torch, timer, peaks, rows, HYMBA_RING,
                                               HYMBA_RING_LENGTHS, seed=22)
    print("  rwkv6-1.6b's and hymba-1.5b's qmm shapes")
    qmm_err = max(qmm_err, check_qmm(torch, timer, peaks, rows, RWKV_QMM + HYMBA_QMM,
                                     RECURRENT_MS, seed=4))
    fused_err = check_fused_decode(torch, timer, peaks, rows)
    mva_errs = check_mva_kernels(torch, timer, peaks, rows)
    fq_err = check_fake_quant(torch, timer, peaks, rows)
    fqg_err = check_fake_quant_group(torch, timer, peaks, rows)
    fqc_err = check_fake_quant_col(torch, timer, peaks, rows)
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
    # the prefix cache's own cost on prompts that never hit: off, off, then
    # on a third time, so 3a 2nd / off / off / 3a 3rd run in turns
    phase("phase 3a, prefix cache: --no-prefix-cache twice, then the default path a third time")
    fp_nc_flags = [*fp_flags, "--no-prefix-cache"]
    fp_nc = serve_path(torch, "fp KV, no prefix cache", fp_nc_flags, fp_need, built)
    fp_nc2 = serve_path(torch, "fp KV, no prefix cache, 2nd", fp_nc_flags, fp_need, built)
    fp3 = serve_path(torch, "fp KV, 3rd", fp_flags, fp_need, built)
    fp_runs = {"3a": ("fp KV", fp), "3a'": ("fp KV, host sampling", fp_host),
               "3a''": ("fp KV, eager", fp_eager),
               "3a' 2nd": ("fp KV, host sampling, 2nd", fp_host2), "3a 2nd": ("fp KV, 2nd", fp2),
               "3a nc": ("fp KV, no prefix cache", fp_nc),
               "3a nc 2nd": ("fp KV, no prefix cache, 2nd", fp_nc2), "3a 3rd": ("fp KV, 3rd", fp3)}
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
    print("  greedy streams of 3a', 3a'' (eager decode step), of both paths served "
          "again in the other order and of 3a without the prefix cache equal 3a's bitwise")
    if fp_nc["metrics"]["prefix_lookups"] or fp_nc2["metrics"]["prefix_lookups"]:
        fail("[3a nc] --no-prefix-cache consulted the trie")
    tps = {k: [fp_runs[c][1]["metrics"]["tokens_per_s"] for c in cells]
           for k, cells in (("on", ("3a 2nd", "3a 3rd")), ("off", ("3a nc", "3a nc 2nd")))}
    print(f"  prefix cache on / off in turns (3a 2nd, nc, nc 2nd, 3a 3rd): tokens/s "
          f"{tps['on'][0]:.2f}, {tps['off'][0]:.2f}, {tps['off'][1]:.2f}, {tps['on'][1]:.2f}; "
          f"means {statistics.mean(tps['on']):.2f} on, {statistics.mean(tps['off']):.2f} off")
    fp_runs = {cell: {k: r[k] for k in ("metrics", "counts", "setup_s", "wall_s",
                                        "peak_mem_gib")}
               for cell, r in fp_runs.values()}
    del fp_host, fp_eager, fp_host2, fp2, fp_nc, fp_nc2, fp3
    phase("phase 3f: two tenants' shared system prompts, with the prefix cache and without")
    prefix = {"3f": tenant_prefix(torch, built, fp_need)}
    phase("phase 3g: peak concurrency at equal cache bytes, sharing against no sharing")
    prefix["3g"] = concurrency_gate(torch, built)
    phase("phase 3h: speculative decoding on 3a's params, --spec-k 4 --draft-bits 2")
    spec = {"3h": spec_cell(torch, fp, fp_need)}
    torch.cuda.empty_cache()
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

    # ---- spec decoding's ceiling: params snapped to the draft's 2-bit grid
    phase("phase 3i: speculative decoding on params snapped to the 2-bit grid, spec and not")
    spec["3i"] = spec_ceiling(torch, fp_need)
    torch.cuda.empty_cache()

    # ---- the ReLeQ search loop: LeNet quickstart twin, ResNet-20 at full width.
    # Deterministic cuDNN algorithms: ResNet-20's early training is chaotic
    # (the step at which it leaves chance level moves with the summation
    # order), so the accuracy floors below need a run that repeats.
    torch.backends.cudnn.deterministic = True
    phase("phase 3d: the quickstart twin on LeNet (pretrain 300, 30 episodes, long retrain 150)")
    lenet_task, lenet = releq_quickstart(torch)
    phase("phase 3s: the Fig 6 enumeration of LeNet's policies and its Pareto frontier")
    baselines = {"pareto": pareto_lenet(torch, lenet_task, lenet["best_bits"])}
    del lenet_task
    phase(f"phase 3e: ReLeQ search on ResNet-20 at full width (pretrain {RESNET20_PRETRAIN}, "
          f"{RESNET20_EPISODES} episodes at episode_end, long retrain 200)")
    task, resnet = releq_resnet20(torch)
    phase("phase 4e: one ResNet-20 QAT step, card against CPU")
    resnet["card_vs_cpu"] = resnet_step_card_vs_cpu(torch, task)
    phase("phase 5e: ResNet-20 QAT step breakdown")
    qat_breakdown = profile_qat_step(torch, task)
    phase("phase 3s: the Table 4 ADMM selector on 3e's ResNet-20 at 4.0 average bits")
    baselines["admm"] = admm_resnet20(torch, task)
    del task
    torch.cuda.empty_cache()

    # ---- the LM QAT path: glm4-9b's widths at 4 layers
    phase(f"phase 3j: LM QAT training, glm4-9b widths at {LM_LAYERS} layers, batch 2 x 4096 "
          f"({LM_UNIFORM_STEPS} steps at 8 bits, {LM_MIXED_STEPS} mixed)")
    lm_run, lm_state, lm = lm_train(torch)
    phase("phase 5j: LM QAT step breakdown")
    lm_state, lm["breakdown"] = profile_lm_step(torch, lm_run, lm_state)
    lm_model, lm_params = lm_run["model"], lm_state["params"]
    del lm_run, lm_state
    torch.cuda.empty_cache()
    phase(f"phase 3k: LM ReLeQ search on 3j's params ({LM_EPISODES} episodes at episode_end, "
          f"2 retrain steps)")
    lm["search"] = lm_search_phase(torch, lm_model, lm_params)
    del lm_model, lm_params
    torch.cuda.empty_cache()
    phase("phase 4j: one LM QAT step, card against CPU")
    lm["card_vs_cpu"] = lm_step_card_vs_cpu(torch)
    torch.cuda.empty_cache()

    # ---- h2o-danube-3-4b: sliding-window ring pools at head dim 120
    phase("phase 3l: h2o-danube-3-4b serving end to end, --bits 4, fp KV ring blocks")
    danube = danube_serving(torch)
    phase("phase 4l: a windowed hd-120 model served on the card and on the CPU, past the wrap")
    ring_streams = ring_card_vs_cpu(torch)
    for r in danube.values():
        for key in ("engine", "model", "sparams"):
            r.pop(key, None)
    torch.cuda.empty_cache()

    # ---- the recurrent families: rwkv6-1.6b and hymba-1.5b
    phase("phase 3o: rwkv6-1.6b serving end to end, --bits 4, the glm4 cell's traffic")
    rec = recurrent_serving(torch)
    phase("phase 3r: speculative decoding on rwkv6-1.6b and hymba-1.5b at 6 and 8 layers "
          "(3o's and 3p's traffic), --spec-k 4 --draft-bits 2")
    rec_spec = spec_recurrent_cut(torch)
    phase("phase 3r, snapped: rwkv6-1.6b on params snapped to the 2-bit grid (3i's regime), "
          "no spec, then spec")
    snapped = serve_path(torch, "rwkv snapped, no spec", ["--bits", "4"],
                         ("qmm_bitserial", "qmm_dequant"), snapped_build(torch, RWKV_ARCH),
                         arch=RWKV_ARCH, forbid=PAGED)
    rec_spec["rwkv snapped"] = spec_recurrent(torch, snapped, "rwkv snapped spec", partial=True)
    rec_spec["rwkv snapped"]["no_spec"] = cell_summary(snapped)
    del snapped
    phase("phase 5o: decode step breakdown, rwkv6-1.6b and hymba-1.5b")
    rec_breakdown = {}
    for cell, label in (("3o", "rwkv"), ("3p", "hymba fp KV")):
        print(f"  [{label}, pipeline]")
        rec_breakdown[label] = profile_decode(torch, rec[cell]["engine"], rec[cell]["work"])
    for r in rec.values():
        for key in ("engine", "model", "sparams"):
            r.pop(key, None)
    torch.cuda.empty_cache()
    phase("phase 4o: narrow rwkv6 and hymba models served on the card and on the CPU")
    rec_streams = recurrent_card_vs_cpu(torch)
    torch.cuda.empty_cache()

    # ---- the moe, vlm and audio families: moonshot, qwen2-vl, musicgen
    phase("phase 3t: moonshot-v1-16b-a3b serving end to end, --bits 4, fp KV (64 experts top-6)")
    mva = mva_serving(torch)
    phase("phase 4t: narrow moonshot, qwen2-vl and musicgen models served on the card and on "
          "the CPU; a MoE graphed step against its eager one")
    mva_streams = mva_card_vs_cpu(torch)

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
    # h2o-danube-3-4b's decode step: 24 layers over full 4096-token rings
    attn120 = per_step(rows, "paged_attention", lambda r: 24 if r["shape"] == "hd120 decode" else 0)
    attn120_q = per_step(rows, "paged_attention_quant",
                         lambda r: 24 if r["shape"] == "hd120 decode"
                         and r["container"] == "int8" else 0)
    # the recurrent families' decode steps (M = 4) and 256-token prefill chunks
    rec_calls = {name: n for name, _, _, _, n, *_ in RWKV_QMM + HYMBA_QMM}

    def rec_qmm(kernel, prefix, M):
        return per_step(rows, kernel, lambda r: rec_calls.get(r["shape"], 0)
                        if r["M"] == M and r["shape"].startswith(prefix)
                        and (M == 4 or "lm_head" not in r["shape"]) else 0,
                        ("bound_bf16_ms",))

    attn64 = per_step(rows, "paged_attention", lambda r: 32 if r["shape"] == "g5 decode" else 0)
    attn64_q = per_step(rows, "paged_attention_quant",
                        lambda r: 32 if r["shape"] == "g5 decode"
                        and r["container"] == "int8" else 0)
    fused = per_step(rows, "fused_qkv_paged_decode", main_int("int4"),
                     [f"{launch}_{key}" for launch in ("project", "attend")
                      for key in ("ms", "library_ms", "bound_ms")])
    fq = per_step(rows, "fake_quant", lambda r: r["calls_per_forward"])
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    fqg, fqg_bwd = ({k: r[k] for k in keys} for r in rows
                    if r["kernel"] in ("fake_quant_group", "fake_quant_group_bwd")
                    and r["calls_per_forward"])
    fqc, fqc_bwd = ({k: r[k] for k in keys} for r in rows
                    if r["kernel"] in ("fake_quant_group_col", "fake_quant_group_col_bwd"))
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
        {"name": "paged_attention_hd120", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:37",
         "launches": danube["3l"]["counts"]["paged_attention"], "max_abs_err": pa120_err,
         **attn120},
        {"name": "paged_attention_quant_hd120", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention_quant.cu",
         "replaces": "src/repro/kernels/paged_attention.py:117",
         "launches": danube["3m"]["counts"]["paged_attention_quant"], "max_abs_err": paq120_err,
         **attn120_q},
        *({"name": f"qmm_{path}_{fam}", "route": "cuda", "source": "src/repro_torch/csrc/qmm.cu",
           "replaces": f"src/repro/kernels/qmm.py:{78 if path == 'bitserial' else 57}",
           "launches": rec[cell]["counts"][f"qmm_{path}"], "max_abs_err": qmm_err,
           **rec_qmm(f"qmm_{path}", fam, 4 if path == "bitserial" else 256)}
          for fam, cell in (("rwkv", "3o"), ("hymba", "3p"))
          for path in ("bitserial", "dequant")),
        {"name": "paged_attention_g5_hd64", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:37",
         "launches": rec["3p"]["counts"]["paged_attention"], "max_abs_err": pa64_err,
         **attn64},
        {"name": "paged_attention_quant_g5_hd64", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention_quant.cu",
         "replaces": "src/repro/kernels/paged_attention.py:117",
         "launches": rec["3q"]["counts"]["paged_attention_quant"], "max_abs_err": paq64_err,
         **attn64_q},
        {"name": "fused_qkv_paged_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_decode.cu",
         "replaces": "src/repro/kernels/fused_decode.py:63",
         "launches": counts["int4 KV"]["fused_qkv_paged_decode"], "max_abs_err": fused_err,
         **fused},
        *({"name": f"qmm_{path}_{fam}", "route": "cuda", "source": "src/repro_torch/csrc/qmm.cu",
           "replaces": f"src/repro/kernels/qmm.py:{78 if path == 'bitserial' else 57}",
           "launches": mva[cell]["counts"][f"qmm_{path}"], "max_abs_err": mva_errs[0],
           **mva_qmm(rows, fam, path == "bitserial")}
          for fam, cell in (("moonshot", "3t"), ("qwen2-vl", "3u"), ("musicgen", "3v"))
          for path in ("bitserial", "dequant")),
        *({"name": f"paged_attention_{tag.replace(' ', '_')}", "route": "cuda",
           "source": "src/repro_torch/csrc/paged_attention.cu",
           "replaces": "src/repro/kernels/paged_attention.py:37",
           "launches": mva[cell]["counts"]["paged_attention"], "max_abs_err": mva_errs[1],
           **per_step(rows, "paged_attention",
                      lambda r, tag=tag: MVA_LAYERS[tag] if r["shape"] == f"{tag} decode" else 0)}
          for tag, cell in (("g1 hd128", "3t"), ("g7 hd128", "3u"), ("g1 hd64", "3v"))),
        {"name": "paged_attention_quant_g7_hd128", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention_quant.cu",
         "replaces": "src/repro/kernels/paged_attention.py:117",
         "launches": mva["3u int8"]["counts"]["paged_attention_quant"],
         "max_abs_err": mva_errs[2],
         **per_step(rows, "paged_attention_quant",
                    lambda r: 28 if r["shape"] == "g7 hd128 decode"
                    and r["container"] == "int8" else 0)},
        {"name": "fused_qkv_paged_decode_g1", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_decode.cu",
         "replaces": "src/repro/kernels/fused_decode.py:63",
         "launches": mva["3t int4"]["counts"]["fused_qkv_paged_decode"],
         "max_abs_err": mva_errs[3],
         **per_step(rows, "fused_qkv_paged_decode",
                    lambda r: 48 if r["shape"] == "g1 main" and r["container"] == "int4" else 0,
                    [f"{launch}_{key}" for launch in ("project", "attend")
                     for key in ("ms", "library_ms", "bound_ms")])},
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
        {"name": "fake_quant_group_col", "route": "cuda",
         "source": "src/repro_torch/csrc/fake_quant.cu",
         "replaces": "src/repro/kernels/fake_quant.py:33",
         "launches": lm["counts"]["fake_quant_group_col"], "max_abs_err": fqc_err, **fqc},
        {"name": "fake_quant_group_col_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/fake_quant.cu",
         "replaces": "src/repro/quant/wrpn.py:78",
         "launches": lm["counts"]["fake_quant_group_col_bwd"], "max_abs_err": fqc_err,
         **fqc_bwd},
    ]
    serve = {label: {"metrics": {k: v for k, v in r["metrics"].items() if k != "requests"},
                     "requests": r["metrics"]["requests"], "counts": r["counts"],
                     "setup_s": r["setup_s"], "wall_s": r["wall_s"],
                     "peak_mem_gib": r["peak_mem_gib"]}
             for label, r in (*fp_runs.items(), ("int4 KV", int4), ("int8 KV", int8),
                              *((f"danube {c}", danube[c]) for c in ("3l", "3m", "3n")),
                              *((f"{RWKV_ARCH if c.startswith('3o') else HYMBA_ARCH} {c}",
                                 rec[c]) for c in rec),
                              *((f"{r['args'].arch} {c}", r) for c, r in mva.items()))}
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
                         "backward (one launch each, f32, bits QAT_BITS); the backward's library "
                         "call is the autograd backward of fake_quantize_per_tensor_affine; "
                         "fake_quant_group_col / _bwd: one QAT forward / backward of the 4-layer "
                         "glm4-9b cell (9 leaves, bf16, phase 3j's mixed policy), launches from "
                         "phase 3j; paged_attention_hd120 / paged_attention_quant_hd120 (int8): "
                         "h2o-danube-3-4b's decode step, 24 calls over full 4096-token rings "
                         "(KV 8, G 4, hd 120), launches from phases 3l / 3m; "
                         "qmm_*_rwkv / qmm_*_hymba: one decode step at M=4 (193 / 321 calls, "
                         "lm_head included) and one 256-token prefill chunk (192 / 320 layer "
                         "calls), launches from phases 3o / 3p; paged_attention_g5_hd64 and "
                         "paged_attention_quant_g5_hd64 (int8): hymba-1.5b's decode step, 32 "
                         "calls over full 1024-token rings (KV 5, G 5, hd 64), launches from "
                         "phases 3p / 3q; qmm_*_moonshot / qwen2-vl / musicgen: one fp-KV "
                         "decode step (moonshot's 9,216 expert calls at 32 rows, 192 "
                         "projections and the lm_head at 4 rows) and one 64-token chunk "
                         "(experts at 384 rows, the rest at 64, no lm_head), launches from "
                         "phases 3t / 3u / 3v; paged_attention_g1_hd128 / g7_hd128 / g1_hd64 "
                         "and paged_attention_quant_g7_hd128 (int8): 48 / 28 / 48 calls at "
                         "the served lengths 41-96; fused_qkv_paged_decode_g1 (int4): "
                         "moonshot's 48 calls, launches from phase 3t's int4 turn",
        "serve": serve, "prefix": prefix, "spec": spec, "decode_breakdown": breakdown,
        "served_streams": streams,
        "danube": {"3n_diverged": danube["3n"]["diverged"], "static": danube["3n static"],
                   "ring_streams_4l": ring_streams},
        "releq": {"lenet_quickstart": lenet, "resnet20": resnet,
                  "qat_step_breakdown": qat_breakdown},
        "lm": lm,
        "recurrent": {"state_bytes_per_row": {c: r.get("state_bytes_per_row")
                                              for c, r in rec.items()},
                      "spec_3r": rec_spec, "decode_breakdown_5o": rec_breakdown,
                      "streams_4o": rec_streams, "baselines_3s": baselines},
        "moe_vlm_audio": {"summaries": {c: r["summary"] for c, r in mva.items()},
                          "decode_breakdown_5t": mva["3t"]["breakdown"],
                          "streams_4t": mva_streams},
        "total_s": time.perf_counter() - T_START}, indent=1, default=str))
    print(f"total {time.perf_counter() - T_START:.1f} s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
