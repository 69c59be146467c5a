"""Serving launcher: ``python -m repro_torch.launch.serve --arch glm4-9b --bits 4``.

Torch port of ``repro.launch.serve``: initialize params (random, seed
0), pack them at a ReLeQ policy (``--bits`` everywhere except the 8-bit
frozen embed/lm_head, or ``--policy-json``), then

- ``--mode continuous`` (default): serve the reference's synthetic
  workload — staggered arrivals every ``--arrival-every`` steps,
  heterogeneous output lengths — through
  :class:`repro_torch.serve.ServeEngine` with on-device sampling and the
  one-step-lookahead pipeline (on the card the decode step and the
  sampler are captured CUDA graphs).  ``--cache paged`` (default) uses
  the block pool with chunked prefill, ``--cache slot`` the slot pool
  with full-prompt prefill.  Prints tokens/s, per-request TTFT,
  occupancy, the sampler and pipeline counts and the kernel launch
  counts.
- ``--mode static``: the fixed-batch loop — ``--batch`` prompts of
  ``--prompt-len`` tokens drawn from ``default_rng(--seed)`` (the
  reference draws them from ``jax.random``), one full-prompt prefill,
  then ``--gen`` greedy decode steps; prints the prefill seconds, ms per
  token-step and the first sequence.

A sliding-window arch (h2o-danube-3-4b) serves from ring caches on
either pool.  The moe (moonshot-v1-16b-a3b; llama4-maverick-400b-a17b,
too large for one card), vlm (qwen2-vl-7b, M-RoPE) and audio
(musicgen-large, absolute sinusoids) archs serve through the same paths
from token prompts (their frontends are stubs, as in the reference).

Runs on ``--device cuda`` (default) and fails without a card; ``--device
cpu`` takes the plain versions of the kernels.  ``--min-prompt-len``
draws each prompt's length in ``[min, --prompt-len]`` (after the
reference's draws, so without it the workload is the reference's).

``--kv-bits B [B ...]`` quantizes the paged KV blocks (one width, or one
per layer; uniform 4 bits packs two codes per byte), and ``--kv-oracle``
stores their exact quantize-dequantize values in f32 instead.

``--prefix-cache`` (on by default, as the reference's) shares full
prompt-prefix KV blocks across sequences through the pool's refcounted
trie; ``--tenants N`` gives the requests of each of N tenants a shared
system prompt (3/4 of the prompt, drawn right after the prompts, as the
reference draws it).  ``--spec-k K --draft-bits B`` turns on speculative
decoding with the quantized self-draft (the same packed weights at B
planes roll K tokens per window, one batched verify scores them).
``--host-sampling`` selects tokens on the host from fetched logits
(implies ``--no-pipeline``); ``--no-pipeline`` keeps device sampling but
syncs every step, as the reference's flags do.

``--ckpt-dir DIR`` serves the ``params`` of the newest complete step in
DIR, packed at the policy as freshly drawn params are: a step the port's
trainer (``launch/train.py --ckpt-dir``) wrote (its manifest's JSON
``tree``), or one the reference's trainer wrote (a ``treedef.pkl``
beside the leaves), read by ``convert.params_from_jax_checkpoint``
without unpickling.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import ckpt as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.convert import is_jax_checkpoint, params_from_jax_checkpoint
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qat import policy_for
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.spec import SpecConfig
from repro_torch.train.serve import make_decode_step, quantize_for_serving

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--mode", choices=("continuous", "static"), default="continuous")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--policy-json", default=None)
    ap.add_argument("--batch", type=int, default=4,
                    help="static mode: fixed batch size")
    ap.add_argument("--seed", type=int, default=1,
                    help="static mode: numpy seed of the prompts")
    ap.add_argument("--num-slots", type=int, default=4,
                    help="max concurrent sequences")
    ap.add_argument("--cache", choices=("paged", "slot"), default="paged",
                    help="paged: block pool + chunked prefill; slot: one "
                         "contiguous row per sequence + full-prompt prefill")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="physical KV blocks (default: full capacity; less "
                         "oversubscribes and may preempt)")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="fixed prefill chunk length")
    ap.add_argument("--kv-bits", type=int, nargs="+", default=None,
                    help="quantize KV blocks: one width, or one per layer")
    ap.add_argument("--kv-oracle", action="store_true",
                    help="with --kv-bits: store exact QDQ values in f32")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="share full prompt-prefix KV blocks across sequences "
                         "(refcounted, copy on write)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="group requests into this many tenants sharing a "
                         "system-prompt prefix (0 = fully unique prompts)")
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic workload size")
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="steps between request arrivals")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculate this many tokens per window with the "
                         "quantized self-draft (0 = off)")
    ap.add_argument("--draft-bits", type=int, default=2,
                    help="bitwidth of the self-draft's packed-weight view")
    ap.add_argument("--host-sampling", action="store_true",
                    help="select tokens on the host from fetched logits "
                         "instead of the on-device sampler; implies "
                         "--no-pipeline")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="disable the one-step-lookahead decode pipeline "
                         "(dispatch and fetch every step in turn)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--min-prompt-len", type=int, default=None,
                    help="draw prompt lengths in [min, --prompt-len]")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a Chrome-trace of the run")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    help="log a registry snapshot line every N engine steps")
    ap.add_argument("--log-json", action="store_true",
                    help="structured logs as JSON lines instead of text")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def build(args, cfg=None):
    """-> (cfg, model, serving params, policy) for ``cfg`` (else
    ``--arch``/``--smoke``): random params (seed 0), or with
    ``--ckpt-dir`` the ``params`` of the newest complete step the port's
    or the reference's trainer saved there, packed at the policy.  The bf16 masters are freed
    when this returns; only the packed weights stay."""
    cfg = cfg or get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    if args.ckpt_dir:
        _, path = ckpt_lib.step_path(args.ckpt_dir)
        if is_jax_checkpoint(path):
            params, _, step = params_from_jax_checkpoint(args.ckpt_dir, model,
                                                         device=args.device)
        else:
            params, _, step = ckpt_lib.restore(args.ckpt_dir, device=args.device,
                                               subtree="params")
        print(f"restored step {step} from {args.ckpt_dir}")
    else:
        params = model.init(seed=0, device=args.device)
    if args.policy_json:
        policy = QuantPolicy.from_file(args.policy_json)
    else:
        policy = policy_for(model, default_bits=args.bits)
    sparams = quantize_for_serving(model, params, policy, device=args.device)
    return cfg, model, sparams, policy


def synthetic_workload(args, vocab_size: int) -> list[tuple[np.ndarray, int]]:
    """The reference launcher's workload: ``(prompt, max_new_tokens)`` per
    request, drawn from ``default_rng(1)`` in the reference's order (with
    ``--tenants``, each tenant's system prompt replaces the first 3/4 of
    its requests' prompts, drawn right after them)."""
    rng = np.random.default_rng(1)
    gens = [int(g) for g in
            rng.integers(max(1, args.gen // 2), args.gen + 1, args.requests)]
    prompts = rng.integers(0, vocab_size, (args.requests, args.prompt_len))
    if args.tenants:
        shared = args.prompt_len * 3 // 4
        sys_prompts = rng.integers(0, vocab_size, (args.tenants, shared))
        for i in range(args.requests):
            prompts[i, :shared] = sys_prompts[i % args.tenants]
    lens = [args.prompt_len] * args.requests
    if args.min_prompt_len is not None:
        lens = [int(n) for n in rng.integers(args.min_prompt_len,
                                             args.prompt_len + 1, args.requests)]
    return [(prompts[i, :lens[i]], gens[i] + 1) for i in range(args.requests)]


def drive(engine, workload, arrival_every: int, sampling: SamplingParams,
          metrics_interval: int = 0) -> None:
    """Submit ``workload`` one request every ``arrival_every`` engine steps
    and step until drained (works on the reference engine too)."""
    from repro_torch.obs import get_logger

    mlog = get_logger("serve.metrics")
    submitted = 0
    while submitted < len(workload) or engine.scheduler.has_work():
        while (submitted < len(workload)
               and engine.steps >= submitted * arrival_every):
            prompt, max_new = workload[submitted]
            engine.submit(prompt, max_new, sampling=sampling)
            submitted += 1
        engine.step()
        if metrics_interval and engine.steps % metrics_interval == 0:
            m = engine.metrics()
            mlog.event("snapshot", step=engine.steps, tokens=m["tokens_total"],
                       tokens_per_s=m["tokens_per_s"], queued=engine.num_queued,
                       running=engine.num_running, recompiles=m["recompiles"])


def continuous(args, cfg, model, sparams, policy) -> ServeEngine:
    """Serve the synthetic workload, print the summary, return the engine."""
    from repro_torch.obs.trace import Tracer

    kv_kw = {}
    if args.kv_bits:
        kv_kw["kv_bits"] = (args.kv_bits[0] if len(args.kv_bits) == 1
                            else args.kv_bits)
        kv_kw["kv_oracle"] = args.kv_oracle
    tracer = Tracer(enabled=True) if args.trace else None
    if tracer is not None:
        tracer.name_thread("serve-loop")
    spec = (SpecConfig(k=args.spec_k, draft_bits=args.draft_bits)
            if args.spec_k else None)
    engine = ServeEngine(model, sparams, num_slots=args.num_slots,
                         max_len=args.prompt_len + args.gen + 1, cache=args.cache,
                         block_size=args.block_size, num_blocks=args.num_blocks,
                         prefill_chunk=args.prefill_chunk, tracer=tracer,
                         prefix_cache=args.prefix_cache,
                         sample_device=not args.host_sampling,
                         pipeline=not (args.host_sampling or args.no_pipeline),
                         spec=spec, device=args.device, **kv_kw)
    drive(engine, synthetic_workload(args, cfg.vocab_size), args.arrival_every,
          SamplingParams(temperature=args.temperature), args.metrics_interval)
    m = engine.metrics()
    kv = (f", KV blocks at {args.kv_bits} bits" + (" (f32 oracle)" if args.kv_oracle else "")
          if args.kv_bits else "")
    paged = args.cache == "paged"
    print(f"served {args.requests} requests on {args.num_slots} {args.cache} rows "
          f"(avg policy {policy.average_bits():.1f} bits{kv}) on {args.device}")
    print(f"tokens/s={m['tokens_per_s']:.1f} occupancy={m['mean_occupancy']:.2f} "
          f"decode_steps={m['decode_steps']} tokens={m['tokens_total']}"
          + (f" preemptions={m['preemptions']} "
             f"block_occ={m['mean_block_occupancy']:.2f}" if paged else ""))
    sm, pl = m["sampler"], m["pipeline"]
    print(f"sampler={'device' if sm['device'] else 'host'} "
          f"fallbacks={sm['fallbacks']} "
          f"pipeline={'on' if pl['enabled'] else 'off'} "
          f"lookahead={pl['lookahead_steps']} bubbles={pl['bubbles']} "
          f"recompiles={m['recompiles']} graph_captures={engine.graph_captures}")
    print(f"decode step p50={m['decode_step_p50_ms']:.2f} ms "
          f"device/host p50={m['decode_device_p50_ms']:.2f}/"
          f"{m['decode_host_p50_ms']:.2f} ms")
    if paged:
        pc = m["prefix_cache"]
        print(f"prefix_cache={'on' if pc['enabled'] else 'off'} "
              f"hit_rate={m['prefix_hit_rate']:.3f} "
              f"hits={m['prefix_hits']}/{m['prefix_lookups']} lookups "
              f"blocks_shared={m['blocks_shared']:.1f} "
              f"prefill_launches={m['prefill_launches']} "
              f"hit_tokens={pc['hit_tokens']} cow={pc['cow_copies']} "
              f"evictions={pc['evictions']}")
    if "spec" in m:
        s = m["spec"]
        print(f"spec k={s['k']} draft_bits={args.draft_bits} "
              f"windows={s['windows']} "
              f"acceptance={s['acceptance_rate']:.3f} "
              f"({s['accepted']}/{s['proposed']})")
    print("kernel launches:", dict(kops.counts))
    for r in m["requests"]:
        print(f"  req {r['id']}: {r['new_tokens']} tokens, "
              f"ttft={r['ttft_steps']} steps / {r['ttft_s'] * 1e3:.0f} ms, "
              f"latency={r['latency_s'] * 1e3:.0f} ms")
    print("first sequence:", engine.output(0))
    if tracer is not None:
        tracer.save(args.trace)
        print(f"wrote {tracer.num_events} trace events to {args.trace}")
    return engine


def static_prompts(args, vocab_size: int) -> np.ndarray:
    """The static loop's ``(--batch, --prompt-len)`` prompts, from
    ``default_rng(--seed)``."""
    rng = np.random.default_rng(args.seed)
    return rng.integers(0, vocab_size, (args.batch, args.prompt_len)).astype(np.int32)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def static(args, cfg, model, sparams, policy) -> dict:
    """The fixed-batch loop: one full-prompt prefill of ``--batch``
    prompts, then ``--gen`` greedy decode steps over the contiguous cache
    (on the card a captured step; it writes the cache in place, where the
    reference's un-donated step returns a new one).  Prints and returns
    the prefill seconds, ms per token-step and the greedy tokens
    ``(batch, gen + 1)``."""
    tokens = torch.from_numpy(static_prompts(args, cfg.vocab_size)).to(args.device)
    _sync(args.device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(sparams, tokens=tokens,
                                  max_len=args.prompt_len + args.gen + 1)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    _sync(args.device)
    prefill_s = time.perf_counter() - t0
    dec = make_decode_step(model, device=args.device)
    toks = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen):
        logits, cache = dec(sparams, cache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        toks.append(tok)
    out = torch.cat(toks, dim=1).cpu().numpy()
    dt = time.perf_counter() - t0
    ms = dt / max(args.gen, 1) * 1e3
    print(f"served batch={args.batch} gen={args.gen} at {ms:.1f} ms/token-step, "
          f"prefill {prefill_s:.3f} s (avg policy {policy.average_bits():.1f} bits) "
          f"on {args.device}")
    print("kernel launches:", dict(kops.counts))
    print("first sequence:", out[0].tolist())
    return {"prefill_s": prefill_s, "ms_per_step": ms, "tokens": out}


def main(argv=None):
    """Run the launcher; returns the engine (continuous mode) or the
    static loop's results."""
    args = parse_args(argv)
    if args.log_json:
        from repro_torch.obs import configure

        configure(json_mode=True)
    cfg, model, sparams, policy = build(args)
    if args.mode == "static":
        return static(args, cfg, model, sparams, policy)
    return continuous(args, cfg, model, sparams, policy)


if __name__ == "__main__":
    main()
