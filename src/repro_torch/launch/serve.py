"""Serving launcher: ``python -m repro_torch.launch.serve --arch glm4-9b --bits 4``.

Torch port of ``repro.launch.serve``, continuous mode: initialize params
(random, seed 0), pack them at a ReLeQ policy
(``--bits`` everywhere except the 8-bit frozen embed/lm_head, or
``--policy-json``), and serve the reference's synthetic workload —
staggered arrivals every ``--arrival-every`` steps, heterogeneous output
lengths — through :class:`repro_torch.serve.ServeEngine` on the paged
pool with chunked prefill, on-device sampling and the one-step-lookahead
pipeline (on the card the decode step and the sampler are captured CUDA
graphs).  Prints tokens/s, per-request TTFT, occupancy, the sampler and
pipeline counts and the kernel launch counts.

Runs on ``--device cuda`` (default) and fails without a card; ``--device
cpu`` takes the plain versions of the kernels.  ``--min-prompt-len``
draws each prompt's length in ``[min, --prompt-len]`` (after the
reference's draws, so without it the workload is the reference's).

``--kv-bits B [B ...]`` quantizes the paged KV blocks (one width, or one
per layer; uniform 4 bits packs two codes per byte), and ``--kv-oracle``
stores their exact quantize-dequantize values in f32 instead.
``--host-sampling`` selects tokens on the host from fetched logits
(implies ``--no-pipeline``); ``--no-pipeline`` keeps device sampling but
syncs every step, as the reference's flags do.

Flags of the reference that this port does not have yet are refused
with the ROADMAP item that brings them: ``--mode static``, ``--cache
slot``, ``--prefix-cache``, ``--tenants``, ``--spec-k``, ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qat import policy_for
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.train.serve import quantize_for_serving

_UNPORTED = (  # (flag test, flag, ROADMAP item)
    (lambda a: a.mode != "continuous", "--mode static", "slice A, item 3 (rest)"),
    (lambda a: a.cache != "paged", "--cache slot", "slice A, item 3 (rest)"),
    (lambda a: a.prefix_cache, "--prefix-cache", "slice A, item 5"),
    (lambda a: a.tenants, "--tenants", "slice A, item 5"),
    (lambda a: a.spec_k, "--spec-k", "slice A, item 7"),
    (lambda a: a.ckpt_dir, "--ckpt-dir", "slice D, item 10"),
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--mode", choices=("continuous", "static"), default="continuous")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--policy-json", default=None)
    ap.add_argument("--num-slots", type=int, default=4,
                    help="max concurrent sequences")
    ap.add_argument("--cache", choices=("paged", "slot"), default="paged")
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
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--tenants", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic workload size")
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="steps between request arrivals")
    ap.add_argument("--spec-k", type=int, default=0)
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
    ap = build_parser()
    args = ap.parse_args(argv)
    for unported, flag, item in _UNPORTED:
        if unported(args):
            ap.error(f"{flag} is not ported to repro_torch yet "
                     f"(ROADMAP.md queue 1, {item})")
    return args


def build(args):
    """-> (cfg, model, serving params, policy).  The bf16 masters are
    freed when this returns; only the packed weights stay."""
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params = model.init(seed=0, device=args.device)
    if args.policy_json:
        policy = QuantPolicy.from_file(args.policy_json)
    else:
        policy = policy_for(model, default_bits=args.bits)
    sparams = quantize_for_serving(model, params, policy, device=args.device)
    return cfg, model, sparams, policy


def synthetic_workload(args, vocab_size: int) -> list[tuple[np.ndarray, int]]:
    """The reference launcher's workload: ``(prompt, max_new_tokens)`` per
    request, drawn from ``default_rng(1)`` in the reference's order."""
    rng = np.random.default_rng(1)
    gens = [int(g) for g in
            rng.integers(max(1, args.gen // 2), args.gen + 1, args.requests)]
    prompts = rng.integers(0, vocab_size, (args.requests, args.prompt_len))
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
    engine = ServeEngine(model, sparams, num_slots=args.num_slots,
                         max_len=args.prompt_len + args.gen + 1,
                         block_size=args.block_size, num_blocks=args.num_blocks,
                         prefill_chunk=args.prefill_chunk, tracer=tracer,
                         sample_device=not args.host_sampling,
                         pipeline=not (args.host_sampling or args.no_pipeline),
                         device=args.device, **kv_kw)
    drive(engine, synthetic_workload(args, cfg.vocab_size), args.arrival_every,
          SamplingParams(temperature=args.temperature), args.metrics_interval)
    m = engine.metrics()
    kv = (f", KV blocks at {args.kv_bits} bits" + (" (f32 oracle)" if args.kv_oracle else "")
          if args.kv_bits else "")
    print(f"served {args.requests} requests on {args.num_slots} paged rows "
          f"(avg policy {policy.average_bits():.1f} bits{kv}) on {args.device}")
    print(f"tokens/s={m['tokens_per_s']:.1f} occupancy={m['mean_occupancy']:.2f} "
          f"decode_steps={m['decode_steps']} tokens={m['tokens_total']} "
          f"preemptions={m['preemptions']} "
          f"block_occ={m['mean_block_occupancy']:.2f}")
    sm, pl = m["sampler"], m["pipeline"]
    print(f"sampler={'device' if sm['device'] else 'host'} "
          f"fallbacks={sm['fallbacks']} "
          f"pipeline={'on' if pl['enabled'] else 'off'} "
          f"lookahead={pl['lookahead_steps']} bubbles={pl['bubbles']} "
          f"recompiles={m['recompiles']} graph_captures={engine.graph_captures}")
    print(f"decode step p50={m['decode_step_p50_ms']:.2f} ms "
          f"device/host p50={m['decode_device_p50_ms']:.2f}/"
          f"{m['decode_host_p50_ms']:.2f} ms "
          f"prefill_launches={m['prefill_launches']}")
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


def main(argv=None) -> ServeEngine:
    args = parse_args(argv)
    if args.log_json:
        from repro_torch.obs import configure

        configure(json_mode=True)
    cfg, model, sparams, policy = build(args)
    return continuous(args, cfg, model, sparams, policy)


if __name__ == "__main__":
    main()
