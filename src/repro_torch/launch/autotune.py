"""Autotune launcher: ``python -m repro_torch.launch.autotune --arch glm4-9b``
(torch port of ``repro.launch.autotune``).

One command from "pretrained params" to "discovered policy is serving":

1. pretrain the reduced model through the port's QAT ``train_step``,
2. run the asynchronous ReLeQ search service (``repro_torch.autotune``)
   with short-QAT accuracy workers and, optionally, hardware-in-the-loop
   latency workers (``--hw engine|analytic``),
3. checkpoint the Pareto archive (``--archive``: JSON, warm-started if
   the file already exists — searches compose across runs),
4. ``--deploy``: pull the ``--select`` winner, bit-pack its weights,
   hot-swap them into a live ServeEngine and run the A/B parity gate.

``--task cnn:lenet`` swaps the LM substrate for the paper's CNN oracle.
``--layers N`` cuts the model's depth and keeps its widths: on the card
``--no-smoke --layers 2`` reaches glm4-9b's widths (a published depth
with its optimizer state does not fit one card); the smoke defaults run
there as they are.
``--hw engine`` times real decode steps on the run's device (the card
unless ``--device cpu``).  ``--hw hlo`` keeps the reference's flag name
but not its XLA: it counts the port's own ops of the candidate's packed
decode step on meta tensors and rooflines them at H100 rates
(``OpCountLatencyEvaluator``; nothing allocated, on any ``--device``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch import resolve_device


def _build_lm(args, device):
    from repro_torch.configs import get_config
    from repro_torch.core.search import make_lm_env_factory
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.quant.qat import bits_assignment, bits_to_device, policy_for
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build_model(cfg)
    data = SyntheticLMData(seed=0, global_batch=8, seq_len=32, vocab=cfg.vocab_size)
    opt = AdamW(lr=3e-3)
    state = init_state(model, opt, seed=0, device=device)
    step = make_train_step(model, opt)
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 8)), device)
    print(f"== pretraining reduced {args.arch} ({args.pretrain_steps} steps) ==", flush=True)
    m = None
    for _ in range(args.pretrain_steps):
        state, m = step(state, data.next(), bm)
    if m is not None:
        print(f"pretrain loss: {float(m['loss']):.3f}")
    params = state["params"]
    del state
    factory = make_lm_env_factory(model, params, data, finetune_steps=args.finetune_steps,
                                  eval_mode="deferred")
    return model, params, factory, model.quant_groups(), model.frozen_bits()


def _build_cnn(args, net: str, device):
    from repro_torch.cnn import CNNTask

    task = CNNTask(net, seed=0, device=device)
    print(f"== pretraining {net} ({args.pretrain_steps} steps) ==", flush=True)
    task.pretrain(args.pretrain_steps)
    print(f"fp accuracy: {task.fp_acc:.3f}")
    factory = task.make_env_factory(retrain_steps=args.finetune_steps, eval_mode="deferred")
    # no ServeEngine deploy path for CNNs, but the analytic hw signal works
    return None, None, factory, task.groups, task.frozen


def _latency_eval(args, model, params, groups, frozen):
    from repro_torch.autotune import (AnalyticLatencyEvaluator, EngineLatencyEvaluator,
                                      OpCountLatencyEvaluator)

    if args.hw == "none":
        return None
    if args.hw in ("engine", "hlo") and model is None:
        raise SystemExit(f"--hw {args.hw} needs the LM serving stack (--task lm); CNN "
                         f"tasks support --hw analytic")
    if args.hw == "engine":
        return EngineLatencyEvaluator(model, params, num_slots=args.hw_slots,
                                      decode_steps=args.hw_decode_steps)
    if args.hw == "hlo":
        return OpCountLatencyEvaluator(model)
    return AnalyticLatencyEvaluator(groups, frozen)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--task", default="lm",
                    help="'lm' or 'cnn:<net>' (lenet, simplenet, ...)")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the LM's depth (widths kept)")
    ap.add_argument("--episodes", type=int, default=24)
    ap.add_argument("--pretrain-steps", type=int, default=120)
    ap.add_argument("--finetune-steps", type=int, default=2)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--inflight", type=int, default=8)
    ap.add_argument("--batch-episodes", type=int, default=4)
    ap.add_argument("--max-staleness", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hw", choices=("none", "analytic", "hlo", "engine"),
                    default="analytic",
                    help="latency evaluator: measured ServeEngine decode steps "
                         "(engine), the closed-form decode roofline at an H100's "
                         "rates (analytic), the packed decode step's op count "
                         "rooflined at H100 rates (hlo: the port's ops on meta "
                         "tensors, not XLA's HLO), or none")
    ap.add_argument("--hw-weight", type=float, default=0.5,
                    help="latency-ratio share of the terminal quant state")
    ap.add_argument("--hw-slots", type=int, default=2)
    ap.add_argument("--hw-decode-steps", type=int, default=8)
    ap.add_argument("--archive", default=None,
                    help="Pareto archive JSON (warm-started when present)")
    ap.add_argument("--deploy", action="store_true",
                    help="hot-swap the archive winner into a ServeEngine "
                         "and run the A/B parity gate")
    ap.add_argument("--select", default="knee",
                    choices=("knee", "accuracy", "efficiency", "latency", "reward"))
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record episode rollouts, evaluator-pool work "
                         "and PPO updates as a Chrome-trace file")
    ap.add_argument("--log-json", action="store_true",
                    help="structured logs as JSON lines instead of text")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    from repro_torch.autotune import AutotuneService, ParetoArchive, ServiceConfig
    from repro_torch.autotune import deploy as deploy_policy_to_engine

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.log_json:
        from repro_torch.obs import configure
        configure(json_mode=True)

    if args.task.startswith("cnn:"):
        model, params, factory, groups, frozen = _build_cnn(
            args, args.task.split(":", 1)[1], device)
    else:
        model, params, factory, groups, frozen = _build_lm(args, device)

    latency_eval = _latency_eval(args, model, params, groups, frozen)
    objectives = ("acc", "sq", "latency") if latency_eval is not None else ("acc", "sq")
    archive = ParetoArchive.warm_start(args.archive, objectives=objectives)
    if len(archive):
        print(f"warm-started archive: {len(archive)} entries")

    print(f"\n== async ReLeQ search: {args.episodes} episodes, {args.workers} workers, "
          f"hw={args.hw} ==", flush=True)
    tracer = None
    if args.trace:
        from repro_torch.obs.trace import Tracer

        tracer = Tracer(enabled=True)
        tracer.name_thread("actor-learner")
    service = AutotuneService(
        factory, latency_eval=latency_eval, archive=archive,
        config=ServiceConfig(num_workers=args.workers, max_inflight=args.inflight,
                             batch_episodes=args.batch_episodes,
                             max_staleness=args.max_staleness,
                             hw_weight=args.hw_weight, seed=args.seed),
        tracer=tracer, device=device)
    try:
        result = service.run(args.episodes, log_every=4)
    finally:
        service.shutdown()
    if tracer is not None:
        tracer.save(args.trace)
        print(f"wrote {tracer.num_events} trace events to {args.trace}")

    s = result.service_stats
    print(f"\nbest reward {result.best_reward:.4f} (avg {result.average_bits():.2f} bits) "
          f"after {s['evals_to_best']} evaluations")
    print(f"throughput {s['episodes_per_s']:.2f} episodes/s, {s['updates']} PPO updates "
          f"(final version {s['policy_version']}, {s['stale_dropped']} stale dropped), "
          f"cache hit-rate {result.cache_stats['hit_rate']:.2f}")
    print(f"archive: {len(archive)} non-dominated points")
    for e in archive.entries()[:8]:
        lat = f" lat={e.latency:.3e}s" if e.latency is not None else ""
        print(f"  acc={e.acc:.3f} sq={e.sq:.3f}{lat} "
              f"avg_bits={np.mean([b for _, b in e.bits]):.2f}")

    if args.archive:
        archive.save(args.archive)
        print(f"archive checkpointed to {args.archive}")

    out = {"model": model, "params": params, "result": result, "archive": archive,
           "service": service}
    if args.deploy:
        if model is None:
            raise SystemExit("--deploy needs the LM task (a ServeEngine)")
        from repro_torch.quant.qat import policy_for
        from repro_torch.serve import ServeEngine

        max_len = 16 + args.gen + 1
        engine = ServeEngine.from_params(
            model, params, policy_for(model, default_bits=8),
            num_slots=args.num_slots, max_len=max_len, device=device)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, model.cfg.vocab_size, 8) for _ in range(2)]
        policy, report = deploy_policy_to_engine(
            archive, model, params, engine, select=args.select,
            parity_prompts=prompts, max_new_tokens=args.gen)
        print(f"\ndeployed {args.select} winner (avg {policy.average_bits():.2f} bits): "
              f"parity={'OK' if report['parity']['match'] else 'FAIL'}")
        print(json.dumps({k: v for k, v in report.items() if k != "parity"}, indent=2))
        out.update(engine=engine, policy=policy, report=report)
    return out


if __name__ == "__main__":
    main()
