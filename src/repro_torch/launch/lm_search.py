"""ReLeQ on a language model: search per-matrix bitwidths for the reduced
(smoke) config of ``--arch`` (glm4-9b by default; any family, the MoE's
expert banks one group per stacked layer) with the QAT train/eval steps
as the accuracy evaluator; the torch twin of
``examples/releq_lm_search.py``.

    PYTHONPATH=src python -m repro_torch.launch.lm_search --device cpu

By default, as the reference's, the asynchronous
``repro_torch.autotune.AutotuneService`` runs the search: episode
rollouts decoupled from the short retrains on a worker pool, results
consumed out of order, every candidate offered to a Pareto archive over
(rel-accuracy, SQ, latency), the latency from the analytic decode
roofline (``AnalyticLatencyEvaluator``, one H100's data-sheet rates).
``--lockstep`` runs the paper-faithful synchronous ``ReLeQSearch`` loop
over ``core.search.make_lm_env_factory`` instead.  Runs on ``--device
cuda`` (default) and fails without a card; ``--device cpu`` takes the
kernels' plain versions.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.search import ReLeQSearch, make_lm_env_factory
from repro_torch.data import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.quant.qat import bits_assignment, bits_to_device, policy_for
from repro_torch.train.train_step import init_state, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--episodes", type=int, default=12)
    ap.add_argument("--pretrain-steps", type=int, default=120)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--lockstep", action="store_true",
                    help="run the paper-faithful synchronous loop instead")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def search(model, params, data, episodes: int, device, finetune_steps: int = 2,
           eval_mode: str = "episode_end", log_every: int = 4):
    """The lockstep search over the LM factory -> (factory, SearchResult)."""
    factory = make_lm_env_factory(model, params, data, finetune_steps=finetune_steps,
                                  eval_mode=eval_mode)
    result = ReLeQSearch(factory, seed=0, device=device).run(episodes=episodes,
                                                             log_every=log_every)
    return factory, result


def search_async(model, params, data, episodes: int, device, workers: int = 2,
                 finetune_steps: int = 2, log_every: int = 4):
    """The asynchronous search (the reference example's default) with the
    analytic latency evaluator -> (service, SearchResult)."""
    from repro_torch.autotune import AnalyticLatencyEvaluator, AutotuneService, ServiceConfig

    factory = make_lm_env_factory(model, params, data, finetune_steps=finetune_steps)
    service = AutotuneService(
        factory,
        latency_eval=AnalyticLatencyEvaluator(model.quant_groups(), model.frozen_bits()),
        config=ServiceConfig(num_workers=workers, batch_episodes=2, seed=0),
        device=device)
    try:
        result = service.run(episodes=episodes, log_every=log_every)
    finally:
        service.shutdown()
    return service, result


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    model = build_model(cfg)
    data = SyntheticLMData(seed=0, global_batch=8, seq_len=32, vocab=cfg.vocab_size)

    print(f"== pretraining reduced {args.arch} ==")
    opt = AdamW(lr=3e-3)
    state = init_state(model, opt, seed=0, device=device)
    step = make_train_step(model, opt)
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 8)), device)
    m = None
    for _ in range(args.pretrain_steps):
        state, m = step(state, data.next(), bm)
    if m is not None:
        print(f"pretrain loss: {float(m['loss']):.3f}")

    out = {"model": model, "state": state}
    if args.lockstep:
        print("\n== lockstep ReLeQ search ==")
        out["factory"], result = search(model, state["params"], data, args.episodes, device)
    else:
        print(f"\n== async ReLeQ search ({args.workers} workers) ==")
        out["service"], result = search_async(model, state["params"], data, args.episodes,
                                              device, workers=args.workers)
        s = result.service_stats
        print(f"throughput {s['episodes_per_s']:.2f} episodes/s, {s['updates']} PPO updates, "
              f"retrain cache hit-rate {result.cache_stats['hit_rate']:.2f}")
        print(f"Pareto archive: {s['archive_size']} non-dominated policies")
        for e in out["service"].archive.entries():
            print(f"  acc={e.acc:.3f} sq={e.sq:.3f} lat={e.latency:.2e}s "
                  f"avg_bits={np.mean([b for _, b in e.bits]):.2f}")
    bits = result.best_bits
    print(f"\nbest policy (avg {np.mean(list(bits.values())):.2f} bits):")
    for name, b in list(bits.items())[:12]:
        print(f"  {name:20s} {b}")
    if len(bits) > 12:
        print(f"  ... (+{len(bits) - 12} groups)")
    print(f"retrain cache: {result.cache_stats}")
    return {**out, "result": result}


if __name__ == "__main__":
    main()
