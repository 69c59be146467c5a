"""repro_torch.autotune: asynchronous hardware-in-the-loop ReLeQ search
service (torch port of ``repro.autotune``).

The paper's RL search, run as a service against the serving stack instead
of a synchronous offline loop:

- service.py   actor/learner orchestrator — PPO updates decoupled from
               episode evaluation via an off-policy buffer with
               staleness-bounded importance correction
- workers.py   evaluator pool: short-QAT accuracy + hardware-in-the-loop
               latency (real ServeEngine decode steps timed on the card,
               the op-count roofline of the packed decode step on meta
               tensors, or the analytic decode roofline) + draftability
               (candidate drafts for a fixed 8-bit target via
               ``repro_torch.spec``; reward = speculative seconds/token)
- archive.py   persistent Pareto archive over (rel-acc, SQ, latency)
               with dominance pruning, JSON checkpoints and warm-start
- deploy.py    archive winner -> packed weights -> hot-swap into a live
               ServeEngine with an A/B token-parity gate

CLI: ``python -m repro_torch.launch.autotune`` (search, archive, deploy).
"""
from repro_torch.autotune.archive import ArchiveEntry, ParetoArchive, dominates  # noqa: F401
from repro_torch.autotune.deploy import (  # noqa: F401
    ab_parity_check,
    compile_policy,
    deploy,
    hot_swap,
    policy_from_entry,
)
from repro_torch.autotune.service import AutotuneService, ServiceConfig  # noqa: F401
from repro_torch.autotune.workers import (  # noqa: F401
    AccuracyEvaluator,
    AnalyticLatencyEvaluator,
    DraftabilityEvaluator,
    EngineLatencyEvaluator,
    EvalResult,
    EvaluatorPool,
    OpCountLatencyEvaluator,
)
