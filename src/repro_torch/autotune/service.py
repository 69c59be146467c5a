"""Asynchronous ReLeQ search: actor/learner orchestrator over a worker pool
(torch port of ``repro.autotune.service``).

``ReLeQSearch`` (core/search.py) is a *lockstep* loop: every env steps
together, every PPO update waits for the slowest evaluation.  The service
decouples the three roles:

- **actor**: rolls episodes out through a ``deferred``-mode
  :class:`~repro_torch.core.env.QuantEnv` — agent forwards + the analytic SQ
  trace only, never blocking on a retrain — and dispatches the finished
  candidate bits to the evaluator pool;
- **workers** (:mod:`repro_torch.autotune.workers`): short-QAT accuracy and
  hardware-in-the-loop latency, running concurrently, results consumed
  in *completion order*;
- **learner**: finalizes each returned episode's terminal reward
  (``env.reward_for`` on the measured accuracy and the latency-blended
  quant state) into an off-policy buffer and runs a PPO update every
  ``batch_episodes`` completions.  Staleness is bounded: trajectories
  older than ``max_staleness`` policy versions are dropped; anything
  younger is corrected by PPO's own clipped likelihood ratio
  (``exp(logp_new - logp_old)`` *is* the importance weight, and the clip
  bounds its variance) — the standard staleness-bounded off-policy
  treatment for near-on-policy buffers.

Hardware in the reward: with a latency evaluator, the terminal quant
state becomes ``(1 - hw_weight) * SQ + hw_weight * latency/latency_8bit``
— both terms live in (0, 1] with "smaller is cheaper", so the paper's
shaped reward applies unchanged while measured serving cost (HAQ-style)
steers the search alongside the paper's analytic SQ.

Every evaluated candidate is offered to the Pareto archive, making the
search resumable and composable across runs (``archive.warm_start``).

The agent runs on ``device`` (the card unless ``device="cpu"``), in the
actor/learner thread, while workers retrain and time engines on the same
card: each worker's captures run in CUDA's thread-local mode
(``train.serve._Graph``).  Actions are drawn on the host from a CPU
``torch.Generator`` seeded ``seed + 1``, as ``core.search`` draws them.
"""
from __future__ import annotations

import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, wait
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.autotune.archive import ParetoArchive
from repro_torch.autotune.workers import AccuracyEvaluator, EvaluatorPool
from repro_torch.core.agent import init_agent
from repro_torch.core.env import STATE_DIM
from repro_torch.core.ppo import PPO, PPOConfig
from repro_torch.core.search import SearchResult


@dataclass
class ServiceConfig:
    num_workers: int = 4       # evaluation threads
    max_inflight: int = 8      # episodes awaiting evaluation
    batch_episodes: int = 4    # completed episodes per PPO update
    max_staleness: int = 3     # drop trajectories older than this many
    #                            policy versions (importance correction
    #                            only bounds variance near-on-policy)
    in_order: bool = False     # True: consume completions in submission
    #                            order (deterministic; used by tests)
    hw_weight: float = 0.5     # latency-ratio share of the terminal quant
    #                            state when a latency evaluator is present
    seed: int = 0


@dataclass
class _Episode:
    states: np.ndarray         # (T, STATE_DIM)
    actions: np.ndarray        # (T,)
    logps: np.ndarray          # (T,)
    values: np.ndarray         # (T,)
    rewards: np.ndarray        # (T,) — terminal entry provisional
    probs: np.ndarray          # (T, A)
    bits: dict
    quant: float               # final State of Quantization
    version: int               # policy version at rollout time
    index: int                 # submission order
    result: object = None      # EvalResult once evaluated
    final_reward: float = 0.0
    q_eff: float = 0.0


class AutotuneService:
    """Asynchronous hardware-in-the-loop ReLeQ search.

    ``make_env`` is any ReLeQSearch-compatible factory; the service runs
    its env in ``deferred`` mode and evaluates candidates through the
    worker pool.  Factories exposing ``.evaluate`` / ``.eval_cache``
    (``make_lm_env_factory``, ``CNNTask.make_env_factory``) share their
    memo-cache with the pool automatically.
    """

    def __init__(self, make_env, *, latency_eval=None,
                 ppo_config: PPOConfig | None = None,
                 archive: ParetoArchive | None = None,
                 config: ServiceConfig | None = None,
                 accuracy_thread_safe: bool = False,
                 registry=None, tracer=None, device=None):
        from repro_torch.obs import Registry, get_logger
        from repro_torch.obs.trace import NULL_TRACER

        self.device = resolve_device(device)
        self.cfg = config or ServiceConfig()
        self.obs = registry if registry is not None else Registry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._log = get_logger("autotune")
        self.env = make_env(0)
        self.env.eval_mode = "deferred"
        # prefer the factory's RAW compute + shared cache so the pool is
        # the single memo layer; a bare cached evaluate still works (the
        # EvalCache re-entrancy guard keeps self-layering deadlock-free)
        accuracy_fn = (getattr(make_env, "compute", None)
                       or getattr(make_env, "evaluate", None)
                       or self.env.evaluate)
        cache = getattr(make_env, "eval_cache", None)
        self.pool = EvaluatorPool(
            AccuracyEvaluator(accuracy_fn, cache=cache,
                              thread_safe=accuracy_thread_safe),
            latency_eval, num_workers=self.cfg.num_workers,
            registry=self.obs, tracer=self.tracer)
        objectives = ("acc", "sq", "latency") if latency_eval is not None \
            else ("acc", "sq")
        if archive is not None and "latency" in archive.objectives \
                and latency_eval is None:
            # fail at construction, not on the first completed episode
            raise ValueError(
                "archive ranks latency but no latency evaluator is "
                "configured — pass one, or warm-start the archive with "
                "objectives=('acc', 'sq')")
        self.archive = archive if archive is not None \
            else ParetoArchive(objectives=objectives)
        num_actions = len(self.env.bitset)
        self.ppo = PPO(init_agent(self.cfg.seed, STATE_DIM, num_actions, self.device),
                       ppo_config if ppo_config is not None else PPOConfig())
        self.gen = torch.Generator().manual_seed(self.cfg.seed + 1)
        self.version = 0
        self._buffer: list[_Episode] = []
        self._stale_dropped = 0
        self._updates = 0
        # search-side instruments: evaluator staleness at consumption
        # (how off-policy the learner actually runs), episode/update
        # counters, archive level
        obs = self.obs
        self._c_episodes = obs.counter("autotune.episodes")
        self._c_updates = obs.counter("autotune.ppo_updates")
        self._c_stale = obs.counter("autotune.stale_dropped",
                                    desc="episodes older than max_staleness")
        self._h_staleness = obs.histogram(
            "autotune.staleness", unit="versions",
            buckets=(0, 1, 2, 3, 5, 8, 13),
            desc="policy versions between rollout and PPO consumption")
        self._g_archive = obs.gauge("autotune.archive_size")

    # ----------------------------------------------------------- actor
    def _rollout(self, index: int) -> _Episode:
        with self.tracer.span("episode.rollout", episode=index,
                              version=self.version):
            return self._rollout_inner(index)

    def _rollout_inner(self, index: int) -> _Episode:
        env = self.env
        obs = env.reset()
        T, A = env.T, len(env.bitset)
        states = np.zeros((T, STATE_DIM), np.float32)
        actions = np.zeros((T,), np.int32)
        logps = np.zeros((T,), np.float32)
        values = np.zeros((T,), np.float32)
        rewards = np.zeros((T,), np.float32)
        probs = np.zeros((T, A), np.float32)
        carry = self.ppo.initial_carry(1)
        info = {}
        for t in range(T):
            carry, act, logp, val, pr = self.ppo.act(
                carry, torch.from_numpy(obs[None]).to(self.device), self.gen)
            a = int(act[0])
            states[t] = obs
            actions[t] = a
            logps[t] = float(logp[0])
            values[t] = float(val[0])
            probs[t] = pr[0].numpy()
            obs, reward, done, info = env.step(a)
            rewards[t] = reward  # terminal entry patched on completion
        return _Episode(states, actions, logps, values, rewards, probs,
                        bits=dict(info["bits"]), quant=float(info["quant"]),
                        version=self.version, index=index)

    # --------------------------------------------------------- learner
    def _finalize(self, ep: _Episode, result) -> None:
        q_eff = ep.quant
        ratio = result.latency_ratio()
        if ratio is not None and self.cfg.hw_weight > 0:
            w = self.cfg.hw_weight
            q_eff = (1.0 - w) * ep.quant + w * min(ratio, 1.0)
        ep.result = result
        ep.q_eff = q_eff
        ep.final_reward = self.env.reward_for(result.acc, q_eff)
        ep.rewards[-1] = ep.final_reward
        self._buffer.append(ep)

    def _maybe_update(self, force: bool = False) -> None:
        if not self._buffer:
            return
        if len(self._buffer) < self.cfg.batch_episodes and not force:
            return
        fresh = [e for e in self._buffer
                 if self.version - e.version <= self.cfg.max_staleness]
        dropped = len(self._buffer) - len(fresh)
        self._stale_dropped += dropped
        self._c_stale.inc(dropped)
        self._buffer.clear()
        if not fresh:
            return
        for e in fresh:  # staleness actually consumed by the learner
            self._h_staleness.observe(self.version - e.version)
        traj = {
            "states": np.stack([e.states for e in fresh]),
            "actions": np.stack([e.actions for e in fresh]),
            "logp_old": np.stack([e.logps for e in fresh]),
            "values": np.stack([e.values for e in fresh]),
            "rewards": np.stack([e.rewards for e in fresh]),
        }
        with self.tracer.span("ppo.update", episodes=len(fresh),
                              version=self.version, stale_dropped=dropped):
            self.ppo.update(traj)
        self.version += 1
        self._updates += 1
        self._c_updates.inc()

    # ------------------------------------------------------------- run
    def run(self, episodes: int, log_every: int = 0) -> SearchResult:
        cfg = self.cfg
        result = SearchResult(best_bits={}, best_reward=-np.inf)
        inflight: deque = deque()   # (future, episode) in submission order
        submitted = completed = 0
        evals_to_best = 0
        t_start = time.perf_counter()

        def consume(ep: _Episode, res) -> None:
            nonlocal completed, evals_to_best
            self._finalize(ep, res)
            completed += 1
            result.episodes.append({
                "episode": ep.index, "env": 0,
                "reward": ep.final_reward,
                "mean_reward": float(ep.rewards.mean()),
                "acc": res.acc, "quant": ep.quant, "q_eff": ep.q_eff,
                "latency": res.latency, "latency_ratio": res.latency_ratio(),
                "bits": dict(ep.bits), "version": ep.version,
                "staleness": self.version - ep.version,
                "cache_hit": res.acc_cache_hit,
            })
            result.prob_evolution.append(ep.probs)
            if ep.final_reward > result.best_reward:
                result.best_reward = ep.final_reward
                result.best_bits = dict(ep.bits)
                evals_to_best = completed
            self.archive.add(ep.bits, acc=res.acc, sq=ep.quant,
                             latency=res.latency, reward=ep.final_reward,
                             meta={"episode": ep.index})
            self.tracer.instant("archive.add", episode=ep.index,
                                reward=ep.final_reward, acc=res.acc,
                                size=len(self.archive))
            self._c_episodes.inc()
            self._g_archive.set(len(self.archive))
            self._maybe_update()
            if log_every and completed % log_every == 0:
                self._log.event(
                    "episode", episode=completed,
                    reward=ep.final_reward, acc=res.acc, quant=ep.quant,
                    staleness=self.version - ep.version,
                    version=self.version, archive=len(self.archive))

        while completed < episodes:
            # actor: keep the evaluation window full
            while submitted < episodes and len(inflight) < cfg.max_inflight:
                ep = self._rollout(submitted)
                inflight.append((self.pool.submit(ep.bits), ep))
                submitted += 1
            if cfg.in_order:
                fut, ep = inflight.popleft()
                consume(ep, fut.result())
                continue
            # out-of-order: drain whatever is done, else block for one
            done_idx = [i for i, (f, _) in enumerate(inflight) if f.done()]
            if not done_idx:
                wait([f for f, _ in inflight], return_when=FIRST_COMPLETED)
                done_idx = [i for i, (f, _) in enumerate(inflight)
                            if f.done()]
            for i in sorted(done_idx, reverse=True):
                fut, ep = inflight[i]
                del inflight[i]
                consume(ep, fut.result())

        self._maybe_update(force=True)
        wall = time.perf_counter() - t_start
        result.cache_stats = self.pool.accuracy.cache.stats()
        result.service_stats = {
            "episodes": completed,
            "wall_s": wall,
            "episodes_per_s": completed / wall if wall > 0 else 0.0,
            "updates": self._updates,
            "policy_version": self.version,
            "stale_dropped": self._stale_dropped,
            "evals_to_best": evals_to_best,
            "archive_size": len(self.archive),
            "pool": self.pool.stats(),
        }
        return result

    def shutdown(self) -> None:
        self.pool.shutdown()
