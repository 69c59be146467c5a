"""ReLeQ search loop: PPO agent × quantization environment (Fig 4);
torch port of ``repro.core.search``.

Faithful mode (paper): one environment, PPO update at the end of every
episode; ``num_envs`` environments step in lockstep through one batched
agent forward.  Produces the learning record the paper's figures need:
per-episode (reward, acc state, quant state, bits) and the per-layer
action-probability evolution (Fig 5).

The agent runs on ``device`` (the card unless ``device="cpu"``); actions
are drawn on the host from a CPU ``torch.Generator`` seeded ``seed + 1``,
as the reference seeds its action key, so a seed gives the same search on
the CPU and on the card up to float rounding.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.agent import init_agent
from repro_torch.core.env import STATE_DIM
from repro_torch.core.ppo import PPO, PPOConfig


@dataclass
class SearchResult:
    best_bits: dict
    best_reward: float
    episodes: list = field(default_factory=list)   # per-episode records
    prob_evolution: list = field(default_factory=list)  # (episode, T, A)
    cache_stats: dict = field(default_factory=dict)  # evaluate() memo hit-rate
    service_stats: dict = field(default_factory=dict)  # async-run throughput

    def average_bits(self, searchable_only=None) -> float:
        """Mean bitwidth over ``searchable_only`` (None -> every group).

        ``None`` and ``[]`` are distinct: None means "average everything",
        while an explicit empty selection has no defined mean and raises."""
        names = list(self.best_bits) if searchable_only is None \
            else list(searchable_only)
        if not names:
            raise ValueError("average_bits over an empty group selection")
        return float(np.mean([self.best_bits[n] for n in names]))


class ReLeQSearch:
    def __init__(self, make_env, *, num_envs: int = 1, seed: int = 0,
                 ppo_config: PPOConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.make_env = make_env
        self.envs = [make_env(i) for i in range(num_envs)]
        self.num_envs = num_envs
        num_actions = len(self.envs[0].bitset)
        params = init_agent(seed, STATE_DIM, num_actions, self.device)
        # fresh config per instance: a dataclass default here would be ONE
        # shared object across every ReLeQSearch construction
        self.ppo = PPO(params, ppo_config if ppo_config is not None else PPOConfig())
        self.gen = torch.Generator().manual_seed(seed + 1)

    def _collect(self):
        """Run one episode in every env -> trajectories + records."""
        E, T = self.num_envs, self.envs[0].T
        states = np.zeros((E, T, STATE_DIM), np.float32)
        actions = np.zeros((E, T), np.int32)
        logps = np.zeros((E, T), np.float32)
        values = np.zeros((E, T), np.float32)
        rewards = np.zeros((E, T), np.float32)
        probs = np.zeros((E, T, len(self.envs[0].bitset)), np.float32)
        infos = [None] * E

        obs = np.stack([env.reset() for env in self.envs])
        carry = self.ppo.initial_carry(E)
        for t in range(T):
            carry, act, logp, val, pr = self.ppo.act(
                carry, torch.from_numpy(obs).to(self.device), self.gen)
            act = act.numpy()
            states[:, t] = obs
            actions[:, t] = act
            logps[:, t] = logp.numpy()
            values[:, t] = val.numpy()
            probs[:, t] = pr.numpy()
            nxt = []
            for e, env in enumerate(self.envs):
                o, r, done, info = env.step(int(act[e]))
                rewards[e, t] = r
                nxt.append(o)
                if done:
                    infos[e] = info
            obs = np.stack(nxt)
        traj = {"states": states, "actions": actions, "logp_old": logps,
                "values": values, "rewards": rewards}
        return traj, rewards, infos, probs

    def run(self, episodes: int, log_every: int = 0) -> SearchResult:
        result = SearchResult(best_bits={}, best_reward=-np.inf)
        for ep in range(episodes):
            traj, rewards, infos, probs = self._collect()
            metrics = self.ppo.update(traj)
            for e, info in enumerate(infos):
                final_r = float(rewards[e, -1])
                result.episodes.append({
                    "episode": ep, "env": e, "reward": final_r,
                    "mean_reward": float(rewards[e].mean()),
                    "acc": info["acc"], "quant": info["quant"],
                    "bits": info["bits"],
                })
                if final_r > result.best_reward:
                    result.best_reward = final_r
                    result.best_bits = dict(info["bits"])
            result.prob_evolution.append(probs.mean(axis=0))
            if log_every and (ep + 1) % log_every == 0:
                from repro_torch.obs import get_logger

                last = result.episodes[-1]
                get_logger("search").event(
                    "episode", episode=ep + 1,
                    reward=float(last["reward"]), acc=float(last["acc"]),
                    quant=float(last["quant"]),
                    avg_bits=float(np.mean(list(last["bits"].values()))),
                    pi_loss=float(metrics["pi_loss"]))
        cache = getattr(self.make_env, "eval_cache", None)
        if cache is not None:
            result.cache_stats = cache.stats()
        return result


def make_lm_env_factory(model, params, data, *, finetune_steps: int = 4,
                        eval_batches: int = 1, reward_mode: str = "proposed",
                        bitset=(2, 3, 4, 5, 6, 7, 8), eval_mode: str = "episode_end",
                        lr: float = 1e-4):
    """Environment factory for LM architectures.

    Accuracy proxy: the per-token likelihood ratio exp(nll_fp - nll_q)
    after ``finetune_steps`` of QAT at the candidate policy (the paper's
    "short retrain"): ``make_train_step`` from a fresh ``opt.init``, the
    candidate's bits moved to the card as data.  ``weight_std`` is taken
    per group (population std of the layer's slice, as ``jnp.std``); the
    memo is the shared :class:`EvalCache`.  The factory carries
    ``.eval_cache``, ``.evaluate`` (cached) and ``.compute`` (the raw
    retrain)."""
    from repro_torch.core.env import QuantEnv
    from repro_torch.core.evalcache import EvalCache
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.quant.qat import bits_assignment, bits_to_device, get_by_path
    from repro_torch.train.train_step import (make_eval_step, make_fp_eval_step,
                                              make_train_step)

    groups = model.quant_groups()
    frozen = model.frozen_bits()
    dev = tree_leaves(params)[0].device
    eval_step = make_eval_step(model)
    fp_eval = make_fp_eval_step(model)
    opt = AdamW(lr=lr, weight_decay=0.0)
    train_step = make_train_step(model, opt)
    eval_batch = [data.eval_batch(data.local_batch, index=10_000_000 + i)
                  for i in range(eval_batches)]
    nll_fp = float(np.mean([float(fp_eval(params, b)) for b in eval_batch]))

    stds = []
    for g in groups:
        leaf = get_by_path(params, g.path)
        if g.layer is not None:
            leaf = leaf[g.layer]
        stds.append(torch.std(leaf.float(), correction=0))
    wstd = dict(zip((g.name for g in groups), torch.stack(stds).tolist()))

    # bit-vectors recur across episodes; the short retrain is the search's
    # wall-clock bottleneck, so memoize on the canonical frozen bits tuple
    memo = EvalCache()

    def compute(bits_by_name: dict) -> float:
        pol = QuantPolicy.from_array(tuple(g.name for g in groups),
                                     [bits_by_name[g.name] for g in groups])
        bm = bits_to_device(bits_assignment(groups, pol), dev)
        if finetune_steps:
            state = {"params": params, "opt": opt.init(params)}
            for _ in range(finetune_steps):
                state, _ = train_step(state, data.next(), bm)
            p_eval = state["params"]
            del state
        else:
            p_eval = params
        nll_q = float(np.mean([float(eval_step(p_eval, b, bm)) for b in eval_batch]))
        return float(np.exp(nll_fp - nll_q))

    def evaluate(bits_by_name: dict) -> float:
        value, _ = memo.get_or_compute(bits_by_name, lambda: compute(bits_by_name))
        return value

    def factory(env_id: int) -> QuantEnv:
        return QuantEnv(groups=groups, evaluate=evaluate, weight_std=wstd,
                        bitset=bitset, frozen=frozen, reward_mode=reward_mode,
                        eval_mode=eval_mode)

    factory.eval_cache = memo          # shared across searches/worker pools
    factory.evaluate = evaluate        # cached step-level API
    factory.compute = compute          # raw retrain
    return factory
