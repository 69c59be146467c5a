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


def make_lm_env_factory(*args, **kwargs):
    """The LM architectures' environment factory needs the LM QAT
    training path, which is not ported."""
    from repro_torch import not_ported

    raise not_ported("make_lm_env_factory (the LM QAT training path)", "slice B, item 8")
