"""Proximal Policy Optimization (paper §2.7, Table 3) — torch port of
``repro.core.ppo``.

Hyper-parameters follow Table 3: Adam step 1e-4, GAE parameter 0.99,
3 epochs per update, clipping ε = 0.1.  The clipped surrogate is the
standard PPO objective; advantages come from GAE over the per-layer-step
rewards of each episode, normalised with the population std (ddof 0, as
``jnp.std``).  Gradients come from ``torch.autograd`` on leaf copies of
the params; the optimizer is the port's :class:`~repro_torch.optim.AdamW`
(the reference's math, not ``torch.optim.AdamW``'s).

Acting draws each action on the host from the policy's probabilities with
a CPU ``torch.Generator`` (the probabilities go to numpy for the search
record anyway), so a seed gives the same draws on the CPU and the card up
to float rounding; ``jax.random.categorical``'s draws cannot be repeated.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.agent import agent_step, lstm_carry, rollout_logits
from repro_torch.optim.adamw import AdamW, tree_leaves, tree_unflatten


@dataclass(frozen=True)
class PPOConfig:
    lr: float = 1e-4
    clip_eps: float = 0.1
    epochs: int = 3
    gamma: float = 0.99          # Table 3 "GAE parameter"
    lam: float = 0.95
    value_coef: float = 0.5
    entropy_coef: float = 1e-2
    max_grad_norm: float = 1.0
    use_lstm: bool = True        # paper §2.7 ablation switch


def gae_advantages(rewards, values, gamma: float, lam: float):
    """rewards/values: (B, T) -> (advantages, returns), episode ends at T."""
    B, T = rewards.shape
    adv = np.zeros((B, T), np.float32)
    last = np.zeros((B,), np.float32)
    next_v = np.zeros((B,), np.float32)
    for t in range(T - 1, -1, -1):
        delta = rewards[:, t] + gamma * next_v - values[:, t]
        last = delta + gamma * lam * last
        adv[:, t] = last
        next_v = values[:, t]
    returns = adv + values
    return adv, returns


def ppo_loss(params, batch, cfg: PPOConfig):
    logits, values = rollout_logits(params, batch["states"], cfg.use_lstm)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, batch["actions"][..., None].long())[..., 0]
    ratio = torch.exp(logp - batch["logp_old"])
    adv = batch["adv"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    pi_loss = -torch.mean(torch.minimum(unclipped, clipped))
    v_loss = torch.mean((values - batch["returns"]) ** 2)
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
    total = pi_loss + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
    return total, {"pi_loss": pi_loss, "v_loss": v_loss, "entropy": entropy,
                   "ratio_max": torch.max(ratio)}


def ppo_grads(params, batch, cfg: PPOConfig):
    """d ppo_loss / d params, in the params' nesting (zeros for the LSTM
    weights the MLP ablation leaves unused, as ``jax.grad`` gives)."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = ppo_loss(tree_unflatten(params, leaves), batch, cfg)
    return tree_unflatten(params, torch.autograd.grad(loss, leaves, allow_unused=True,
                                                      materialize_grads=True))


class PPO:
    def __init__(self, params, cfg: PPOConfig = PPOConfig()):
        self.cfg = cfg
        self.opt = AdamW(lr=cfg.lr, weight_decay=0.0, clip_norm=cfg.max_grad_norm)
        self.params = params
        self.opt_state = self.opt.init(params)
        self.device = tree_leaves(params)[0].device

    def update(self, trajectories: dict) -> dict:
        """trajectories: states (B,T,S) f32, actions (B,T) i32,
        logp_old (B,T), rewards (B,T), values (B,T) — numpy."""
        adv, ret = gae_advantages(trajectories["rewards"], trajectories["values"],
                                  self.cfg.gamma, self.cfg.lam)
        dev = self.device
        batch = {
            "states": torch.as_tensor(trajectories["states"], dtype=torch.float32).to(dev),
            "actions": torch.as_tensor(trajectories["actions"], dtype=torch.int64).to(dev),
            "logp_old": torch.as_tensor(trajectories["logp_old"],
                                        dtype=torch.float32).to(dev),
            "adv": torch.as_tensor(adv).to(dev),
            "returns": torch.as_tensor(ret).to(dev),
        }
        for _ in range(self.cfg.epochs):
            grads = ppo_grads(self.params, batch, self.cfg)
            self.params, self.opt_state = self.opt.update(self.params, grads,
                                                          self.opt_state)
        with torch.no_grad():
            _, metrics = ppo_loss(self.params, batch, self.cfg)
        return {k: float(v) for k, v in metrics.items()}

    # -- acting ----------------------------------------------------------
    @torch.no_grad()
    def act(self, carry, state, gen: torch.Generator):
        """state: (B, S) on the agent's device -> (carry', action (B,),
        logp (B,), value (B,), probs (B, A)); all but the carry on the
        CPU.  ``gen`` is the CPU generator the actions are drawn from."""
        carry, logits, value = agent_step(self.params, carry, state,
                                          use_lstm=self.cfg.use_lstm)
        logits = logits.cpu()
        probs = torch.softmax(logits, -1)
        action = torch.multinomial(probs, 1, generator=gen)[:, 0]
        logp = F.log_softmax(logits, -1).gather(-1, action[:, None])[:, 0]
        return carry, action, logp, value.cpu(), probs

    def initial_carry(self, batch: int):
        return lstm_carry(batch, self.device)
