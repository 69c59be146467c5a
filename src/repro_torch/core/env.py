"""The ReLeQ quantization environment (paper §2.3-2.5, Fig 4); a numpy-only
copy of ``repro.core.env``.

An episode walks the network's quantizable groups in order; at step t the
agent picks group t's bitwidth from the flexible action set (Fig 2a — any
bitwidth, not ±1 moves).  The environment then

  1. updates the policy-so-far,
  2. obtains the State of Relative Accuracy from the *evaluator* (short
     retrain + validation, or the cheaper end-of-episode mode the paper
     uses for deeper nets),
  3. computes the State of Quantization (costmodel.py, the paper's formula),
  4. emits the shaped reward (reward.py).

The evaluator is an injected callable ``evaluate(bits_by_name) -> rel_acc``
so the same environment drives the paper's CNNs (accuracy ratio) and the
LM stack (likelihood ratio).

Evaluation modes (``eval_mode``):
  per_step     evaluate after every action (paper's shallow-net mode)
  episode_end  evaluate once, at the final action (deep nets)
  deferred     never evaluate inside ``step`` — the episode's terminal
               reward stays provisional (acc = the initial 1.0) until an
               external evaluator reports back and the caller patches it
               via :meth:`reward_for`: the step-level API of an
               asynchronous search that rolls out episodes without
               blocking on the short retrain.

State embedding (Table 1, both axes):
  layer-specific static : layer index (norm), log #weights (norm), weight std
  layer-specific dynamic: current bitwidth (norm)
  network-specific dyn. : State_Quantization, State_Accuracy
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import costmodel
from repro_torch.core.reward import REWARDS

STATE_DIM = 6


@dataclass
class QuantEnv:
    groups: list                      # QuantGroup list (searchable ORDER)
    evaluate: object                  # callable(dict name->bits) -> rel acc
    weight_std: dict                  # name -> std of the fp weights (static)
    bitset: tuple = (2, 3, 4, 5, 6, 7, 8)
    frozen: dict = field(default_factory=dict)   # name -> fixed bits
    reward_mode: str = "proposed"
    reward_kwargs: dict = field(default_factory=dict)
    eval_mode: str = "per_step"       # per_step | episode_end (deep nets)
    init_bits: int = 8                # paper: all layers start at 8 bits
    # HAQ-style extension: per-layer KV-cache bitwidth pseudo-groups
    # (``model.kv_quant_groups()``, names ``kv.L..``) appended after the
    # weight walk — the agent picks serving KV precision with the same
    # flexible action set, and SQ prices the cache bytes through the
    # groups' n_weights (n_macs = 0: bits buy bandwidth, not precision)
    kv_groups: list = field(default_factory=list)

    def __post_init__(self):
        if self.eval_mode not in ("per_step", "episode_end", "deferred"):
            raise ValueError(f"eval_mode={self.eval_mode!r}")
        if self.kv_groups:
            self.groups = list(self.groups) + list(self.kv_groups)
        self.searchable = [g for g in self.groups if g.name not in self.frozen]
        self.T = len(self.searchable)
        self._logw = {g.name: np.log(max(g.n_weights, 1)) for g in self.groups}
        self._logw_max = max(self._logw.values())
        self._reward = REWARDS[self.reward_mode]
        self.reset()

    # ------------------------------------------------------------------
    def reset(self):
        self.bits = {g.name: self.init_bits for g in self.groups}
        self.bits.update(self.frozen)
        self.t = 0
        self.acc_state = 1.0  # starts from the (re)trained 8-bit baseline
        self.quant_state = self._quant_state()
        return self._obs()

    def _quant_state(self) -> float:
        vec = [self.bits[g.name] for g in self.groups]
        return costmodel.state_of_quantization(vec, self.groups)

    def _obs(self) -> np.ndarray:
        g = self.searchable[min(self.t, self.T - 1)]
        return np.asarray([
            self.t / max(self.T - 1, 1),
            self._logw[g.name] / self._logw_max,
            min(self.weight_std.get(g.name, 0.0), 2.0),
            self.bits[g.name] / max(self.bitset),
            self.quant_state,
            min(self.acc_state, 1.2),
        ], np.float32)

    # ------------------------------------------------------------------
    def step(self, action: int):
        """-> (obs, reward, done, info)."""
        g = self.searchable[self.t]
        self.bits[g.name] = int(self.bitset[action])
        self.quant_state = self._quant_state()
        done = self.t == self.T - 1
        if self.eval_mode == "per_step" or (done and self.eval_mode == "episode_end"):
            self.acc_state = float(self.evaluate(dict(self.bits)))
        reward = self._reward(self.acc_state, self.quant_state,
                              **self.reward_kwargs)
        self.t += 1
        info = {"bits": dict(self.bits), "acc": self.acc_state,
                "quant": self.quant_state, "group": g.name}
        return self._obs(), float(reward), done, info

    # ------------------------------------------------------------------
    def reward_for(self, acc: float, quant: float) -> float:
        """Step-level API: the episode reward for an externally supplied
        (rel-accuracy, quant-state) pair, under this env's reward shaping.
        The async service uses it to finalize a ``deferred`` episode once
        its evaluation worker reports back — identical to what
        ``episode_end`` would have computed in-line."""
        return float(self._reward(float(acc), float(quant),
                                  **self.reward_kwargs))
