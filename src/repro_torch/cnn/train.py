"""CNN training/eval with WRPN QAT + the ReLeQ environment glue (torch
port of ``repro.cnn.train``).

``CNNTask`` owns one (network, dataset) pair:
- ``pretrain``: full-precision training (the paper starts the agent from a
  pre-trained model),
- ``evaluate_bits``: the environment's accuracy oracle — short QAT retrain
  at a candidate bitwidth assignment, then validation accuracy relative to
  the fp baseline,
- ``long_retrain``: the paper's final step after the agent converges.

Quantization is per-tensor WRPN with the STE (paper §4.2).  The bits
vector is an int32 tensor on the task's device, and every forward
quantizes all the layers in one grouped fake-quant call (one launch for
the forward, one for the STE backward) that reads each layer's entry as
data, full precision included (32 passes the weights through), so every
policy runs the same launches.  SGD with
momentum (``m = 0.9 m + g``, ``p -= lr m``) through ``torch.autograd`` on
leaf tensors; each step makes new tensors, so ``train`` never changes the
params it is given, as the reference's functional step does not.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.cnn.data import DATASET_FOR, make_dataset
from repro_torch.cnn.models import build_cnn
from repro_torch.core.env import QuantEnv
from repro_torch.quant.wrpn import fake_quant_ste_group


def _quantize_cnn_params(params, names, bits_vec: torch.Tensor):
    """The weights of ``names`` through one grouped fake-quant call, layer
    ``names[i]`` at ``bits_vec[i]``; biases and other layers as they are."""
    qs = dict(zip(names, fake_quant_ste_group([params[n]["w"] for n in names], bits_vec)))
    return {n: ({"w": qs[n], "b": p["b"]} if n in qs else p) for n, p in params.items()}


class CNNTask:
    def __init__(self, net_name: str, seed: int = 0, batch: int = 128,
                 lr: float = 2e-3, device=None):
        self.device = resolve_device(device)
        self.model = build_cnn(net_name)
        self.data = make_dataset(DATASET_FOR[net_name], seed)
        self.batch = batch
        self.seed = seed
        self.lr = lr
        self.groups = self.model.quant_groups()
        self.frozen = self.model.frozen_bits()
        self.names = [g.name for g in self.groups]
        self._index = 0
        self.params = self.model.init(seed, self.device)
        self.mom = self._zeros_like(self.params)
        self._fp_vec = torch.full((len(self.names),), 32, dtype=torch.int32,
                                  device=self.device)
        # fixed validation set, on the device once
        self._val = [self._to_device(*self.data.batch(256, i, "val")) for i in range(2)]
        self.fp_acc = None

    def _to_device(self, x: np.ndarray, y: np.ndarray):
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).to(self.device, torch.int64))

    @staticmethod
    def _zeros_like(params):
        return {n: {k: torch.zeros_like(t) for k, t in p.items()} for n, p in params.items()}

    def _bits_vec(self, bits_by_name: dict | None) -> torch.Tensor:
        if bits_by_name is None:
            return self._fp_vec
        vec = [int(bits_by_name.get(n, 32)) for n in self.names]
        return torch.tensor(vec, dtype=torch.int32).to(self.device)

    def _logits(self, params, x, bits_vec):
        return self.model.apply(_quantize_cnn_params(params, self.names, bits_vec), x)

    def _train_step(self, params, mom, x, y, bits_vec):
        leaves = {n: {k: t.detach().requires_grad_(True) for k, t in p.items()}
                  for n, p in params.items()}
        logp = F.log_softmax(self._logits(leaves, x, bits_vec), dim=-1)
        nll = -logp.gather(-1, y[:, None]).mean()
        flat = [t for p in leaves.values() for t in p.values()]
        grads = iter(torch.autograd.grad(nll, flat))
        new_p, new_m = {}, {}
        with torch.no_grad():
            for n, p in leaves.items():
                new_p[n], new_m[n] = {}, {}
                for k, t in p.items():
                    m = 0.9 * mom[n][k] + next(grads)
                    new_m[n][k] = m
                    new_p[n][k] = t.detach() - self.lr * m
        return new_p, new_m

    # ------------------------------------------------------------------
    def train(self, steps: int, bits_by_name: dict | None = None,
              params=None, mom=None):
        params = self.params if params is None else params
        mom = self.mom if mom is None else mom
        vec = self._bits_vec(bits_by_name)
        for _ in range(steps):
            x, y = self._to_device(*self.data.batch(self.batch, self._index, "train"))
            self._index += 1
            params, mom = self._train_step(params, mom, x, y, vec)
        return params, mom

    @torch.no_grad()
    def accuracy(self, params, bits_by_name: dict | None = None) -> float:
        vec = self._bits_vec(bits_by_name)
        hits = [(self._logits(params, x, vec).argmax(-1) == y).float().mean()
                for x, y in self._val]
        return float(np.mean([float(h) for h in hits]))

    def pretrain(self, steps: int = 400) -> float:
        self.params, self.mom = self.train(steps)
        self.fp_acc = self.accuracy(self.params)
        return self.fp_acc

    # ------------------------------------------------------------------
    def evaluate_bits(self, bits_by_name: dict, retrain_steps: int = 4) -> float:
        """ReLeQ accuracy oracle: short retrain then rel. val accuracy."""
        params, _ = self.train(retrain_steps, bits_by_name, params=self.params,
                               mom=self._zeros_like(self.mom))
        acc = self.accuracy(params, bits_by_name)
        return acc / max(self.fp_acc, 1e-6)

    def long_retrain(self, bits_by_name: dict, steps: int = 200) -> float:
        """Paper's final step: long QAT retrain at the chosen bitwidths."""
        params, _ = self.train(steps, bits_by_name, params=self.params,
                               mom=self._zeros_like(self.mom))
        return self.accuracy(params, bits_by_name) / max(self.fp_acc, 1e-6)

    # ------------------------------------------------------------------
    def weight_std(self) -> dict:
        # ddof 0, as jnp.std
        return {n: float(self.params[n]["w"].std(correction=0)) for n in self.names}

    def make_env_factory(self, *, retrain_steps: int = 4,
                         reward_mode: str = "proposed",
                         bitset=(2, 3, 4, 5, 6, 7, 8),
                         eval_mode: str = "per_step", cache=None):
        """Env factory for ReLeQSearch.

        ``cache=None`` builds a fresh :class:`EvalCache`; pass one to share
        retrain results across searches (warm-started runs).  The cache is
        exposed as ``factory.eval_cache`` so the search record can report
        its hit rate."""
        from repro_torch.core.evalcache import EvalCache

        memo = cache if cache is not None else EvalCache()

        def evaluate(bits: dict) -> float:
            value, _ = memo.get_or_compute(
                bits, lambda: self.evaluate_bits(bits, retrain_steps))
            return value

        def factory(env_id: int) -> QuantEnv:
            return QuantEnv(
                groups=self.groups,
                evaluate=evaluate,
                weight_std=self.weight_std(),
                bitset=bitset,
                frozen=self.frozen,
                reward_mode=reward_mode,
                eval_mode=eval_mode,
            )

        factory.eval_cache = memo
        return factory
