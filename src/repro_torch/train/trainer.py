"""Fault-tolerant training loop (torch port of ``repro.train.trainer``).

- **checkpoint/restart**: the full state (params, optimizer, data cursor,
  bits map) saved atomically every ``ckpt_interval`` steps; ``run``
  resumes from the newest complete checkpoint after a crash.
- **straggler mitigation**: per-step wall-clock watermarks against a
  running EMA; a step slower than ``straggler_factor x`` the EMA counts and
  fires ``on_straggler``.
- **NaN quarantine**: a non-finite loss drops the step, reloads the last
  checkpoint and skips the offending batch.  With no checkpoint to reload
  (``ckpt_dir=None``, or none saved yet) it raises, naming the step: the
  optimizer has already written that step's gradients into its moments in
  place (``optim.adamw``), so the state cannot be carried on.

- **elastic scaling**: with ``mesh=`` (a ``DeviceMesh``) the restart
  reload and the NaN-quarantine reload go through
  ``dist.elastic.restore_elastic``: a checkpoint written under any rank
  count is placed under the current mesh's specs, each leaf as the given
  state's leaf is placed (a quarantine reload comes back under the same
  placements).  Every rank runs the loop; ``ckpt.save`` gathers sharded
  leaves and writes from rank 0 alone.

Each step reads its loss on the host: that is the loop's one sync a
step, as in the reference.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import ckpt as ckpt_lib
from repro_torch.optim.adamw import tree_leaves, tree_unflatten


@dataclass
class Trainer:
    model: object
    optimizer: object
    data: object                      # SyntheticLMData-like
    step_fn: object                   # (state, batch, bits_map) -> (state, metrics)
    bits_map: dict
    ckpt_dir: str | None = None
    mesh: object = None
    ckpt_interval: int = 50
    straggler_factor: float = 3.0
    on_straggler: object = None
    log_every: int = 10
    history: list = field(default_factory=list)
    straggler_count: int = 0
    _ema: float | None = None
    _warmup: int = 0

    def save(self, state, step: int):
        if self.ckpt_dir is None:
            return
        ckpt_lib.save(self.ckpt_dir, step, state,
                      meta={"data": self.data.state_dict(),
                            "bits_map": {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                                       else v).tolist()
                                         for k, v in self.bits_map.items()}})

    def _reload(self, state):
        """-> (restored state, meta, step), each leaf in the dtype of the
        given state's leaf, on its device; placed on the mesh when the
        Trainer has one."""
        if self.mesh is not None:
            from repro_torch.dist.elastic import restore_elastic

            return restore_elastic(self.ckpt_dir, state, self.mesh)
        dev = next(x for x in tree_leaves(state) if isinstance(x, torch.Tensor)).device
        tree, meta, step = ckpt_lib.restore(self.ckpt_dir, device=dev)
        restored = tree_unflatten(state, [
            a.to(ref.dtype) if isinstance(ref, torch.Tensor) else a
            for ref, a in zip(tree_leaves(state), tree_leaves(tree))])
        return restored, meta, step

    def try_restore(self, state):
        """-> (state, start_step); falls back to the given fresh state."""
        if self.ckpt_dir is None:
            return state, 0
        try:
            restored, meta, step = self._reload(state)
        except FileNotFoundError:
            return state, 0
        self.data.load_state_dict(meta["data"])
        return restored, step

    def _watch(self, dt: float, step: int):
        # the first 2 steps include warm-up (kernel builds, allocator) —
        # never seed the EMA with them
        self._warmup += 1
        if self._warmup <= 2:
            return
        if self._ema is None:
            self._ema = dt
            return
        if dt > self.straggler_factor * self._ema:
            self.straggler_count += 1
            if self.on_straggler:
                self.on_straggler(step, dt, self._ema)
            return  # don't let the straggler poison the EMA
        self._ema = 0.9 * self._ema + 0.1 * dt

    def run(self, state, num_steps: int, start_step: int | None = None):
        state, resumed = self.try_restore(state)
        step = resumed if start_step is None else start_step
        last_good = step
        while step < num_steps:
            batch = self.data.next()
            t0 = time.perf_counter()
            new_state, metrics = self.step_fn(state, batch, self.bits_map)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self._watch(dt, step)
            if not math.isfinite(loss):
                # NaN quarantine: reload the last checkpoint, skip this batch
                del new_state
                if self.ckpt_dir is None or ckpt_lib.latest_step(self.ckpt_dir) is None:
                    raise FloatingPointError(
                        f"non-finite loss {loss} at step {step + 1} and no checkpoint to "
                        f"reload (ckpt_dir={self.ckpt_dir!r}): the optimizer state was "
                        f"updated in place with this step's gradients")
                state, _, step = self._reload(state)
                self.data.index += 1
                continue
            state = new_state
            step += 1
            self.history.append({"step": step, "loss": loss, "dt": dt})
            if self.log_every and step % self.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms, stragglers={self.straggler_count})")
            if self.ckpt_dir and step % self.ckpt_interval == 0:
                self.save(state, step)
                last_good = step
        if self.ckpt_dir and last_good != step:
            self.save(state, step)
        return state
