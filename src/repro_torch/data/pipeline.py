"""Deterministic synthetic LM data pipeline; a copy of ``repro.data.pipeline``
(numpy only, so the port keeps its own copy: batches are bitwise the
reference's for the same seed and cursor).  No corpora are read.

Design goals (matching a production input pipeline's contract):

- **Learnable**: tokens follow a sparse first-order Markov chain derived from
  the seed, so cross-entropy has real headroom below uniform (≈ log V), loss
  decreases under training, and — what ReLeQ needs — *quantizing weights
  measurably hurts the model's achievable likelihood*.
- **Deterministic & checkpointable**: batch ``i`` of host-shard ``h`` is a
  pure function of ``(seed, i, h)``; the checkpointed cursor is one integer.
- **Shardable / elastic**: the global batch is partitioned by ``(shard,
  num_shards)``; re-sharding after an elastic resize just changes the
  partition arithmetic, no state migration.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_BRANCH = 4  # successors per token: entropy = log2(4) bits/token << log2(V)


def _chain(seed: int, vocab: int) -> np.ndarray:
    """(V, _BRANCH) successor table, deterministic in seed."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, _BRANCH), dtype=np.int64)


def markov_batch(seed: int, index: int, batch: int, seq_len: int,
                 vocab: int, chain: np.ndarray | None = None) -> np.ndarray:
    """(batch, seq_len+1) int32 tokens for next-token training."""
    if chain is None:
        chain = _chain(seed, vocab)
    rng = np.random.default_rng((seed * 1_000_003 + index) % (2 ** 63))
    toks = np.empty((batch, seq_len + 1), np.int64)
    toks[:, 0] = rng.integers(0, vocab, size=batch)
    choices = rng.integers(0, _BRANCH, size=(batch, seq_len))
    for t in range(seq_len):
        toks[:, t + 1] = chain[toks[:, t], choices[:, t]]
    return toks.astype(np.int32)


@dataclass
class SyntheticLMData:
    seed: int
    global_batch: int
    seq_len: int
    vocab: int
    shard: int = 0
    num_shards: int = 1
    index: int = 0            # cursor (checkpointed)

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError("global_batch must divide num_shards")
        self._chain = _chain(self.seed, self.vocab)

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.num_shards

    def next(self) -> dict:
        """{"tokens": (B_local, S), "labels": (B_local, S)} int32."""
        # one RNG stream per (global batch index, shard) — deterministic
        toks = markov_batch(self.seed + 7919 * self.shard, self.index,
                            self.local_batch, self.seq_len, self.vocab,
                            self._chain)
        self.index += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def eval_batch(self, batch: int, index: int = 10_000_000) -> dict:
        """Held-out batch (indices far above any training cursor)."""
        toks = markov_batch(self.seed + 104729, index, batch,
                            self.seq_len, self.vocab, self._chain)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # ---- checkpoint protocol ------------------------------------------
    def state_dict(self) -> dict:
        return {"seed": self.seed, "index": self.index,
                "shard": self.shard, "num_shards": self.num_shards}

    def load_state_dict(self, d: dict, *, reshard: tuple[int, int] | None = None):
        assert d["seed"] == self.seed, "data seed mismatch on restore"
        self.index = int(d["index"])
        if reshard is not None:  # elastic resize: new (shard, num_shards)
            self.shard, self.num_shards = reshard
