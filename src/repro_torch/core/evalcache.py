"""Shared, thread-safe memo-cache for candidate-policy evaluations; a copy
of ``repro.core.evalcache``.

The short retrain behind ``evaluate(bits_by_name)`` is the search's
wall-clock bottleneck, and bit-vectors recur across episodes (the agent
revisits policies; early-episode prefixes repeat).  One cache may be
shared across searches and across a pool of evaluation workers, which
needs three properties:

- **canonical key**: a frozen ``((name, bits), ...)`` tuple sorted by
  group name, so hits are independent of dict insertion order and the
  same cache serves the accuracy and latency evaluators;
- **concurrency safety**: a lock around the table plus per-key in-flight
  coalescing — two workers racing on the same candidate run the retrain
  once, the loser blocks on the winner's result (re-entrant: a cache
  layered over an already-cached evaluator computes inline instead of
  deadlocking on its own in-flight event);
- **hit-rate counters**: ``stats()`` is surfaced in the search record
  (``SearchResult.cache_stats``).
"""
from __future__ import annotations

import threading


class EvalCache:
    """get-or-compute memo keyed on a canonical frozen bits tuple."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: dict[tuple, object] = {}
        # key -> (owner thread id, event) while a compute is in flight
        self._inflight: dict[tuple, tuple[int, threading.Event]] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(bits_by_name: dict) -> tuple:
        """Canonical frozen key: sorted (name, bits) pairs."""
        return tuple(sorted((str(n), int(b)) for n, b in bits_by_name.items()))

    def __len__(self) -> int:
        with self._lock:
            return len(self._values)

    def get_or_compute(self, bits_by_name: dict, fn):
        """-> (value, was_hit).  ``fn()`` runs at most once per key across
        all threads; concurrent same-key callers block on the winner."""
        key = self.key(bits_by_name)
        me = threading.get_ident()
        while True:
            with self._lock:
                if key in self._values:
                    self.hits += 1
                    return self._values[key], True
                entry = self._inflight.get(key)
                if entry is None:
                    event = threading.Event()
                    self._inflight[key] = (me, event)
                    self.misses += 1
                    owner = True
                elif entry[0] == me:
                    # re-entrant: this thread already owns the compute for
                    # this key (cache layered over a cached evaluator) —
                    # run the inner fn inline; the outer frame stores it
                    return fn(), False
                else:
                    owner = False
                    event = entry[1]
            if owner:
                try:
                    value = fn()
                except BaseException:
                    with self._lock:  # let a waiter retry (and re-raise)
                        self._inflight.pop(key, None)
                    event.set()
                    raise
                with self._lock:
                    self._values[key] = value
                    self._inflight.pop(key, None)
                event.set()
                return value, False
            event.wait()
            # winner stored the value (loop re-checks; if the winner
            # raised, this thread becomes the new owner and recomputes)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._values),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
            }
