"""Iteration-level scheduler: which sequence runs in which row, when.

Continuous batching à la Orca/vLLM, specialized to ReLeQ serving: every
engine step the scheduler (1) admits queued requests — *mid-decode*, the
running sequences never stop — gated on both a free sequence row AND
enough free KV blocks for the whole prompt (paged pool; the slot pool
degenerates to "any free slot"), and (2) reserves one token of cache
growth per running sequence before the packed decode step.  When the
block pool is exhausted, the reservation pass *preempts the youngest
running sequence*: its blocks return to the pool, the request goes back
to the FRONT of the admission queue, and re-admission recomputes its
cache from prompt + already-emitted tokens (recompute-style preemption —
greedy decode is deterministic, so the replayed state is exact and the
client-visible token stream is unaffected).  Oldest-first reservation
plus a pool sized for ≥ 1 full sequence guarantees progress: the oldest
sequence can always grow.

The scheduler owns the bookkeeping (queue, pool, running table) and makes
no model calls — the engine turns its decisions into prefill/decode
launches.  Keeping the policy host-side means the device-side decode step
stays a single fixed-shape executable regardless of traffic.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

from repro_torch.serve.queue import AdmissionQueue
from repro_torch.serve.request import Request, RequestState


@dataclass
class RunningSeq:
    """One admitted sequence: its request, next token to feed, and how
    many tokens its cache currently holds (drives block reservation)."""

    request: Request
    slot: int
    last_token: int
    cached_len: int = 0
    order: int = 0        # admission counter — youngest = max(order)


class ContinuousScheduler:
    def __init__(self, pool, queue: AdmissionQueue, registry=None):
        self.pool = pool
        self.queue = queue
        self.running: dict[int, RunningSeq] = {}  # row -> sequence
        self.preemptions = 0
        self._order = 0
        # prefix-cache hooks; identity no-ops for pools without sharing
        self._cow = getattr(pool, "cow_for_write", lambda *a: True)
        self._record = getattr(pool, "record_token", lambda *a: None)
        # scheduling-decision counters (repro_torch.obs); a private registry
        # keeps the instrument calls unconditional
        if registry is None:
            from repro_torch.obs import Registry
            registry = Registry()
        self._c_admitted = registry.counter("sched.admitted",
                                            unit="requests")
        self._c_blocked = registry.counter(
            "sched.admit_blocked", desc="head-of-line admission stalls")
        self._c_preempt = registry.counter("sched.preemptions")

    # ------------------------------------------------------------------
    @property
    def num_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.running)

    def admissions(self) -> list[tuple[Request, int, int]]:
        """Pop queued requests into free rows (FIFO, head-of-line blocking:
        a big request never gets overtaken by a small one).  Returns
        ``(request, row, cached)`` triples — ``cached`` is how many replay
        tokens the prefix trie already holds, mapped into the fresh block
        table by incref (``pool.map_shared``): the engine prefills only
        the tail.  The admission gate counts *new* blocks only, so a
        request whose prompt is mostly shared admits into a pool that
        could not hold it cold.  The trie is consulted at pop time:
        requests admitted in the SAME step don't see each other's blocks
        (they publish after their prefill lands), which staggered
        arrivals make irrelevant in steady state."""
        admitted = []
        map_shared = getattr(self.pool, "map_shared", None)
        while self.queue:
            req = self.queue.peek()
            tokens = req.replay_tokens()
            # headroom watermark: one growth block per running (or just-
            # admitted) sequence, so admitting never sets up an immediate
            # preempt-replay cycle
            if not self.pool.can_admit(
                    req.cache_tokens_needed(),
                    reserve_blocks=len(self.running) + len(admitted),
                    tokens=tokens):
                self._c_blocked.inc()
                break
            self.queue.pop()
            seq = self.pool.alloc_seq()
            cached = map_shared(seq, tokens) if map_shared else 0
            ok = self.pool.ensure(seq, req.cache_tokens_needed())
            assert ok, "can_admit promised the blocks"
            self._c_admitted.inc()
            admitted.append((req, seq, cached))
        return admitted

    def start(self, request: Request, slot: int, first_token: int,
              cached_len: int = 0) -> None:
        """Register a prefilled sequence as running."""
        request.state = RequestState.RUNNING
        self.running[slot] = RunningSeq(request, slot, first_token,
                                        cached_len, self._order)
        self._order += 1

    def advance(self, slot: int, token: int) -> None:
        seq = self.running[slot]
        # the PREVIOUS token is now fed (its KV write landed this step):
        # record it so the pool publishes completed blocks into the trie
        self._record(slot, seq.last_token)
        seq.last_token = token
        seq.cached_len += 1

    def reserve_for_decode(self) -> list[Request]:
        """Grow every running sequence by one token's worth of blocks,
        oldest first; preempt-and-requeue the youngest on exhaustion.
        The write position must also be privately owned — a decode into a
        still-shared block (a preempted sibling's prefix outliving it)
        copies-on-write first, and a failed copy is handled exactly like
        block exhaustion.  Returns the preempted requests (already
        requeued)."""
        preempted: list[Request] = []
        for slot in sorted(self.running, key=lambda s: self.running[s].order):
            if slot not in self.running:  # already preempted this pass
                continue
            seq = self.running[slot]
            while not (self.pool.ensure(slot, seq.cached_len + 1)
                       and self._cow(slot, seq.cached_len)):
                victim = max(self.running,
                             key=lambda s: self.running[s].order)
                preempted.append(self.preempt(victim))
                if victim == slot:
                    break
        return preempted

    def reserve_lookahead(self) -> bool:
        """Non-preempting reservation ONE decode step beyond the last
        reserved write: blocks for ``cached_len + 2`` tokens and private
        ownership of position ``cached_len + 1`` for every running
        sequence.  Used by the engine's one-step-lookahead pipeline,
        which falls back to the synchronous path (a ``pipeline.bubbles``
        count) whenever the extra step cannot be covered without
        preempting.  Partial grants are kept: the blocks are needed
        within two steps anyway and are freed by preempt/finish like any
        others, so the progress guarantee is unchanged."""
        for slot in sorted(self.running,
                           key=lambda s: self.running[s].order):
            seq = self.running[slot]
            if not (self.pool.ensure(slot, seq.cached_len + 2)
                    and self._cow(slot, seq.cached_len + 1)):
                return False
        return True

    def reserve_for_spec(self, want: dict[int, int]
                         ) -> tuple[dict[int, int], list[Request]]:
        """Reserve ``cached_len + k + 1`` tokens of cache per running row
        for a speculative window of ``want[slot] = k`` draft tokens,
        oldest first.  Under block pressure a row's window SHRINKS toward
        zero before anyone is preempted — losing speculation for a step
        is strictly cheaper than a preempt-replay cycle — and only when
        even plain decode growth (k = 0) cannot be covered does the
        youngest sequence get preempted, exactly like
        :meth:`reserve_for_decode`.  Returns (granted window per surviving
        slot, preempted requests).  Speculation never reserves beyond what
        the target itself will need (callers cap k by the remaining token
        budget), so the no-extra-blocks invariant holds by construction.
        """
        granted: dict[int, int] = {}
        preempted: list[Request] = []
        for slot in sorted(self.running, key=lambda s: self.running[s].order):
            if slot not in self.running:  # already preempted this pass
                continue
            seq = self.running[slot]
            want_k = max(int(want.get(slot, 0)), 0)
            while slot in self.running:
                # retry the FULL wanted window each pass: a preemption on
                # the previous pass freed blocks, so a window that had
                # shrunk toward zero may now be grantable again
                k = want_k
                while k > 0 and not self.pool.ensure(slot,
                                                     seq.cached_len + k + 1):
                    k -= 1  # shrink the window before taking blocks
                if k > 0 or self.pool.ensure(slot, seq.cached_len + 1):
                    # drafts + verify write [cached_len, cached_len+k+1):
                    # COW any still-shared block under the window before
                    # the spec step scatters into it
                    if not self._cow(slot, seq.cached_len,
                                     seq.cached_len + k + 1):
                        k = 0  # treat like exhaustion: shrink, then preempt
                        if self._cow(slot, seq.cached_len):
                            granted[slot] = 0
                            break
                    else:
                        granted[slot] = k
                        break
                victim = max(self.running,
                             key=lambda s: self.running[s].order)
                preempted.append(self.preempt(victim))
        return granted, preempted

    def preempt(self, slot: int) -> Request:
        """Evict a running sequence: blocks back to the pool, request back
        to the queue head (it keeps its emitted tokens; re-admission
        replays prompt + outputs to rebuild the cache)."""
        seq = self.running.pop(slot)
        self.pool.free_seq(slot)
        req = seq.request
        req.state = RequestState.QUEUED
        req.preemptions += 1
        req.queued_time = time.perf_counter()  # its next wait starts now
        self.preemptions += 1
        self._c_preempt.inc()
        self.queue.push_front(req)
        return req

    def finish(self, slot: int) -> Request:
        """Retire a sequence and free its row + blocks for the next one."""
        seq = self.running.pop(slot)
        seq.request.state = RequestState.FINISHED
        self.pool.free_seq(slot)
        return seq.request
