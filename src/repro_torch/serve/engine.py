"""ServeEngine: the continuous-batching serve loop (torch port of
``repro.serve.engine``).

``submit()`` enqueues a request; ``step()`` runs one engine iteration
(admit -> chunked prefill of new sequences -> reserve one token of growth
per running row, preempting the youngest on block exhaustion -> one
packed decode step over every running row); ``run_until_drained()``
steps until queue and rows are empty.  Weights stay bit-packed at a
ReLeQ ``QuantPolicy`` for the engine's lifetime.

Admission runs *fixed-shape chunked prefill* straight into the
sequence's KV blocks (``prefill_chunk`` chunks of one shape for any
prompt length); a preempted request re-admits by replaying prompt +
emitted tokens, and greedy decode makes the replay exact.

One-token hotpath (``sample_device=True`` / ``pipeline=True``, both
default, as the reference's): tokens are selected on the device
(``serve.sampler``), so a decode step fetches a ``(num_slots,) int32``
vector instead of the logits, and with the one-step lookahead step t+1
is dispatched before step t's tokens are fetched, fed step t's token
vector on the device.  The lookahead runs only when the next step is
composition-stable (nothing queued, budget left in every row, the extra
write position reserved without preempting,
``scheduler.reserve_lookahead``); any other step runs synchronously and
counts ``pipeline.bubbles``.  ``step()`` admits before it syncs the
in-flight step.  ``sample_device=False`` selects on the host from the
fetched logits (``Request.select_token``) and implies no pipeline.

On the card the decode step is one captured CUDA graph
(``train.serve.make_decode_step``) and the sampler another
(``serve.sampler``): a step is two graph replays and a few small copies,
on one stream.  A replay overwrites its output buffers, and in the
pipeline step t's tokens are fetched after step t+1 is dispatched, so
each dispatch copies its token vector into a pinned host buffer behind
an event; the sync waits for that copy alone.  The sampler graphs are
shared by every engine on the device, so each dispatch also keeps its
own device copy of the token vector, the feed of a chained step.
``decode_fn=`` replaces the decode step, as in the reference
(``decode_fn=model.decode_step`` serves eagerly); a failed capture or
replay raises.  ``serve.recompiles`` counts graphs captured again because
the tensors they were bound to changed: 0 in steady state.

Every matmul of packed weights is the hand-written ``qmm`` kernel and
every decode attention a hand-written paged-attention kernel
(``kernels.ops``); with ``kv_bits`` the pool holds quantized blocks and a
decode step with packed q/k/v runs the fused QKV + paged-decode kernel.
Metric keys are byte-compatible with the reference.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``cache="slot"``, prefix caching, speculative decoding, mesh
placement.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import not_ported, resolve_device
from repro_torch.obs import Registry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.quant.policy import QuantPolicy
from repro_torch.serve.cache import PagedCachePool
from repro_torch.serve.queue import AdmissionQueue
from repro_torch.serve.request import Request, SamplingParams
from repro_torch.serve.sampler import greedy_rows, row_arrays, sample_rows
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.train.serve import make_decode_step


def _param_device(sparams) -> torch.device:
    emb = sparams["embed"]
    return getattr(emb, "w", emb).device


@dataclass
class _Inflight:
    """One dispatched-but-unsynced decode step: the sampled token vector
    (``(num_slots,) int32`` on the device, possibly still computing; the
    step's own copy of the output of a sampler graph that every engine
    replays), its host copy and the event that covers that copy (None on
    the CPU, where the copy is done), the emission positions it was
    sampled at, and a snapshot of the rows it covered (identity-checked
    at sync: a row that turned over since dispatch carried a phantom
    token, which is discarded)."""

    tokens: torch.Tensor       # (num_slots,) int32 on the engine's device
    host: torch.Tensor         # its copy on the host
    event: object              # torch.cuda.Event covering the copy, or None
    positions: torch.Tensor    # (num_slots,) int32 on the engine's device
    rows: dict                 # slot -> RunningSeq at dispatch time


class ServeEngine:
    def __init__(self, model, sparams, *, num_slots: int = 8,
                 max_len: int = 256, cache: str = "paged",
                 block_size: int = 16, num_blocks: int | None = None,
                 prefill_chunk: int = 16, max_pending: int = 0,
                 spec=None, kv_bits=None, kv_oracle: bool = False,
                 metrics_window: int = 512, prefix_cache: bool = False,
                 registry=None, tracer=None, sample_device: bool = True,
                 pipeline: bool = True, decode_fn=None,
                 device=None):
        if cache != "paged":
            raise not_ported(f"cache={cache!r}", "slice A, item 3 (rest)")
        if prefix_cache:
            raise not_ported("prefix caching", "slice A, item 5")
        if spec is not None:
            raise not_ported("speculative decoding", "slice A, item 7")
        if metrics_window < 1:
            raise ValueError("metrics_window must be >= 1")
        self.device = resolve_device(device)
        if _param_device(sparams).type != self.device.type:
            raise ValueError(f"serving params live on {_param_device(sparams)}, "
                             f"engine device is {self.device}")
        self.model = model
        self.sparams = sparams
        self.cache_kind = cache
        self.obs = registry if registry is not None else Registry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.pool = PagedCachePool(model, num_slots, max_len,
                                   block_size=block_size,
                                   num_blocks=num_blocks, device=self.device,
                                   kv_bits=kv_bits, kv_oracle=kv_oracle)
        self.prefill_chunk = prefill_chunk
        self.pool.tracer = self.tracer
        self.queue = AdmissionQueue(max_pending)
        self.scheduler = ContinuousScheduler(self.pool, self.queue,
                                             registry=self.obs)
        self._length_bound = self.pool.length_bound
        self._decode = decode_fn or make_decode_step(model, device=self.device)
        # one-token hotpath: device sampling, and the lookahead on top
        self._sample_device = bool(sample_device)
        self._pipeline_on = bool(pipeline and sample_device)
        self._inflight: _Inflight | None = None
        self._row_sig = None      # batch-composition key for _row_params
        self._row_dev = None      # cached device sampling-param arrays
        self._all_greedy = True   # every running row at temperature <= 0
        self._next_id = 0
        self._step_idx = 0
        obs = self.obs
        TOK = (1, 4, 16, 64, 256, 1024, 4096)   # token-count boundaries
        self._c_tokens = obs.counter("serve.tokens_total", unit="tokens")
        self._c_decode_steps = obs.counter("serve.decode_steps", unit="steps")
        self._c_run_seconds = obs.counter("serve.run_seconds", unit="s")
        self._c_occ_sum = obs.counter("serve.occupancy_sum")
        self._c_block_occ_sum = obs.counter("serve.block_occupancy_sum")
        self._c_prefill_launches = obs.counter("serve.prefill_launches")
        self._c_recompiles = obs.counter(
            "serve.recompiles",
            desc="CUDA graphs captured again after construction")
        self._h_decode = obs.histogram("serve.decode_step_seconds", unit="s",
                                       window=metrics_window)
        self._h_decode_tok = obs.histogram("serve.decode_tok_seconds",
                                           unit="s", window=metrics_window)
        self._h_device = obs.histogram("serve.decode_device_seconds",
                                       unit="s", window=metrics_window)
        self._h_host = obs.histogram("serve.decode_host_seconds", unit="s",
                                     window=metrics_window)
        self._h_queue_wait = obs.histogram("serve.queue_wait_seconds",
                                           unit="s", window=metrics_window)
        self._h_admit_hit = obs.histogram("prefix.admit_hit_tokens",
                                          unit="tokens", buckets=TOK,
                                          window=metrics_window)
        self._h_admit_total = obs.histogram("prefix.admit_replay_tokens",
                                            unit="tokens", buckets=TOK,
                                            window=metrics_window)
        self._g_queue = obs.gauge("serve.queue_depth", unit="requests")
        self._g_running = obs.gauge("serve.running_rows", unit="rows")
        self._c_lookahead = obs.counter(
            "pipeline.lookahead", unit="steps",
            desc="decode steps dispatched before the previous sync")
        self._c_bubbles = obs.counter(
            "pipeline.bubbles", unit="steps",
            desc="pipeline-on steps that ran synchronously")
        self._device_seconds = 0.0
        self._graphed = {"decode": self._decode, "sample": sample_rows,
                         "greedy": greedy_rows}
        self._recaptures = 0      # the decode graph's, at the last check
        self.requests: dict[int, Request] = {}

    @classmethod
    def from_params(cls, model, params, policy: QuantPolicy, **kw):
        """Quantize + bit-pack training params at ``policy`` and serve."""
        from repro_torch.train.serve import quantize_for_serving

        return cls(model, quantize_for_serving(model, params, policy,
                                               device=kw.get("device")), **kw)

    # ------------------------------------------------------------- frontend
    def submit(self, prompt, max_new_tokens: int,
               sampling: SamplingParams | None = None,
               eos_id: int | None = None) -> int:
        req = Request(self._next_id, np.asarray(prompt), max_new_tokens,
                      sampling or SamplingParams(), eos_id)
        if req.total_len() > self._length_bound:
            raise ValueError(
                f"request needs {req.total_len()} cache tokens > pool "
                f"max_len {self._length_bound}")
        req.arrival_step = self._step_idx
        self.queue.push(req)  # may raise (backpressure): nothing registered
        self._next_id += 1
        self.requests[req.request_id] = req
        return req.request_id

    @property
    def steps(self) -> int:
        return self._step_idx

    @property
    def num_queued(self) -> int:
        return len(self.queue)

    @property
    def num_running(self) -> int:
        return self.scheduler.num_running

    @property
    def graph_captures(self) -> dict:
        """CUDA graphs captured so far by the decode step and the shared
        samplers (0 each on the CPU or with an eager ``decode_fn``)."""
        return {kind: getattr(fn, "captures", 0) for kind, fn in self._graphed.items()}

    @property
    def graph_capture_seconds(self) -> dict:
        """Host seconds of the warm-ups and captures counted in
        :attr:`graph_captures`."""
        return {kind: getattr(fn, "capture_seconds", 0.0)
                for kind, fn in self._graphed.items()}

    def _note_recapture(self) -> None:
        """Count the decode graph's re-captures since the last call in
        ``serve.recompiles``, with an instant on the tracer.  (The
        samplers copy every input, so they never capture again.)"""
        n = getattr(self._decode, "recaptures", 0)
        if n > self._recaptures:
            self._c_recompiles.inc(n - self._recaptures)
            self._recaptures = n
            self.tracer.instant("cuda_graph.capture", kind="decode", step=self._step_idx)

    # ------------------------------------------------------------- prefill
    def _admit_paged(self, req: Request, seq: int, hit: int = 0):
        """Chunked prefill straight into the sequence's blocks.  Every
        chunk has the same shape.  On resume after preemption the prompt
        + emitted tokens are replayed and no new token is emitted."""
        replay = req.replay_tokens()
        C = self.prefill_chunk
        logits = None
        for lo in range(hit, len(replay), C):
            piece = replay[lo:lo + C]
            valid = len(piece)
            buf = np.zeros((1, C), np.int32)
            buf[0, :valid] = piece
            with self.tracer.span("prefill.chunk", seq=seq, start=lo,
                                  valid=valid, request=req.request_id):
                logits, cache = self.model.prefill_chunk(
                    self.sparams, self.pool.step_cache(),
                    torch.from_numpy(buf).to(self.device), seq, lo, valid)
                self.pool.accept(cache)
            self._c_prefill_launches.inc()
        self.pool.record_tokens(seq, replay)
        req.prefix_cached_tokens += hit
        self._h_admit_hit.observe(hit)
        self._h_admit_total.observe(len(replay))
        if req.output_tokens:  # resume: last emitted token is the next feed
            return req.output_tokens[-1], len(replay), False
        return req.select_token(logits[0, 0].cpu().numpy()), len(replay), True

    # ----------------------------------------------------------------- loop
    def step(self) -> dict:
        """One engine iteration.  Returns the step's events:
        ``{"admitted": [ids], "tokens": [(id, tok)], "finished": [ids],
        "preempted": [ids]}``."""
        t0 = time.perf_counter()
        tr = self.tracer
        events = {"admitted": [], "tokens": [], "finished": [],
                  "preempted": []}

        # 0) a lookahead dispatched by the PREVIOUS step is this step's
        #    decode, synced below AFTER admissions.  A fully-stale one
        #    (every row it covered finished at the last sync) is dropped
        #    unfetched: its writes went to blocks rewritten before any read
        inf = self._inflight
        self._inflight = None
        if inf is not None and not any(
                self.scheduler.running.get(s) is q for s, q in inf.rows.items()):
            inf = None

        # 1) admit queued requests into free rows (mid-decode is fine:
        #    running sequences are untouched, their blocks never move; an
        #    in-flight lookahead touches only its own rows' blocks, and
        #    everything runs on one stream)
        for req, slot, hit in self.scheduler.admissions():
            wait = time.perf_counter() - req.queued_time
            self._h_queue_wait.observe(wait)
            tr.complete("queue.wait", start=req.queued_time, dur=wait,
                        request=req.request_id,
                        requeued=req.preemptions > 0)
            with tr.span("admit", request=req.request_id, seq=slot,
                         prefix_hit_tokens=hit) as sp:
                tok, cached, emitted = self._admit_paged(req, slot, hit)
                sp.set(replay_tokens=cached, new_tokens=cached - hit)
            if emitted:
                self._emit(req, tok, events)
            events["admitted"].append(req.request_id)
            self.scheduler.start(req, slot, tok, cached_len=cached)
            if req.done:  # 1-token budget (or instant EOS): row back now
                self._finish(self.scheduler.finish(slot), events)

        if inf is not None:
            # 2/3 pipelined) the in-flight lookahead IS this step's decode:
            #    its write positions were reserved at dispatch
            self._timed_decode(events, tr, lambda ev: self._pipeline_tail(inf, ev),
                               mode="pipelined")
        else:
            # 2) reserve next-token blocks; exhaustion preempts youngest
            for req in self.scheduler.reserve_for_decode():
                events["preempted"].append(req.request_id)
                tr.instant("preempt", request=req.request_id, step=self._step_idx)

            # 3) one packed decode step over every running row
            if self.scheduler.running:
                self._timed_decode(events, tr, self._sync_body, mode="decode")

        self._step_idx += 1
        self._g_queue.set(len(self.queue))
        self._g_running.set(self.scheduler.num_running)
        self._c_run_seconds.inc(time.perf_counter() - t0)
        return events

    def _timed_decode(self, events: dict, tr, body, mode: str) -> None:
        """Run one decode body under the ``decode.step`` span with the
        occupancy counters and the device/host wall-time split:
        ``_device_seconds`` is time driving or awaiting the device (the
        dispatch, which on the CPU is the compute, plus the blocking fetch
        of tokens or logits); ``decode.host`` the rest (host sampling,
        bookkeeping)."""
        self._c_occ_sum.inc(self.pool.occupancy())
        self._c_block_occ_sum.inc(self.pool.block_occupancy())
        self._c_decode_steps.inc()
        self._device_seconds = 0.0
        t_dec = time.perf_counter()
        n_tok = len(events["tokens"])
        with tr.span("decode.step", step=self._step_idx,
                     rows=len(self.scheduler.running), mode=mode) as sp:
            body(events)
            emitted = len(events["tokens"]) - n_tok
            sp.set(tokens=emitted)
        dt = time.perf_counter() - t_dec
        self._h_decode.observe(dt)
        if emitted > 0:  # an all-stale sync can emit 0
            self._h_decode_tok.observe(dt / emitted)
        self._h_device.observe(self._device_seconds)
        self._h_host.observe(max(dt - self._device_seconds, 0.0))

    def _sync_body(self, events: dict) -> None:
        """Decode body for a step with no pipelined predecessor."""
        if self._sample_device:
            self._pipeline_tail(self._dispatch_decode(), events)
        else:
            self._decode_once(events)

    # ------------------------------------------------------ device hotpath
    def _row_params(self):
        """Device-resident per-row sampling parameters, re-uploaded only
        when the batch composition changes (slot -> request mapping)."""
        sched = self.scheduler
        sig = tuple(sorted((s, q.request.request_id)
                           for s, q in sched.running.items()))
        if sig != self._row_sig:
            temps, top_ks, top_ps, seeds, rids = row_arrays(
                self.pool.num_slots, ((s, q.request) for s, q in sched.running.items()))
            self._all_greedy = bool((temps <= 0.0).all())
            # uint32 seeds ride in int64 (torch's uint32 lacks most ops on CUDA)
            arrs = (temps, top_ks, top_ps, seeds.astype(np.int64), rids)
            self._row_dev = tuple(torch.from_numpy(a).to(self.device) for a in arrs)
            self._row_sig = sig
        return self._row_dev

    def _dispatch_decode(self, toks_dev=None, positions=None) -> _Inflight:
        """Dispatch one packed decode + on-device sampling WITHOUT
        blocking.  The synchronous head builds the feed from the host's
        ``last_token``s; a chained (lookahead) dispatch feeds the previous
        step's device token vector back in.  The sampler's output buffer
        is shared by every engine and overwritten by its next replay, so
        the step keeps its own copy (the chained feed); on the card that
        copy goes on to pinned host memory behind an event."""
        sched = self.scheduler
        if toks_dev is None:
            toks = np.zeros((self.pool.num_slots, 1), np.int32)
            pos = np.zeros((self.pool.num_slots,), np.int32)
            for slot, seq in sched.running.items():
                toks[slot, 0] = seq.last_token
                pos[slot] = len(seq.request.output_tokens)
            toks_dev = torch.from_numpy(toks).to(self.device)
            positions = torch.from_numpy(pos).to(self.device)
        t_dev = time.perf_counter()
        with self.tracer.span("decode.dispatch", rows=len(sched.running)):
            logits, cache = self._decode(self.sparams, self.pool.step_cache(), toks_dev)
            self.pool.accept(cache)
            params = self._row_params()
            if self._all_greedy:
                tokens = greedy_rows(logits[:, -1])
            else:
                tokens = sample_rows(logits[:, -1], *params, positions)
            tokens = tokens.clone()
            host, event = tokens, None
            if tokens.is_cuda:
                host = torch.empty(tokens.shape, dtype=tokens.dtype, pin_memory=True)
                host.copy_(tokens, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
        self._device_seconds += time.perf_counter() - t_dev
        self._note_recapture()
        return _Inflight(tokens, host, event, positions, dict(sched.running))

    def _sync_inflight(self, inf: _Inflight, events: dict) -> None:
        """Wait for the in-flight token vector's host copy, then emit and
        advance.  Rows whose sequence turned over since dispatch carried a
        phantom token, which is discarded here."""
        t_dev = time.perf_counter()
        with self.tracer.span("decode.device", rows=len(inf.rows)):
            if inf.event is not None:
                inf.event.synchronize()
            toks = inf.host.numpy()
        self._device_seconds += time.perf_counter() - t_dev
        with self.tracer.span("decode.host"):
            for slot, seq in inf.rows.items():
                if self.scheduler.running.get(slot) is not seq:
                    continue
                tok = int(toks[slot])
                self._emit(seq.request, tok, events)
                if seq.request.done:
                    self._finish(self.scheduler.finish(slot), events)
                else:
                    self.scheduler.advance(slot, tok)

    def _pipeline_tail(self, inf: _Inflight, events: dict) -> None:
        """Dispatch the NEXT step's decode (when safe) BEFORE syncing the
        current one, so the wait and the bookkeeping below overlap the
        device's next step.  Ineligible steps sync in plain order and
        count ``pipeline.bubbles``.  Chaining feeds ``inf.tokens`` back for
        EVERY slot, so it needs the running rows to be exactly those the
        in-flight step covered: a row admitted since has no token there."""
        nxt = None
        same_rows = (len(self.scheduler.running) == len(inf.rows) and all(
            inf.rows.get(s) is q for s, q in self.scheduler.running.items()))
        if self._pipeline_on:
            if same_rows and self._lookahead_ok():
                nxt = self._dispatch_decode(inf.tokens[:, None], inf.positions + 1)
                self._c_lookahead.inc()
            else:
                self._c_bubbles.inc()
        self._sync_inflight(inf, events)
        self._inflight = nxt

    def _lookahead_ok(self) -> bool:
        """Can step t+1 be dispatched before step t's tokens land?  Needs
        nothing queued to admit, budget for one more token after this step
        in every running request (an EOS can still land: that row's
        phantom token is discarded at sync), and a non-preempting
        reservation of the t+1 write position."""
        if len(self.queue):
            return False
        for seq in self.scheduler.running.values():
            req = seq.request
            if len(req.output_tokens) + 2 > req.max_new_tokens:
                return False
        return self.scheduler.reserve_lookahead()

    def _decode_once(self, events: dict) -> None:
        """One packed single-token decode over every running row, host
        sampling from the fetched ``(num_slots, V)`` logits
        (``sample_device=False``)."""
        toks = np.zeros((self.pool.num_slots, 1), np.int32)
        for slot, seq in self.scheduler.running.items():
            toks[slot, 0] = seq.last_token
        t_dev = time.perf_counter()
        with self.tracer.span("decode.device",
                              rows=len(self.scheduler.running)):
            logits, cache = self._decode(
                self.sparams, self.pool.step_cache(),
                torch.from_numpy(toks).to(self.device))
            self.pool.accept(cache)
            rows = logits[:, -1].cpu().numpy()  # (num_slots, V) — blocks here
        self._device_seconds += time.perf_counter() - t_dev
        self._note_recapture()
        with self.tracer.span("decode.host"):
            for slot, seq in list(self.scheduler.running.items()):
                tok = seq.request.select_token(rows[slot])
                self._emit(seq.request, tok, events)
                if seq.request.done:
                    self._finish(self.scheduler.finish(slot), events)
                else:
                    self.scheduler.advance(slot, tok)

    def run_until_drained(self, max_steps: int = 100_000) -> dict:
        steps = 0
        while self.scheduler.has_work():
            if steps >= max_steps:
                raise RuntimeError(f"not drained after {max_steps} steps")
            self.step()
            steps += 1
        return self.metrics()

    # -------------------------------------------------------------- metrics
    def _emit(self, req: Request, tok: int, events: dict) -> None:
        if not req.output_tokens:
            req.first_token_time = time.perf_counter()
            req.first_token_step = self._step_idx
        req.output_tokens.append(tok)
        self._c_tokens.inc()
        events["tokens"].append((req.request_id, tok))

    def _finish(self, req: Request, events: dict) -> None:
        req.finish_time = time.perf_counter()
        events["finished"].append(req.request_id)

    def metrics(self) -> dict:
        """Aggregate and per-request metrics; keys are byte-compatible with
        the reference engine's."""
        per_request = []
        for req in self.requests.values():
            per_request.append({
                "id": req.request_id,
                "state": req.state.value,
                "prompt_len": int(req.prompt.size),
                "new_tokens": len(req.output_tokens),
                "preemptions": req.preemptions,
                "ttft_s": req.ttft(),
                "ttft_steps": (None if req.first_token_step is None
                               else req.first_token_step - req.arrival_step),
                "latency_s": (None if req.finish_time is None
                              else req.finish_time - req.arrival_time),
                "prefix_cached_tokens": req.prefix_cached_tokens,
            })
        decode_steps = int(self._c_decode_steps.value)
        tokens_total = int(self._c_tokens.value)
        run_seconds = self._c_run_seconds.value
        pool = self.pool
        out = {
            "steps": self._step_idx,
            "decode_steps": decode_steps,
            "tokens_total": tokens_total,
            "tokens_per_s": (tokens_total / run_seconds
                             if run_seconds > 0 else 0.0),
            "mean_occupancy": (self._c_occ_sum.value / decode_steps
                               if decode_steps else 0.0),
            "num_slots": pool.num_slots,
            "cache": self.cache_kind,
            "preemptions": self.scheduler.preemptions,
            "recompiles": int(self._c_recompiles.value),
            "requests": per_request,
            "sampler": {
                "device": self._sample_device,
                "fallbacks": 0,   # no speculative path
            },
            "pipeline": {
                "enabled": self._pipeline_on,
                "lookahead_steps": int(self._c_lookahead.value),
                "bubbles": int(self._c_bubbles.value),
            },
        }
        if self._h_decode.count:
            out["decode_step_p50_ms"] = self._h_decode.percentile(50) * 1e3
            out["decode_step_p99_ms"] = self._h_decode.percentile(99) * 1e3
            out["decode_device_p50_ms"] = self._h_device.percentile(50) * 1e3
            out["decode_host_p50_ms"] = self._h_host.percentile(50) * 1e3
            if self._h_decode_tok.count:
                out["decode_tok_p50_ms"] = self._h_decode_tok.percentile(50) * 1e3
        if self._h_queue_wait.count:
            out["queue_wait_p50_ms"] = self._h_queue_wait.percentile(50) * 1e3
        out["mean_block_occupancy"] = (self._c_block_occ_sum.value / decode_steps
                                       if decode_steps else 0.0)
        out["block_size"] = pool.block_size
        out["num_blocks"] = pool.num_blocks
        out["prefill_launches"] = int(self._c_prefill_launches.value)
        total = self._h_admit_total.window_sum()
        out["prefix_hit_rate"] = (self._h_admit_hit.window_sum() / total
                                  if total else 0.0)
        out["prefix_hits"] = pool.prefix_hits
        out["prefix_lookups"] = pool.prefix_lookups
        out["blocks_shared"] = 0.0
        out["prefix_cache"] = {
            "enabled": False,
            "lookups": pool.prefix_lookups,
            "hits": pool.prefix_hits,
            "hit_tokens": pool.prefix_hit_tokens,
            "cow_copies": pool.cow_copies,
            "evictions": pool.prefix_evictions,
            "cached_blocks": pool.prefix_cached_blocks,
        }
        if pool.kv_bits is not None:
            out["kv_bits"] = list(pool.kv_bits)
            out["kv_oracle"] = pool.kv_oracle
        return out

    def output(self, request_id: int) -> list[int]:
        return list(self.requests[request_id].output_tokens)
