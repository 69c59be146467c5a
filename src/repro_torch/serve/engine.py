"""ServeEngine: the continuous-batching serve loop (torch port of
``repro.serve.engine``, synchronous host-sampling path).

``submit()`` enqueues a request; ``step()`` runs one engine iteration
(admit -> chunked prefill of new sequences -> reserve one token of growth
per running row, preempting the youngest on block exhaustion -> one
packed decode step over every running row); ``run_until_drained()``
steps until queue and rows are empty.  Weights stay bit-packed at a
ReLeQ ``QuantPolicy`` for the engine's lifetime.

Admission runs *fixed-shape chunked prefill* straight into the
sequence's KV blocks (``prefill_chunk`` chunks of one shape for any
prompt length); a preempted request re-admits by replaying prompt +
emitted tokens, and greedy decode makes the replay exact.  Each decode
step fetches the ``(num_slots, V)`` logits and selects tokens on the
host from the per-request numpy streams (``Request.select_token``), bit
for bit as the reference's ``sample_device=False`` path.

On the card every packed matmul is the hand-written ``qmm`` kernel and
every decode attention a hand-written paged-attention kernel
(``kernels.ops``); with ``kv_bits`` the pool holds quantized blocks and a
decode step with packed q/k/v runs the fused QKV + paged-decode kernel.
There is no jit, so the ``recompiles`` metric is always 0.  Metric keys
are byte-compatible with the reference.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``cache="slot"``, prefix caching, on-device sampling and the
lookahead pipeline, speculative decoding, mesh placement.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import not_ported, resolve_device
from repro_torch.obs import Registry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.quant.policy import QuantPolicy
from repro_torch.serve.cache import PagedCachePool
from repro_torch.serve.queue import AdmissionQueue
from repro_torch.serve.request import Request, SamplingParams
from repro_torch.serve.scheduler import ContinuousScheduler


def _param_device(sparams) -> torch.device:
    emb = sparams["embed"]
    return getattr(emb, "w", emb).device


class ServeEngine:
    def __init__(self, model, sparams, *, num_slots: int = 8,
                 max_len: int = 256, cache: str = "paged",
                 block_size: int = 16, num_blocks: int | None = None,
                 prefill_chunk: int = 16, max_pending: int = 0,
                 spec=None, kv_bits=None, kv_oracle: bool = False,
                 metrics_window: int = 512, prefix_cache: bool = False,
                 registry=None, tracer=None, sample_device: bool = False,
                 pipeline: bool = False, device=None):
        if cache != "paged":
            raise not_ported(f"cache={cache!r}", "slice A, item 3 (rest)")
        if prefix_cache:
            raise not_ported("prefix caching", "slice A, item 5")
        if sample_device or pipeline:
            raise not_ported("on-device sampling and the lookahead pipeline",
                             "slice A, item 6")
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
            "serve.recompiles", desc="always 0: the port compiles nothing per call")
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
        self._device_seconds = 0.0
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

        # 1) admit queued requests into free rows (mid-decode is fine:
        #    running sequences are untouched, their blocks never move)
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

        # 2) reserve next-token blocks; exhaustion preempts youngest
        for req in self.scheduler.reserve_for_decode():
            events["preempted"].append(req.request_id)
            tr.instant("preempt", request=req.request_id, step=self._step_idx)

        # 3) one packed decode step over every running row
        if self.scheduler.running:
            self._timed_decode(events, tr)

        self._step_idx += 1
        self._g_queue.set(len(self.queue))
        self._g_running.set(self.scheduler.num_running)
        self._c_run_seconds.inc(time.perf_counter() - t0)
        return events

    def _timed_decode(self, events: dict, tr) -> None:
        """Run one decode under the ``decode.step`` span with the
        occupancy counters and the device/host wall-time split:
        ``decode.device`` is the model call plus the blocking logits
        fetch, ``decode.host`` the rest (host sampling, bookkeeping)."""
        self._c_occ_sum.inc(self.pool.occupancy())
        self._c_block_occ_sum.inc(self.pool.block_occupancy())
        self._c_decode_steps.inc()
        self._device_seconds = 0.0
        t_dec = time.perf_counter()
        n_tok = len(events["tokens"])
        with tr.span("decode.step", step=self._step_idx,
                     rows=len(self.scheduler.running), mode="decode") as sp:
            self._decode_once(events)
            emitted = len(events["tokens"]) - n_tok
            sp.set(tokens=emitted)
        dt = time.perf_counter() - t_dec
        self._h_decode.observe(dt)
        if emitted > 0:
            self._h_decode_tok.observe(dt / emitted)
        self._h_device.observe(self._device_seconds)
        self._h_host.observe(max(dt - self._device_seconds, 0.0))

    def _decode_once(self, events: dict) -> None:
        """One packed single-token decode over every running row, host
        sampling from the fetched ``(num_slots, V)`` logits."""
        toks = np.zeros((self.pool.num_slots, 1), np.int32)
        for slot, seq in self.scheduler.running.items():
            toks[slot, 0] = seq.last_token
        t_dev = time.perf_counter()
        with self.tracer.span("decode.device",
                              rows=len(self.scheduler.running)):
            logits, cache = self.model.decode_step(
                self.sparams, self.pool.step_cache(),
                torch.from_numpy(toks).to(self.device))
            self.pool.accept(cache)
            rows = logits[:, -1].cpu().numpy()  # (num_slots, V) — blocks here
        self._device_seconds += time.perf_counter() - t_dev
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
            "sampler": {"device": False, "fallbacks": 0},
            "pipeline": {"enabled": False, "lookahead_steps": 0, "bubbles": 0},
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
