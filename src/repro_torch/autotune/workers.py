"""Evaluation workers (torch port of ``repro.autotune.workers``): the
evaluator kinds behind one interface.

A candidate bitwidth policy is scored on up to two axes:

- **accuracy** (`AccuracyEvaluator`): the short-QAT proxy — any
  ``evaluate(bits_by_name) -> rel_acc`` callable (LM likelihood ratio,
  CNN accuracy ratio, or a synthetic oracle).  Results memoize in a
  shared :class:`~repro_torch.core.evalcache.EvalCache`; evaluators that
  are not thread-safe (they advance a data cursor, e.g. the QAT retrain)
  are serialized behind a lock while distinct-candidate latency
  measurements still overlap.
- **latency** (hardware-in-the-loop): seconds per decode step of the
  candidate policy:

  * :class:`EngineLatencyEvaluator` packs the candidate's weights
    (``quant.pack``) and times real ``ServeEngine`` decode steps on the
    engine's device — the HAQ-style signal.  The engine pipelines its
    steps (a step returns with the next one in flight), so the device is
    synchronized before each clock is read, and CUDA events time the same
    window on the card (``records``);
  * :class:`OpCountLatencyEvaluator` (the twin of the reference's
    ``HLOLatencyEvaluator``, which rooflines XLA's optimized HLO) builds
    the candidate's packed decode step on meta tensors and rooflines the
    port's own op count of it (``launch.op_costs``: aten ops and each
    kernel's contract bytes) at one H100's rates, with nothing allocated;
  * :class:`AnalyticLatencyEvaluator` is the closed-form decode roofline
    (``costmodel.weight_stream_decode_time``, one H100's data-sheet rates
    unless others are given) for tests and benches.

  Each reports ``ref_latency`` at the all-8-bit reference so
  the service can fold the *ratio* into the reward alongside SQ.

- **draftability** (:class:`DraftabilityEvaluator`): the candidate bits
  play the *quantized self-draft* under a fixed 8-bit target
  (``repro_torch.spec``), and the measured quantity is end-to-end
  speculative seconds per emitted token.

:class:`EvaluatorPool` fans candidates out to a thread pool and returns
futures — the async service consumes them out of order.  One pool-wide
measurement lock serializes every timing and every serialized retrain on
the shared device.
"""
from __future__ import annotations

import gc
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core.evalcache import EvalCache


@dataclass(frozen=True)
class EvalResult:
    """One worker's verdict on a candidate policy."""

    acc: float                      # relative accuracy in (0, ~1.2]
    sq: float | None = None         # filled by the service (analytic)
    latency: float | None = None    # s/decode-step at the candidate
    ref_latency: float | None = None  # same measurement at all-8-bit
    acc_cache_hit: bool = False
    eval_seconds: float = 0.0

    def latency_ratio(self) -> float | None:
        """latency / 8-bit reference, in (0, 1] for any sub-8-bit policy."""
        if self.latency is None or not self.ref_latency:
            return None
        return self.latency / self.ref_latency


class AccuracyEvaluator:
    """Short-QAT accuracy proxy behind the shared memo-cache.

    ``thread_safe=False`` (default) serializes the underlying callable —
    the QAT retrain advances a data cursor, so two threads inside it would
    race.  Device-parallel evaluators (one card per worker, or a pure
    function) pass ``thread_safe=True``.
    """

    def __init__(self, fn, *, cache: EvalCache | None = None,
                 thread_safe: bool = False):
        self.fn = fn
        self.cache = cache if cache is not None else EvalCache()
        self._lock = None if thread_safe else threading.Lock()

    def __call__(self, bits_by_name: dict) -> tuple[float, bool]:
        def compute():
            if self._lock is not None:
                with self._lock:
                    return float(self.fn(bits_by_name))
            return float(self.fn(bits_by_name))

        value, hit = self.cache.get_or_compute(bits_by_name, compute)
        return float(value), hit


class _LatencyBase:
    """Shared cache + 8-bit reference plumbing for latency evaluators."""

    def __init__(self, group_names, frozen=None):
        self.group_names = tuple(group_names)
        self.frozen = dict(frozen or {})
        self.cache = EvalCache()
        self._ref: float | None = None

    def _measure(self, bits_by_name: dict) -> float:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, bits_by_name: dict) -> tuple[float, float]:
        """-> (latency, ref_latency) in seconds per decode step."""
        if self._ref is None:
            ref_bits = {n: self.frozen.get(n, 8) for n in self.group_names}
            self._ref, _ = self.cache.get_or_compute(
                ref_bits, lambda: self._measure(ref_bits))
        lat, _ = self.cache.get_or_compute(
            bits_by_name, lambda: self._measure(bits_by_name))
        return float(lat), float(self._ref)


class AnalyticLatencyEvaluator(_LatencyBase):
    """Closed-form decode roofline (``costmodel.weight_stream_decode_time``)
    at ``peak`` flop/s and ``bw`` bytes/s (one H100's by default)."""

    def __init__(self, groups, frozen=None, *, batch: int = 1,
                 peak=costmodel.H100_PEAK_FLOPS, bw=costmodel.H100_HBM_BW):
        super().__init__((g.name for g in groups), frozen)
        self.groups = list(groups)
        self.batch = batch
        self.peak, self.bw = peak, bw

    def _measure(self, bits_by_name: dict) -> float:
        vec = [bits_by_name.get(g.name, 8) for g in self.groups]
        return costmodel.weight_stream_decode_time(vec, self.groups, batch=self.batch,
                                                   peak=self.peak, bw=self.bw)


class OpCountLatencyEvaluator(_LatencyBase):
    """No-card stand-in: the candidate's packed decode step, built on meta
    tensors (``launch.specs``) and counted (``launch.op_costs``), scored
    ``max(flops / peak, bytes / bw)`` at one H100's data-sheet rates.  It
    sees the bitplanes ``quant.pack`` would serve, through each kernel's
    contract (planes of ``bits·K·N/8`` bytes), so fewer bits always cost
    fewer bytes.  One count per distinct candidate (memoized); nothing is
    allocated on any device."""

    def __init__(self, model, *, batch: int = 1, max_len: int = 32,
                 peak=costmodel.H100_PEAK_FLOPS, bw=costmodel.H100_HBM_BW):
        groups = model.quant_groups()
        super().__init__((g.name for g in groups), model.frozen_bits())
        self.model = model
        self.batch = batch
        self.max_len = max_len
        self.peak, self.bw = peak, bw

    def _measure(self, bits_by_name: dict) -> float:
        from repro_torch.launch.op_costs import count_costs
        from repro_torch.launch.specs import cache_struct, sds, serving_params_struct
        from repro_torch.quant.policy import QuantPolicy

        policy = QuantPolicy.from_array(
            self.group_names, [bits_by_name[n] for n in self.group_names])
        sparams = serving_params_struct(self.model, policy)
        cache = cache_struct(self.model, self.batch, self.max_len)
        tokens = sds((self.batch, 1), torch.int32)
        costs = count_costs(self.model.decode_step, sparams, cache, tokens)
        return max(costs.flops / self.peak, costs.traffic_bytes / self.bw)


def _params_device(params) -> torch.device:
    from repro_torch.optim.adamw import tree_leaves

    return tree_leaves(params)[0].device


def _time_steps(engine, steps: int) -> tuple[float, float | None]:
    """Run ``steps`` engine steps -> (host s, CUDA-event s or None).  On
    the card the device is synchronized before each host clock is read
    (the engine's lookahead leaves a step in flight when ``step()``
    returns) and CUDA events bracket the same window."""
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(engine.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    if not cuda:
        return time.perf_counter() - t0, None
    end.record()
    torch.cuda.synchronize(engine.device)
    return time.perf_counter() - t0, start.elapsed_time(end) / 1e3


class EngineLatencyEvaluator(_LatencyBase):
    """Hardware-in-the-loop: pack the candidate policy and time real
    ``ServeEngine`` decode steps with every row occupied.  The measured
    wall time per engine step — prefill excluded, the graph capture and
    warm-up excluded — is the serving cost the reward sees.  The engine
    runs on the params' device.

    Inside an :class:`EvaluatorPool` the timing runs under the pool's
    measurement lock, so it never overlaps a serialized QAT retrain (or
    another timing) on the shared device.  A ``thread_safe=True``
    accuracy evaluator opts out of that lock — only pair it with this
    evaluator when accuracy work runs on *different* devices, or the
    memoized first measurement will bake in their contention.

    ``kv_quant=True`` extends the candidate space with the model's
    per-layer KV-cache groups (``model.kv_quant_groups()``): any
    ``kv.L..`` keys in ``bits_by_name`` become the engine's per-layer
    ``kv_bits`` list, so the HAQ-style KV action is priced by the same
    measurement as the weight bits.  The 8-bit reference then runs with an
    int8 KV pool (uniform ``kv.* = 8``), making the ratio a pure
    like-for-like bitwidth effect.

    ``records`` keeps one dict per measurement: the average weight bits,
    the KV bits, and seconds per step on the host clock and, on the card,
    by CUDA events."""

    def __init__(self, model, params, *, num_slots: int = 2,
                 prompt_len: int = 4, decode_steps: int = 8,
                 warmup_steps: int = 2, cache: str = "paged",
                 block_size: int = 8, prefill_chunk: int = 8,
                 vocab: int | None = None, seed: int = 0,
                 kv_quant: bool = False):
        groups = model.quant_groups()
        names = [g.name for g in groups]
        self.weight_group_names = tuple(names)
        self.kv_group_names: tuple = ()
        if kv_quant:
            if cache != "paged":
                raise ValueError("kv_quant requires cache='paged'")
            self.kv_group_names = tuple(
                g.name for g in model.kv_quant_groups())
            names += list(self.kv_group_names)
        super().__init__(names, model.frozen_bits())
        self.model, self.params = model, params
        self.device = _params_device(params)
        self.num_slots = num_slots
        self.prompt_len = prompt_len
        self.decode_steps = decode_steps
        self.warmup_steps = warmup_steps
        self.engine_kw = dict(cache=cache)
        if cache == "paged":
            self.engine_kw.update(block_size=block_size,
                                  prefill_chunk=prefill_chunk)
        self.vocab = vocab if vocab is not None else model.cfg.vocab_size
        self.seed = seed
        self.records: list[dict] = []

    def _measure(self, bits_by_name: dict) -> float:
        from repro_torch.quant.policy import QuantPolicy
        from repro_torch.serve import ServeEngine

        wbits = [bits_by_name.get(n, 8) for n in self.weight_group_names]
        policy = QuantPolicy.from_array(self.weight_group_names, wbits)
        # "kv."-prefixed groups are serving-cache state, not weights: they
        # route to the pool's per-layer kv_bits knob, not the pack policy
        kv_kw = {}
        kv_named = {n: int(bits_by_name[n]) for n in self.kv_group_names
                    if n in bits_by_name}
        if kv_named:
            kv_kw["kv_bits"] = [kv_named.get(n, 8)
                                for n in self.kv_group_names]
        gen = self.warmup_steps + self.decode_steps + 2
        max_len = self.prompt_len + gen + 1
        engine = ServeEngine.from_params(
            self.model, self.params, policy, num_slots=self.num_slots,
            max_len=max_len, device=self.device, **self.engine_kw, **kv_kw)
        try:
            rng = np.random.default_rng(self.seed)
            for _ in range(self.num_slots):
                engine.submit(rng.integers(0, self.vocab, self.prompt_len), gen)
            while engine.num_running < self.num_slots:  # admit + prefill
                engine.step()
            for _ in range(self.warmup_steps):
                engine.step()
            host, event = _time_steps(engine, self.decode_steps)
        finally:
            # drop the engine now: its pool and its graphs' private memory
            # go back before the next candidate's engine is built
            del engine
            gc.collect()
        self.records.append({
            "avg_bits": float(np.mean(wbits)), "kv_bits": kv_kw.get("kv_bits"),
            "host_s": host / self.decode_steps,
            "event_s": None if event is None else event / self.decode_steps})
        return host / self.decode_steps


class DraftabilityEvaluator(_LatencyBase):
    """Hardware-in-the-loop *draftability*: how fast does the fixed 8-bit
    target serve when the CANDIDATE policy plays the quantized self-draft?

    Measures end-to-end speculative seconds per emitted token over real
    ``ServeEngine`` steps — draft roll, batched verify, and rejection
    overhead all included, so a candidate that proposes quickly but gets
    rejected scores exactly as badly as it serves.  The reference is the
    all-8-bit "draft" (a draft as expensive as the target — speculation's
    no-win point), so ``latency_ratio() < 1`` iff the candidate actually
    accelerates serving end to end.  Like :class:`EngineLatencyEvaluator`
    this must run under the pool's measurement lock, synchronizes the
    device before each clock, and keeps ``records``."""

    def __init__(self, model, params, *, k: int = 4, num_slots: int = 2,
                 prompt_len: int = 4, decode_steps: int = 6,
                 warmup_steps: int = 2, block_size: int = 8,
                 prefill_chunk: int = 8, vocab: int | None = None,
                 seed: int = 0):
        groups = model.quant_groups()
        super().__init__((g.name for g in groups), model.frozen_bits())
        self.model, self.params = model, params
        self.device = _params_device(params)
        self.k = k
        self.num_slots = num_slots
        self.prompt_len = prompt_len
        self.decode_steps = decode_steps
        self.warmup_steps = warmup_steps
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        self.vocab = vocab if vocab is not None else model.cfg.vocab_size
        self.seed = seed
        self.records: list[dict] = []
        self._sparams8 = None  # 8-bit target, packed once and reused

    def _measure(self, bits_by_name: dict) -> float:
        from repro_torch.quant.policy import QuantPolicy
        from repro_torch.quant.qat import policy_for
        from repro_torch.serve import ServeEngine
        from repro_torch.spec import SpecConfig
        from repro_torch.train.serve import quantize_for_serving

        if self._sparams8 is None:
            self._sparams8 = quantize_for_serving(
                self.model, self.params, policy_for(self.model, 8), device=self.device)
        bits = [bits_by_name[n] for n in self.group_names]
        policy = QuantPolicy.from_array(self.group_names, bits)
        # budget so no request finishes mid-measurement (an idle row would
        # charge the candidate for scheduling, not drafting)
        gen = (self.warmup_steps + self.decode_steps + 2) * (self.k + 1)
        max_len = self.prompt_len + gen + 1
        engine = ServeEngine(
            self.model, self._sparams8, num_slots=self.num_slots,
            max_len=max_len, cache="paged", block_size=self.block_size,
            prefill_chunk=self.prefill_chunk, device=self.device,
            spec=SpecConfig(k=self.k, draft_policy=policy))
        try:
            rng = np.random.default_rng(self.seed)
            for _ in range(self.num_slots):
                engine.submit(rng.integers(0, self.vocab, self.prompt_len), gen)
            while engine.num_running < self.num_slots:  # admit + prefill
                engine.step()
            for _ in range(self.warmup_steps):
                engine.step()
            tok0 = engine.metrics()["tokens_total"]
            host, event = _time_steps(engine, self.decode_steps)
            emitted = max(engine.metrics()["tokens_total"] - tok0, 1)
        finally:
            # drop the engine now: its pool and its graphs' private memory
            # go back before the next candidate's engine is built
            del engine
            gc.collect()
        self.records.append({
            "avg_bits": float(np.mean(bits)), "emitted": emitted,
            "host_s": host / emitted,
            "event_s": None if event is None else event / emitted})
        return host / emitted


class EvaluatorPool:
    """Thread pool running (accuracy, latency) evaluations per candidate.

    ``submit`` returns a :class:`Future` resolving to :class:`EvalResult`;
    the service consumes completions out of order.  Accuracy results share
    one :class:`EvalCache` (hit-rate surfaced via :meth:`stats`); latency
    evaluators carry their own cache keyed on the same canonical tuple.
    """

    def __init__(self, accuracy: AccuracyEvaluator, latency=None, *,
                 num_workers: int = 4, registry=None, tracer=None):
        from repro_torch.obs import Registry
        from repro_torch.obs.trace import NULL_TRACER

        self.accuracy = accuracy
        self.latency = latency
        self.obs = registry if registry is not None else Registry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._h_eval = self.obs.histogram("autotune.eval_seconds", unit="s")
        self._c_acc_hits = self.obs.counter("autotune.acc_cache_hits")
        self.num_workers = max(1, int(num_workers))
        self._ex = ThreadPoolExecutor(
            max_workers=self.num_workers,
            thread_name_prefix="autotune-eval")
        self._submitted = 0
        self._completed = 0
        self._lock = threading.Lock()
        # wall-clock latency measurements must not overlap retrains (or
        # each other) on a shared device — one pool-wide measurement
        # lock serializes both, so a serialized accuracy evaluator and
        # an EngineLatencyEvaluator timing never contend.  thread_safe
        # accuracy evaluators (per-worker devices / pure oracles) opt
        # out of the shared lock and keep running concurrently.
        self._measure_lock = threading.Lock()
        if accuracy._lock is not None:
            accuracy._lock = self._measure_lock

    def _evaluate(self, bits_by_name: dict) -> EvalResult:
        # worker threads record into the shared tracer concurrently: each
        # shows up as its own Perfetto track (named after the executor's
        # thread_name_prefix), spans balance per-thread
        tr = self.tracer
        if tr.enabled:
            tr.name_thread(threading.current_thread().name)
        t0 = time.perf_counter()
        with tr.span("eval.accuracy") as sp:
            acc, hit = self.accuracy(bits_by_name)
            sp.set(cache_hit=hit)
        if hit:
            self._c_acc_hits.inc()
        lat = ref = None
        if self.latency is not None:
            with self._measure_lock, tr.span("eval.latency"):
                lat, ref = self.latency(bits_by_name)
        with self._lock:
            self._completed += 1
        dt = time.perf_counter() - t0
        self._h_eval.observe(dt)
        return EvalResult(acc=acc, latency=lat, ref_latency=ref,
                          acc_cache_hit=hit, eval_seconds=dt)

    def submit(self, bits_by_name: dict) -> Future:
        with self._lock:
            self._submitted += 1
        return self._ex.submit(self._evaluate, dict(bits_by_name))

    def stats(self) -> dict:
        out = {
            "workers": self.num_workers,
            "submitted": self._submitted,
            "completed": self._completed,
            "acc_cache": self.accuracy.cache.stats(),
        }
        if self.latency is not None and hasattr(self.latency, "cache"):
            out["latency_cache"] = self.latency.cache.stats()
        return out

    def shutdown(self) -> None:
        self._ex.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
