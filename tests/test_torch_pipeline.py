"""The port's one-token hotpath (device sampling + the one-step-lookahead
pipeline, the engine's defaults) on the CPU, with the reference's weights
carried over by ``repro_torch.convert``.

- The reference's engine gates (``tests/test_sampler_device.py``)
  rewritten for the port: pipelined equals synchronous and host
  sampling; lookahead + bubbles == decode steps; a sampled stream is the
  same pipelined or not; a mid-run submission breaks the pipeline
  cleanly; preemption under the pipeline replays to the unpressured
  tokens.
- Against ``JaxEngine(sample_device=True, pipeline=True)`` run op by op
  (its model calls unjitted, its sampler jit'd), on the launcher's
  trimmed workload: greedy streams equal under the margin rule of
  ``tests/test_torch_serve.py``; sampled streams (temperature 0.9, top_p
  0.9, seed 123) equal draw for draw, apart from draws flagged at a CDF
  boundary (``tests/test_torch_sampler.py``'s rule); the lookahead and
  bubble counts equal the reference's, since both run the same
  scheduler.
- The buffer discipline of the card's graphs, with stand-ins that
  overwrite their outputs at every replay: one engine with admissions
  and preemptions between lookahead replays, and two engines stepped in
  turn over samplers shared by both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant.qat import policy_for as jax_policy_for
from repro.serve import ServeEngine as JaxEngine
from repro.serve.cache import PagedCachePool as JaxPool
from repro.serve.request import SamplingParams as JaxSamplingParams
from repro.train.serve import quantize_for_serving as jax_qfs
from repro_torch.launch import serve as launcher
from repro_torch.quant.qat import policy_for
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.serve.sampler import uniform
from repro_torch.train.serve import quantize_for_serving
from test_torch_gpu import boundary_flagged
from test_torch_serve import LOGIT_BOUND, _args, _engine_kw, _ref_margin
from torch_parity import models, to_port

SAMPLED = dict(temperature=0.9, top_p=0.9, seed=123)


@pytest.fixture(scope="module")
def port():
    _, tm = models()
    sp = quantize_for_serving(tm, tm.init(seed=3, device="cpu"), policy_for(tm, 4),
                              device="cpu")
    return tm, sp


def _prompt(tm, n, seed):
    return np.random.default_rng(seed).integers(0, tm.cfg.vocab_size, n)


def _serve(tm, sp, prompts, gens, sampling=None, **kw):
    kw = {"num_slots": 3, "max_len": 32, "block_size": 4, "prefill_chunk": 4, **kw}
    eng = ServeEngine(tm, sp, device="cpu", **kw)
    rids = [eng.submit(p, g, sampling=sampling) for p, g in zip(prompts, gens)]
    eng.run_until_drained()
    return [eng.output(r) for r in rids], eng.metrics()


def test_pipelined_equals_synchronous_and_counts_every_step(port):
    tm, sp = port
    prompts = [_prompt(tm, 4, 80 + s) for s in range(3)]
    gens = [9, 9, 9]
    host, mh = _serve(tm, sp, prompts, gens, sample_device=False, pipeline=False)
    sync, ms = _serve(tm, sp, prompts, gens, pipeline=False)
    piped, m = _serve(tm, sp, prompts, gens)
    assert piped == sync == host
    assert mh["sampler"]["device"] is False and mh["pipeline"]["enabled"] is False
    assert ms["pipeline"] == {"enabled": False, "lookahead_steps": 0, "bubbles": 0}
    pl = m["pipeline"]
    assert pl["enabled"] and m["sampler"] == {"device": True, "fallbacks": 0}
    assert pl["lookahead_steps"] > 0
    assert pl["lookahead_steps"] + pl["bubbles"] == m["decode_steps"]
    assert m["recompiles"] == 0


def test_pipeline_invariant_sampled_stream(port):
    tm, sp = port
    prompts = [_prompt(tm, 4, 90 + s) for s in range(2)]
    sampling = SamplingParams(**SAMPLED)
    piped, m = _serve(tm, sp, prompts, [7, 7], sampling, num_slots=2)
    sync, _ = _serve(tm, sp, prompts, [7, 7], sampling, num_slots=2, pipeline=False)
    assert piped == sync
    assert m["pipeline"]["lookahead_steps"] > 0


def test_mid_run_submission_breaks_pipeline_cleanly(port):
    tm, sp = port

    def run(pipeline):
        eng = ServeEngine(tm, sp, device="cpu", num_slots=3, max_len=32, block_size=4,
                          prefill_chunk=4, pipeline=pipeline)
        r0 = eng.submit(_prompt(tm, 4, 7), 10)
        for _ in range(6):
            eng.step()
        r1 = eng.submit(_prompt(tm, 5, 8), 6)
        eng.run_until_drained()
        return [eng.output(r0), eng.output(r1)], eng.metrics()["pipeline"]

    (piped, pl), (sync, _) = run(True), run(False)
    assert piped == sync
    assert pl["lookahead_steps"] > 0 and pl["bubbles"] > 0


def test_preemption_under_the_pipeline_replays_to_the_same_tokens(port):
    tm, sp = port
    args = _args(gen=16, prompt_len=8, block_size=4, arrival_every=0)
    work = launcher.synthetic_workload(args, tm.cfg.vocab_size)
    runs = {}
    for num_blocks, kw in ((None, {"sample_device": False, "pipeline": False}),
                           (9, {})):     # 8 usable blocks: 4 rows need up to 24
        eng = ServeEngine(tm, sp, device="cpu",
                          **{**_engine_kw(args), "num_blocks": num_blocks, **kw})
        launcher.drive(eng, work, 0, SamplingParams())
        runs[num_blocks] = ([eng.output(r) for r in range(len(work))], eng.metrics())
    assert runs[None][1]["preemptions"] == 0 and runs[9][1]["preemptions"] > 0
    assert runs[9][1]["pipeline"]["lookahead_steps"] > 0
    assert runs[9][0] == runs[None][0]


@pytest.fixture(scope="module")
def reference():
    """The reference model, its params and the port's copy of them."""
    jm, tm = models()
    jsp = jax_qfs(jm, jm.init(jax.random.PRNGKey(0)), jax_policy_for(jm, 4))
    return jm, tm, jsp, to_port(jsp)


def _both(reference, sampling, **over):
    """The trimmed launcher workload through the reference (device
    sampling + pipeline, op by op) and the port (its defaults)."""
    jm, tm, jsp, tsp = reference
    args = _args(**over)
    work = launcher.synthetic_workload(args, jm.cfg.vocab_size)
    ref = JaxEngine(jm, jsp, prefix_cache=False, sample_device=True, pipeline=True,
                    prefill_fn=jm.prefill_chunk, decode_fn=jm.decode_step,
                    **_engine_kw(args))
    launcher.drive(ref, work, args.arrival_every, JaxSamplingParams(**sampling))
    eng = ServeEngine(tm, tsp, device="cpu", **_engine_kw(args))
    launcher.drive(eng, work, args.arrival_every, SamplingParams(**sampling))
    return work, ref, eng


def _first_divergence(got, want):
    return next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)


def test_greedy_streams_and_counts_equal_reference(reference):
    jm, _, jsp, _ = reference
    work, ref, eng = _both(reference, {})
    for rid in ref.requests:
        want, got = ref.output(rid), eng.output(rid)
        assert len(got) == len(want) == work[rid][1]
        if got != want:
            i = _first_divergence(got, want)
            margin, scale = _ref_margin(jm, jsp, work[rid][0], want[:i])
            print(f"request {rid}: first divergence at token {i}, reference top-2 "
                  f"margin {margin:.4g} (bound {LOGIT_BOUND * scale:.4g})")
            assert margin < LOGIT_BOUND * scale
    m, rm = eng.metrics(), ref.metrics()
    assert m["pipeline"] == rm["pipeline"] and m["sampler"] == rm["sampler"]
    assert m["pipeline"]["lookahead_steps"] > 0
    assert m["decode_steps"] == rm["decode_steps"]


def _ref_logits(jm, jsp, prompt, emitted):
    """The reference's logits row after ``prompt + emitted``."""
    replay = np.concatenate([prompt, np.asarray(emitted, np.int64)]).astype(np.int32)
    pool = JaxPool(jm, 1, len(replay) + 1, block_size=16, prefix_cache=False)
    seq = pool.alloc_seq()
    pool.ensure(seq, len(replay) + 1)
    logits, _ = jm.prefill_chunk(jsp, pool.step_cache(), jnp.asarray(replay[None]),
                                 seq, 0, len(replay))
    return np.asarray(logits[0, 0], np.float32)


def test_sampled_streams_equal_reference_draw_for_draw(reference):
    jm, _, jsp, _ = reference
    work, ref, eng = _both(reference, SAMPLED)
    sp = SamplingParams(**SAMPLED)
    draws = flagged = 0
    for rid in ref.requests:
        want, got = ref.output(rid), eng.output(rid)
        assert len(got) == len(want) == work[rid][1]
        draws += len(want)
        if got == want:
            continue
        # position 0 is drawn on the host from the prefill logits (the
        # same numpy stream in both packages); later positions on the device
        i = _first_divergence(got, want)
        assert i > 0, f"request {rid}: the host draw at position 0 differs"
        u = uniform(*(torch.tensor([v]) for v in (SAMPLED["seed"], rid, i)))
        row = _ref_logits(jm, jsp, work[rid][0], want[:i])
        assert boundary_flagged(row, sp, u[0].item()), (
            f"request {rid} diverged at token {i} away from any CDF boundary")
        flagged += 1
    print(f"sampled streams: {draws} draws, {flagged} first divergences at a "
          f"flagged CDF boundary")
    assert flagged <= 0.01 * draws
    assert eng.metrics()["pipeline"] == ref.metrics()["pipeline"]


class _ReplayedEagerly:
    """Stands in for ``train.serve._Graph`` on the CPU: runs the step once
    at "capture" and again at each replay, writing every result into the
    output buffers of the first run, as a graph replay overwrites its
    buffers.  A caller that read an output after the next replay would
    see the next step's values."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs, self.launches, self.seconds = fn, inputs, {}, 0.0
        self.outputs = fn(*inputs)

    def replay(self):
        for buf, new in zip(self.outputs, self.fn(*self.inputs)):
            buf.copy_(new)
        return self.outputs


def test_graphed_step_bookkeeping_with_reused_buffers(port, monkeypatch):
    """The engine around ``GraphedDecodeStep`` (static inputs copied in,
    one output buffer overwritten per replay, a re-capture when a bound
    tensor moves) gives the eager engine's streams, with admissions
    between lookahead replays and preemptions under pressure."""
    from repro_torch.train import serve as tserve

    monkeypatch.setattr(tserve, "_Graph", _ReplayedEagerly)
    tm, sp = port
    args = _args(gen=16, prompt_len=8, block_size=4, arrival_every=3)
    work = launcher.synthetic_workload(args, tm.cfg.vocab_size)
    outs = {}
    for name, num_blocks, fn in (("eager", None, None), ("graphed", None, True),
                                 ("graphed, preempting", 9, True)):
        step = tserve.GraphedDecodeStep(tm) if fn else None
        eng = ServeEngine(tm, sp, device="cpu", decode_fn=step,
                          **{**_engine_kw(args), "num_blocks": num_blocks})
        launcher.drive(eng, work, args.arrival_every, SamplingParams())
        outs[name] = [eng.output(r) for r in range(len(work))]
        m = eng.metrics()
        assert m["pipeline"]["lookahead_steps"] > 0 and m["recompiles"] == 0
        if fn:
            assert (step.captures, step.recaptures) == (1, 0)
    assert outs["graphed"] == outs["eager"] == outs["graphed, preempting"]
    # a moved pool tensor is a new key: captured again, counted as a recompile
    eng.pool.cache["k"] = eng.pool.cache["k"].clone()
    eng.submit(work[0][0], 4)
    eng.run_until_drained()
    assert (step.captures, step.recaptures) == (2, 1)
    assert eng.metrics()["recompiles"] == 1


class _SharedOutput:
    """Stands in for a module-level sampler graph on the CPU: every call,
    from any engine, writes its result into one output buffer, as a
    replay of the graph shared by every engine on the card does."""

    def __init__(self, fn):
        self.fn, self.out = fn, None

    def __call__(self, *args):
        new = self.fn(*args)
        if self.out is None or self.out.shape != new.shape:
            self.out = new.clone()
        else:
            self.out.copy_(new)
        return self.out


@pytest.mark.parametrize("sampling", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_two_pipelined_engines_stepped_in_turn(port, monkeypatch, sampling):
    """Two engines on one device, stepped alternately, each with its own
    graphed decode step and the shared samplers: every lookahead is fed
    its own engine's tokens, so each engine's streams are those it gives
    when it serves alone."""
    from repro_torch.serve import engine as engine_mod
    from repro_torch.train import serve as tserve

    monkeypatch.setattr(tserve, "_Graph", _ReplayedEagerly)
    monkeypatch.setattr(engine_mod, "greedy_rows", _SharedOutput(engine_mod.greedy_rows))
    monkeypatch.setattr(engine_mod, "sample_rows", _SharedOutput(engine_mod.sample_rows))
    tm, sp = port
    sp_ = SamplingParams(**sampling)
    prompts = [[_prompt(tm, 4 + s, 100 * e + s) for s in range(3)] for e in range(2)]
    gens = [[9, 7, 11], [8, 12, 6]]
    alone = [_serve(tm, sp, prompts[e], gens[e], sp_, pipeline=False)[0] for e in range(2)]
    engines = [ServeEngine(tm, sp, device="cpu", decode_fn=tserve.GraphedDecodeStep(tm),
                           num_slots=3, max_len=32, block_size=4, prefill_chunk=4)
               for _ in range(2)]
    rids = [[eng.submit(p, g, sampling=sp_) for p, g in zip(prompts[e], gens[e])]
            for e, eng in enumerate(engines)]
    while any(eng.scheduler.has_work() for eng in engines):
        for eng in engines:
            if eng.scheduler.has_work():
                eng.step()
    for e, eng in enumerate(engines):
        assert [eng.output(r) for r in rids[e]] == alone[e], f"engine {e}"
        assert eng.metrics()["pipeline"]["lookahead_steps"] > 0
