"""RWKV6 (rwkv6-1.6b's smoke config) in the port against the JAX package,
with the reference's own weights carried over by ``repro_torch.convert``.

- ``wkv6_chunked`` (lengths on and off the chunk, a carried state) and
  ``wkv6_step`` within 1e-5 * max|ref| in f32: the port forms every
  chunk's pairwise terms at once and sums in another order.
- Logits of ``forward``, ``prefill`` and ``decode_step`` (and the cache
  leaves ``wkv``/``x_tm``/``x_cm``) within 1e-4 * max|ref| in f32 and
  2e-2 in bf16.  The bf16 ``forward`` and ``prefill`` are held against
  the reference run op by op (``jax.disable_jit``): their jit'd
  ``lax.scan`` fuses the bf16 token-shift arithmetic and rounds at other
  points (up to 8e-2 apart from the same function run op by op on these
  inputs), and its engine is run op by op in every stream test here.
- ``quant_groups``/``frozen_bits`` equal, and the packed serving params
  (RWKV's dict-stacked ``blocks`` become the per-layer list) bitwise.
- The paged engine (an O(1)-state pool: no blocks, no length bound, no
  prefix cache) gives the reference engine's greedy streams, run op by op,
  at prefill chunks 4 and 16; the slot pool gives the paged pool's, with
  more requests than rows (a reused row starts from zero state).
- Speculative decoding (k 3, 2-bit draft): greedy streams equal the
  non-spec ones and the reference spec engine's, with equal window
  counts; fix-ups run; the state handed to every verify and fix-up is
  bitwise the pre-draft state.
- ``kv_bits`` is refused with the reference's error.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as jrwkv
from repro.quant.pack import Packed as JPacked
from repro.quant.qat import policy_for as jax_policy_for
from repro.serve import ServeEngine as JaxEngine
from repro.serve.cache import PagedCachePool as JaxPool
from repro.spec import SpecConfig as JaxSpec
from repro.train.serve import quantize_for_serving as jax_qfs
from repro_torch.launch import serve as launcher
from repro_torch.models import rwkv as trwkv
from repro_torch.quant.pack import Packed
from repro_torch.quant.qat import policy_for
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.serve.cache import PagedCachePool
from repro_torch.spec import SpecConfig
from repro_torch.train.serve import quantize_for_serving
from torch_parity import (ReplayedEagerly, models, own_path_replay, rel_err, to_port,
                          watch_spec_state)

ARCH = "rwkv6-1.6b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
OP_BY_OP = dict(sample_device=False, pipeline=False)
STATE = ("wkv", "x_tm", "x_cm")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def served():
    jm, tm = models(ARCH)
    jsp = jax_qfs(jm, jm.init(jax.random.PRNGKey(0)), jax_policy_for(jm, 4))
    return jm, tm, jsp, to_port(jsp)


# --------------------------------------------------------------- the scans
@pytest.mark.parametrize("S,chunk", [(21, 8), (16, 16), (5, 16), (1, 4)])
def test_wkv6_chunked_matches_reference(S, chunk):
    rng = np.random.default_rng(S)
    B, H, K = 2, 3, 8
    r, k, v = (rng.normal(size=(B, S, H, K)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.normal(size=(B, S, H, K))).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    s0 = rng.normal(size=(B, H, K, K)).astype(np.float32)
    jo, js = jrwkv.wkv6_chunked(*map(jnp.asarray, (r, k, v, logw, u, s0)), chunk=chunk)
    to, ts = trwkv.wkv6_chunked(*map(_t, (r, k, v, logw, u, s0)), chunk=chunk)
    assert to.shape == (B, S, H, K) and ts.shape == (B, H, K, K)
    assert rel_err(to.numpy(), jo) <= 1e-5
    assert rel_err(ts.numpy(), js) <= 1e-5


def test_wkv6_step_matches_reference():
    rng = np.random.default_rng(1)
    B, H, K = 3, 2, 8
    r, k, v = (rng.normal(size=(B, H, K)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.normal(size=(B, H, K))).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    s = rng.normal(size=(B, H, K, K)).astype(np.float32)
    jo, js = jrwkv.wkv6_step(*map(jnp.asarray, (r, k, v, logw, u, s)))
    to, ts = trwkv.wkv6_step(*map(_t, (r, k, v, logw, u, s)))
    assert rel_err(to.numpy(), jo) <= 1e-5
    assert rel_err(ts.numpy(), js) <= 1e-5


# ----------------------------------------------------------------- model
def _op_by_op(dtype):
    """bf16: run the reference's scans op by op (module docstring)."""
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_match_reference(dtype):
    jm, tm = models(ARCH, dtype=dtype)
    jp = jm.init(jax.random.PRNGKey(0))
    tp, tol = to_port(jp), TOL[dtype]
    toks = np.random.default_rng(3).integers(0, jm.cfg.vocab_size, (2, 13)).astype(np.int32)
    got, aux = tm.forward(tp, tokens=_t(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 13, jm.cfg.vocab_size)
    assert float(aux) == 0.0
    with _op_by_op(dtype):
        want, _ = jm.forward(jp, tokens=jnp.asarray(toks))
        jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks), max_len=20)
    assert rel_err(got.numpy(), want) <= tol
    tl, tc = tm.prefill(tp, tokens=_t(toks), max_len=20)
    assert rel_err(tl.numpy(), jl) <= tol
    for key in STATE:
        assert tc[key].dtype == getattr(torch, str(jc[key].dtype))
        assert rel_err(tc[key].float().numpy(), np.asarray(jc[key], np.float32)) <= tol, key
    np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
    # decode on from the prefilled contiguous cache
    t = np.array([[3], [5]], np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(t))
        tl, tc = tm.decode_step(tp, tc, _t(t))
        assert rel_err(tl.numpy(), jl) <= tol
        t = np.asarray(np.argmax(np.asarray(jl)[:, -1], -1)[:, None], np.int32)
    for key in STATE:
        assert rel_err(tc[key].float().numpy(), np.asarray(jc[key], np.float32)) <= tol, key


@pytest.mark.parametrize("packed", [False, True], ids=["fp", "packed4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_prefill_chunk_and_decode_match_reference(dtype, packed):
    """Chunked prefill (one prompt longer than a chunk) and decode over an
    O(1)-state pool; logits and the state rows within the model bounds."""
    jm, tm = models(ARCH, dtype=dtype)
    jp = jm.init(jax.random.PRNGKey(1))
    if packed:
        jp = jax_qfs(jm, jp, jax_policy_for(jm, default_bits=4))
    tp, tol = to_port(jp), TOL[dtype]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jm.cfg.vocab_size, 7), rng.integers(0, jm.cfg.vocab_size, 3)]
    jpool = JaxPool(jm, 2, 24, block_size=4, prefix_cache=False)
    tpool = PagedCachePool(tm, 2, 24, block_size=4, device="cpu")
    assert tpool.blocks_per_seq == jpool.blocks_per_seq == 0
    assert tpool.recurrent_keys == STATE
    C = 4
    for seq, prompt in enumerate(prompts):
        for pool in (jpool, tpool):
            assert pool.alloc_seq() == seq and pool.ensure(seq, 10)
        for lo in range(0, len(prompt), C):
            piece = prompt[lo:lo + C]
            buf = np.zeros((1, C), np.int32)
            buf[0, :len(piece)] = piece
            jl, jc = jm.prefill_chunk(jp, jpool.step_cache(), jnp.asarray(buf), seq, lo,
                                      len(piece))
            jpool.accept(jc)
            tl, tc = tm.prefill_chunk(tp, tpool.step_cache(), _t(buf), seq, lo, len(piece))
            tpool.accept(tc)
            assert rel_err(tl.numpy(), jl) <= tol, (seq, lo)
    toks = np.asarray([[p[-1]] for p in prompts], np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jpool.step_cache(), jnp.asarray(toks))
        jpool.accept(jc)
        state = {k: tpool.cache[k] for k in STATE}
        tl, tc = tm.decode_step(tp, tpool.step_cache(), _t(toks))
        tpool.accept(tc)
        assert all(tc[k] is state[k] for k in STATE)   # written in place
        assert rel_err(tl.numpy(), jl) <= tol
        toks = np.asarray(np.argmax(np.asarray(jl)[:, -1], -1)[:, None], np.int32)
    for key in STATE:
        assert rel_err(tpool.cache[key].float().numpy(),
                       np.asarray(jpool.cache[key], np.float32)) <= tol, key
    np.testing.assert_array_equal(tpool.cache["length"].numpy(),
                                  np.asarray(jpool.cache["length"]))


def test_quant_groups_frozen_bits_and_serving_params_match_reference():
    jm, tm = models(ARCH)
    jg, tg = jm.quant_groups(), tm.quant_groups()
    assert [(g.name, g.path, g.shape, g.n_weights, g.n_macs, g.layer) for g in tg] == \
        [(g.name, g.path, g.shape, g.n_weights, g.n_macs, g.layer) for g in jg]
    assert tm.frozen_bits() == jm.frozen_bits()
    jp = jm.init(jax.random.PRNGKey(2))
    jsp = jax_qfs(jm, jp, jax_policy_for(jm, default_bits=4))
    tsp = quantize_for_serving(tm, to_port(jp), policy_for(tm, default_bits=4), device="cpu")
    assert isinstance(tsp["blocks"], list) and len(tsp["blocks"]) == jm.cfg.num_layers
    n = 0
    for jl, tl in zip(jsp["blocks"], tsp["blocks"]):
        for grp, names in (("tm", ("wr", "wk", "wv", "wg", "wo")), ("cm", ("wk", "wv", "wr"))):
            for name in names:
                jw, tw = jl[grp][name], tl[grp][name]
                assert isinstance(jw, JPacked) and isinstance(tw, Packed) and tw.bits == 4
                np.testing.assert_array_equal(tw.planes.numpy(), np.asarray(jw.planes))
                np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
                n += 1
        for name in ("mu_r", "w0", "wa", "wb", "u", "gn"):   # f32 leaves pass through
            np.testing.assert_array_equal(tl["tm"][name].numpy(), np.asarray(jl["tm"][name]))
    assert n == 8 * jm.cfg.num_layers
    np.testing.assert_array_equal(tsp["lm_head"].planes.numpy(),
                                  np.asarray(jsp["lm_head"].planes))


# ------------------------------------------------------------- the engine
def _workload(vocab: int, lens=(5, 11, 8), gen: int = 7, seed: int = 5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n).astype(np.int32), gen - i) for i, n in enumerate(lens)]


def _kw(chunk: int, work, **extra):
    return dict(num_slots=3, max_len=max(len(p) + g for p, g in work) + 1, block_size=4,
                prefill_chunk=chunk, **extra)


def _streams(engine, work, arrival_every=2):
    launcher.drive(engine, work, arrival_every, SamplingParams())
    return [engine.output(r) for r in range(len(work))]


@pytest.mark.parametrize("chunk", [4, 16])
def test_streams_equal_reference_op_by_op(served, chunk):
    jm, tm, jsp, tsp = served
    work = _workload(jm.cfg.vocab_size)
    ref = JaxEngine(jm, jsp, prefill_fn=jm.prefill_chunk, decode_fn=jm.decode_step,
                    **OP_BY_OP, **_kw(chunk, work))
    want = _streams(ref, work)
    eng = ServeEngine(tm, tsp, device="cpu", **_kw(chunk, work))
    assert _streams(eng, work) == want
    pool = eng.pool
    assert pool.blocks_per_seq == 0 and pool.length_bound is None
    assert not pool.prefix_cache and eng.metrics()["prefix_cache"]["enabled"] is False
    assert pool.cache_bytes() == 0 and "k" not in pool.cache
    assert pool.num_free == pool.num_slots


def test_paged_equals_slot_with_row_reuse(served):
    """Five requests on two rows: every row is reused, and a new occupant
    starts from zero state on both pools."""
    jm, tm, jsp, tsp = served
    work = _workload(jm.cfg.vocab_size, lens=(4, 6, 5, 9, 3), gen=6, seed=11)
    kw = dict(num_slots=2, max_len=24, block_size=4, prefill_chunk=4)
    slot = ServeEngine(tm, tsp, device="cpu", cache="slot", **kw)
    want = _streams(slot, work, arrival_every=0)
    assert slot.pool.length_bound is None
    paged = ServeEngine(tm, tsp, device="cpu", **kw)
    assert _streams(paged, work, arrival_every=0) == want


def test_all_rows_busy_at_once(served):
    """No blocks, so nothing to reserve: admission fills every row."""
    jm, tm, jsp, tsp = served
    eng = ServeEngine(tm, tsp, device="cpu", num_slots=3, max_len=24)
    for p, _ in _workload(jm.cfg.vocab_size, lens=(4, 4, 4, 4)):
        eng.submit(p, max_new_tokens=5)
    peak = 0
    while eng.scheduler.has_work():
        eng.step()
        peak = max(peak, eng.num_running)
    assert peak == 3


def test_kv_bits_refused(served):
    _, tm, _, tsp = served
    with pytest.raises(ValueError, match="O\\(1\\) recurrent state"):
        ServeEngine(tm, tsp, device="cpu", num_slots=2, max_len=24, kv_bits=8)
    with pytest.raises(ValueError, match="O\\(1\\) recurrent state"):
        launcher.main(["--arch", ARCH, "--device", "cpu", "--requests", "1", "--gen", "2",
                       "--kv-bits", "8"])


# --------------------------------------------------------- speculation
def test_spec_streams_fixups_and_snapshot(served):
    jm, tm, jsp, tsp = served
    work = _workload(jm.cfg.vocab_size, lens=(5, 7, 9), gen=9)
    kw = _kw(4, work)
    want = _streams(ServeEngine(tm, tsp, device="cpu", **kw), work, arrival_every=0)
    ref = JaxEngine(jm, jsp, spec=JaxSpec(k=3, draft_bits=2), prefill_fn=jm.prefill_chunk,
                    decode_fn=jm.decode_step, verify_fn=jm.verify_chunk, **OP_BY_OP, **kw)
    assert _streams(ref, work, arrival_every=0) == want
    for sample_device in (True, False):   # the greedy device path and the host path
        eng = ServeEngine(tm, tsp, device="cpu", spec=SpecConfig(k=3, draft_bits=2),
                          sample_device=sample_device, **kw)
        seen = watch_spec_state(eng)
        assert _streams(eng, work, arrival_every=0) == want
        assert eng.metrics()["spec"] == ref.metrics()["spec"]
        fixups = int(eng.obs.get("spec.fixups").value)
        assert fixups > 0 and fixups == sum(len(s["verify"]) == 2 for s in seen)
        for s in seen:
            for got in s["verify"]:
                for key in STATE:
                    assert torch.equal(got[key], s["draft"][key]), key


@pytest.mark.parametrize("broken", [False, True], ids=["intact", "fixup_skipped"])
def test_own_path_replay(served, broken):
    """chip_smoke's 3r check: every spec token is the argmax of a plain
    replay of its windows, and every base token of its decode steps; an
    engine that skips its fix-ups fails it."""
    jm, tm, jsp, tsp = served
    rng = np.random.default_rng(5)
    work = [(rng.integers(0, jm.cfg.vocab_size, n).astype(np.int32), g)
            for n, g in ((5, 12), (11, 9), (8, 14), (6, 10))]
    kw = _kw(4, work)
    if broken:
        with pytest.raises(SystemExit):
            own_path_replay(tm, tsp, work, kw, skip_fixup=True)
        return
    own, dec = own_path_replay(tm, tsp, work, kw)
    n = sum(g for _, g in work)
    assert own.exact == dec.exact == n and not own.ties and not dec.ties
    assert own.partial   # windows that accepted part of their draft, then a fix-up


@pytest.mark.parametrize("spec", [None, 3], ids=["decode", "spec"])
def test_graphed_steps_advance_the_state_once(served, monkeypatch, spec):
    """The captured decode steps (the target's and the spec draft's) with a
    stand-in graph whose warm-up is a real step, as on the card: the
    state leaves are put back after each capture, so the streams are the
    eager engine's."""
    from repro_torch.serve import engine as engine_mod
    from repro_torch.train import serve as tserve

    jm, tm, jsp, tsp = served
    work = _workload(jm.cfg.vocab_size, lens=(5, 7, 9), gen=9)
    kw = _kw(4, work, spec=SpecConfig(k=spec, draft_bits=2) if spec else None)
    want = _streams(ServeEngine(tm, tsp, device="cpu", **kw), work, arrival_every=0)
    monkeypatch.setattr(tserve, "_Graph", ReplayedEagerly)
    steps = []

    def graphed(model, device=None):
        steps.append(tserve.GraphedDecodeStep(model))
        return steps[-1]

    monkeypatch.setattr(engine_mod, "make_decode_step", graphed)
    eng = ServeEngine(tm, tsp, device="cpu", **kw)
    assert _streams(eng, work, arrival_every=0) == want
    assert len(steps) == (2 if spec else 1) and all(s.recaptures == 0 for s in steps)
    assert steps[-1].captures == 1
