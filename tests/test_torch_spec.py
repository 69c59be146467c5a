"""Speculative decoding in the port (``repro_torch.spec``, the engine's
spec path, ``TransformerLM.verify_chunk``), held against the JAX
package's with the reference's own weights.

- Bitwise: ``repack_weight`` (2-D and an expert bank), ``low_bit_view``
  (planes and scales of every packed leaf; frozen groups shared by
  reference) and ``snap_params_to_grid``.
- The same results on the same inputs: ``spec_window``,
  ``greedy_window`` and ``draft_token``.
- ``verify_chunk`` logits within 1e-4 * max|ref| at f32 (fp weights)
  and 2e-2 * max|ref| at bf16 (4-bit packed; the bounds of
  ``tests/test_torch_model.py``), the pool's K/V within the same bound at
  f32 and bitwise at the packed bf16 path.
- The engine on the launcher's trimmed workload: greedy spec streams
  equal the port's non-spec streams and those of the reference's spec
  engine run op by op, with equal window, proposed and accepted counts,
  on the host path and on the device-greedy path; sampled spec streams
  at temperature 0.8 equal the reference's (the same numpy streams
  resolve both).  Spec composes with prefix sharing, EOS and the budget
  land mid-window as in the reference's ``tests/test_spec.py``, and with
  both decode steps "captured" (a stand-in for the card's graphs) the
  draft and the target keep one capture each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant.pack import Packed as JPacked
from repro.quant.pack import pack_weight as jax_pack_weight
from repro.quant.pack import repack_weight as jax_repack
from repro.quant.qat import policy_for as jax_policy_for
from repro.serve import ServeEngine as JaxEngine
from repro.serve.cache import PagedCachePool as JaxPool
from repro.serve.request import SamplingParams as JaxSamplingParams
from repro.spec import SpecConfig as JaxSpec
from repro.spec import draft as jax_draft
from repro.spec import sampler as jax_sampler
from repro.train.serve import quantize_for_serving as jax_qfs
from repro_torch.launch import serve as launcher
from repro_torch.quant.pack import Packed, pack_weight, repack_weight
from repro_torch.quant.qat import get_by_path, policy_for
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.serve.cache import PagedCachePool
from repro_torch.serve.request import Request
from repro_torch.spec import SpecConfig, low_bit_view, snap_params_to_grid, spec_window
from repro_torch.spec import sampler as tsampler
from repro_torch.train.serve import quantize_for_serving
from test_torch_pipeline import _ReplayedEagerly
from test_torch_serve import _args, _engine_kw
from torch_parity import models, rel_err, to_port

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def reference():
    """The reference model, its training and serving params, and the
    port's copies of both."""
    jm, tm = models()
    jp = jm.init(jax.random.PRNGKey(0))
    jsp = jax_qfs(jm, jp, jax_policy_for(jm, 4))
    return jm, tm, jp, jsp, to_port(jsp)


def _same_packed(t: Packed, j: JPacked):
    assert t.bits == j.bits
    np.testing.assert_array_equal(t.planes.numpy(), np.asarray(j.planes))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))


# ---------------------------------------------------------------- config
def test_spec_config_validation():
    assert SpecConfig(k=2, draft_bits=2).k == 2
    for kw in ({"k": 0, "draft_bits": 2}, {"k": 4}, {"k": 4, "draft_bits": 9},
               {"k": 4, "draft_bits": 1}):
        with pytest.raises(ValueError):
            SpecConfig(**kw)


# --------------------------------------------------------------- repack
@pytest.mark.parametrize("src,dst", [(8, 2), (4, 2), (8, 3), (4, 3), (8, 4), (8, 6), (3, 2)])
def test_repack_weight_bitwise_reference(src, dst):
    w = np.random.default_rng(src * 10 + dst).normal(size=(24, 40)).astype(np.float32)
    jplanes, jscale = jax_pack_weight(jnp.asarray(w), src)
    planes, scale = pack_weight(torch.from_numpy(w), src)
    got = repack_weight(Packed(planes, scale, src), dst)
    _same_packed(got, jax_repack(JPacked(jplanes, jscale, src), dst))
    assert got.planes.shape == (dst, 3, 40)


def test_repack_weight_noop_at_equal_or_wider():
    planes, scale = pack_weight(torch.randn(8, 8), 4)
    p4 = Packed(planes, scale, 4)
    assert repack_weight(p4, 4) is p4 and repack_weight(p4, 8) is p4


def test_repack_weight_expert_bank_bitwise_reference():
    bank = np.random.default_rng(3).normal(size=(3, 16, 8)).astype(np.float32)
    jp = [jax_pack_weight(jnp.asarray(bank[e]), 8) for e in range(3)]
    tp = [pack_weight(torch.from_numpy(bank[e]), 8) for e in range(3)]
    want = jax_repack(JPacked(jnp.stack([p for p, _ in jp]), jnp.stack([s for _, s in jp]), 8), 2)
    got = repack_weight(Packed(torch.stack([p for p, _ in tp]),
                               torch.stack([s for _, s in tp]), 8), 2)
    assert got.planes.shape == (3, 2, 2, 8)
    _same_packed(got, want)


# ------------------------------------------------- low_bit_view, grid snap
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_low_bit_view_bitwise_reference(reference, bits):
    """Every packed leaf of the draft equals the reference's; frozen groups,
    and every group at the target's own 4 bits, are the target's leaves."""
    jm, tm, _, jsp, tsp = reference
    jd, td = jax_draft.low_bit_view(jm, jsp, bits=bits), low_bit_view(tm, tsp, bits)
    frozen = tm.frozen_bits()
    seen = {"packed": 0, "frozen": 0}
    for g in tm.quant_groups():
        if g.path == ("embed",):
            continue
        if g.path == ("lm_head",):
            jl, tl, tt = jd["lm_head"], td["lm_head"], tsp["lm_head"]
        else:
            jl = get_by_path(jd["blocks"][0][g.layer], g.path[2:])
            tl = get_by_path(td["blocks"][0][g.layer], g.path[2:])
            tt = get_by_path(tsp["blocks"][0][g.layer], g.path[2:])
        _same_packed(tl, jl)
        if g.name in frozen:
            assert tl is tt                     # shared by reference
            seen["frozen"] += 1
        else:
            assert tl.bits == min(bits, 4) and tt.bits == 4  # the target is untouched
            assert (tl is tt) == (bits >= 4)
            seen["packed"] += 1
    assert seen["packed"] == 7 * tm.cfg.num_layers and seen["frozen"] == 1


@pytest.mark.parametrize("bits", [2, 3])
def test_snap_params_to_grid_bitwise_reference(reference, bits):
    jm, tm, jp, _, _ = reference
    jsnap = jax_draft.snap_params_to_grid(jm, jp, bits)
    tsnap = snap_params_to_grid(tm, to_port(jp), bits)
    frozen = tm.frozen_bits()
    checked = 0
    for g in tm.quant_groups():
        got = get_by_path(tsnap, g.path).float().numpy()
        want = np.asarray(get_by_path(jsnap, g.path), np.float32)
        np.testing.assert_array_equal(got, want, err_msg=g.name)
        checked += g.name not in frozen
    assert checked > 0
    if bits == 2:
        # the 2-bit levels (0 and +-scale) are exact in the bf16 leaf, so the
        # snapped weights pack losslessly at 2 bits: a 4-bit target and its
        # 2-plane view then dequantize alike (finer levels round in bf16)
        w = get_by_path(tsnap, tm.quant_groups()[1].path)[0].float()
        from repro_torch.quant.pack import dequant_packed

        assert torch.allclose(dequant_packed(*pack_weight(w, 2), 2), w, atol=1e-6)


# ------------------------------------------------------------ the sampler
@pytest.mark.parametrize("sp", [dict(), dict(temperature=0.8, seed=4),
                                dict(temperature=1.3, top_k=5, seed=5),
                                dict(temperature=0.7, top_p=0.8, seed=6),
                                dict(temperature=1.0, top_k=20, top_p=0.95, seed=7),
                                dict(temperature=0.5, top_k=1, seed=8)],
                         ids=["greedy", "t0.8", "top-k", "top-p", "top-k-top-p", "top-1"])
def test_window_resolution_matches_reference(sp):
    """The port's copy of ``repro.spec.sampler`` gives the reference's
    proposals, emitted tokens and acceptance on the same logits and
    streams, for every window length; ``greedy_window`` on the target's
    argmaxes equals ``spec_window`` where every row is greedy."""
    rng = np.random.default_rng(11)
    V = 37
    tp, jsp_ = SamplingParams(**sp), JaxSamplingParams(**sp)
    treq = Request(7, np.arange(3), 20, tp)
    from repro.serve.request import Request as JaxRequest

    jreq = JaxRequest(7, np.arange(3), 20, jsp_)
    for trial in range(12):
        k = trial % 5
        target = (rng.normal(size=(k + 1, V)) * 2).astype(np.float32)
        draft_logits = target[:k] + rng.normal(size=(k, V)).astype(np.float32)
        drafts, jdrafts, qs, jqs = [], [], [], []
        for j in range(k):
            d, q = tsampler.draft_token(draft_logits[j], tp, treq.rng_for(trial + j, 1))
            jd, jq = jax_sampler.draft_token(draft_logits[j], jsp_,
                                             jreq.rng_for(trial + j, 1))
            assert d == jd and (q is None) == (jq is None)
            if q is not None:
                np.testing.assert_array_equal(q, jq)
            drafts.append(d)
            qs.append(q)
        got = spec_window(drafts, target, tp, treq.rng_for, base_pos=trial, q_probs=qs)
        want = jax_sampler.spec_window(drafts, target, jsp_, jreq.rng_for, base_pos=trial,
                                       q_probs=qs)
        assert got == want
        if not sp:
            tops = target.argmax(-1)
            assert tsampler.greedy_window(drafts, tops) == got
            assert jax_sampler.greedy_window(drafts, tops) == got


# ------------------------------------------------------------ verify_chunk
@pytest.mark.parametrize("dtype,packed", [("float32", False), ("bfloat16", True)],
                         ids=["f32-fp", "bf16-packed4"])
def test_verify_chunk_matches_reference(reference, dtype, packed):
    """Two rows with cached prompts of 7 and 3 tokens and a dead third
    lane: the verifier's logits at every position, then the pool."""
    if packed:    # the served model: the config's bf16, 4-bit packed
        jm, tm, _, jp, tp = reference
    else:
        jm, tm = models(dtype=dtype)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = to_port(jp)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jm.cfg.vocab_size, n) for n in (7, 3)]
    C = 4
    jpool = JaxPool(jm, 3, 24, block_size=4, prefix_cache=False)
    tpool = PagedCachePool(tm, 3, 24, block_size=4, device="cpu", prefix_cache=False)
    for pool in (jpool, tpool):
        for prompt in prompts:
            seq = pool.alloc_seq()
            assert pool.ensure(seq, len(prompt) + C)
    for seq, prompt in enumerate(prompts):
        buf = np.zeros((1, 8), np.int32)
        buf[0, :len(prompt)] = prompt
        _, jc = jm.prefill_chunk(jp, jpool.step_cache(), jnp.asarray(buf), seq, 0, len(prompt))
        jpool.accept(jc)
        _, tc = tm.prefill_chunk(tp, tpool.step_cache(), torch.from_numpy(buf), seq, 0,
                                 len(prompt))
        tpool.accept(tc)
    toks = rng.integers(0, jm.cfg.vocab_size, (3, C)).astype(np.int32)
    starts = np.asarray([7, 3, 0], np.int32)
    valids = np.asarray([4, 2, 0], np.int32)        # a short window, a dead lane
    jl, jc = jm.verify_chunk(jp, jpool.step_cache(), jnp.asarray(toks), jnp.asarray(starts),
                             jnp.asarray(valids))
    jpool.accept(jc)
    tl, tc = tm.verify_chunk(tp, tpool.step_cache(), torch.from_numpy(toks),
                             torch.from_numpy(starts), torch.from_numpy(valids))
    tpool.accept(tc)
    assert tl.shape == (3, C, jm.cfg.vocab_size) and tl.dtype == torch.float32
    live = np.asarray([[j < v for j in range(C)] for v in valids])
    assert rel_err(tl.numpy()[live], np.asarray(jl)[live]) <= TOL[dtype]
    np.testing.assert_array_equal(tpool.cache["length"].numpy(), [11, 5, 0])
    np.testing.assert_array_equal(tpool.cache["length"].numpy(),
                                  np.asarray(jpool.cache["length"]))
    for key in ("k", "v"):
        got = tpool.cache[key].float().numpy()
        want = np.asarray(jpool.cache[key], np.float32)
        if packed and dtype == "bfloat16":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            assert rel_err(got, want) <= TOL[dtype], key


# ------------------------------------------------------------ the engine
SPEC = dict(k=4, draft_bits=2)
HOST = dict(sample_device=False, pipeline=False)


def _reference_spec(reference, sampling, args):
    jm, _, _, jsp, _ = reference
    work = launcher.synthetic_workload(args, jm.cfg.vocab_size)
    ref = JaxEngine(jm, jsp, spec=JaxSpec(**SPEC), prefill_fn=jm.prefill_chunk,
                    decode_fn=jm.decode_step, verify_fn=jm.verify_chunk, **HOST,
                    **_engine_kw(args))
    launcher.drive(ref, work, args.arrival_every, JaxSamplingParams(**sampling))
    return work, ref


def _port_run(reference, work, args, sampling, **kw):
    _, tm, _, _, tsp = reference
    eng = ServeEngine(tm, tsp, device="cpu", **kw, **_engine_kw(args))
    launcher.drive(eng, work, args.arrival_every, SamplingParams(**sampling))
    return [eng.output(r) for r in range(len(work))], eng.metrics()


@pytest.fixture(scope="module")
def greedy_reference(reference):
    args = _args()
    return (args, *_reference_spec(reference, {}, args))


@pytest.mark.parametrize("kw", [HOST, {}], ids=["host", "device-greedy"])
def test_greedy_spec_streams_equal_nonspec_and_reference(reference, greedy_reference, kw):
    args, work, ref = greedy_reference
    want = [ref.output(r) for r in range(len(work))]
    got, m = _port_run(reference, work, args, {}, spec=SpecConfig(**SPEC), **kw)
    plain, _ = _port_run(reference, work, args, {})
    assert got == want == plain
    assert m["spec"] == ref.metrics()["spec"] and m["spec"]["windows"] > 0
    assert m["sampler"]["fallbacks"] == 0 and not m["pipeline"]["enabled"]
    assert m["recompiles"] == 0


def test_sampled_spec_streams_equal_reference(reference):
    """Temperature 0.8: the draft proposals, accept/reject uniforms and
    residual draws come from the request's per-position numpy streams,
    and the port's logits equal the op-by-op reference's, so the streams
    and counts are equal draw for draw.  Under device sampling each spec
    step fetches the logits and counts a fallback."""
    sampling = dict(temperature=0.8, seed=21)
    args = _args()
    work, ref = _reference_spec(reference, sampling, args)
    for kw in (HOST, {}):
        got, m = _port_run(reference, work, args, sampling, spec=SpecConfig(**SPEC), **kw)
        assert got == [ref.output(r) for r in range(len(work))]
        assert m["spec"] == ref.metrics()["spec"] and m["spec"]["accepted"] > 0
        assert (m["sampler"]["fallbacks"] > 0) == (kw == {})


@pytest.fixture(scope="module")
def port():
    _, tm = models()
    sp = quantize_for_serving(tm, tm.init(seed=3, device="cpu"), policy_for(tm, 4),
                              device="cpu")
    return tm, sp


def _serve(tm, sp, prompts, gens, eos=None, stagger=1, **kw):
    kw = {"num_slots": 3, "max_len": 32, "block_size": 4, "prefill_chunk": 4, **kw}
    eng = ServeEngine(tm, sp, device="cpu", **kw)
    rids, sub = [], 0
    while sub < len(prompts) or eng.scheduler.has_work():
        while sub < len(prompts) and eng.steps >= sub * stagger:
            rids.append(eng.submit(prompts[sub], gens[sub], eos_id=eos))
            sub += 1
        eng.step()
    return [eng.output(r) for r in rids], eng


def test_spec_with_prefix_sharing(port):
    """Drafts write through block tables holding trie-mapped blocks;
    ``reserve_for_spec`` copies whatever is still shared under the
    window, and greedy spec output equals plain decode."""
    tm, sp = port
    P = np.random.default_rng(7).integers(0, tm.cfg.vocab_size, 9)
    want, _ = _serve(tm, sp, [P, P, P], [6, 6, 6])
    got, eng = _serve(tm, sp, [P, P, P], [6, 6, 6], spec=SpecConfig(k=3, draft_bits=2))
    assert got == want
    assert eng.pool.prefix_hit_tokens > 0 and eng.metrics()["spec"]["windows"] > 0


def test_spec_eos_and_budget_mid_window(port):
    """EOS inside a window truncates the stream where plain decode does;
    the tokens after it are dropped, the row retires, the pool drains."""
    tm, sp = port
    prompt = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, 4)
    stream, _ = _serve(tm, sp, [prompt], [10], num_slots=1, max_len=24)
    stream = stream[0]
    eos = stream[2]
    cut = stream.index(eos) + 1
    for spec_k in (4, 2):
        got, eng = _serve(tm, sp, [prompt], [10], eos=eos, num_slots=1, max_len=24,
                          spec=SpecConfig(k=spec_k, draft_bits=2))
        assert got[0] == stream[:cut]
        assert eng.pool.num_free == eng.pool.num_slots
        assert eng.pool.num_free_blocks == eng.pool.num_blocks - 1
    got, _ = _serve(tm, sp, [prompt], [7], num_slots=1, max_len=24,
                    spec=SpecConfig(k=4, draft_bits=2))
    assert got[0] == stream[:7]               # the budget mid-window


def test_spec_graphed_draft_and_target_keep_one_capture(port, monkeypatch):
    """Both decode steps as "captured" stand-ins that overwrite their
    outputs at every replay: the draft and the target each capture once,
    nothing is captured again (the masked draft tables go through a
    buffer of their own), and the streams equal the eager run's, with
    windows of every length (the budgets end inside windows)."""
    from repro_torch.serve import engine as engine_mod
    from repro_torch.train import serve as tserve

    tm, sp = port
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n) for n in (5, 9, 3, 7)]
    gens = [9, 6, 11, 4]
    want, _ = _serve(tm, sp, prompts, gens, stagger=2, spec=SpecConfig(k=3, draft_bits=2))
    monkeypatch.setattr(tserve, "_Graph", _ReplayedEagerly)
    monkeypatch.setattr(engine_mod, "make_decode_step",
                        lambda model, device=None: tserve.GraphedDecodeStep(model))
    got, eng = _serve(tm, sp, prompts, gens, stagger=2, spec=SpecConfig(k=3, draft_bits=2))
    assert got == want
    caps = eng.graph_captures
    assert caps["decode"] == 1 and caps["draft"] == 1
    assert eng._decode.recaptures == eng._draft_decode.recaptures == 0
    assert eng.metrics()["recompiles"] == 0
