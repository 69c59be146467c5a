"""Sliding-window (ring) serving in the port against the JAX package.

- ``chunk_attention`` and ``blocked_attention`` with a window (one that
  is not a multiple of the tile sizes) within 1e-5 of the reference's in
  f32.
- ``TransformerLM.prefill`` of a ring: a prompt longer than the window is
  rolled so that position p sits at slot ``p % Tc``; logits within the
  model's bounds and every cache K/V slot equal to the reference's.
- The paged engine on h2o-danube's smoke config (window 8, head dim 16):
  greedy streams equal the reference engine run op by op, for fp, int8 and
  packed int4 ring blocks, with prompts of 5-20 tokens (some past the
  wrap already in prefill) and prefill chunks of 4 and 16 (a chunk longer
  than the ring).  The pool shrinks its block size to a divisor of the
  ring and turns the prefix cache off, as the reference's does.
- Speculative decoding near the wrap: the ring cap takes rows down to
  k = 0 on the same steps as the reference (equal window and proposal
  counts), and the streams are equal.
- Head dim 120 (h2o-danube's published head dim): the plain paged
  attention versions (fp, int8 rows of 120 bytes, packed int4 rows of 60)
  over ring tables against the reference's oracles, and a narrow model's
  greedy streams through the port's plain path against the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import common as jcommon
from repro.quant.qat import policy_for as jax_policy_for
from repro.serve import ServeEngine as JaxEngine
from repro.spec import SpecConfig as JaxSpec
from repro.train.serve import quantize_for_serving as jax_qfs
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model
from repro_torch.models import common as tcommon
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.spec import SpecConfig
from torch_parity import models, rel_err, to_port

ARCH = "h2o-danube-3-4b"
LOGIT_BOUND = 2e-2          # relative logit bound at bf16 (test_torch_model.py)
OP_BY_OP = dict(sample_device=False, pipeline=False)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------- attention kernels
@pytest.mark.parametrize("window", [3, 5, 8, None])
def test_chunk_attention_window_matches_reference(window):
    rng = np.random.default_rng(0 if window is None else window)
    B, C, T, H, KV, hd = 2, 6, 10, 4, 2, 16
    q = rng.normal(size=(B, C, H, hd)).astype(np.float32)
    kc = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    vc = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    kn = rng.normal(size=(B, C, KV, hd)).astype(np.float32)
    vn = rng.normal(size=(B, C, KV, hd)).astype(np.float32)
    # a ring context of T slots behind starts 13 and 4 (row 1 not full)
    starts = np.array([13, 4], np.int32)
    s_idx = np.arange(T)[None, :]
    p_tok = starts[:, None] - 1 - ((starts[:, None] - 1 - s_idx) % T)
    ctx_pos = np.where(p_tok >= 0, p_tok, -1).astype(np.int32)
    q_pos = (starts[:, None] + np.arange(C)[None, :]).astype(np.int32)
    want = jcommon.chunk_attention(*map(jnp.asarray, (q, kc, vc, ctx_pos, kn, vn, q_pos)),
                                   window=window)
    got = tcommon.chunk_attention(*map(_t, (q, kc, vc, ctx_pos, kn, vn, q_pos)),
                                  window=window)
    assert rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("S,window", [(37, 11), (40, 7), (37, None)])
def test_blocked_attention_window_matches_reference(S, window):
    rng = np.random.default_rng(S)
    B, H, KV, hd = 1, 4, 2, 16
    q, k, v = (rng.normal(size=(B, S, n, hd)).astype(np.float32) for n in (H, KV, KV))
    kw = dict(causal=True, window=window, q_chunk=8, kv_chunk=16)
    want = jcommon.blocked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = tcommon.blocked_attention(*map(_t, (q, k, v)), **kw)
    assert rel_err(got.numpy(), want) <= 1e-5


# ------------------------------------------------------------ ring prefill
@pytest.fixture(scope="module")
def danube():
    jm, tm = models(ARCH)
    jsp = jax_qfs(jm, jm.init(jax.random.PRNGKey(0)), jax_policy_for(jm, 4))
    return jm, tm, jsp, to_port(jsp)


@pytest.mark.parametrize("S,max_len", [(5, 30), (8, 30), (13, 30)],
                         ids=["short", "full", "rolled"])
def test_prefill_ring_roll_matches_reference(danube, S, max_len):
    jm, tm, jsp, tsp = danube
    assert tm.cache_len(max_len) == jm.cache_len(max_len) == 8
    tokens = np.random.default_rng(S).integers(0, jm.cfg.vocab_size, (2, S)).astype(np.int32)
    want_logits, want = jm.prefill(jsp, tokens=jnp.asarray(tokens), max_len=max_len)
    got_logits, got = tm.prefill(tsp, tokens=_t(tokens), max_len=max_len)
    scale = float(np.abs(np.asarray(want_logits)).max())
    assert float(np.abs(got_logits.numpy() - np.asarray(want_logits)).max()) <= LOGIT_BOUND * scale
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(want[key], np.float32), err_msg=key)
    np.testing.assert_array_equal(got["length"].numpy(), np.asarray(want["length"]))


# ------------------------------------------------------------- the engine
def _workload(vocab: int, gen: int = 9, seed: int = 5):
    """Prompts of 5-20 tokens (the ring holds 8), from a numpy seed."""
    rng = np.random.default_rng(seed)
    lens = [5, 20, 14]
    return [(rng.integers(0, vocab, n).astype(np.int32), gen - i) for i, n in enumerate(lens)]


def _kw(chunk: int, work):
    return dict(num_slots=3, max_len=max(len(p) + g for p, g in work) + 1,
                block_size=3, prefill_chunk=chunk)


def _streams(engine, work, arrival_every=2, sampling=None):
    launcher.drive(engine, work, arrival_every, sampling or SamplingParams())
    return [engine.output(r) for r in range(len(work))]


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("kv_bits", [None, 8, 4], ids=["fp", "int8", "int4"])
def test_ring_streams_equal_reference_op_by_op(danube, kv_bits, chunk):
    jm, tm, jsp, tsp = danube
    work = _workload(jm.cfg.vocab_size)
    kw = dict(_kw(chunk, work), kv_bits=kv_bits)
    ref = JaxEngine(jm, jsp, prefill_fn=jm.prefill_chunk, decode_fn=jm.decode_step,
                    **OP_BY_OP, **kw)
    want = _streams(ref, work)
    eng = ServeEngine(tm, tsp, device="cpu", **kw)
    got = _streams(eng, work)
    assert got == want
    assert [len(s) for s in got] == [g for _, g in work]
    # block size 3 does not divide the ring of 8: both pools shrink it to 2
    assert eng.pool.block_size == ref.pool.block_size == 2
    assert eng.pool.blocks_per_seq * eng.pool.block_size == 8
    assert eng.pool.length_bound is None and not eng.pool.prefix_cache
    m = eng.metrics()
    assert m["prefix_cache"]["enabled"] is False and m["recompiles"] == 0


def test_ring_decode_never_takes_the_fused_op(danube, monkeypatch):
    """Packed q/k/v over int4 ring blocks: the unfused quantized attention
    runs, never the fused op (it writes at min(length, Tc - 1))."""
    from repro_torch.kernels import ops

    jm, tm, jsp, tsp = danube

    def refuse(*a, **k):
        raise AssertionError("the fused decode ran on a windowed layer")

    monkeypatch.setattr(ops, "fused_qkv_paged_decode", refuse)
    work = _workload(jm.cfg.vocab_size, gen=6)
    eng = ServeEngine(tm, tsp, device="cpu", kv_bits=4, **_kw(4, work))
    assert all(len(s) == g for s, (_, g) in zip(_streams(eng, work), work))


@pytest.mark.parametrize("k", [2, 4])
def test_spec_ring_cap_matches_reference(danube, k):
    """Greedy spec near the wrap: prompts of 5-7 tokens reach the ring's
    end within a window or two, after which every row runs at k = 0."""
    jm, tm, jsp, tsp = danube
    rng = np.random.default_rng(k)
    work = [(rng.integers(0, jm.cfg.vocab_size, n).astype(np.int32), 8) for n in (5, 7)]
    kw = dict(_kw(4, work), block_size=4)
    ref = JaxEngine(jm, jsp, spec=JaxSpec(k=k, draft_bits=2), prefill_fn=jm.prefill_chunk,
                    decode_fn=jm.decode_step, verify_fn=jm.verify_chunk, **OP_BY_OP, **kw)
    want = _streams(ref, work, arrival_every=0)
    eng = ServeEngine(tm, tsp, device="cpu", spec=SpecConfig(k=k, draft_bits=2), **kw)
    got = _streams(eng, work, arrival_every=0)
    assert got == want
    m, rm = eng.metrics()["spec"], ref.metrics()["spec"]
    assert m == rm
    # the cap bit: fewer tokens proposed than k per window would give
    assert 0 < m["proposed"] < k * m["windows"]


# --------------------------------------------------------- head dim 120
def _ring_case(hd: int, kv_bits, seed: int = 0):
    """A decode call at head dim ``hd`` over ring tables: each row's table
    a shuffled full set of 4 blocks of 4 tokens, lengths {1, 7, 15, 16}
    (min(length + 1, Tc) as the decode step passes them)."""
    from repro.quant import pack as jpack

    rng = np.random.default_rng(seed)
    B, KV, G, bs, nb = 4, 2, 2, 4, 4
    NB = 1 + B * nb
    q = rng.normal(size=(B, 1, KV * G, hd)).astype(np.float32)
    bt = np.stack([1 + rng.permutation(B * nb)[:nb] for _ in range(B)]).astype(np.int32)
    lengths = np.array([1, 7, 15, 16], np.int32)
    k, v = (rng.normal(size=(NB, bs, KV, hd)).astype(np.float32) for _ in range(2))
    if kv_bits is None:
        return q, (k, v), bt, lengths
    qmax = float(2 ** (kv_bits - 1) - 1)
    (kc, ks), (vc, vs) = (jpack.kv_quantize(jnp.asarray(x), qmax) for x in (k, v))
    if kv_bits == 4:
        kc, vc = jpack.kv_pack_int4(kc), jpack.kv_pack_int4(vc)
    return q, tuple(np.asarray(a) for a in (kc, vc, ks, vs)), bt, lengths


@pytest.mark.parametrize("kv_bits", [None, 8, 4], ids=["fp", "int8", "int4"])
def test_plain_paged_attention_head_dim_120_over_ring_tables(kv_bits):
    """The plain versions the CPU serves at head dim 120 (int8 rows of 120
    bytes, packed int4 rows of 60) against the reference's oracles."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    q, pools, bt, lengths = _ring_case(120, kv_bits)
    if kv_bits is None:
        want = jref.paged_attention_ref(*map(jnp.asarray, (q, *pools, bt, lengths)))
        got = tref.paged_attention_ref(*map(_t, (q, *pools, bt, lengths)))
    else:
        want = jref.quant_paged_attention_ref(*map(jnp.asarray, (q, *pools, bt, lengths)))
        got = tref.quant_paged_attention_ref(*map(_t, (q, *pools, bt, lengths)))
    assert got.shape == (4, 1, 4, 120)
    assert rel_err(got.numpy(), want) <= 1e-5


def test_head_dim_120_streams_equal_reference():
    """2 layers, d_model 240, 2 heads over 1 KV head of 120 dims, window
    8: the port's plain path against the reference, past the wrap."""
    over = dict(num_layers=2, d_model=240, num_heads=2, num_kv_heads=1, head_dim=120,
                d_ff=96, vocab_size=251, sliding_window=8)
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **over)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    assert tm.cfg.hd == 120
    jsp = jax_qfs(jm, jm.init(jax.random.PRNGKey(2)), jax_policy_for(jm, 4))
    work = _workload(jm.cfg.vocab_size, gen=8, seed=7)[:2]
    ref = JaxEngine(jm, jsp, prefill_fn=jm.prefill_chunk, decode_fn=jm.decode_step,
                    **OP_BY_OP, **_kw(4, work))
    want = _streams(ref, work)
    assert _streams(ServeEngine(tm, to_port(jsp), device="cpu", **_kw(4, work)), work) == want
