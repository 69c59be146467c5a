"""Quantized-KV serving in the port against the JAX package.

- ``repro_torch.quant.pack``'s ``kv_*`` helpers are bitwise the
  reference's, all-zero rows included.
- ``kernels.ref.quant_paged_attention_ref`` against the reference oracle
  and ``paged_attention_quant_pallas`` in interpret mode: live rows within
  1e-5 * max (an f32 softmax over the same dequantized scores, summed in
  another order); the Pallas kernel's dead rows are exact zeros.
- ``kernels.ref.fused_qkv_paged_decode_ref`` against the reference's
  composed oracle and ``fused_qkv_paged_decode_pallas`` in interpret mode:
  codes and scales bitwise, output equal at bf16 (the reference's own
  contract, ``tests/test_kernels.py``).
- ``PagedCachePool(kv_bits=...)`` leaves match the reference's layout.
- Greedy streams of the port's engine equal the reference engine run op
  by op for int8, packed int4, a mixed per-layer grid and dense q/k/v;
  the quantized pool equals the port's own kv-oracle pool exactly; a
  preempted int4 run replays to the same tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_decode import fused_qkv_paged_decode_pallas
from repro.kernels.paged_attention import paged_attention_quant_pallas
from repro.models.common import rope_freqs as jax_rope_freqs
from repro.quant import pack as jpack
from repro.quant.qat import policy_for as jax_policy_for
from repro.serve import ServeEngine as JaxEngine
from repro.serve.cache import PagedCachePool as JaxPool
from repro.train.serve import quantize_for_serving as jax_qfs
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as launcher
from repro_torch.quant import pack as tpack
from repro_torch.quant.qat import policy_for
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.serve.cache import PagedCachePool
from repro_torch.train.serve import quantize_for_serving
from torch_parity import models, to_port


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- kv helpers
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_kv_helpers_bitwise_equal_reference(bits):
    qmax = float(2 ** (bits - 1) - 1)
    x = np.random.default_rng(bits).normal(size=(5, 3, 16)).astype(np.float32)
    x[1, 2] = 0.0                      # an all-zero (token, head) row
    x[4] = 0.0
    codes, scale = tpack.kv_quantize(_t(x), qmax)
    jcodes, jscale = jpack.kv_quantize(jnp.asarray(x), qmax)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert not scale[4].any() and not codes[1, 2].any()
    np.testing.assert_array_equal(tpack.kv_dequantize(codes, scale).numpy(),
                                  np.asarray(jpack.kv_dequantize(jcodes, jscale)))
    np.testing.assert_array_equal(tpack.kv_qdq(_t(x), qmax).numpy(),
                                  np.asarray(jpack.kv_qdq(jnp.asarray(x), qmax)))
    # a 0-d tensor ceiling (the pool's kv_qmax[layer]) gives the same codes
    c2, s2 = tpack.kv_quantize(_t(x), torch.tensor(qmax))
    assert torch.equal(c2, codes) and torch.equal(s2, scale)
    if bits == 4:
        packed = tpack.kv_pack_int4(codes)
        jpacked = jpack.kv_pack_int4(jcodes)
        assert packed.dtype == torch.uint8 and packed.shape == (5, 3, 8)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
        np.testing.assert_array_equal(tpack.kv_unpack_int4(packed).numpy(),
                                      np.asarray(jpack.kv_unpack_int4(jpacked)))
        assert torch.equal(tpack.kv_unpack_int4(packed), codes)


def test_kv_pack_int4_every_code_and_odd_head_dim():
    codes = torch.arange(-7, 8, dtype=torch.int8).repeat(2)[:30].reshape(3, 10)
    packed = tpack.kv_pack_int4(codes)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpack.kv_pack_int4(jnp.asarray(codes.numpy()))))
    assert torch.equal(tpack.kv_unpack_int4(packed), codes)
    with pytest.raises(ValueError):
        tpack.kv_pack_int4(codes[:, :9])


# ------------------------------------------------- plain quantized attention
def _quant_pools(NB, bs, KV, hd, kv_bits, seed=11):
    """Random fp pool -> (codes, scales) in the requested block container,
    quantized by the reference (numpy out)."""
    rng = np.random.default_rng(seed)
    qmax = float(2 ** (kv_bits - 1) - 1)
    kc, ks = jpack.kv_quantize(jnp.asarray(rng.normal(size=(NB, bs, KV, hd)), jnp.float32), qmax)
    vc, vs = jpack.kv_quantize(jnp.asarray(rng.normal(size=(NB, bs, KV, hd)), jnp.float32), qmax)
    if kv_bits == 4:
        kc, vc = jpack.kv_pack_int4(kc), jpack.kv_pack_int4(vc)
    return [np.asarray(a) for a in (kc, vc, ks, vs)], qmax


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("case", ["block_boundary", "length_zero", "one_block"])
def test_quant_paged_attention_plain_matches_reference(kv_bits, case):
    B, bs, KV, G, hd = 3, 4, 2, 2, 8
    nb = 1 if case == "one_block" else 3
    NB = 1 + B * nb
    rng = np.random.default_rng(kv_bits + len(case))
    q = rng.normal(size=(B, 1, KV * G, hd)).astype(np.float32)
    (kc, vc, ks, vs), _ = _quant_pools(NB, bs, KV, hd, kv_bits)
    bt = (1 + np.arange(B * nb).reshape(B, nb)).astype(np.int32)
    lengths = {"block_boundary": [bs, 2 * bs, nb * bs], "length_zero": [0, 0, bs + 1],
               "one_block": [1, bs // 2, bs]}[case]
    if case == "length_zero":
        bt[:2] = 0                      # dead rows sit on the garbage sink
    ln = np.asarray(lengths, np.int32)
    got = tref.quant_paged_attention_ref(*map(_t, (q, kc, vc, ks, vs, bt, ln))).numpy()
    oracle = np.asarray(jref.quant_paged_attention_ref(*map(jnp.asarray, (q, kc, vc, ks, vs, bt, ln))))
    pallas = np.asarray(paged_attention_quant_pallas(
        jnp.asarray(q).reshape(B, KV, G, hd), *map(jnp.asarray, (kc, vc, ks, vs, bt, ln)),
        interpret=True)).reshape(B, 1, KV * G, hd)
    live = ln > 0
    for name, ref in (("oracle", oracle), ("pallas", pallas)):
        np.testing.assert_allclose(got[live], ref[live], rtol=1e-5,
                                   atol=1e-5 * np.abs(ref[live]).max(), err_msg=name)
    # the oracle's dead rows (uniform average) are matched too; Pallas gives zeros
    np.testing.assert_allclose(got[~live], oracle[~live], rtol=1e-5, atol=1e-6)
    assert not pallas[~live].any()


# ---------------------------------------------------------- plain fused decode
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("lengths_case", ["mid", "boundary", "zero"])
def test_fused_decode_plain_matches_reference(kv_bits, lengths_case):
    B, nb, bs, KV, G, hd, D = 3, 3, 4, 2, 2, 8, 32
    H, NB, Tc = KV * G, 1 + B * nb, nb * bs
    rng = np.random.default_rng(kv_bits * 7 + len(lengths_case))
    (kc, vc, ks, vs), qmax = _quant_pools(NB, bs, KV, hd, kv_bits)
    bt = (1 + np.arange(B * nb).reshape(B, nb)).astype(np.int32)
    ln = np.asarray({"mid": [1, 5, Tc - 1], "boundary": [bs - 1, bs, 2 * bs - 1],
                     "zero": [0, 0, 3]}[lengths_case], np.int32)
    x = jnp.asarray(rng.normal(size=(B, D)), jnp.bfloat16)
    jw, tw = [], []
    for n_out, bits in ((H * hd, 4), (KV * hd, 3), (KV * hd, 8)):
        planes, scale = jpack.pack_weight(jnp.asarray(rng.normal(size=(D, n_out)), jnp.float32), bits)
        jw.append(jpack.Packed(planes, scale, bits))
        tw.append(tpack.Packed(_t(planes), _t(scale), bits))
    jargs = [jnp.asarray(a) for a in (kc, vc, ks, vs, bt, ln)]
    targs = [_t(a) for a in (kc, vc, ks, vs, bt, ln)]
    ro, rkc, rvc, rks, rvs = jref.fused_qkv_paged_decode_ref(
        x, *jw, *jargs, jnp.float32(qmax), 1e4, H, KV)
    ang = jnp.asarray(ln, jnp.float32)[:, None] * jax_rope_freqs(hd, 1e4)
    po, pkc, pvc, pks, pvs = fused_qkv_paged_decode_pallas(
        x, *(a for w in jw for a in (w.planes, w.scale)), *jargs, jnp.cos(ang),
        jnp.sin(ang), jnp.float32(qmax), bits_q=4, bits_k=3, bits_v=8, num_heads=H,
        interpret=True)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    ops.reset_counts()
    out, tkc, tvc, tks, tvs = ops.fused_qkv_paged_decode(
        xt, *tw, *targs, torch.tensor(qmax), rope_theta=1e4, num_heads=H, num_kv_heads=KV)
    assert ops.counts["plain"] == 1 and out.shape == (B, 1, H, hd) and out.dtype == torch.bfloat16
    assert tkc.dtype == (torch.uint8 if kv_bits == 4 else torch.int8)
    for name, (rc, rv, rs, rvs_) in (("ref", (rkc, rvc, rks, rvs)), ("pallas", (pkc, pvc, pks, pvs))):
        for got, want in ((tkc, rc), (tvc, rv), (tks, rs), (tvs, rvs_)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    got = out.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(ro.astype(jnp.float32)))
    np.testing.assert_array_equal(
        got, np.asarray(po.reshape(B, 1, H, hd).astype(jnp.bfloat16), np.float32))


def test_ops_quantized_dispatch_on_cpu_counts_plain():
    B, bs, KV, G, hd, nb = 2, 4, 2, 2, 8, 2
    (kc, vc, ks, vs), _ = _quant_pools(1 + B * nb, bs, KV, hd, 8)
    q = torch.randn(B, 1, KV * G, hd).to(torch.bfloat16)
    bt = torch.arange(1, 1 + B * nb, dtype=torch.int32).reshape(B, nb)
    ln = torch.tensor([3, 8], dtype=torch.int32)
    ops.reset_counts()
    out = ops.paged_attention(q, *map(_t, (kc, vc)), bt, ln, *map(_t, (ks, vs)))
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    # an f32 (oracle) pool with a bf16 q attends in f32
    fp = tpack.kv_dequantize(_t(kc), _t(ks))
    out2 = ops.paged_attention(q, fp, tpack.kv_dequantize(_t(vc), _t(vs)), bt, ln)
    assert torch.equal(out, out2)
    assert ops.counts == {"qmm_bitserial": 0, "qmm_dequant": 0, "paged_attention": 0,
                          "paged_attention_quant": 0, "fused_qkv_paged_decode": 0,
                          "fake_quant": 0, "fake_quant_group": 0,
                          "fake_quant_group_bwd": 0, "plain": 2}


# ----------------------------------------------------------------- pool layout
@pytest.mark.parametrize("kv", [{"kv_bits": 8}, {"kv_bits": 4}, {"kv_bits": [8, 4]},
                                {"kv_bits": 4, "kv_oracle": True}],
                         ids=["int8", "int4", "mixed", "oracle"])
def test_pool_layout_matches_reference(kv):
    jm, tm = models()
    jp = JaxPool(jm, 2, 32, block_size=8, prefix_cache=False, **kv)
    tp = PagedCachePool(tm, 2, 32, block_size=8, device="cpu", **kv)
    assert sorted(tp.cache) == sorted(jp.cache)
    assert tp.paged_keys == jp.paged_keys
    for key, leaf in jp.cache.items():
        assert tuple(tp.cache[key].shape) == leaf.shape, key
        assert str(tp.cache[key].dtype).split(".")[-1] == str(leaf.dtype), key
    np.testing.assert_array_equal(tp.cache["kv_qmax"].numpy(), np.asarray(jp.cache["kv_qmax"]))
    assert tp.kv_bits == jp.kv_bits and tp.kv_oracle == jp.kv_oracle
    fp_t = PagedCachePool(tm, 2, 32, block_size=8, device="cpu")
    fp_j = JaxPool(jm, 2, 32, block_size=8, prefix_cache=False)
    assert tp.cache_bytes() / fp_t.cache_bytes() == jp.cache_bytes() / fp_j.cache_bytes()


def test_pool_kv_validation():
    _, tm = models()
    with pytest.raises(ValueError, match="kv_oracle requires"):
        PagedCachePool(tm, 2, 32, kv_oracle=True, device="cpu")
    with pytest.raises(ValueError, match="2..8"):
        PagedCachePool(tm, 2, 32, kv_bits=9, device="cpu")
    with pytest.raises(ValueError, match="entries for"):
        PagedCachePool(tm, 2, 32, kv_bits=[8, 8, 8], device="cpu")


def test_kv_quant_groups_match_reference():
    jm, tm = models()
    for seq_len in (128, 4096):
        assert [dataclasses.astuple(g) for g in tm.kv_quant_groups(seq_len)] == \
            [dataclasses.astuple(g) for g in jm.kv_quant_groups(seq_len)]


# ------------------------------------------------------------ engine streams
def _args(**over):
    return launcher.parse_args(["--device", "cpu", "--requests", "4", "--gen", "8",
                                *sum(([f"--{k.replace('_', '-')}", str(v)]
                                      for k, v in over.items()), [])])


def _engine_kw(args):
    return dict(num_slots=args.num_slots, max_len=args.prompt_len + args.gen + 1,
                block_size=args.block_size, num_blocks=args.num_blocks,
                prefill_chunk=args.prefill_chunk)


def _ref_margin(jm, jsp, prompt, emitted, kv_bits):
    """The reference's top-2 logit margin after ``prompt + emitted``."""
    replay = np.concatenate([prompt, np.asarray(emitted, np.int64)]).astype(np.int32)
    pool = JaxPool(jm, 1, len(replay) + 1, block_size=16, prefix_cache=False,
                   kv_bits=kv_bits)
    seq = pool.alloc_seq()
    pool.ensure(seq, len(replay) + 1)
    logits, _ = jm.prefill_chunk(jsp, pool.step_cache(), jnp.asarray(replay[None]),
                                 seq, 0, len(replay))
    top = np.sort(np.asarray(logits[0, 0]))[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("bits,kv_bits", [(4, 8), (4, 4), (4, [8, 3]), (16, 8)],
                         ids=["int8", "int4", "mixed", "dense-qkv-int8"])
def test_greedy_streams_equal_reference_op_by_op(bits, kv_bits):
    """Packed q/k/v take the fused op, dense ones (16 bits) the unfused
    quantized attention; both match the reference run op by op."""
    jm, tm = models()
    jsp = jax_qfs(jm, jm.init(jax.random.PRNGKey(0)), jax_policy_for(jm, bits))
    args = _args()
    work = launcher.synthetic_workload(args, jm.cfg.vocab_size)
    ref = JaxEngine(jm, jsp, prefix_cache=False, sample_device=False, pipeline=False,
                    prefill_fn=jm.prefill_chunk, decode_fn=jm.decode_step,
                    kv_bits=kv_bits, **_engine_kw(args))
    launcher.drive(ref, work, args.arrival_every, SamplingParams())
    eng = ServeEngine(tm, to_port(jsp), device="cpu", kv_bits=kv_bits, **_engine_kw(args))
    launcher.drive(eng, work, args.arrival_every, SamplingParams())
    for rid in ref.requests:
        want, got = ref.output(rid), eng.output(rid)
        assert len(got) == len(want) == work[rid][1]
        if got != want:
            i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            margin = _ref_margin(jm, jsp, work[rid][0], want[:i], kv_bits)
            pytest.fail(f"request {rid} diverged at token {i}: {got} != {want} "
                        f"(reference top-2 margin there {margin:.4g})")
    m, rm = eng.metrics(), ref.metrics()
    assert m["kv_bits"] == rm["kv_bits"] and m["kv_oracle"] is False


def _port_engine_outputs(sp, tm, args, work, **kw):
    eng = ServeEngine(tm, sp, device="cpu", **{**_engine_kw(args), **kw})
    launcher.drive(eng, work, args.arrival_every, SamplingParams())
    return [eng.output(r) for r in range(len(work))], eng.metrics()


@pytest.mark.parametrize("kv_bits", [8, 4, [6, 3]], ids=["int8", "int4", "mixed"])
def test_quantized_pool_equals_oracle_exactly(kv_bits):
    _, tm = models()
    sp = quantize_for_serving(tm, tm.init(seed=2, device="cpu"), policy_for(tm, 4),
                              device="cpu")
    args = _args(gen=12)
    work = launcher.synthetic_workload(args, tm.cfg.vocab_size)
    quant, mq = _port_engine_outputs(sp, tm, args, work, kv_bits=kv_bits)
    oracle, mo = _port_engine_outputs(sp, tm, args, work, kv_bits=kv_bits, kv_oracle=True)
    assert quant == oracle
    assert mo["kv_oracle"] is True and mq["kv_bits"] == mo["kv_bits"]


def test_int4_preemption_replays_to_the_same_tokens():
    _, tm = models()
    sp = quantize_for_serving(tm, tm.init(seed=3, device="cpu"), policy_for(tm, 4),
                              device="cpu")
    args = _args(gen=16, prompt_len=8, block_size=4, arrival_every=0)
    work = launcher.synthetic_workload(args, tm.cfg.vocab_size)
    outs = {}
    for num_blocks in (None, 9):   # 8 usable blocks: 4 rows need up to 24
        outs[num_blocks] = _port_engine_outputs(sp, tm, args, work, kv_bits=4,
                                                num_blocks=num_blocks)
    assert outs[None][1]["preemptions"] == 0 and outs[9][1]["preemptions"] > 0
    assert outs[9][0] == outs[None][0]


def test_launcher_passes_kv_flags():
    args = launcher.parse_args(["--device", "cpu", "--requests", "2", "--gen", "3",
                                "--kv-bits", "4", "--kv-oracle"])
    _, tm = models()
    sp = quantize_for_serving(tm, tm.init(seed=0, device="cpu"), policy_for(tm, 4),
                              device="cpu")
    eng = launcher.continuous(args, tm.cfg, tm, sp, policy_for(tm, 4))
    assert eng.pool.kv_bits == [4, 4] and eng.pool.kv_oracle
    assert eng.pool.cache["k"].dtype == torch.float32
