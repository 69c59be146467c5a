"""The port's dense transformer against the JAX reference, with the
reference's own weights carried over by ``repro_torch.convert``.

- ``quantize_for_serving``: packed planes and scales, and the embedding
  QDQ the port computes once, are BITWISE equal to the reference's.
- ``prefill_chunk`` and ``decode_step`` logits over a paged pool (two
  rows, one prompt longer than a chunk), with fp and
  4-bit packed weights.  At ``dtype="float32"`` the two differ only in
  f32 summation order: 1e-4 * max|ref|.  At the config's bfloat16 the
  activations are rounded to bf16 after every linear, norm and attention
  (8 mantissa bits, relative step 2^-8 = 3.9e-3); a dense bf16 matmul
  sums in another order in each framework, which moves a rounding by
  about one step (measured 5.9e-3 on the CPU), so the bound is
  2e-2 * max|ref|, about five steps.  The packed path rounds identically
  in both and agrees bitwise there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant.pack import QDQ as JQDQ
from repro.quant.pack import Packed as JPacked
from repro.quant.qat import policy_for as jax_policy_for
from repro.quant.wrpn import fake_quant as jax_fake_quant
from repro.serve.cache import PagedCachePool as JaxPool
from repro.train.serve import quantize_for_serving as jax_qfs
from repro_torch.quant.pack import QDQ, Packed
from repro_torch.quant.qat import policy_for
from repro_torch.serve.cache import PagedCachePool
from repro_torch.train.serve import quantize_for_serving
from torch_parity import models, rel_err, to_port

import jax

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _jax_params(jm):
    return jm.init(jax.random.PRNGKey(0))


def test_quantize_for_serving_bitwise():
    jm, tm = models()
    jp = _jax_params(jm)
    jsp = jax_qfs(jm, jp, jax_policy_for(jm, default_bits=4))
    tsp = quantize_for_serving(tm, to_port(jp), policy_for(tm, default_bits=4),
                               device="cpu")
    n_packed = 0
    for l, (jl, tl) in enumerate(zip(jsp["blocks"][0], tsp["blocks"][0])):
        for grp in ("attn", "mlp"):
            for name, jw in jl[grp].items():
                tw = tl[grp][name]
                assert isinstance(jw, JPacked) and isinstance(tw, Packed)
                assert tw.bits == jw.bits == 4
                np.testing.assert_array_equal(tw.planes.numpy(), np.asarray(jw.planes))
                np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
                n_packed += 1
    assert n_packed == 7 * jm.cfg.num_layers
    jh, th = jsp["lm_head"], tsp["lm_head"]
    assert th.bits == jh.bits == 8
    np.testing.assert_array_equal(th.planes.numpy(), np.asarray(jh.planes))
    np.testing.assert_array_equal(th.scale.numpy(), np.asarray(jh.scale))
    # the embedding QDQ, computed once by the port, against the reference's
    # per-lookup re-quantization of the whole table
    je, te = jsp["embed"], tsp["embed"]
    assert isinstance(je, JQDQ) and isinstance(te, QDQ) and te.bits == je.bits == 8
    ref = np.asarray(jax_fake_quant(je.w, je.bits, axis=0).astype(jnp.float32))
    np.testing.assert_array_equal(te.value.float().numpy(), ref)
    # and convert.py's QDQ path computes the same once-only value
    np.testing.assert_array_equal(to_port(jsp)["embed"].value.float().numpy(), ref)


def _pools(jm, tm, rows_tokens, max_len=24, block_size=4):
    """A reference and a port pool with identical block tables."""
    jpool = JaxPool(jm, len(rows_tokens), max_len, block_size=block_size,
                    prefix_cache=False)
    tpool = PagedCachePool(tm, len(rows_tokens), max_len, block_size=block_size,
                           device="cpu")
    for n in rows_tokens:
        for pool in (jpool, tpool):
            seq = pool.alloc_seq()
            assert pool.ensure(seq, n)
    np.testing.assert_array_equal(tpool.block_tables.numpy(), jpool.block_tables)
    return jpool, tpool


@pytest.mark.parametrize("packed", [False, True], ids=["fp", "packed4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_reference(dtype, packed):
    jm, tm = models(dtype=dtype)
    jp = _jax_params(jm)
    if packed:
        jp = jax_qfs(jm, jp, jax_policy_for(jm, default_bits=4))
    tp = to_port(jp)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jm.cfg.vocab_size, 7), rng.integers(0, jm.cfg.vocab_size, 3)]
    n_dec = 3
    jpool, tpool = _pools(jm, tm, [len(p) + n_dec for p in prompts])
    C, tol = 4, TOL[dtype]
    for seq, prompt in enumerate(prompts):
        for lo in range(0, len(prompt), C):
            piece = prompt[lo:lo + C]
            buf = np.zeros((1, C), np.int32)
            buf[0, :len(piece)] = piece
            jl, jc = jm.prefill_chunk(jp, jpool.step_cache(), jnp.asarray(buf),
                                      seq, lo, len(piece))
            jpool.accept(jc)
            tl, tc = tm.prefill_chunk(tp, tpool.step_cache(), torch.from_numpy(buf),
                                      seq, lo, len(piece))
            tpool.accept(tc)
            assert rel_err(tl.numpy(), jl) <= tol, (seq, lo)
    np.testing.assert_array_equal(tpool.cache["length"].numpy(),
                                  np.asarray(jpool.cache["length"]))
    toks = np.asarray([[p[-1]] for p in prompts], np.int32)
    for step in range(n_dec):
        jl, jc = jm.decode_step(jp, jpool.step_cache(), jnp.asarray(toks))
        jpool.accept(jc)
        tl, tc = tm.decode_step(tp, tpool.step_cache(), torch.from_numpy(toks))
        tpool.accept(tc)
        assert tl.shape == (2, 1, jm.cfg.vocab_size) and tl.dtype == torch.float32
        assert rel_err(tl.numpy(), jl) <= tol, step
        toks = np.asarray(np.argmax(np.asarray(jl)[:, -1], -1)[:, None], np.int32)
    np.testing.assert_array_equal(tpool.cache["length"].numpy(),
                                  np.asarray(jpool.cache["length"]))


def test_unported_paths_raise():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    for arch in ("hymba-1.5b", "rwkv6-1.6b", "moonshot-v1-16b-a3b", "qwen2-vl-7b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(get_config(arch, smoke=True))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(get_config("h2o-danube-3-4b", smoke=True))  # sliding window
    _, tm = models()
    for fn in (tm.forward, tm.prefill, tm.verify_chunk):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn()


def test_quant_groups_match_reference():
    jm, tm = models()
    jg, tg = jm.quant_groups(), tm.quant_groups()
    assert [(g.name, g.shape, g.n_weights, g.n_macs, g.layer) for g in tg] == \
        [(g.name, g.shape, g.n_weights, g.n_macs, g.layer) for g in jg]
    assert tm.frozen_bits() == jm.frozen_bits()
