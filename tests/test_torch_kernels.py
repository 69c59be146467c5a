"""repro_torch.kernels: the plain versions against the JAX package's
oracles and Pallas kernels (interpret mode), and the device dispatch of
``kernels.ops`` on CPU tensors.  The CUDA kernels themselves are held
against their plain versions on the card, in ``test_torch_gpu.py``.

Tolerances: qmm is an f32 sum of exact products (bf16-representable x
times codes |c| <= 127) taken in a different order by each version, so
rtol 1e-5 with atol 1e-5 * max|ref| (f32 has ~6e-8 relative rounding;
K <= 136 terms).  Paged attention is an f32 softmax over the same
scores: 1e-5 * max|ref|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets torch's CPU threads)
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.qmm import qmm_pallas
from repro.quant import pack as jpack
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

K, N = 136, 48  # K//8 = 17 and N = 48: neither is a tile multiple


def _qmm_inputs(M, bits, seed=0, k=K, n=N):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    planes, scale = jpack.pack_weight(jnp.asarray(w), bits)
    # bf16-representable activations: the Pallas bodies cast x to bf16
    x = np.asarray(jnp.asarray(rng.standard_normal((M, k)), jnp.bfloat16)
                   .astype(jnp.float32))
    return x, np.asarray(planes), np.asarray(scale)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("M", [1, 4, 64])
def test_qmm_plain_matches_reference_and_pallas(M, bits):
    x, planes, scale = _qmm_inputs(M, bits, seed=M * 10 + bits)
    got = tref.qmm_ref(torch.from_numpy(x), torch.from_numpy(planes),
                       torch.from_numpy(scale), bits).numpy()
    refs = {"jnp": jref.qmm_ref(jnp.asarray(x), planes, scale, bits)}
    for path in ("bitserial", "dequant"):
        refs[path] = qmm_pallas(jnp.asarray(x), jnp.asarray(planes),
                                jnp.asarray(scale), bits=bits, path=path,
                                interpret=True)
    for name, ref in refs.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)


def _paged_inputs(lengths, seed=0, B=4, KV=2, G=2, hd=16, bs=4, nb=5):
    rng = np.random.default_rng(seed)
    NB = B * nb + 3
    q = rng.standard_normal((B, 1, KV * G, hd)).astype(np.float32)
    k_pool = rng.standard_normal((NB, bs, KV, hd)).astype(np.float32)
    v_pool = rng.standard_normal((NB, bs, KV, hd)).astype(np.float32)
    # shuffled physical blocks, block 0 reserved as in the pool
    bt = (rng.permutation(NB - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    return q, k_pool, v_pool, bt, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("lengths", [
    [1, 4, 5, 17],     # ragged, one exactly at a block boundary
    [20, 8, 12, 3],    # full table; boundary lengths
    [0, 7, 16, 1],     # a dead row (compared on live rows only)
])
def test_paged_attention_plain_matches_pallas(lengths):
    q, kp, vp, bt, ln = _paged_inputs(lengths, seed=sum(lengths))
    B, _, H, hd = q.shape
    KV = kp.shape[2]
    got = tref.paged_attention_ref(torch.from_numpy(q), torch.from_numpy(kp),
                                   torch.from_numpy(vp), torch.from_numpy(bt),
                                   torch.from_numpy(ln)).numpy()
    pallas = np.asarray(paged_attention_pallas(
        jnp.asarray(q).reshape(B, KV, H // KV, hd), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bt), jnp.asarray(ln), interpret=True)
    ).reshape(B, 1, H, hd)
    oracle = np.asarray(jref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ln)))
    live = ln > 0
    for name, ref in (("pallas", pallas), ("oracle", oracle)):
        np.testing.assert_allclose(got[live], ref[live], rtol=1e-5,
                                   atol=1e-5 * np.abs(ref[live]).max(),
                                   err_msg=name)
    # the Pallas contract for a dead row is exact zeros
    assert not np.any(pallas[~live])


def test_ops_cpu_tensors_take_the_plain_version():
    ops.reset_counts()
    x, planes, scale = _qmm_inputs(6, 4, seed=3)
    xt = torch.from_numpy(x).reshape(2, 3, K).to(torch.bfloat16)
    y = ops.qmm(xt, torch.from_numpy(planes), torch.from_numpy(scale), bits=4)
    assert y.shape == (2, 3, N) and y.dtype == torch.float32
    ref = tref.qmm_ref(xt.reshape(6, K), torch.from_numpy(planes),
                       torch.from_numpy(scale), 4)
    np.testing.assert_array_equal(y.reshape(6, N).numpy(), ref.numpy())
    q, kp, vp, bt, ln = _paged_inputs([3, 9, 1, 20])
    out = ops.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(vp), torch.from_numpy(bt),
                              torch.from_numpy(ln))
    assert out.shape == q.shape
    assert ops.counts == {"qmm_bitserial": 0, "qmm_dequant": 0,
                          "paged_attention": 0, "paged_attention_quant": 0,
                          "fused_qkv_paged_decode": 0, "fake_quant": 0,
                          "fake_quant_group": 0, "fake_quant_group_bwd": 0,
                          "fake_quant_group_col": 0, "fake_quant_group_col_max": 0,
                          "fake_quant_group_col_qdq": 0, "fake_quant_group_col_bwd": 0, "plain": 2}
    ops.reset_counts()
    assert not any(ops.counts.values())


def test_ops_rejects_inconsistent_shapes():
    x, planes, scale = _qmm_inputs(2, 4)
    with pytest.raises(ValueError):
        ops.qmm(torch.from_numpy(x), torch.from_numpy(planes), torch.from_numpy(scale),
                bits=3)
    with pytest.raises(ValueError):
        ops.qmm(torch.from_numpy(x)[:, :K - 8], torch.from_numpy(planes),
                torch.from_numpy(scale), bits=4)


@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
def test_every_config_head_dim_has_its_kernels(smoke):
    """Every config's head dim, published and smoke, is one the paged
    attention kernels take (both), and one the fused decode takes where
    the arch can reach it (RoPE positions, no window); the ssm family has
    no KV blocks."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.kernels.fused_decode import FUSED_HEAD_DIMS
    from repro_torch.kernels.paged_attention import HEAD_DIMS

    for arch in ARCHS:
        cfg = get_config(arch, smoke=smoke)
        if cfg.family == "ssm":
            continue
        assert cfg.hd in HEAD_DIMS, (arch, cfg.hd)
        if cfg.rope == "rope" and cfg.sliding_window is None:
            assert cfg.hd in FUSED_HEAD_DIMS, (arch, cfg.hd)
