"""Launch plans of the split-K qmm dequant body and the split-KV paged
attention, held on the CPU: CTA counts at glm4-9b's shapes, K ranges,
workspace sizes, and a torch model of split-and-combine against the JAX
package's Pallas paged attention (interpret mode).

The model mirrors ``csrc/paged_attention.cu`` and ``csrc/split_kv.cuh``:
each split of ``split_plan(nb)`` pages leaves (m, l, acc) over its live
tokens (an empty split leaves m = -1e30, l = 0, acc = 0), and the combine
takes m = max m_s, l = sum l_s e^{m_s - m}, out = sum acc_s e^{m_s - m} /
max(l, 1e-20).  Tolerance 1e-5 * max|ref| in f32: both sides sum the same
exact products in other orders.
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets torch's CPU threads)
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.kernels.paged_attention import MAX_SPLITS, split_plan, split_workspace_numel
from repro_torch.kernels.qmm import (SMEM_MAX, SMS, TILE_K, dequant_plan,
                                     dequant_smem)

GLM4_QMM = [  # (K, N, bits) of every packed matrix of glm4-9b at the served policy
    (4096, 4096, 4), (4096, 256, 4), (4096, 13696, 4), (13696, 4096, 4),
    (4096, 151552, 8),
]
LM_HEAD = (4096, 151552, 8)
WORKSPACE_MAX = 32 << 20   # bytes of split-K partials a call may allocate, M <= 256


@pytest.mark.parametrize("K,N,bits", GLM4_QMM)
def test_qmm_plan_fills_the_card_at_a_prefill_chunk(K, N, bits):
    plan = dequant_plan(64, K, N, bits)
    assert plan.ctas >= SMS
    assert plan.col_tiles * 64 >= N and plan.token_tiles * plan.token_tile >= 64


@pytest.mark.parametrize("M", [1, 33, 64, 65, 256, 300])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 256), (13696, 4096), (136, 13),
                                 (13696, 300), (8, 5)])
def test_qmm_plan_k_ranges_cover_k_once(M, K, N):
    plan = dequant_plan(M, K, N)
    ranges = plan.k_ranges()
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.chunks * TILE_K
    assert plan.chunks * TILE_K - TILE_K < K <= plan.chunks * TILE_K
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert lo < hi == lo2          # contiguous, none empty
    assert plan.token_tiles * plan.token_tile >= M > (plan.token_tiles - 1) * plan.token_tile


@pytest.mark.parametrize("M", [33, 64, 65, 256])
def test_qmm_plan_workspace_stays_small(M):
    # the lm_head (151552 columns) is never split: no workspace at all
    assert dequant_plan(M, *LM_HEAD).workspace_bytes(M, LM_HEAD[1]) == 0
    for K, N, bits in GLM4_QMM:
        assert dequant_plan(M, K, N, bits).workspace_bytes(M, N) <= WORKSPACE_MAX


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("M", [33, 64, 65, 256, 300])
def test_qmm_plan_fits_shared_memory(M, bits):
    for K, N, _ in GLM4_QMM:
        plan = dequant_plan(M, K, N, bits)
        assert plan.kgroups >= 1
        assert dequant_smem(plan.token_tile, bits, plan.kgroups) <= SMEM_MAX


def test_attention_split_plan_reads_the_table_width_only():
    assert list(inspect.signature(split_plan).parameters) == ["nb"]
    for nb in range(1, 400):
        pps, splits = split_plan(nb)
        assert 1 <= splits <= MAX_SPLITS and pps >= 1
        assert (splits - 1) * pps < nb <= splits * pps   # every page once, no empty tail split
    assert split_plan(6)[1] > 1                           # the served cells' main lengths


def _split_kv_model(q, k_pool, v_pool, bt, lengths):
    """Torch model of the split-KV kernel and its combine, in f32."""
    B, KV, G, hd = q.shape
    bs = k_pool.shape[1]
    nb = bt.shape[1]
    pps, S = split_plan(nb)
    out = torch.zeros((B, KV, G, hd))
    for b in range(B):
        ln = min(max(int(lengths[b]), 0), nb * bs)
        ms, ls, accs = [], [], []
        for s in range(S):
            t0, t1 = s * pps * bs, min(ln, (s + 1) * pps * bs)
            if t0 >= t1:
                ms.append(torch.full((KV, G), -1e30))
                ls.append(torch.zeros((KV, G)))
                accs.append(torch.zeros((KV, G, hd)))
                continue
            pos = torch.arange(t0, t1)
            phys = bt[b, pos // bs].long()
            k = k_pool[phys, pos % bs]                      # (T, KV, hd)
            v = v_pool[phys, pos % bs]
            sc = torch.einsum("kgh,tkh->kgt", q[b], k) * hd ** -0.5
            m = sc.max(dim=-1).values
            p = torch.exp(sc - m[..., None])
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("kgt,tkh->kgh", p, v))
        m = torch.stack(ms).max(dim=0).values
        w = [torch.exp(mi - m) for mi in ms]
        l = sum(li * wi for li, wi in zip(ls, w))
        o = sum(ai * wi[..., None] for ai, wi in zip(accs, w))
        out[b] = o / torch.clamp(l, min=1e-20)[..., None]
    return out


@pytest.mark.parametrize("nb", [19, 64], ids=["table-fits", "wide-table"])
def test_split_kv_model_matches_pallas(nb):
    lengths = [0, 1, 16, 17, 300]
    B, KV, G, hd, bs = len(lengths), 2, 4, 32, 16
    rng = np.random.default_rng(nb)
    NB = B * nb + 1
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    kp = rng.standard_normal((NB, bs, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, KV, hd)).astype(np.float32)
    bt = (rng.permutation(NB - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    got = _split_kv_model(*(torch.from_numpy(a) for a in (q, kp, vp, bt, ln))).numpy()
    ref = np.asarray(paged_attention_pallas(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                            jnp.asarray(bt), jnp.asarray(ln), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert not got[0].any() and not ref[0].any()     # a row of length 0: exact zeros
    pps, splits = split_plan(nb)
    assert split_workspace_numel(B, KV, G, hd, splits) == B * KV * splits * G * (hd + 2)
    assert math.ceil(nb / pps) == splits
