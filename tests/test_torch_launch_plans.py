"""Launch plans of the split-K qmm bodies (bit-serial and dequant), the
split-KV paged attention (fp and quantized) and the fused decode's two
launches, held on the CPU: CTA counts at glm4-9b's shapes, K ranges,
workspace and shared-memory sizes, and torch models of split-and-combine
against the JAX package's Pallas kernels (interpret mode).

The bit-serial model mirrors ``csrc/bitserial.cuh``: each split of
``bitserial_plan`` (whole 128-row K steps) leaves the dequant-form partial
sum x * (u - n) over its K range, and split 0 of the tile's cluster sums
the partials in split order and applies ``/ n * scale`` once.

The models mirror ``csrc/paged_attention.cu``, ``csrc/kv_attention.cuh``
and ``csrc/split_kv.cuh``: each split of ``split_plan(nb)`` pages leaves
(m, l, acc) over its live tokens (an empty split leaves m = -1e30, l = 0,
acc = 0), the quantized sweep folding 32-token tiles of dequantized codes
in turn; the combine takes m = max m_s, l = sum l_s e^{m_s - m}, out =
sum acc_s e^{m_s - m} / max(l, 1e-20).  The fused decode's model sums
its projection's split-K partials (sum x*(u - n) over each split's
128-row steps) in split order and finishes them once, and appends the new
token's partial (m = its score, l = 1, acc = its dequantized v) after
``attend_plan(nb)``'s page splits.  Tolerance 1e-5 * max|ref| in f32:
both sides sum the same exact products in other orders.
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets torch's CPU threads)
from repro.kernels.fused_decode import fused_qkv_paged_decode_pallas
from repro.kernels.paged_attention import paged_attention_pallas, paged_attention_quant_pallas
from repro.kernels.qmm import qmm_pallas
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_decode import (CHUNK, COLS, PROJECT_CTAS, attend_plan,
                                              project_plan)
from repro_torch.kernels.paged_attention import MAX_SPLITS, split_plan, split_workspace_numel
from repro_torch.models.common import rope_cos_sin, rope_rotate
from repro_torch.quant import wrpn as twrpn
from repro_torch.quant.pack import (Packed, kv_dequantize, kv_pack_int4, kv_quantize,
                                    pack_weight, unpack_bitplanes)
from repro_torch.kernels.qmm import (BS_MAX_SPLITS, BS_MIN_STEPS, BS_ROWS, BS_STEP, SM_SMEM,
                                     SMEM_MAX, SMS, TILE_K, bitserial_plan, bitserial_smem,
                                     bitserial_splits, dequant_plan, dequant_smem)

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


# ---- the bit-serial body (csrc/bitserial.cuh): decode rows, M <= 32
DECODE_M = [1, 4, 16, 32]


@pytest.mark.parametrize("M", DECODE_M)
@pytest.mark.parametrize("K,N,bits", GLM4_QMM)
def test_bitserial_plan_fills_the_card_at_decode(K, N, bits, M):
    plan = bitserial_plan(M, K, N, bits)
    assert plan.ctas >= SMS
    assert plan.row_tiles == 1                 # every row in one CTA: planes read once
    assert plan.col_tiles * 16 * plan.warps >= N > (plan.col_tiles - 1) * 16 * plan.warps
    assert plan.splits == 1 or plan.ctas <= 2 * 3 * SMS   # no more split than the rule asks


@pytest.mark.parametrize("M", [1, 5, 8, 9, 20, 32, 33, 70])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 256), (13696, 4096), (136, 13),
                                 (13696, 300), (8, 5), (1000, 96)])
def test_bitserial_plan_k_ranges_cover_k_once(M, K, N):
    plan = bitserial_plan(M, K, N)
    ranges = plan.k_ranges(K)
    assert len(ranges) == plan.splits >= 1
    covered = [k for lo, hi in ranges for k in range(lo, hi)]
    assert covered == list(range(K))                     # every row once, in order
    for lo, hi in ranges:
        assert lo % BS_STEP == 0 and hi > lo            # whole steps, none empty
    if plan.splits > 1:                                  # a split keeps its steps
        assert plan.steps // plan.splits >= BS_MIN_STEPS and plan.splits <= BS_MAX_SPLITS
    assert plan.row_tiles * 32 >= M > (plan.row_tiles - 1) * 32
    assert plan.warps in (1, 2, 4, 8)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("M", DECODE_M)
def test_bitserial_plan_workspace_and_shared_memory_fit(M, bits):
    """qmm's splits of a tile are one cluster (at most 16 CTAs, H100's
    non-portable size) whose combine scratch -- each thread's accumulators,
    4 floats per n8 tile -- reuses the CTA's ring: no workspace in device
    memory."""
    for K, N, _ in GLM4_QMM:
        plan = bitserial_plan(M, K, N, bits)
        assert 1 <= plan.splits <= BS_MAX_SPLITS == 16
        smem = bitserial_smem(M, bits, plan.warps)
        assert smem <= SMEM_MAX
        assert 32 * plan.warps * -(-M // 8) * 4 * 4 <= smem
    # three CTAs per SM fit their shared memory at every decode width
    assert 3 * bitserial_smem(M, bits) <= 228 * 1024


# ---- f32 x (RWKV's token-shift mixes): both bodies on the tensor cores,
# x split into three bf16 terms (kernels/ref.py::split_bf16x3)
RWKV_F32 = [(2048, 2048), (2048, 7168)]   # (K, N) of rwkv6-1.6b's f32 projections


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [1, 4, 20, 64, 256])
@pytest.mark.parametrize("K,N", RWKV_F32)
def test_f32_plans_fit_shared_memory_and_fill_the_card(K, N, M, bits):
    """At RWKV's shapes, every row count its served path gives the f32
    projections (decode 1-4, the spec verify 20, prefill chunks): the
    bit-serial plan (M <= 32) and the dequant plan keep at least one CTA
    per SM within a CTA's shared memory."""
    if M <= BS_ROWS:
        bplan = bitserial_plan(M, K, N, bits)
        assert bplan.ctas >= SMS
        smem = bitserial_smem(M, bits, bplan.warps, f32=True)
        assert smem <= SMEM_MAX
        if M <= 8 and bits <= 4:    # decode's grid fits the card at once
            assert bplan.ctas <= SMS * (SM_SMEM // (smem + 1024))
    dplan = dequant_plan(M, K, N, bits, f32=True)
    assert dplan.token_tile == 64 and dplan.kgroups in (1, 2)
    assert dequant_smem(64, bits, dplan.kgroups, f32=True) <= SMEM_MAX
    assert dplan.ctas >= SMS
    ranges = dplan.k_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == dplan.chunks * TILE_K
    assert all(lo < hi for lo, hi in ranges)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
def test_f32_rings_fit_at_every_row_count(bits):
    """The bit-serial f32 slot (the raw rows and their three bf16 term
    tiles) at every row count a CTA takes, at the 4 warps of qmm's plan and
    of the fused projection, and the dequant f32 ring at one and two
    warpgroups; two bit-serial CTAs share an SM at decode's M = 4."""
    for M in range(1, BS_ROWS + 1):
        assert bitserial_smem(M, bits, 4, f32=True) <= SMEM_MAX
    assert 2 * bitserial_smem(4, bits, f32=True) <= SM_SMEM - 2 * 1024
    for kg in (1, 2):
        assert dequant_smem(64, bits, kg, f32=True) <= SMEM_MAX


@pytest.mark.parametrize("M,K,N,bits", [(1, 2048, 64, 4), (4, 1000, 96, 2),
                                        (20, 2048, 32, 8), (40, 512, 16, 4)])
def test_f32_bitserial_model_matches_plain(M, K, N, bits):
    """The f32 body's sum as a torch model: per split of the plan, each
    bf16 term's partial over the split's K range, the terms and then the
    splits added in order, finished once; against qmm_ref in f32."""
    rng = np.random.default_rng(M + K + bits)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)) * K ** -0.5
    planes, scale = pack_weight(w, bits)
    plan = bitserial_plan(M, K, N, bits)
    codes = unpack_bitplanes(planes, bits).float()
    terms = [t.float() for t in tref.split_bf16x3(x)]
    s = None
    for lo, hi in plan.k_ranges(K):
        part = terms[0][:, lo:hi] @ codes[lo:hi]
        for t in terms[1:]:
            part = part + t[:, lo:hi] @ codes[lo:hi]
        s = part if s is None else s + part
    got = s / float(2 ** (bits - 1) - 1) * scale
    plain = tref.qmm_ref(x, planes, scale, bits)
    assert (got - plain).abs().max().item() <= 1e-5 * plain.abs().max().item()


@pytest.mark.parametrize("B", [1, 4, 32, 40])
@pytest.mark.parametrize("D,widths", [(4096, (4096, 256, 256)), (1536, (64, 32, 32)),
                                      (13696, (300, 8, 8))])
def test_project_plan_agrees_with_bitserial_plan(B, D, widths):
    plan = project_plan(B, D, widths)
    assert CHUNK == BS_STEP and COLS == 64                 # the body's own constants
    assert plan.splits == bitserial_splits(plan.col_tiles * plan.row_tiles, plan.chunks)
    one = project_plan(B, D, widths[:1])
    qplan = bitserial_plan(B, D, widths[0], warps=4)
    assert (one.col_tiles, one.row_tiles, one.chunks, one.splits) == (
        qplan.col_tiles, qplan.row_tiles, qplan.steps, qplan.splits)
    assert one.k_ranges(D) == qplan.k_ranges(D)


def _bitserial_model(x, planes, scale, bits, plan, K):
    """Torch model of the bit-serial body: dequant-form partials per split,
    summed in split order, finished once."""
    n = float(2 ** (bits - 1) - 1)
    codes = unpack_bitplanes(planes, bits).float()          # u - n
    parts = [x[:, lo:hi] @ codes[lo:hi] for lo, hi in plan.k_ranges(K)]
    s = parts[0]
    for p_ in parts[1:]:
        s = s + p_
    return s / n * scale


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M,K,N", [(1, 1024, 96), (5, 1000, 96), (32, 2048, 64),
                                   (40, 1024, 32)])
def test_bitserial_model_matches_pallas(M, K, N, bits):
    rng = np.random.default_rng(M * 10 + bits)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)) * K ** -0.5
    planes, scale = pack_weight(w, bits)
    plan = bitserial_plan(M, K, N, bits)
    assert plan.splits > 1                                   # the cluster combine runs
    xt = torch.from_numpy(np.asarray(x, np.float32))
    got = _bitserial_model(xt, planes, scale, bits, plan, K).numpy()
    bk = 200 if K % 256 else 256
    ref = np.asarray(qmm_pallas(x, jnp.asarray(planes.numpy()), jnp.asarray(scale.numpy()),
                                bits=bits, path="bitserial", block=(M, N, bk), interpret=True))
    # both sum exact f32 products x * (u - n) in other orders
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    plain = tref.qmm_ref(xt, planes, scale, bits).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5 * np.abs(plain).max())


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
        out[b] = _combine(list(zip(ms, ls, accs)))
    return out


def _combine(parts):
    """split_kv.cuh's combine of [(m, l, acc)] in split order."""
    m = torch.stack([p[0] for p in parts]).max(dim=0).values
    w = [torch.exp(mi - m) for mi, _, _ in parts]
    l = sum(li * wi for (_, li, _), wi in zip(parts, w))
    o = sum(ai * wi[..., None] for (_, _, ai), wi in zip(parts, w))
    return o / torch.clamp(l, min=1e-20)[..., None]


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


# ---- the quantized split-KV sweep (csrc/kv_attention.cuh)
TILE = 32


def _sweep_model(q, k, v, scale):
    """One split's (m, l, acc) over its tokens, 32-token tiles in turn: q
    (KV, G, hd), k and v (T, KV, hd) dequantized."""
    KV, G, hd = q.shape
    m, l, acc = torch.full((KV, G), -1e30), torch.zeros((KV, G)), torch.zeros((KV, G, hd))
    for t0 in range(0, k.shape[0], TILE):
        s = torch.einsum("kgh,tkh->kgt", q, k[t0:t0 + TILE]) * scale
        mn = torch.maximum(m, s.max(dim=-1).values)
        corr = torch.exp(m - mn)
        p = torch.exp(s - mn[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("kgt,tkh->kgh", p, v[t0:t0 + TILE])
        m = mn
    return m, l, acc


def _quant_split_kv_model(q, kc, vc, ks, vs, bt, lengths, plan=split_plan, new=None):
    """Torch model of the quantized split-KV kernels: the page splits of
    ``plan(nb)``, then ``new(b)``'s partial last where given."""
    B, KV, G, hd = q.shape
    bs, nb = kc.shape[1], bt.shape[1]
    pps, S = plan(nb)
    kd = tref.gather_dequant(kc, ks, bt.long())           # (B, nb*bs, KV, hd) f32
    vd = tref.gather_dequant(vc, vs, bt.long())
    out = torch.zeros((B, KV, G, hd))
    for b in range(B):
        ln = min(max(int(lengths[b]), 0), nb * bs)
        parts = []
        for s in range(S):
            t0, t1 = s * pps * bs, min(ln, (s + 1) * pps * bs)
            parts.append(_sweep_model(q[b], kd[b, t0:max(t0, t1)], vd[b, t0:max(t0, t1)],
                                      hd ** -0.5))
        if new is not None:
            parts.append(new(b))
        out[b] = _combine(parts)
    return out


def _quant_pool(NB, bs, KV, hd, kv_bits, rng):
    qmax = float(2 ** (kv_bits - 1) - 1)
    pools = []
    for _ in range(2):
        codes, scale = kv_quantize(torch.from_numpy(
            rng.standard_normal((NB, bs, KV, hd)).astype(np.float32)), qmax)
        pools.append((kv_pack_int4(codes) if kv_bits == 4 else codes, scale))
    (kc, ks), (vc, vs) = pools
    return kc, vc, ks, vs, qmax


@pytest.mark.parametrize("nb", [19, 64], ids=["table-fits", "wide-table"])
@pytest.mark.parametrize("lengths", [[1, 16, 17, 300], [0, 5, 64, 33]], ids=["ragged", "dead-row"])
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_quant_split_kv_model_matches_pallas(kv_bits, lengths, nb):
    B, KV, G, hd, bs = len(lengths), 2, 4, 32, 16
    rng = np.random.default_rng(nb + kv_bits)
    NB = B * nb + 1
    kc, vc, ks, vs, _ = _quant_pool(NB, bs, KV, hd, kv_bits, rng)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    bt = (rng.permutation(NB - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    got = _quant_split_kv_model(torch.from_numpy(q), kc, vc, ks, vs, torch.from_numpy(bt),
                                torch.from_numpy(ln)).numpy()
    ref = np.asarray(paged_attention_quant_pallas(
        jnp.asarray(q), *(jnp.asarray(t.numpy()) for t in (kc, vc, ks, vs)), jnp.asarray(bt),
        jnp.asarray(ln), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    dead = ln == 0
    assert not got[dead].any() and not ref[dead].any()   # a row of length 0: exact zeros
    assert split_plan(nb)[1] > 1


# ---- the fused decode: split-K projection (A), split-KV attend (B)
def test_attend_plan_reads_the_table_width_only():
    assert list(inspect.signature(attend_plan).parameters) == ["nb"]
    for nb in range(1, 400):
        pps, splits = attend_plan(nb)
        assert 1 <= splits <= MAX_SPLITS - 1 and pps >= 1    # + the new token's partial
        assert (splits - 1) * pps < nb <= splits * pps
    assert attend_plan(7)[1] > 1                               # the int4 cell's main lengths


GLM4_QKV = (4096, (32 * 128, 2 * 128, 2 * 128))     # d_model; q, k, v widths


@pytest.mark.parametrize("B", [1, 4, 8])
def test_project_plan_fills_the_card_at_glm4(B):
    D, widths = GLM4_QKV
    plan = project_plan(B, D, widths)
    assert plan.col_tiles == 72 and plan.row_tiles == 1
    assert plan.ctas >= SMS and plan.ctas >= PROJECT_CTAS
    assert 2 <= plan.splits <= plan.chunks == 32
    ranges = plan.k_ranges(D)
    assert ranges[0][0] == 0 and ranges[-1][1] == D
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert lo < hi == lo2 and lo % CHUNK == 0           # contiguous whole chunks
    ntot = sum(widths)
    assert plan.workspace_numel(B, ntot) == plan.splits * B * ntot


@pytest.mark.parametrize("B", [1, 3, 8, 9, 33])
@pytest.mark.parametrize("D", [32, 512, 1536, 4096, 4104, 13696])
def test_project_plan_k_ranges_cover_k_once(B, D):
    plan = project_plan(B, D, (300, 8, 8))
    covered = [k for lo, hi in plan.k_ranges(D) for k in range(lo, hi)]
    assert covered == list(range(D))                        # every row once, in order
    assert 1 <= plan.splits <= plan.chunks == -(-D // CHUNK)
    assert plan.workspace_numel(B, 316) == plan.splits * B * 316


def _split_k_projection(x, w, plan, D):
    """(A)'s raw partials of one matrix, sum x*(u - n) per split."""
    codes = unpack_bitplanes(w.planes, w.bits).float()      # u - n
    return [x[:, lo:hi] @ codes[lo:hi] for lo, hi in plan.k_ranges(D)]


def _fused_model(x, ws, kc, vc, ks, vs, bt, ln, cos, sin, qmax, H, KV, act):
    """Torch model of the fused decode's two launches."""
    B, D = x.shape
    hd = ws[0].scale.numel() // H
    G = H // KV
    plan = project_plan(B, D, [w.scale.numel() for w in ws])
    parts = [_split_k_projection(x.float(), w, plan, D) for w in ws]
    raw = torch.stack([torch.cat([p[s] for p in parts], dim=1) for s in range(plan.splits)])
    proj = tref.finish_projection(raw, *ws)
    q, k, v = proj.to(act).split([H * hd, KV * hd, KV * hd], dim=1)
    c, s_ = cos[:, None, :], sin[:, None, :]
    q = rope_rotate(q.reshape(B, H, hd), c, s_).to(act).float().reshape(B, KV, G, hd)
    k = rope_rotate(k.reshape(B, KV, hd), c, s_).to(act)
    k_codes, k_sc = kv_quantize(k, qmax)
    v_codes, v_sc = kv_quantize(v.reshape(B, KV, hd), qmax)
    kn, vn = kv_dequantize(k_codes, k_sc), kv_dequantize(v_codes, v_sc)

    def new(b):
        m = torch.einsum("kgh,kh->kg", q[b], kn[b]) * hd ** -0.5
        return m, torch.ones_like(m), vn[b][:, None, :].expand(KV, G, hd)

    out = _quant_split_kv_model(q, kc, vc, ks, vs, bt, ln, plan=attend_plan, new=new)
    if kc.dtype == torch.uint8:
        k_codes, v_codes = kv_pack_int4(k_codes), kv_pack_int4(v_codes)
    return out, k_codes, v_codes, k_sc, v_sc, plan


@pytest.mark.parametrize("lengths,nb", [([0, 5, 8, 11], 3), ([0, 5, 33, 79], 20)],
                         ids=["few-pages", "multi-page-splits"])
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_fused_decode_model_matches_pallas(kv_bits, lengths, nb):
    B, KV, G, hd, bs, D = len(lengths), 2, 2, 16, 4, 1536
    H = KV * G
    rng = np.random.default_rng(kv_bits * 3 + nb)
    NB = B * nb + 1
    kc, vc, ks, vs, qmax = _quant_pool(NB, bs, KV, hd, kv_bits, rng)
    bt = (rng.permutation(NB - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    x = jnp.asarray(rng.standard_normal((B, D)), jnp.bfloat16)
    ws, jw = [], []
    for n_out, bits in ((H * hd, 4), (KV * hd, 3), (KV * hd, 8)):
        w = torch.from_numpy(rng.standard_normal((D, n_out)).astype(np.float32)) * D ** -0.5
        planes, scale = pack_weight(w, bits)
        ws.append(Packed(planes, scale, bits))
        jw += [jnp.asarray(planes.numpy()), jnp.asarray(scale.numpy())]
    cos, sin = rope_cos_sin(torch.from_numpy(ln), hd, 1e4)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    tb = torch.from_numpy(bt)
    got = _fused_model(xt, ws, kc, vc, ks, vs, tb, torch.from_numpy(ln), cos, sin, qmax, H, KV,
                       torch.bfloat16)
    assert got[-1].splits == 6                               # (A) split in six
    assert attend_plan(nb)[0] == (2 if nb == 20 else 1)
    ref = fused_qkv_paged_decode_pallas(
        x, *jw, *(jnp.asarray(t.numpy()) for t in (kc, vc, ks, vs)), jnp.asarray(bt),
        jnp.asarray(ln), jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()), jnp.float32(qmax),
        bits_q=4, bits_k=3, bits_v=8, num_heads=H, interpret=True)
    for g, r in zip(got[1:5], ref[1:]):                      # codes and scales: bitwise
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    out, ro = got[0].numpy(), np.asarray(ref[0])
    np.testing.assert_allclose(out, ro, rtol=0, atol=1e-5 * np.abs(ro).max())


# ---- the per-column grouped fake-quant of the LM QAT path (csrc/fake_quant.cu)
GLM4_4L = [(151552, 4096), (4, 4096, 4096), (4, 4096, 256), (4, 4096, 256),
           (4, 4096, 4096), (4, 4096, 13696), (4, 4096, 13696), (4, 13696, 4096),
           (4096, 151552)]   # embed, wq, wk, wv, wo, wg, wu, wd, lm_head at 4 layers


@pytest.mark.parametrize("dtype,cols", [(torch.bfloat16, 256), (torch.float32, 128)],
                         ids=["bf16", "f32"])
def test_col_plan_at_the_glm4_cell(dtype, cols):
    """One launch for the nine leaves of the 4-layer glm4-9b cell: every
    tile a strip of 512 bytes of a row over a block of 256 rows, each leaf's
    K split into its own row blocks (embed's 151,552 rows into 592), the
    descriptors inside 4 KB of kernel parameters."""
    from repro_torch.kernels import fake_quant as fq

    plan = fq.fake_quant_col_plan(GLM4_4L, dtype)
    assert plan.tile_cols == cols == fq.COL_TX * 16 // torch.empty((), dtype=dtype).element_size()
    assert fq.COL_ROWS == 256 and plan.launches == ((0, 9),)
    assert plan.splits == (592, 16, 16, 16, 16, 16, 16, 54, 16) and plan.split == 592
    assert plan.dims[0] == (1, 151552, 4096) and plan.dims[1] == (4, 4096, 4096)
    assert plan.tiles == tuple(L * -(-N // cols) for L, _, N in plan.dims)
    assert plan.ctas == (sum(t * s for t, s in zip(plan.tiles, plan.splits)),)
    per = 16 // torch.empty((), dtype=dtype).element_size()
    assert plan.bwd_ctas == (sum(-(-L * K * N // (256 * fq.STE_VECS * per))
                                 for L, K, N in plan.dims),)
    assert plan.param_bytes == (fq.COL_PARAM_BYTES[0] + 9 * fq.COL_PARAM_BYTES[1],)
    assert fq.COL_PARAM_BYTES[0] + fq.COL_MAX * fq.COL_PARAM_BYTES[1] <= 4096


@pytest.mark.parametrize("K,split", [(7, 1), (256, 1), (257, 2), (4096, 16), (13696, 54),
                                     (151552, 592)])
def test_col_plan_split_follows_the_longest_k(K, split):
    """Each leaf's K is split into its own 256-row blocks, whatever the
    other leaves' K; the plan's split is the longest leaf's."""
    from repro_torch.kernels import fake_quant as fq

    plan = fq.fake_quant_col_plan([(3, 7, 300), (K, 16)], torch.float32)
    assert plan.splits == (1, split) and plan.split == split
    assert (split - 1) * fq.COL_ROWS < K <= split * fq.COL_ROWS
    assert plan.ctas == (3 * 3 + split,)


def test_col_plan_splits_at_the_parameter_cap_and_refuses_bad_leaves():
    from repro_torch.kernels import fake_quant as fq

    plan = fq.fake_quant_col_plan([(2, 5, 9)] * 120, torch.float32)
    assert plan.launches == ((0, 56), (56, 112), (112, 120))
    assert plan.ctas == (56 * 2, 56 * 2, 8 * 2)
    for bad in ([], [(4,)], [(0, 4)]):
        with pytest.raises(ValueError):
            fq.fake_quant_col_plan(bad, torch.float32)
    with pytest.raises(TypeError):
        fq.fake_quant_col_plan([(4, 4)], torch.float16)
    w = torch.ones(2, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        fq.fake_quant_group_col_cuda([w], [torch.tensor([4, 4], dtype=torch.int32)])
    with pytest.raises(ValueError, match="CUDA"):
        fq.fake_quant_group_col_bwd_cuda([w], [w], [torch.ones(2, 1, 4)])


# ---- a model of the per-column kernels' CTAs, held on the CPU ---------------
MOONSHOT_BANKS = [(4, 64, 2048, 1408), (4, 64, 1408, 2048), (4, 64, 2048, 1408)]
SMALL_LEAVES = [(20, 1, 5, 5), (50, 20, 5, 5), (800, 500), (500, 10), (3, 7, 300)]
STATIC_SMEM_MAX = 48 * 1024      # a kernel's static shared memory


def _col_ctas(plan, launch):
    """The forward's CTAs of ``plan``'s launch ``launch`` as
    ``csrc/fake_quant.cu::col_cta`` maps them: each leaf's CTAs from its
    first, strips fastest, then row blocks, then layers -> a list of (leaf,
    layer, col0, k0, rows)."""
    a, b = plan.launches[launch]
    from repro_torch.kernels.fake_quant import COL_ROWS

    first, ctas = [], 0
    for i in range(a, b):
        first.append(ctas)
        ctas += plan.tiles[i] * plan.splits[i]
    assert ctas == plan.ctas[launch]
    out = []
    for c in range(ctas):
        j = max(j for j, f in enumerate(first) if f <= c)
        i = a + j
        _, K, N = plan.dims[i]
        strips = -(-N // plan.tile_cols)
        local = c - first[j]
        strip, local = local % strips, local // strips
        block, layer = local % plan.splits[i], local // plan.splits[i]
        k0 = block * COL_ROWS
        out.append((i, layer, strip * plan.tile_cols, k0, min(COL_ROWS, K - k0)))
    return out


@pytest.mark.parametrize("shapes,dtype", [
    (GLM4_4L, torch.bfloat16), (GLM4_4L, torch.float32), (MOONSHOT_BANKS, torch.bfloat16),
    (SMALL_LEAVES, torch.float32), (SMALL_LEAVES, torch.bfloat16)],
    ids=["glm4-bf16", "glm4-f32", "moonshot-banks", "lenet-ragged-f32", "lenet-ragged-bf16"])
def test_col_plan_covers_every_element_once(shapes, dtype):
    """Every (layer, row, column) of every leaf falls in exactly one CTA's
    tile; each tile is at most COL_ROWS rows of one layer; the kernels'
    cp.async rings and reduction arrays fit their static shared memory;
    descriptors fit 4 KB."""
    from repro_torch.kernels import fake_quant as fq

    plan = fq.fake_quant_col_plan(shapes, dtype)
    seen = {}
    for launch in range(len(plan.launches)):
        assert plan.param_bytes[launch] <= 4096
        for i, layer, col0, k0, rows in _col_ctas(plan, launch):
            assert 0 < rows <= fq.COL_ROWS and k0 % fq.COL_ROWS == 0
            seen.setdefault((i, layer, col0), []).append((k0, rows))
    assert len(seen) == sum(plan.tiles)
    for i, (L, K, N) in enumerate(plan.dims):
        cols = sorted(c for (j, l, c) in seen if j == i and l == 0)
        assert cols == list(range(0, N, plan.tile_cols))        # columns tiled once
        for layer in range(L):
            for col0 in cols:
                got = sorted(seen[(i, layer, col0)])
                assert got[0][0] == 0 and sum(r for _, r in got) == K   # rows once, in order
                assert all(k + r == k2 for (k, r), (k2, _) in zip(got, got[1:]))
    ring = fq.COL_RING * fq.THREADS * 16
    assert ring + fq.COL_TY * plan.tile_cols * 4 <= STATIC_SMEM_MAX     # the max pass
    assert ring + 255 * 4 <= STATIC_SMEM_MAX                            # the QDQ pass


def _keys(x: torch.Tensor) -> torch.Tensor:
    """|x|'s bit patterns as non-negative int64 keys (bf16: its 16 bits)."""
    if x.dtype == torch.bfloat16:
        return (x.view(torch.int16).to(torch.int64) & 0x7FFF)
    return x.view(torch.int32).to(torch.int64) & 0x7FFFFFFF


def _col_forward_model(ws, bits):
    """A torch model of the per-column forward over ``ws`` (one dtype) at
    row blocks of ``COL_ROWS``: each CTA's tile keys (the max of |w|'s bits
    over its rows), merged into scale bits that start at eps's with an
    unsigned max, CTAs taken in an arbitrary (here reversed) order, a NaN
    written as the card writes it; then the QDQ with q / n from the table
    -> (outs, scales)."""
    from repro_torch.kernels import fake_quant as fq

    dtype = ws[0].dtype
    plan = fq.fake_quant_col_plan([w.shape for w in ws], dtype)
    eps = torch.tensor(float(torch.tensor(twrpn.EPS, dtype=dtype))).view(torch.int32)
    scale_bits = [torch.full((L, N), int(eps), dtype=torch.int64) for L, _, N in plan.dims]
    nan = 0x7FFF0000 if dtype == torch.bfloat16 else 0x7FFFFFFF
    ctas = [c for launch in range(len(plan.launches)) for c in _col_ctas(plan, launch)]
    for i, layer, col0, k0, rows_ in reversed(ctas):
        L, K, N = plan.dims[i]
        tile = ws[i].reshape(L, K, N)[layer, k0:k0 + rows_, col0:col0 + plan.tile_cols]
        keys = _keys(tile).amax(dim=0)
        top = 0x7F80 if dtype == torch.bfloat16 else 0x7F800000
        widened = torch.where(keys > top, torch.tensor(nan),
                              keys << 16 if dtype == torch.bfloat16 else keys)
        dst = scale_bits[i][layer, col0:col0 + keys.numel()]
        torch.maximum(dst, widened, out=dst)
    outs, scales = [], []
    for i, (w, b) in enumerate(zip(ws, bits)):
        N = plan.dims[i][2]
        s = scale_bits[i].to(torch.int32).view(torch.float32).reshape(*w.shape[:-2], 1, N)
        bl = tref.col_bits_view(w, b)
        n = twrpn._levels(bl)
        q = torch.round(torch.clamp(w.float() / s, -1.0, 1.0) * n)
        d = torch.where((q == 0) | torch.isnan(q), q, q / n)   # the table: a zero code or a
        out = torch.where(bl >= twrpn.FP_BITS, w, (d * s).to(dtype))   # NaN as it is
        outs.append(out)
        scales.append(s)
    return outs, scales


def _nan_or_same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit patterns where either is not NaN, NaN where either is."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    an, bn = torch.isnan(a.float()), torch.isnan(b.float())
    return bool(torch.equal(an, bn) and torch.equal(a.view(view)[~an], b.view(view)[~bn]))


def _col_edge_leaves(dtype, seed):
    """Narrow leaves (K <= 512) with a zero column, NaNs in several parts
    of one column, values near the eps floor, -0.0 and a ragged N."""
    rng = np.random.default_rng(seed)
    shapes = [(2, 96, 40), (3, 40, 24), (300, 17), (2, 512, 64), (1, 33, 7)]
    ws = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    ws[0][1, :, 5] = 0.0                                  # a zero column
    ws[0][0, 3, 11], ws[0][0, 70, 11] = float("nan"), float("nan")
    ws[2][250, 3] = float("nan")
    near = 1.0005e-8 if dtype == torch.float32 else 9.95e-9
    ws[1] = torch.linspace(-1, 1, ws[1].numel()).reshape(ws[1].shape) * near
    ws[3][0, :, 7] = -0.0
    return [w.to(dtype) for w in ws]


@pytest.mark.parametrize("K", [256, 257, 1100], ids=["k256", "k257", "k1100"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_col_forward_model_matches_plain_bitwise(dtype, K):
    """The kernel's tiling and order-free integer max merge over the edge
    leaves (1 or 2 row blocks) and a (2, K, 40) leaf of 1, 2 or 5 blocks,
    NaNs in several of its blocks and its largest |w| in the last, against
    kernels.ref.fake_quant_group_col_ref bit for bit (a NaN held as a NaN:
    the card writes torch's NaN as 0x7fffffff / 0x7fff, the CPU 0x7fc0)."""
    from repro_torch.kernels.fake_quant import COL_ROWS

    ws = _col_edge_leaves(dtype, 3)
    rng = np.random.default_rng(K)
    w = torch.from_numpy(rng.standard_normal((2, K, 40)).astype(np.float32))
    for r in range(3, K, COL_ROWS):
        w[0, r, 9] = float("nan")                        # one NaN in each block of column 9
    w[1, K - 1, 20] = 50.0                               # column 20's max in the last block
    ws.append(w.to(dtype))
    bits = [torch.tensor(b, dtype=torch.int32)
            for b in ([2, 8], [1, 16, 32], 5, [3, 7], 4, [6, 3])]
    outs, scales = _col_forward_model(ws, bits)
    want, want_s = tref.fake_quant_group_col_ref(ws, bits)
    for i in range(len(ws)):
        assert _nan_or_same(scales[i], want_s[i]), i
        assert _nan_or_same(outs[i], want[i]), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_col_ste_model_gathers_each_elements_scale(dtype):
    """The flat STE's map: 16-byte vector v of a leaf (THREADS * STE_VECS
    a block) holds elements v * NV ..; element e's scale is scale[l * N +
    n] with row = e // N, l = row // K, n = e - row * N; grad = g * (|w| <=
    s) against fake_quant_group_col_bwd_ref, bit for bit."""
    from repro_torch.kernels import fake_quant as fq

    ws = _col_edge_leaves(dtype, 4)
    gs = [torch.from_numpy(np.random.default_rng(i).standard_normal(w.shape).astype(np.float32))
          .to(dtype) for i, w in enumerate(ws)]
    gs[0].view(-1)[:4] = torch.tensor([float("inf"), float("nan"), -3.0, float("-inf")])
    _, scales = tref.fake_quant_group_col_ref(ws, [torch.tensor(4, dtype=torch.int32)] * 5)
    per = 16 // torch.empty((), dtype=dtype).element_size()
    plan = fq.fake_quant_col_plan([w.shape for w in ws], dtype)
    for i, (w, g, s) in enumerate(zip(ws, gs, scales)):
        L, K, N = plan.dims[i]
        numel = L * K * N
        blocks = -(-numel // (fq.THREADS * fq.STE_VECS * per))
        e = torch.arange(blocks * fq.THREADS * fq.STE_VECS * per)
        e = e[e < numel]
        row = e // N
        sidx = row // K * N + (e - row * N)
        inside = (w.reshape(-1)[e].abs().float() <= s.reshape(-1)[sidx]).to(dtype)
        got = (g.reshape(-1)[e] * inside).reshape(w.shape)
        (want,) = tref.fake_quant_group_col_bwd_ref([w], [g], [s])
        assert _nan_or_same(got, want), i
