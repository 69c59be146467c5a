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
from repro_torch.quant.pack import (Packed, kv_dequantize, kv_pack_int4, kv_quantize,
                                    pack_weight, unpack_bitplanes)
from repro_torch.kernels.qmm import (BS_MAX_SPLITS, BS_MIN_STEPS, BS_STEP, SMEM_MAX, SMS, TILE_K,
                                     bitserial_plan, bitserial_smem, bitserial_splits,
                                     dequant_plan, dequant_smem)

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
