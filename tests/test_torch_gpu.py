"""The hand-written CUDA kernels against their plain versions, on an sm_90
card (skipped elsewhere).  No JAX here: the machine with the card runs
only the port.  Run there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: both versions sum exact f32 products (bf16 activations, or
the three bf16 terms of an f32 activation, times integer codes, or bf16
scores) in different orders over up to K = 13696 terms, so 1e-4 *
max|plain| — the bound chip_smoke.py states.  The fused
decode's projections sum in another order than the plain version's
dequant-form matmul, so its new-token codes may move by one step where a
value sits on a rounding edge: scales within 2^-7 relative, codes within
+-1, output within 2e-2 * max|plain|; its attention half alone, on the
same projections, gives codes and scales bitwise.  The fake-quant kernels
(flat and grouped, forward and STE backward) are elementwise IEEE f32 in
the plain version's order, and the scale a max: bitwise, compared as bit
patterns where NaN or -0.0 may sit.  The
split-K qmm bodies (bit-serial and dequant) and the split-KV attention add
their partials in a fixed order, so two calls on the same inputs are
bitwise equal.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.quant.pack import pack_weight


@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run on an sm_90 card only)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) card")
    return torch.device("cuda")


def _qmm_inputs(M, K, N, bits, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((K, N), generator=gen, device=dev)
    planes, scale = pack_weight(w, bits)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    return x, planes, scale


@pytest.mark.gpu
@pytest.mark.parametrize("path,M", [("bitserial", 1), ("bitserial", 5),
                                    ("bitserial", 20), ("dequant", 40),
                                    ("dequant", 130)])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("K,N", [(4096, 256), (13696, 300), (136, 13)])
def test_qmm_kernel_matches_plain(sm90, K, N, bits, path, M):
    from repro_torch.kernels.qmm import qmm_cuda

    x, planes, scale = _qmm_inputs(M, K, N, bits, sm90, seed=bits + M)
    got = qmm_cuda(x, planes, scale, bits, path)
    torch.cuda.synchronize()
    plain = tref.qmm_ref(x, planes, scale, bits)
    assert (got - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("lengths", [[1, 16, 17, 300], [0, 5, 64, 33]])
def test_paged_attention_kernel_matches_plain(sm90, lengths):
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    B, KV, G, hd, bs, nb = 4, 2, 16, 128, 16, 19
    NB = B * nb + 1
    gen = torch.Generator(device=sm90).manual_seed(1)
    q = torch.randn((B, KV, G, hd), generator=gen, device=sm90).to(torch.bfloat16)
    kp = torch.randn((NB, bs, KV, hd), generator=gen, device=sm90).to(torch.bfloat16)
    vp = torch.randn((NB, bs, KV, hd), generator=gen, device=sm90).to(torch.bfloat16)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(NB - 1) + 1)
    bt = perm[:B * nb].reshape(B, nb).to(sm90, torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=sm90)
    got = paged_attention_cuda(q, kp, vp, bt, ln).reshape(B, 1, KV * G, hd)
    torch.cuda.synchronize()
    plain = tref.paged_attention_ref(q.reshape(B, 1, KV * G, hd).float(),
                                     kp.float(), vp.float(), bt, ln)
    live = ln > 0
    err = (got[live] - plain[live]).abs().max().item()
    assert err <= 1e-4 * plain[live].abs().max().item()
    assert not got[~live].any()  # a dead row is exact zeros


@pytest.mark.gpu
def test_ops_counts_kernel_launches_on_the_card(sm90):
    x, planes, scale = _qmm_inputs(4, 256, 64, 4, sm90)
    ops.reset_counts()
    ops.qmm(x, planes, scale, bits=4)
    ops.qmm(torch.cat([x] * 10), planes, scale, bits=4)
    assert ops.counts == {"qmm_bitserial": 1, "qmm_dequant": 1,
                          "paged_attention": 0, "paged_attention_quant": 0,
                          "fused_qkv_paged_decode": 0, "fake_quant": 0,
                          "fake_quant_group": 0, "fake_quant_group_bwd": 0,
                          "fake_quant_group_col": 0, "fake_quant_group_col_max": 0,
                          "fake_quant_group_col_qdq": 0, "fake_quant_group_col_bwd": 0, "plain": 0}


def _quant_pool(NB, bs, KV, hd, kv_bits, gen, dev):
    from repro_torch.quant.pack import kv_pack_int4, kv_quantize

    qmax = float(2 ** (kv_bits - 1) - 1)
    out = []
    for _ in range(2):
        codes, scale = kv_quantize(torch.randn((NB, bs, KV, hd), generator=gen, device=dev), qmax)
        out.append((kv_pack_int4(codes) if kv_bits == 4 else codes, scale))
    (kc, ks), (vc, vs) = out
    return kc, vc, ks, vs, qmax


def _tables(B, nb, lengths, dev):
    NB = B * nb + 1
    perm = torch.from_numpy(np.random.default_rng(2).permutation(NB - 1) + 1)
    bt = perm[:B * nb].reshape(B, nb).to(dev, torch.int32)
    return NB, bt, torch.tensor(lengths, dtype=torch.int32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("lengths", [[1, 16, 17, 300], [0, 5, 64, 33]])
def test_paged_attention_quant_kernel_matches_plain(sm90, kv_bits, lengths):
    from repro_torch.kernels.paged_attention_quant import paged_attention_quant_cuda

    B, KV, G, hd, bs, nb = 4, 2, 16, 128, 16, 19
    gen = torch.Generator(device=sm90).manual_seed(3)
    NB, bt, ln = _tables(B, nb, lengths, sm90)
    kc, vc, ks, vs, _ = _quant_pool(NB, bs, KV, hd, kv_bits, gen, sm90)
    q = torch.randn((B, KV, G, hd), generator=gen, device=sm90).to(torch.bfloat16)
    got = paged_attention_quant_cuda(q, kc, vc, ks, vs, bt, ln).reshape(B, 1, KV * G, hd)
    torch.cuda.synchronize()
    plain = tref.quant_paged_attention_ref(q.reshape(B, 1, KV * G, hd).float(),
                                           kc, vc, ks, vs, bt, ln)
    live = ln > 0
    err = (got[live] - plain[live]).abs().max().item()
    assert err <= 1e-4 * plain[live].abs().max().item()
    assert not got[~live].any()  # a dead row is exact zeros


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("bits", [(4, 4, 4), (4, 3, 8)], ids=["4-4-4", "4-3-8"])
def test_fused_decode_kernel_matches_plain(sm90, kv_bits, bits):
    from repro_torch.kernels.fused_decode import (fused_attend_cuda,
                                                  fused_qkv_paged_decode_cuda)
    from repro_torch.models.common import rope_cos_sin
    from repro_torch.quant.pack import Packed, kv_unpack_int4

    B, KV, G, hd, bs, nb, D = 4, 2, 16, 128, 16, 19, 4096
    H = KV * G
    gen = torch.Generator(device=sm90).manual_seed(4)
    NB, bt, ln = _tables(B, nb, [0, 16, 41, nb * bs - 1], sm90)
    kc, vc, ks, vs, qmax = _quant_pool(NB, bs, KV, hd, kv_bits, gen, sm90)
    ws = []
    for n, b in zip((H * hd, KV * hd, KV * hd), bits):
        planes, scale = pack_weight(torch.randn((D, n), generator=gen, device=sm90) * D ** -0.5, b)
        ws.append(Packed(planes, scale, b))
    x = torch.randn((B, D), generator=gen, device=sm90).to(torch.bfloat16)
    cos, sin = rope_cos_sin(ln, hd, 1e4)
    qm = torch.tensor(qmax, device=sm90)
    got = fused_qkv_paged_decode_cuda(x, *ws, kc, vc, ks, vs, bt, ln, cos, sin, qm, H)
    torch.cuda.synchronize()
    plain = tref.fused_qkv_paged_decode_ref(x, *ws, kc, vc, ks, vs, bt, ln, cos, sin, qm, H, KV)
    out, po = got[0].reshape(B, 1, H, hd), plain[0].float()
    assert (out - po).abs().max().item() <= 2e-2 * po.abs().max().item()
    for g, p in zip(got[3:], plain[3:]):
        assert ((g - p).abs() <= 2.0 ** -7 * p.abs()).all()
    unpack = kv_unpack_int4 if kv_bits == 4 else (lambda c: c)
    for g, p in zip(got[1:3], plain[1:3]):
        assert (unpack(g).int() - unpack(p).int()).abs().max().item() <= 1
    # the attention half alone, on the plain version's own projections
    proj = torch.cat([tref.qmm_ref(x, w.planes, w.scale, w.bits) for w in ws], dim=1)
    got_b = fused_attend_cuda(proj, torch.bfloat16, kc, vc, ks, vs, bt, ln, cos, sin, qm, H)
    torch.cuda.synchronize()
    plain_b = tref.fused_decode_attend_ref(proj, kc, vc, ks, vs, bt, ln, cos, sin, qm, H, KV,
                                           torch.bfloat16)
    for g, p in zip(got_b[1:], plain_b[1:]):
        assert torch.equal(g, p)
    ob, pb = got_b[0].reshape(B, 1, H, hd), plain_b[0].float()
    assert (ob - pb).abs().max().item() <= 1e-2 * pb.abs().max().item()


FQ_SHAPES = [(16, 3, 3, 3), (64, 64, 3, 3), (16, 10), (7, 300), (4096, 13696)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FQ_SHAPES, ids=str)
def test_fake_quant_kernel_matches_plain_bitwise(sm90, shape, dtype):
    from repro_torch.kernels.fake_quant import fake_quant_cuda
    from repro_torch.quant.wrpn import tensor_scale

    gen = torch.Generator(device=sm90).manual_seed(5)
    w = torch.randn(shape, generator=gen, device=sm90).to(dtype)
    w.view(-1)[:2] = 0.0
    scale = tensor_scale(w)
    bits_vec = torch.tensor([1, 2, 3, 4, 5, 6, 7, 8, 16, 32], dtype=torch.int32, device=sm90)
    for i in range(bits_vec.numel()):
        got = fake_quant_cuda(w, bits_vec[i], scale)
        torch.cuda.synchronize()
        assert torch.equal(got, tref.fake_quant_ref(w, bits_vec[i], scale)), int(bits_vec[i])
    # a view 4 bytes past an aligned base takes the scalar path
    flat = w.reshape(-1)[1:]
    got = fake_quant_cuda(flat, bits_vec[2], scale)
    assert torch.equal(got, tref.fake_quant_ref(flat, bits_vec[2], scale))


@pytest.mark.gpu
def test_fake_quant_kernel_keeps_nan_and_ops_counts_it(sm90):
    w = torch.tensor([[float("nan"), 0.5, -2.0, 1.0, 0.25, -0.0, 3.0]], device=sm90)
    scale = torch.tensor(2.0, device=sm90)
    ops.reset_counts()
    got = ops.fake_quant(w, torch.tensor(3, dtype=torch.int32, device=sm90), scale)
    assert ops.counts["fake_quant"] == 1 and ops.counts["plain"] == 0
    plain = tref.fake_quant_ref(w, 3, scale)
    assert torch.isnan(got[0, 0]) and torch.equal(got[0, 1:], plain[0, 1:])


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [2, 4, 32])
def test_fake_quant_ste_on_the_card_matches_the_cpu(sm90, bits):
    from repro_torch.quant.wrpn import fake_quant_ste

    w_cpu = torch.randn((32, 16, 3, 3), generator=torch.Generator().manual_seed(bits))
    cot = torch.randn(w_cpu.shape, generator=torch.Generator().manual_seed(99))
    grads, vals = [], []
    for dev in (sm90, torch.device("cpu")):
        w = w_cpu.to(dev).requires_grad_(True)
        out = fake_quant_ste(w, torch.tensor(bits, dtype=torch.int32, device=dev))
        (g,) = torch.autograd.grad(out, w, cot.to(dev))
        vals.append(out.detach().cpu())
        grads.append(g.cpu())
    assert torch.equal(vals[0], vals[1]) and torch.equal(grads[0], grads[1])


# ---- the grouped fake-quant of the QAT path: one launch per forward (the
# scales taken in the launch), one for the STE backward; bit patterns
# compared, so the sign of zero and NaN are held
FQ_GROUP_BITS = (1, 2, 3, 4, 5, 6, 7, 8, 16, 32)


def _bit_pattern(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bit_pattern(a),
                                                                      _bit_pattern(b))


def _fq_group(net, dtype, dev, seed, extra=()):
    """The quantized weights of ``net`` (every layer, in the QAT order),
    then ``extra`` shapes, random from ``seed``, with a -0.0 and a 0.0."""
    from repro_torch.cnn.models import build_cnn

    shapes = [tuple(p["w"].shape) for p in build_cnn(net).init(0, device="cpu").values()]
    gen = torch.Generator(device=dev).manual_seed(seed)
    ws = []
    for shape in [*shapes, *extra]:
        w = torch.randn(shape, generator=gen, device=dev)
        w.view(-1)[:2] = torch.tensor([-0.0, 0.0], device=dev)
        ws.append(w.to(dtype))
    return ws


def _edge_tensors(dtype, dev):
    """An all-zero tensor (the eps floor), one holding a NaN, and one whose
    max sits where the floor's dtype decides the scale: f32 just above
    1e-8 (below bf16(1e-8)), bf16 just below 1e-8 (bf16(1e-8) wins)."""
    near = 1.0005e-8 if dtype == torch.float32 else 9.95e-9
    nan = torch.randn((33, 7), generator=torch.Generator().manual_seed(4))
    nan[3, 2] = float("nan")
    return [torch.zeros((5, 9), device=dev, dtype=dtype),
            nan.to(dev, dtype),
            (torch.linspace(-1, 1, 301) * near).to(dev, dtype)]


def _fq_check_group(ws, dev, seed=0):
    """The grouped forward and backward against their plain versions, bit
    for bit; returns the launches counted."""
    n = len(ws)
    bits = torch.tensor([FQ_GROUP_BITS[(i + seed) % len(FQ_GROUP_BITS)] for i in range(n)],
                        dtype=torch.int32, device=dev)
    ops.reset_counts()
    outs, scales = ops.fake_quant_group(ws, bits)
    torch.cuda.synchronize()
    want, want_s = tref.fake_quant_group_ref(ws, bits)
    assert _same_bits(scales, want_s)
    for i, (o, p) in enumerate(zip(outs, want)):
        assert _same_bits(o, p), (i, tuple(ws[i].shape), int(bits[i]))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    gs = []
    for w in ws:
        g = torch.randn(w.shape, generator=gen, device=dev)
        g.view(-1)[:4] = torch.tensor([float("inf"), float("nan"), -3.0, float("-inf")],
                                      device=dev)[:g.numel()]
        gs.append(g.to(w.dtype))
    grads = ops.fake_quant_group_bwd(ws, gs, scales)
    torch.cuda.synchronize()
    for i, (g, p) in enumerate(zip(grads, tref.fake_quant_group_bwd_ref(ws, gs, want_s))):
        assert _same_bits(g, p), (i, tuple(ws[i].shape))
    assert ops.counts["plain"] == 0 and ops.counts["fake_quant"] == 0
    return ops.counts["fake_quant_group"], ops.counts["fake_quant_group_bwd"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("net", ["lenet", "resnet20"])
def test_fake_quant_group_matches_plain_bitwise(sm90, net, dtype):
    for seed in range(3):         # each layer meets several bits entries
        ws = _fq_group(net, dtype, sm90, seed) + _edge_tensors(dtype, sm90)
        assert _fq_check_group(ws, sm90, seed) == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fake_quant_group_with_a_tensor_read_twice(sm90, dtype):
    from repro_torch.kernels.fake_quant import fake_quant_group_plan

    ws = _fq_group("resnet20", dtype, sm90, 7, extra=[(4096, 13696)])   # glm4-9b's wg
    plan = fake_quant_group_plan([w.numel() for w in ws], dtype)
    assert plan.second_read == (len(ws) - 1,)
    assert _fq_check_group(ws, sm90) == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fake_quant_group_any_cluster_size_is_bitwise(sm90, dtype, cluster):
    """Launched at every cluster size (the ablation's sweep): at one or two
    CTAs ResNet-20's larger layers no longer fit the registers and are
    read twice; the outputs and scales do not change."""
    from repro_torch.kernels.fake_quant import group_launch

    ws = _fq_group("resnet20", dtype, sm90, 8) + _edge_tensors(dtype, sm90)
    bits = torch.tensor([FQ_GROUP_BITS[i % 10] for i in range(len(ws))], dtype=torch.int32,
                        device=sm90)
    outs = [torch.empty_like(w) for w in ws]
    scales = torch.empty(len(ws), device=sm90)
    group_launch(ws, outs, bits, scales, cluster)
    torch.cuda.synchronize()
    want, want_s = tref.fake_quant_group_ref(ws, bits)
    assert _same_bits(scales, want_s)
    assert all(_same_bits(o, p) for o, p in zip(outs, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fake_quant_group_unaligned_views_and_many_launches(sm90, dtype):
    """Views 1 element past an aligned base take the scalar loads; 150
    tensors take two launches of at most GROUP_MAX."""
    from repro_torch.kernels.fake_quant import GROUP_MAX

    gen = torch.Generator(device=sm90).manual_seed(11)
    base = torch.randn(40_000, generator=gen, device=sm90).to(dtype)
    ws = [base[1:1 + 37 * 19].view(37, 19), base[1:30_001], base[3:8]]
    ws += [torch.randn((i % 13 + 1, 17), generator=gen, device=sm90).to(dtype)
           for i in range(147)]
    assert len(ws) > GROUP_MAX
    assert _fq_check_group(ws, sm90, seed=3) == (2, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FQ_SHAPES[:4], ids=str)
def test_fake_quant_group_of_one_equals_the_flat_kernel(sm90, shape, dtype):
    from repro_torch.kernels.fake_quant import fake_quant_cuda, fake_quant_group_cuda
    from repro_torch.quant.wrpn import tensor_scale

    gen = torch.Generator(device=sm90).manual_seed(12)
    w = torch.randn(shape, generator=gen, device=sm90).to(dtype)
    for b in FQ_GROUP_BITS:
        bits = torch.tensor([b], dtype=torch.int32, device=sm90)
        (got,), scale, launches = fake_quant_group_cuda([w], bits)
        assert launches == 1 and _same_bits(scale[0], tensor_scale(w))
        assert _same_bits(got, fake_quant_cuda(w, bits[0], tensor_scale(w)))


@pytest.mark.gpu
def test_fake_quant_group_constants_match_the_library(sm90):
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import fake_quant as fq

    out = (ctypes.c_int * 7)()
    build.library("fake_quant").fake_quant_group_limits(out)
    assert list(out) == [fq.THREADS, fq.MAX_VECS, fq.BWD_VECS, fq.GROUP_MAX, fq.MAX_CLUSTER,
                         fq.FWD_PARAM_BYTES[0] + fq.FWD_PARAM_BYTES[1] * fq.GROUP_MAX,
                         fq.BWD_PARAM_BYTES[0] + fq.BWD_PARAM_BYTES[1] * fq.GROUP_MAX]


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["lenet", "resnet20"])
def test_qat_step_launches_one_group_per_forward_and_backward(sm90, net):
    from repro_torch.cnn import CNNTask

    task = CNNTask(net, seed=0, batch=8, device=sm90)
    bits = {n: (2, 3, 4, 8, 32)[i % 5] for i, n in enumerate(task.names)}
    ops.reset_counts()
    params, _ = task.train(2, bits)
    task.accuracy(params, bits)          # two validation batches: two forwards
    torch.cuda.synchronize()
    assert ops.counts["fake_quant_group"] == 4 and ops.counts["fake_quant_group_bwd"] == 2
    assert ops.counts["fake_quant"] == 0 and ops.counts["plain"] == 0


# ---- the per-column grouped fake-quant of the LM QAT path
def _col_leaves(dtype, dev, seed=0, extra=()):
    """Stacked and 2-D leaves (ragged N, K past one CTA's rows), a leaf with
    an all-zero column, one with a NaN, one near the eps floor, and a
    -0.0 and a 0.0 in each."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = [(4, 300, 256), (3, 7, 300), (2000, 72), (2, 33, 9), *extra]
    ws = []
    for shape in shapes:
        w = torch.randn(shape, generator=gen, device=dev)
        w.view(-1)[:2] = torch.tensor([-0.0, 0.0], device=dev)
        ws.append(w.to(dtype))
    zero_col = torch.randn((2, 40, 24), generator=gen, device=dev)
    zero_col[1, :, 5] = 0.0
    nan = torch.randn((3, 17, 40), generator=gen, device=dev)
    nan[2, 3, 11] = float("nan")
    near = 1.0005e-8 if dtype == torch.float32 else 9.95e-9
    tiny = torch.linspace(-1, 1, 2 * 31 * 16, device=dev).reshape(2, 31, 16) * near
    return ws + [t.to(dtype) for t in (zero_col, nan, tiny)]


def _col_bits(ws, dev, seed):
    out = []
    for i, w in enumerate(ws):
        L = w.shape[0] if w.ndim == 3 else 1
        vals = [FQ_GROUP_BITS[(i + l + seed) % len(FQ_GROUP_BITS)] for l in range(L)]
        out.append(torch.tensor(vals if w.ndim == 3 else vals[0], dtype=torch.int32,
                                device=dev))
    return out


def _col_check(ws, dev, seed=0):
    """The per-column forward and backward against their plain versions,
    bit for bit; returns the launches counted."""
    bits = _col_bits(ws, dev, seed)
    ops.reset_counts()
    outs, scales = ops.fake_quant_group_col(ws, bits)
    torch.cuda.synchronize()
    want, want_s = tref.fake_quant_group_col_ref(ws, bits)
    for i, (o, p, s, q) in enumerate(zip(outs, want, scales, want_s)):
        assert _same_bits(s, q), (i, tuple(ws[i].shape))
        assert _same_bits(o, p), (i, tuple(ws[i].shape), bits[i].tolist())
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    gs = []
    for w in ws:
        g = torch.randn(w.shape, generator=gen, device=dev)
        g.view(-1)[:4] = torch.tensor([float("inf"), float("nan"), -3.0, float("-inf")],
                                      device=dev)
        gs.append(g.to(w.dtype))
    grads = ops.fake_quant_group_col_bwd(ws, gs, scales)
    torch.cuda.synchronize()
    for i, (g, p) in enumerate(zip(grads, tref.fake_quant_group_col_bwd_ref(ws, gs, want_s))):
        assert _same_bits(g, p), (i, tuple(ws[i].shape))
    assert ops.counts["plain"] == 0
    return ops.counts["fake_quant_group_col"], ops.counts["fake_quant_group_col_bwd"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fake_quant_col_matches_plain_bitwise(sm90, dtype):
    for seed in range(3):         # each layer meets several bits entries
        assert _col_check(_col_leaves(dtype, sm90, seed), sm90, seed) == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fake_quant_col_split_over_a_cluster(sm90, dtype):
    """K past many CTAs' rows (the name is from the cluster design this
    test first held): the plan splits the leaf's K into 36 row blocks of
    COL_ROWS, whose maxima merge into the scales by an atomic max."""
    from repro_torch.kernels.fake_quant import fake_quant_col_plan

    ws = _col_leaves(dtype, sm90, 5, extra=[(2, 9000, 136)])
    assert fake_quant_col_plan([w.shape for w in ws], dtype).split == 36
    assert _col_check(ws, sm90, 5) == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fake_quant_col_unaligned_views_and_many_launches(sm90, dtype):
    """A view 1 element past an aligned base takes the scalar loads; 70
    leaves take two launches of at most COL_MAX."""
    from repro_torch.kernels.fake_quant import COL_MAX

    gen = torch.Generator(device=sm90).manual_seed(11)
    base = torch.randn(40_000, generator=gen, device=sm90).to(dtype)
    ws = [base[1:1 + 37 * 64].view(37, 64), base[1:1 + 3 * 19 * 8].view(3, 19, 8)]
    ws += [torch.randn((i % 3 + 1, i % 13 + 1, 17), generator=gen, device=sm90).to(dtype)
           for i in range(68)]
    assert len(ws) > COL_MAX
    assert _col_check(ws, sm90, seed=3) == (2, 2)


@pytest.mark.gpu
def test_fake_quant_col_constants_match_the_library(sm90):
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import fake_quant as fq

    out = (ctypes.c_int * 10)()
    build.library("fake_quant").fake_quant_col_limits(out)
    descriptors = fq.COL_PARAM_BYTES[0] + fq.COL_PARAM_BYTES[1] * fq.COL_MAX
    assert list(out) == [fq.THREADS, fq.COL_TX, fq.COL_TY, fq.COL_ROWS, fq.COL_RING,
                         fq.COL_UNROLL, fq.STE_VECS, fq.COL_MAX, descriptors, descriptors]


@pytest.mark.gpu
def test_lm_qat_step_launches_one_col_group_per_forward_and_backward(sm90):
    """A glm4 smoke QAT train step at a mixed policy on the card: one
    per-column forward launch, one backward, no plain call; an eval step
    one forward launch."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.quant.qat import bits_assignment, bits_to_device
    from repro_torch.train.train_step import init_state, make_eval_step, make_train_step

    model = build_model(get_config("glm4-9b", smoke=True))
    groups = model.quant_groups()
    pol = QuantPolicy.from_array(tuple(g.name for g in groups),
                                 [(2, 3, 4, 8, 32)[i % 5] for i in range(len(groups))])
    bm = bits_to_device(bits_assignment(groups, pol), sm90)
    opt = AdamW(lr=1e-3)
    state = init_state(model, opt, seed=0, device=sm90)
    data = SyntheticLMData(seed=0, global_batch=2, seq_len=32, vocab=model.cfg.vocab_size)
    ops.reset_counts()
    state, m = make_train_step(model, opt, remat="full")(state, data.next(), bm)
    torch.cuda.synchronize()
    assert ops.counts["fake_quant_group_col"] == 1 and ops.counts["fake_quant_group_col_bwd"] == 1
    make_eval_step(model)(state["params"], data.eval_batch(2), bm)
    torch.cuda.synchronize()
    assert ops.counts["fake_quant_group_col"] == 2 and ops.counts["plain"] == 0
    assert np.isfinite(float(m["loss"]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fake_quant_col_expert_banks_with_layer_bits_bitwise(sm90, dtype):
    """Expert banks (L, E, K, N) with one bitwidth per stacked layer, shared
    by its E experts (the reference's (L,) bits): moonshot's bank shapes at
    2 layers, a ragged bank and leaves of one bit and of one per layer in
    the same launch; forward, scales and STE bit for bit the plain
    versions, one launch each way."""
    gen = torch.Generator(device=sm90).manual_seed(23)
    shapes = ((2, 64, 2048, 1408), (2, 64, 1408, 2048), (3, 5, 40, 24), (4, 17, 40),
              (33, 9))
    ws = [torch.randn(s, generator=gen, device=sm90).to(dtype) for s in shapes]
    ws[2][1, 3, :, 7] = 0.0                     # an all-zero column in one expert
    bits = [torch.tensor(b, dtype=torch.int32, device=sm90)
            for b in ([2, 8], [5, 3], [1, 16, 32], [4, 6, 7, 2], 3)]
    ops.reset_counts()
    outs, scales = ops.fake_quant_group_col(ws, bits)
    torch.cuda.synchronize()
    for i, (w, b) in enumerate(zip(ws, bits)):
        (want,), (want_s,) = tref.fake_quant_group_col_ref([w], [b])
        assert _same_bits(scales[i], want_s), i
        assert _same_bits(outs[i], want), (i, b.tolist())
    gs = [torch.randn(s, generator=gen, device=sm90).to(dtype) for s in shapes]
    grads = ops.fake_quant_group_col_bwd(ws, gs, scales)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(grads, ws)):
        (want,) = tref.fake_quant_group_col_bwd_ref([w], [gs[i]], [scales[i]])
        assert _same_bits(g, want), i
    assert (ops.counts["fake_quant_group_col"], ops.counts["fake_quant_group_col_bwd"],
            ops.counts["plain"]) == (1, 1, 0)
    with pytest.raises(ValueError, match="divisor"):
        ops.fake_quant_group_col([ws[2]], [torch.tensor([2, 3], dtype=torch.int32,
                                                        device=sm90)])


# the boundaries of the per-column forward's tiles (256-row blocks, strips of
# 512 bytes of a row): one block exactly, one row and one column more (N 257
# is no multiple of the vector: the element-by-element walk), an embed-length
# K, one bf16 strip exactly, a ragged leaf of three blocks
COL_ROUTE_SHAPES = [(2, 256, 256), (2, 257, 257), (151552, 72), (3, 512, 128), (513, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fake_quant_col_route_boundaries_bitwise(sm90, dtype):
    """Forward, scales and STE bit for bit the plain versions at each tile
    boundary, bits cycling through 1-8, 16 and 32 over the layers from
    three offsets, with a bank of (L,) bits in the same call."""
    from repro_torch.kernels.fake_quant import fake_quant_col_plan

    gen = torch.Generator(device=sm90).manual_seed(41)
    ws = [torch.randn(s, generator=gen, device=sm90).to(dtype) for s in COL_ROUTE_SHAPES]
    plan = fake_quant_col_plan([w.shape for w in ws], dtype)
    assert plan.splits == (1, 2, 592, 2, 3)
    for seed in range(3):
        assert _col_check(ws, sm90, seed) == (1, 1)
    bank = torch.randn((3, 4, 1408, 72), generator=gen, device=sm90).to(dtype)
    leaves = ws + [bank]
    for offset in range(2):
        bits = _col_bits(ws, sm90, offset) + [
            torch.tensor([FQ_GROUP_BITS[(offset + l) % 10] for l in range(3)],
                         dtype=torch.int32, device=sm90)]
        outs, scales = ops.fake_quant_group_col(leaves, bits)
        torch.cuda.synchronize()
        want, want_s = tref.fake_quant_group_col_ref(leaves, bits)
        for i in range(len(leaves)):
            assert _same_bits(scales[i], want_s[i]) and _same_bits(outs[i], want[i]), i


def _nan_column_leaves(dtype, dev):
    """Leaves of K 4096 and 4097 (16 and 17 row blocks) whose column 5
    holds NaNs of one payload in four row blocks, and whose column 9 holds
    NaNs of three payloads in three."""
    gen = torch.Generator(device=dev).manual_seed(43)
    ws = [torch.randn((2, K, 72), generator=gen, device=dev).to(dtype) for K in (4096, 4097)]
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    same = 0x7FC1 if dtype == torch.bfloat16 else 0x7FC00011
    payloads = ([0x7F85, 0xFFC3 - 0x10000, 0x7FA0] if dtype == torch.bfloat16 else
                [0x7F800005, 0xFFC0000D - 0x100000000, 0x7FA00000])   # the second signed
    for w in ws:
        bits = w.view(view)                   # written as integers: the payloads kept
        for k in (3, 1100, 2600, 4000):
            bits[1, k, 5] = same
        for k, b in zip((10, 1500, 3900), payloads):
            bits[0, k, 9] = b
    return ws


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fake_quant_col_nan_payloads_in_several_partial_maxima(sm90, dtype):
    """NaNs of one payload in several parts of a column, and of several
    payloads (one with its sign set) in others: the partial maxima meet as
    integer maxima of |w|'s bits, and a NaN scale is written as the plain
    version's abs writes it on the card (f32 0x7fffffff, bf16 0x7fff), so
    forward, scales and STE are bit for bit the plain versions and three
    runs give the same bits.  The grouped forward of the CNN path (row 5)
    writes its NaN scales by the same rule."""
    ws = _nan_column_leaves(dtype, sm90)
    bits = [torch.tensor([4, 8], dtype=torch.int32, device=sm90)] * 2
    gen = torch.Generator(device=sm90).manual_seed(44)
    gs = [torch.randn(w.shape, generator=gen, device=sm90).to(dtype) for w in ws]
    runs = []
    for _ in range(3):
        outs, scales = ops.fake_quant_group_col(ws, bits)
        grads = ops.fake_quant_group_col_bwd(ws, gs, scales)
        torch.cuda.synchronize()
        runs.append((outs, scales, grads))
    for outs, scales, grads in runs[1:]:
        for a, b in zip(outs + scales + grads, runs[0][0] + runs[0][1] + runs[0][2]):
            assert _same_bits(a, b)
    outs, scales, grads = runs[0]
    want, want_s = tref.fake_quant_group_col_ref(ws, bits)
    nan = 0x7FFF0000 if dtype == torch.bfloat16 else 0x7FFFFFFF
    for i in range(2):
        s = scales[i].reshape(2, 72)
        assert int(s[0, 9].view(torch.int32)) == int(s[1, 5].view(torch.int32)) == nan
        assert _same_bits(scales[i], want_s[i]), i
        assert _same_bits(outs[i], want[i]), i
        (g,) = tref.fake_quant_group_col_bwd_ref([ws[i]], [gs[i]], [want_s[i]])
        assert _same_bits(grads[i], g), i
    flat = ws[1][0, 1400:1600].contiguous()              # holds column 9's second NaN
    _, scale = ops.fake_quant_group([flat], torch.tensor([4], dtype=torch.int32, device=sm90))
    _, want_scale = tref.fake_quant_group_ref([flat], [4])
    assert _same_bits(scale, want_scale) and int(scale[0].view(torch.int32)) == nan


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fake_quant_kernel_at_every_resnet20_shape(sm90, dtype):
    """The flat kernel (256-thread blocks, one 16-byte vector a thread) at
    every ResNet-20 weight shape (and 4 bytes past an aligned base: the scalar path), bits 1-8, 16
    and 32, bitwise; at bits 32 a NaN keeps its payload."""
    from repro_torch.cnn.models import build_cnn
    from repro_torch.kernels.fake_quant import fake_quant_cuda
    from repro_torch.quant.wrpn import tensor_scale

    shapes = {tuple(p["w"].shape) for p in build_cnn("resnet20").init(0, device="cpu").values()}
    gen = torch.Generator(device=sm90).manual_seed(45)
    bits_vec = torch.tensor(FQ_GROUP_BITS, dtype=torch.int32, device=sm90)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for shape in sorted(shapes):
        w = torch.randn(shape, generator=gen, device=sm90).to(dtype)
        w.view(view).view(-1)[5] = 0x7F85 if dtype == torch.bfloat16 else 0x7F800005
        w.view(-1)[:2] = torch.tensor([-0.0, 0.0], device=sm90).to(dtype)
        scale = tensor_scale(w[torch.isfinite(w)])
        for x in (w, w.reshape(-1)[2:]):
            for i in range(bits_vec.numel()):
                got = fake_quant_cuda(x, bits_vec[i], scale)
                torch.cuda.synchronize()
                assert _same_bits(got, tref.fake_quant_ref(x, bits_vec[i], scale)), (shape, i)
        assert _same_bits(fake_quant_cuda(w, bits_vec[-1], scale), w)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "hymba-1.5b"])
def test_moe_and_hybrid_qat_step_card_vs_cpu(sm90, arch):
    """chip_smoke.py's phase 4w for one family: a narrow model's QAT step
    (f32, mixed bits) on the card against the CPU, within its stated
    bounds; the MoE model drops choices at capacity."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    r = chip_smoke.family_step_card_vs_cpu(torch, arch)
    assert r["failure"] is None, r
    if arch.startswith("moonshot"):
        assert r["drops"] > 0


# ---- the bit-serial body: tensor cores (bf16 x, and f32 x as three bf16
# terms), split-K with an in-launch combine
@pytest.mark.gpu
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("M", [1, 5, 8, 9, 20, 32])
@pytest.mark.parametrize("K,N", [(4096, 256), (13696, 300), (136, 13), (1000, 4096)])
def test_qmm_bitserial_tensor_cores_match_plain(sm90, K, N, M, bits):
    from repro_torch.kernels.qmm import qmm_cuda

    x, planes, scale = _qmm_inputs(M, K, N, bits, sm90, seed=5 * bits + M)
    got = qmm_cuda(x, planes, scale, bits, "bitserial")
    again = qmm_cuda(x, planes, scale, bits, "bitserial")
    torch.cuda.synchronize()
    assert torch.equal(got, again)       # splits summed in a fixed order
    plain = tref.qmm_ref(x, planes, scale, bits)
    assert (got - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [33, 70])
@pytest.mark.parametrize("K,N", [(4096, 256), (136, 13)])
def test_qmm_bitserial_more_rows_than_a_cta_holds(sm90, K, N, M):
    from repro_torch.kernels.qmm import bitserial_plan, qmm_cuda

    assert bitserial_plan(M, K, N).row_tiles == -(-M // 32) >= 2
    x, planes, scale = _qmm_inputs(M, K, N, 4, sm90, seed=M)
    got = qmm_cuda(x, planes, scale, 4, "bitserial")
    torch.cuda.synchronize()
    plain = tref.qmm_ref(x, planes, scale, 4)
    assert (got - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("x_offset", [0, 1], ids=["x-aligned", "x-unaligned"])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 300)])
def test_qmm_bitserial_unaligned_planes(sm90, K, N, x_offset):
    """Planes whose base is not 16-byte aligned take the plain-load staging;
    an x view off its 16-byte boundary is copied by the wrapper."""
    from repro_torch.kernels.qmm import qmm_cuda

    x, planes, scale = _qmm_inputs(4, K, N, 4, sm90, seed=11)
    buf = torch.empty(planes.numel() + 1, dtype=torch.uint8, device=sm90)
    shifted = buf[1:].view(planes.shape)
    shifted.copy_(planes)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    xbuf = torch.empty(x.numel() + x_offset, dtype=x.dtype, device=sm90)
    xv = xbuf[x_offset:].view(x.shape)
    xv.copy_(x)
    got = qmm_cuda(xv, shifted, scale, 4, "bitserial")
    torch.cuda.synchronize()
    plain = tref.qmm_ref(x, planes, scale, 4)
    assert (got - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 9, 32])
@pytest.mark.parametrize("K,N", [(4096, 256), (136, 13)])
def test_qmm_bitserial_f32_activations_take_the_tensor_cores(sm90, K, N, M):
    from repro_torch.kernels.qmm import qmm_cuda

    x, planes, scale = _qmm_inputs(M, K, N, 4, sm90, seed=M)
    x = x.float() + 1e-3 * torch.randn(x.shape, device=sm90)   # not bf16-representable
    got = qmm_cuda(x, planes, scale, 4, "bitserial")
    torch.cuda.synchronize()
    plain = tref.qmm_ref(x, planes, scale, 4)
    assert (got - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 16, 32])
@pytest.mark.parametrize("K,N,bits", [(4096, 4096, 4), (4096, 256, 4), (4096, 13696, 4),
                                      (13696, 4096, 4), (4096, 151552, 8)])
def test_qmm_bitserial_is_bitwise_repeatable_at_glm4(sm90, K, N, bits, M):
    from repro_torch.kernels.qmm import bitserial_plan, qmm_cuda

    x, planes, scale = _qmm_inputs(M, K, N, bits, sm90, seed=M)
    first = qmm_cuda(x, planes, scale, bits, "bitserial")
    second = qmm_cuda(x, planes, scale, bits, "bitserial")
    torch.cuda.synchronize()
    assert torch.equal(first, second), bitserial_plan(M, K, N, bits)
    plain = tref.qmm_ref(x, planes, scale, bits)
    assert (first - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


# ---- the wgmma dequant body (bf16 x, and f32 x as three bf16 terms), split-K
@pytest.mark.gpu
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("M", [33, 64, 65, 256, 300])
@pytest.mark.parametrize("K,N", [(4096, 256), (13696, 300), (136, 13), (4096, 13696)])
def test_qmm_dequant_tensor_cores_match_plain(sm90, K, N, M, bits):
    from repro_torch.kernels.qmm import qmm_cuda

    x, planes, scale = _qmm_inputs(M, K, N, bits, sm90, seed=3 * bits + M)
    got = qmm_cuda(x, planes, scale, bits, "dequant")
    torch.cuda.synchronize()
    plain = tref.qmm_ref(x, planes, scale, bits)
    assert (got - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [33, 64, 130])
@pytest.mark.parametrize("K,N", [(4096, 256), (136, 13)])
def test_qmm_dequant_f32_activations_take_the_tensor_cores(sm90, K, N, M):
    from repro_torch.kernels.qmm import qmm_cuda

    x, planes, scale = _qmm_inputs(M, K, N, 4, sm90, seed=M)
    x = x.float() + 1e-3 * torch.randn(x.shape, device=sm90)   # not bf16-representable
    got = qmm_cuda(x, planes, scale, 4, "dequant")
    torch.cuda.synchronize()
    plain = tref.qmm_ref(x, planes, scale, 4)
    assert (got - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(64, 4096, 256), (64, 13696, 4096), (300, 4096, 4096),
                                   (64, 136, 13)])
def test_qmm_dequant_is_bitwise_repeatable(sm90, M, K, N):
    from repro_torch.kernels.qmm import dequant_plan, qmm_cuda

    x, planes, scale = _qmm_inputs(M, K, N, 4, sm90, seed=7)
    first = qmm_cuda(x, planes, scale, 4, "dequant")
    second = qmm_cuda(x, planes, scale, 4, "dequant")
    torch.cuda.synchronize()
    assert torch.equal(first, second), dequant_plan(M, K, N)


# ---- f32 x on the tensor cores: the three-term split at its edges
F32_MAX, BF16_MAX_ABOVE = 0x7F7FFFFF, 0xFF7F8000   # f32 max; -(a value above bf16's max)
NAN_QUIET, NAN_LOW_PAYLOAD = 0x7FC00000, 0x7F800001


def _f32_of(bits: int) -> float:
    return float(torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32))


def _f32_edge_case(kind, M, K, N, dev, seed):
    """x (M, K) f32 that bf16 cannot hold, with ``kind``'s values in rows 0
    and M - 1, and packed weights; -> (x, planes, scale, bits, x the
    kernel multiplies: its split summed back)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bits = 2 if kind == "near-max" else 4
    # near-max: at 2 bits the codes u - n lie in {-1, 0, 1}, and a small
    # scale keeps the plain version's x * (code / n * scale) finite too
    w = torch.randn((K, N), generator=gen, device=dev) * (1e-3 if kind == "near-max" else 1.0)
    planes, scale = pack_weight(w, bits)
    x = torch.randn((M, K), generator=gen, device=dev) * (1 + 1e-3)
    k0, k1 = 3, K - 5
    if kind == "nan":
        x[0, k0], x[M - 1, k1] = _f32_of(NAN_QUIET), _f32_of(NAN_LOW_PAYLOAD)
    elif kind == "inf":
        x[0, k0], x[M - 1, k1] = float("inf"), float("-inf")
    elif kind == "near-max":
        x[0, k0], x[M - 1, k1] = _f32_of(F32_MAX), _f32_of(BF16_MAX_ABOVE)
    elif kind == "subnormal-bf16":      # whole rows of bf16 subnormals: k * 2^-133
        for r in (0, M - 1):
            k = torch.randint(-127, 128, (K,), generator=gen, device=dev).float()
            x[r] = k * 2.0 ** -133
    elif kind == "subnormal-f32":       # whole rows of f32 subnormals, any bits
        for r in (0, M - 1):
            raw = torch.randint(-(2 ** 23) + 1, 2 ** 23, (K,), generator=gen, device=dev)
            x[r] = raw.abs().to(torch.int32).view(torch.float32) * raw.sign().float()
    split = sum(t.float() for t in tref.split_bf16x3(x.cpu())).to(dev)
    return x, planes, scale, bits, split


def _plain_f64(x, planes, scale, bits):
    """The plain version's function, x @ dequant(planes), summed in f64 on
    the CPU and rounded once: cuBLAS's f32 sums of subnormal products are
    no yardstick for a row of subnormals."""
    w = tref.dequant_ref(planes.cpu(), scale.cpu(), bits).double()
    return (x.cpu().double() @ w).float().to(x.device)


def _assert_rows_match(got, plain):
    """NaN where the plain version has NaN, the same infinities, and each
    row's finite values within 1e-4 of that row's max|plain|."""
    assert torch.equal(got.isnan(), plain.isnan())
    inf = plain.isinf()
    assert torch.equal(got.isinf(), inf) and torch.equal(got[inf], plain[inf])
    fin = plain.isfinite()
    err = torch.where(fin, (got - plain).abs(), torch.zeros_like(got)).amax(dim=1)
    ref = torch.where(fin, plain.abs(), torch.zeros_like(plain)).amax(dim=1)
    assert bool((err <= 1e-4 * ref).all()), (err / ref.clamp_min(1e-30)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["nan", "inf", "near-max", "subnormal-bf16", "subnormal-f32"])
@pytest.mark.parametrize("path,M", [("bitserial", 1), ("bitserial", 4), ("bitserial", 20),
                                    ("dequant", 64), ("dequant", 256)])
def test_qmm_f32_edge_values_match_plain(sm90, path, M, kind):
    """NaN (a quiet one, and one whose payload lies only in the low 16
    bits), +-inf, values above bf16's largest finite (f32 max), and rows
    of subnormals through the split and the tensor cores, against the
    plain version's function summed in f64.  A row of bf16 subnormals shows the tensor cores keep
    subnormal terms.  An f32 subnormal's bits below 2^-133 are beyond any
    bf16 term: those rows are held against the plain version of the x the
    split keeps (each element's bits from 2^-133 up)."""
    from repro_torch.kernels.qmm import qmm_cuda

    K, N = 2048, 320
    x, planes, scale, bits, split = _f32_edge_case(kind, max(M, 2), K, N, sm90, seed=M)
    x, split = x[:M], split[:M]
    got = qmm_cuda(x, planes, scale, bits, path)
    again = qmm_cuda(x, planes, scale, bits, path)
    torch.cuda.synchronize()
    assert torch.equal(got.nan_to_num(), again.nan_to_num())
    assert torch.equal(got.isnan(), again.isnan())
    plain = _plain_f64(split if kind == "subnormal-f32" else x, planes, scale, bits)
    if kind == "subnormal-bf16":
        assert torch.equal(split, x) and bool((plain[0] != 0).any())
    _assert_rows_match(got, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("path,M", [("bitserial", 1), ("bitserial", 4), ("bitserial", 9),
                                    ("bitserial", 20), ("bitserial", 32), ("dequant", 33),
                                    ("dequant", 64), ("dequant", 256), ("dequant", 600)])
@pytest.mark.parametrize("K,N,bits", [(2048, 2048, 4), (2048, 7168, 4), (2048, 13696, 2),
                                      (7168, 2048, 8), (1600, 32001, 3)])
def test_qmm_f32_is_bitwise_repeatable_at_every_plan(sm90, K, N, bits, path, M):
    """f32 x at each plan its shapes give: bit-serial 1-4 warps, 1-16 K
    splits in a cluster, 1-4 row tiles of n8; dequant 64-token tiles of
    one warpgroup, split or not (the combine in split order)."""
    from repro_torch.kernels.qmm import bitserial_plan, dequant_plan, qmm_cuda

    x, planes, scale = _qmm_inputs(M, K, N, bits, sm90, seed=M + bits)
    x = x.float() + 1e-3 * torch.randn(x.shape, device=sm90)
    plan = (bitserial_plan(M, K, N, bits) if path == "bitserial"
            else dequant_plan(M, K, N, bits, f32=True))
    first = qmm_cuda(x, planes, scale, bits, path)
    second = qmm_cuda(x, planes, scale, bits, path)
    torch.cuda.synchronize()
    assert torch.equal(first, second), plan
    plain = tref.qmm_ref(x, planes, scale, bits)
    assert (first - plain).abs().max().item() <= 1e-4 * plain.abs().max().item(), plan


def test_qmm_f32_repeatability_cases_cover_the_dequant_plans():
    """The cases above reach every kind of f32 dequant plan (CPU only)."""
    from repro_torch.kernels.qmm import dequant_plan

    seen = {(p.kgroups, p.splits > 1) for p in
            (dequant_plan(M, K, N, b, f32=True) for M in (33, 64, 256, 600)
             for K, N, b in [(2048, 2048, 4), (2048, 7168, 4), (2048, 13696, 2),
                             (7168, 2048, 8), (1600, 32001, 3)])}
    assert {(1, False), (1, True)} <= seen


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["plain", "nan", "inf", "subnormal-bf16"])
@pytest.mark.parametrize("B", [1, 4, 20])
def test_fused_projection_f32_takes_the_tensor_cores(sm90, B, kind):
    """Launch (A) at act_dtype f32 (x split into three bf16 terms), at
    glm4-9b's q|k|v shapes and three bit widths: finished partials against
    the plain projections row by row, edge values included, and bitwise
    repeatable."""
    from repro_torch.kernels.fused_decode import fused_project_cuda

    x, ws, _, H, KV = _fused_case(sm90, 4, [0] * B, 1, bits=(4, 3, 8), B=B, seed=B)
    D = x.shape[1]
    edge = _f32_edge_case(kind, max(B, 2), D, 8, sm90, seed=B)[0][:B]
    x = edge if kind != "plain" else x.float() + 1e-3 * torch.randn(x.shape, device=sm90)
    partials = fused_project_cuda(x, *ws, H, KV)
    again = fused_project_cuda(x, *ws, H, KV)
    torch.cuda.synchronize()
    assert torch.equal(partials.nan_to_num(), again.nan_to_num())
    got = tref.finish_projection(partials, *ws)
    plain = torch.cat([_plain_f64(x, w.planes, w.scale, w.bits) for w in ws], dim=1)
    _assert_rows_match(got, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_fused_decode_f32_matches_its_launches_alone(sm90, kv_bits):
    """The whole fused decode at f32 activations: (A) on the tensor cores,
    its split partials finished in (B)'s prologue, equal bit for bit to
    (A) alone finished by the plain twin and fed to (B) at f32."""
    from repro_torch.kernels.fused_decode import (fused_attend_cuda, fused_project_cuda,
                                                  fused_qkv_paged_decode_cuda, project_plan)

    B = 4
    x, ws, args, H, KV = _fused_case(sm90, kv_bits, [41, 58, 73, 96], 7, B=B, seed=3)
    x = x.float() + 1e-3 * torch.randn(x.shape, device=sm90)
    assert project_plan(B, x.shape[1], [w.scale.numel() for w in ws]).splits > 1
    whole = fused_qkv_paged_decode_cuda(x, *ws, *args, H)
    proj = tref.finish_projection(fused_project_cuda(x, *ws, H, KV), *ws)
    staged = fused_attend_cuda(proj, torch.float32, *args, H)
    torch.cuda.synchronize()
    for a, b in zip(whole, staged):      # out, codes and scales
        assert torch.equal(a, b)
    plain = torch.cat([tref.qmm_ref(x, w.planes, w.scale, w.bits) for w in ws], dim=1)
    assert (proj - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


# ---- split-KV fp paged attention
def _paged_case(dev, B, KV, G, hd, bs, nb, lengths, dtype, seed):
    NB = B * nb + 1
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, KV, G, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((NB, bs, KV, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((NB, bs, KV, hd), generator=gen, device=dev).to(dtype)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(NB - 1) + 1)
    bt = perm[:B * nb].reshape(B, nb).to(dev, torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, ln


def _check_paged(q, kp, vp, bt, ln):
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    B, KV, G, hd = q.shape
    got = paged_attention_cuda(q, kp, vp, bt, ln)
    again = paged_attention_cuda(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    assert torch.equal(got, again)       # split order fixed: bitwise repeatable
    got = got.reshape(B, 1, KV * G, hd)
    plain = tref.paged_attention_ref(q.reshape(B, 1, KV * G, hd).float(), kp.float(),
                                     vp.float(), bt, ln)
    live = ln > 0
    if live.any():
        err = (got[live] - plain[live]).abs().max().item()
        assert err <= 1e-4 * plain[live].abs().max().item()
    assert not got[~live].any()          # a dead row is exact zeros


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("lengths,nb", [
    ([16, 32, 48, 96], 6),        # every row ends on a page (= split) boundary
    ([0, 1, 33, 96], 6),          # a dead row; a token past a 32-token tile
    ([5, 0, 17, 40], 64),         # table far wider than any row: many empty splits
    ([512, 511, 257, 1], 40),     # 3 pages per split: ends on and off split edges
], ids=["page-ends", "dead-row", "wide-table", "multi-page-splits"])
def test_paged_attention_split_kv_matches_plain(sm90, lengths, nb, dtype):
    case = _paged_case(sm90, 4, 2, 16, 128, 16, nb, lengths, dtype, seed=sum(lengths) + nb)
    _check_paged(*case)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 16, 128])
@pytest.mark.parametrize("hd", [16, 64, 96, 120, 128])
def test_paged_attention_head_dims_and_groups(sm90, hd, G):
    case = _paged_case(sm90, 3, 2, G, hd, 16, 9, [0, 70, 144], torch.bfloat16, seed=hd + G)
    _check_paged(*case)


@pytest.mark.gpu
def test_paged_attention_launches_more_ctas_than_rows_times_heads(sm90):
    from repro_torch.kernels.paged_attention import split_plan

    nb = -(-96 // 16)                    # the served cells' main lengths, block 16
    _, splits = split_plan(nb)
    assert splits > 1
    case = _paged_case(sm90, 4, 2, 16, 128, 16, nb, [41, 58, 73, 96], torch.bfloat16, seed=9)
    _check_paged(*case)


# ---- split-KV quantized paged attention (int8 codes, packed int4)
def _quant_case(dev, B, KV, G, hd, bs, nb, lengths, kv_bits, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    NB, bt, ln = _tables(B, nb, lengths, dev)
    kc, vc, ks, vs, _ = _quant_pool(NB, bs, KV, hd, kv_bits, gen, dev)
    q = torch.randn((B, KV, G, hd), generator=gen, device=dev).to(torch.bfloat16)
    return q, kc, vc, ks, vs, bt, ln


def _check_paged_quant(q, kc, vc, ks, vs, bt, ln):
    from repro_torch.kernels.paged_attention_quant import paged_attention_quant_cuda

    B, KV, G, hd = q.shape
    got = paged_attention_quant_cuda(q, kc, vc, ks, vs, bt, ln)
    again = paged_attention_quant_cuda(q, kc, vc, ks, vs, bt, ln)
    torch.cuda.synchronize()
    assert torch.equal(got, again)       # split order fixed: bitwise repeatable
    got = got.reshape(B, 1, KV * G, hd)
    plain = tref.quant_paged_attention_ref(q.reshape(B, 1, KV * G, hd).float(), kc, vc, ks, vs,
                                           bt, ln)
    live = ln > 0
    if live.any():
        err = (got[live] - plain[live]).abs().max().item()
        assert err <= 1e-4 * plain[live].abs().max().item()
    assert not got[~live].any()          # a dead row is exact zeros


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("lengths,nb", [
    ([16, 32, 48, 96], 6),        # every row ends on a page (= split) boundary
    ([0, 1, 33, 96], 6),          # a dead row; a token past a 32-token tile
    ([5, 0, 17, 40], 64),         # table far wider than any row: many empty splits
    ([512, 511, 257, 1], 40),     # 3 pages per split: ends on and off split edges
], ids=["page-ends", "dead-row", "wide-table", "multi-page-splits"])
def test_paged_attention_quant_split_kv_matches_plain(sm90, lengths, nb, kv_bits):
    case = _quant_case(sm90, 4, 2, 16, 128, 16, nb, lengths, kv_bits, seed=sum(lengths) + nb)
    _check_paged_quant(*case)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("G", [1, 16, 128])
@pytest.mark.parametrize("hd", [16, 64, 96, 120, 128])
def test_paged_attention_quant_head_dims_and_groups(sm90, hd, G, kv_bits):
    # a table of 20 pages: wider than 16, so splits hold 2 pages
    case = _quant_case(sm90, 3, 2, G, hd, 16, 20, [0, 70, 300], kv_bits, seed=hd + G + kv_bits)
    _check_paged_quant(*case)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_paged_attention_quant_launches_more_ctas_than_rows_times_heads(sm90, kv_bits):
    from repro_torch.kernels.paged_attention import split_plan

    nb = -(-96 // 16)                    # the served cells' main lengths, block 16
    _, splits = split_plan(nb)
    assert splits > 1
    case = _quant_case(sm90, 4, 2, 16, 128, 16, nb, [41, 58, 73, 96], kv_bits, seed=9)
    _check_paged_quant(*case)


# ---- the fused decode's split-K projection and split-KV attend launch
def _fused_case(dev, kv_bits, lengths, nb, bits=(4, 4, 4), B=4, seed=5,
                shape=(2, 16, 128, 16, 4096)):
    """(x, [wq, wk, wv], attend args, H, KV) at ``shape`` = (KV, G, hd, bs,
    D): glm4-9b's by default."""
    from repro_torch.models.common import rope_cos_sin
    from repro_torch.quant.pack import Packed

    KV, G, hd, bs, D = shape
    H = KV * G
    gen = torch.Generator(device=dev).manual_seed(seed)
    NB, bt, ln = _tables(B, nb, lengths, dev)
    kc, vc, ks, vs, qmax = _quant_pool(NB, bs, KV, hd, kv_bits, gen, dev)
    ws = []
    for n, b in zip((H * hd, KV * hd, KV * hd), bits):
        planes, scale = pack_weight(torch.randn((D, n), generator=gen, device=dev) * D ** -0.5, b)
        ws.append(Packed(planes, scale, b))
    x = torch.randn((B, D), generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = rope_cos_sin(ln, hd, 1e4)
    return x, ws, (kc, vc, ks, vs, bt, ln, cos, sin, torch.tensor(qmax, device=dev)), H, KV


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_fused_decode_is_bitwise_repeatable(sm90, kv_bits):
    from repro_torch.kernels.fused_decode import fused_qkv_paged_decode_cuda

    x, ws, args, H, _ = _fused_case(sm90, kv_bits, [41, 58, 73, 96], 7)
    first = fused_qkv_paged_decode_cuda(x, *ws, *args, H)
    second = fused_qkv_paged_decode_cuda(x, *ws, *args, H)
    torch.cuda.synchronize()
    for a, b in zip(first, second):      # out, codes and scales
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("splits", [1, 2, 3, 8, 32, None],
                         ids=["s1", "s2", "s3", "s8", "s32", "plan"])
@pytest.mark.parametrize("B", [1, 4, 8, 33])
def test_fused_projection_split_k_matches_plain(sm90, B, splits, act):
    """Launch (A)'s raw partials (dequant form, one set per K split),
    finished by the plain twin of (B)'s prologue, against the plain
    projections; bf16 x and f32 x (three bf16 terms) take the tensor cores."""
    from repro_torch.kernels.fused_decode import fused_project_cuda

    x, ws, _, H, KV = _fused_case(sm90, 4, [0] * B, 1, bits=(4, 3, 8), B=B)
    if act == torch.float32:
        x = x.float() + 1e-3 * torch.randn(x.shape, device=sm90)
    partials = fused_project_cuda(x, *ws, H, KV, splits)
    again = fused_project_cuda(x, *ws, H, KV, splits)
    torch.cuda.synchronize()
    assert torch.equal(partials, again)
    got = tref.finish_projection(partials, *ws)
    plain = torch.cat([tref.qmm_ref(x, w.planes, w.scale, w.bits) for w in ws], dim=1)
    assert (got - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("B,lengths,nb,bits", [
    (4, [41, 58, 73, 96], 7, (4, 4, 4)),                  # the main lengths
    (8, [0, 3, 16, 17, 40, 63, 90, 111], 8, (4, 3, 8)),   # three bit widths: three n's
    (1, [17], 2, (2, 5, 4)),
], ids=["main", "mixed-bits", "one-row"])
def test_fused_decode_matches_its_launches_alone(sm90, kv_bits, B, lengths, nb, bits):
    """The whole op finishes (A)'s split partials in (B)'s prologue; run
    alone, (A)'s partials finished by the plain twin and fed to (B) as
    finished projections must give the same out, codes and scales."""
    from repro_torch.kernels.fused_decode import (fused_attend_cuda, fused_project_cuda,
                                                  fused_qkv_paged_decode_cuda, project_plan)

    x, ws, args, H, KV = _fused_case(sm90, kv_bits, lengths, nb, bits=bits, B=B, seed=B)
    assert project_plan(B, x.shape[1], [w.scale.numel() for w in ws]).splits > 1
    whole = fused_qkv_paged_decode_cuda(x, *ws, *args, H)
    proj = tref.finish_projection(fused_project_cuda(x, *ws, H, KV), *ws)
    staged = fused_attend_cuda(proj, torch.bfloat16, *args, H)
    torch.cuda.synchronize()
    for a, b in zip(whole, staged):      # out, codes and scales
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("lengths,nb", [
    ([0, 16, 47, 95], 6),         # a new row; ends on a page edge; the new token fills a page
    ([0, 5, 17, 40], 64),         # a table far wider than any row: 2 pages per split
    ([479, 300, 257, 1], 40),     # 3 pages per split
], ids=["page-ends", "wide-table", "multi-page-splits"])
def test_fused_attend_split_kv_matches_plain(sm90, lengths, nb, kv_bits):
    from repro_torch.kernels.fused_decode import fused_attend_cuda

    x, ws, args, H, KV = _fused_case(sm90, kv_bits, lengths, nb, seed=nb)
    proj = torch.cat([tref.qmm_ref(x, w.planes, w.scale, w.bits) for w in ws], dim=1)
    got = fused_attend_cuda(proj, torch.bfloat16, *args, H)
    again = fused_attend_cuda(proj, torch.bfloat16, *args, H)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    plain = tref.fused_decode_attend_ref(proj, *args, H, KV, torch.bfloat16)
    for g, p in zip(got[1:], plain[1:]):     # codes and scales: bitwise
        assert torch.equal(g, p)
    B, hd = x.shape[0], proj.shape[1] // (H + 2 * KV)
    # the plain version rounds its output to bf16: 1e-2 * max|plain|
    og, op = got[0].reshape(B, 1, H, hd), plain[0].float()
    assert (og - op).abs().max().item() <= 1e-2 * op.abs().max().item()


# ---------------------------------------------------------------------------
# the one-token hotpath: the captured decode step, the graphed sampler and
# the pipelined engine (the small model of chip_smoke.py's phase 4)
# ---------------------------------------------------------------------------


def boundary_flagged(row, sp, u) -> bool:
    """Does ``u * total`` lie within 4·V ulps of a boundary of the warped
    row's CDF, where an f32 sum taken in another order may land elsewhere?
    (The sampled-token rule of the CPU tests too.)"""
    from repro_torch.serve.request import warp_probs

    cdf = np.cumsum(warp_probs(row, sp))
    x = float(u) * cdf[-1]
    ulp = float(np.spacing(np.float32(cdf[-1])))
    return bool(np.min(np.abs(cdf - x)) <= 4 * row.size * ulp)


def _small_served(bits, dev):
    """chip_smoke.py's small model (2 layers, d_model 256, head dim 128,
    vocab 1000), its serving params at ``bits`` on ``dev``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.quant.qat import policy_for
    from repro_torch.train.serve import quantize_for_serving

    cfg = dataclasses.replace(get_config("glm4-9b", smoke=True), num_layers=2, d_model=256,
                              num_heads=4, num_kv_heads=2, head_dim=128, d_ff=688,
                              vocab_size=1000)
    sm = build_model(cfg)
    params = sm.init(seed=5, device="cpu")
    return sm, quantize_for_serving(sm, params, policy_for(sm, bits), device=dev)


HOTPATH_CELLS = [(4, None), (4, 4), (16, 8)]
HOTPATH_IDS = ["fp", "int4-fused", "int8-dense-qkv"]


@pytest.mark.gpu
@pytest.mark.parametrize("bits,kv_bits", HOTPATH_CELLS, ids=HOTPATH_IDS)
def test_graphed_decode_step_equals_eager_bitwise(sm90, bits, kv_bits):
    """Twin pools fed the same prefills and tokens: the captured step's
    logits, every pool byte and ``length`` equal the eager step's over six
    replays, one after a block-table change (a row crosses a block edge)
    and two after an admission between replays.  Each replay counts the
    launches of one eager step, and nothing is captured again."""
    from repro_torch.serve.cache import PagedCachePool
    from repro_torch.train.serve import GraphedDecodeStep

    sm, sp = _small_served(bits, sm90)
    pools = [PagedCachePool(sm, 4, 64, block_size=16, device=sm90, kv_bits=kv_bits)
             for _ in range(2)]
    graphed = GraphedDecodeStep(sm)
    rng = np.random.default_rng(3)
    lengths = {}

    def admit(n):
        toks = torch.from_numpy(rng.integers(0, 1000, (1, 16)).astype(np.int32))
        seq = None
        for pool in pools:
            seq = pool.alloc_seq()
            pool.ensure(seq, n + 1)
            for lo in range(0, n, 16):
                _, cache = sm.prefill_chunk(sp, pool.step_cache(), toks.to(sm90),
                                            seq, lo, min(16, n - lo))
                pool.accept(cache)
        lengths[seq] = n

    def step(i):
        for seq in lengths:
            for pool in pools:
                assert pool.ensure(seq, lengths[seq] + 1)
        feed = torch.from_numpy(rng.integers(0, 1000, (4, 1)).astype(np.int32)).to(sm90)
        counts = []
        outs = []
        for pool, fn in zip(pools, (sm.decode_step, graphed)):
            ops.reset_counts()
            logits, cache = fn(sp, pool.step_cache(), feed)
            pool.accept(cache)
            torch.cuda.synchronize()
            counts.append(dict(ops.counts))
            outs.append(logits.clone())
        assert torch.equal(outs[0], outs[1]), f"replay {i}: logits differ"
        for key, leaf in pools[0].cache.items():
            assert torch.equal(leaf, pools[1].cache[key]), f"replay {i}: {key} differs"
        if i > 0:      # the first call also ran the warm-up step eagerly
            assert counts[0] == counts[1] and counts[0]["plain"] == 0, counts
        for seq in lengths:
            lengths[seq] += 1

    admit(37)
    admit(15)                 # crosses into its second block at the second step
    for i in range(3):
        step(i)
    admit(20)                 # an admission between replays
    for i in range(3, 6):
        step(i)
    assert (graphed.captures, graphed.recaptures) == (1, 0)


def _sampler_case(dev, B, V, seed, greedy_every=4):
    from repro_torch.serve.request import Request, SamplingParams
    from repro_torch.serve.sampler import row_arrays

    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    logits[::5, :3] = logits[::5].max(-1, keepdims=True)   # ties at the max
    grid = [(t, k, p) for t in (0.5, 0.9, 1.7) for k in (0, 5, 50) for p in (1.0, 0.9)]
    reqs, sps = [], []
    for i in range(B):
        t, k, p = grid[i % len(grid)]
        sp = SamplingParams(0.0 if i % greedy_every == 0 else t, k, p,
                            int(rng.integers(0, 2 ** 32)))
        reqs.append((i, Request(int(rng.integers(0, 2 ** 31)), [1], 8, sp)))
        sps.append(sp)
    temps, top_ks, top_ps, seeds, rids = row_arrays(B, reqs)
    pos = rng.integers(0, 4096, B).astype(np.int32)
    args = [torch.from_numpy(a) for a in (logits, temps, top_ks, top_ps,
                                          seeds.astype(np.int64), rids, pos)]
    return args, sps


@pytest.mark.gpu
def test_graphed_sampler_equals_the_cpu(sm90):
    """The sampler graph on the card against the plain sampler on the CPU:
    greedy rows and the uniforms bitwise, sampled tokens equal except at a
    flagged CDF boundary; the greedy graph equals the argmax; one capture
    per shape."""
    from repro_torch.serve import sampler as tsampler

    flagged = draws = 0
    for seed in range(4):
        args, sps = _sampler_case(sm90, 64, 4099, seed)
        want = tsampler.sample_rows(*args)
        got = tsampler.sample_rows(*(a.to(sm90) for a in args)).cpu()
        u_cpu = tsampler.uniform(*args[4:])
        u_card = tsampler.uniform(*(a.to(sm90) for a in args[4:])).cpu()
        assert torch.equal(u_cpu.view(torch.int32), u_card.view(torch.int32))
        greedy = args[1] <= 0
        assert torch.equal(got[greedy], want[greedy])
        assert torch.equal(tsampler.greedy_rows(args[0].to(sm90)).cpu(),
                           tsampler.greedy_rows(args[0]))
        for i in torch.nonzero(got != want)[:, 0].tolist():
            assert boundary_flagged(args[0][i].numpy(), sps[i], u_cpu[i].item()), (
                f"row {i}: card drew {got[i]}, CPU {want[i]}, away from any CDF boundary")
            flagged += 1
        draws += int((~greedy).sum())
    print(f"graphed sampler: {draws} sampled draws, {flagged} at a flagged CDF boundary")
    assert flagged <= 0.01 * draws


@pytest.mark.gpu
def test_graphed_sampler_chi_square(sm90):
    from repro_torch.serve import sampler as tsampler
    from repro_torch.serve.request import Request, SamplingParams, warp_probs

    sp = SamplingParams(temperature=1.0, top_k=0, top_p=0.8, seed=11)
    rng = np.random.default_rng(7)
    row = (rng.normal(size=(12,)) * 1.5).astype(np.float32)
    p = warp_probs(row, sp)
    N = 4000
    arrs = tsampler.row_arrays(N, [(i, Request(3, [1], 8, sp)) for i in range(N)])
    draws = tsampler.sample_rows(
        torch.from_numpy(np.broadcast_to(row, (N, row.size)).copy()).to(sm90),
        *(torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a).to(sm90)
          for a in arrs),
        torch.arange(N, dtype=torch.int32, device=sm90)).cpu().numpy()
    counts = np.bincount(draws, minlength=row.size)
    live = p > 1e-12
    assert counts[~live].sum() == 0, "drew a nucleus-masked token"
    exp = p[live] * N
    chi2 = float(((counts[live] - exp) ** 2 / exp).sum())
    assert chi2 < 31.3, (chi2, counts, p)      # p = 0.001 critical value, df <= 11


@pytest.mark.gpu
@pytest.mark.parametrize("bits,kv_bits", HOTPATH_CELLS, ids=HOTPATH_IDS)
def test_pipelined_graphed_engine_equals_eager_host_sampling(sm90, bits, kv_bits):
    """The engine's defaults on the card (captured decode step, device
    sampling, lookahead) against the eager step with host sampling: the
    same greedy streams bitwise, every decode step a lookahead or a bubble,
    one decode capture and no re-capture."""
    from repro_torch.serve import ServeEngine

    sm, sp = _small_served(bits, sm90)
    rng = np.random.default_rng(9)
    work = [(rng.integers(0, 1000, int(n)), 20) for n in (9, 40, 17, 31, 24, 16)]
    runs = {}
    for name, kw in (("eager host", {"decode_fn": sm.decode_step, "sample_device": False,
                                     "pipeline": False}),
                     ("graphed pipeline", {})):
        eng = ServeEngine(sm, sp, num_slots=4, max_len=64, block_size=16, prefill_chunk=16,
                          device=sm90, kv_bits=kv_bits, **kw)
        for prompt, n in work:
            eng.submit(prompt, n)
        ops.reset_counts()
        eng.run_until_drained()
        torch.cuda.synchronize()
        assert ops.counts["plain"] == 0 and ops.counts["qmm_bitserial"] > 0
        runs[name] = ([eng.output(r) for r in range(len(work))], eng.metrics(),
                      eng.graph_captures)
    assert runs["graphed pipeline"][0] == runs["eager host"][0]
    m, captures = runs["graphed pipeline"][1], runs["graphed pipeline"][2]
    pl = m["pipeline"]
    assert pl["lookahead_steps"] > 0
    assert pl["lookahead_steps"] + pl["bubbles"] == m["decode_steps"]
    assert m["recompiles"] == 0 and captures["decode"] == 1


# ---------------------------------------------------------------------------
# prefix caching and speculative decoding on the card (the small model)
# ---------------------------------------------------------------------------


def _aliased_tables(dev, B, nb, lengths, seed):
    """Block tables in which rows 0 and 1 map the same physical blocks for
    their first 9 pages (144 tokens), and rows 2 and 3 their first 7, as
    two tenants' shared prompt prefixes map them."""
    NB = B * nb + 1
    perm = np.random.default_rng(seed).permutation(NB - 1) + 1
    bt = perm[:B * nb].reshape(B, nb).copy()
    bt[1, :9] = bt[0, :9]
    bt[3, :7] = bt[2, :7]
    return (NB, torch.from_numpy(bt).to(dev, torch.int32),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


ALIASED = [150, 231, 300, 190]         # past the served cells' 97, every row shares


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_paged_attention_aliased_prefix_blocks_match_plain(sm90, dtype):
    B, KV, G, hd, bs, nb = 4, 2, 16, 128, 16, 19
    NB, bt, ln = _aliased_tables(sm90, B, nb, ALIASED, 1)
    gen = torch.Generator(device=sm90).manual_seed(11)
    q = torch.randn((B, KV, G, hd), generator=gen, device=sm90).to(dtype)
    kp = torch.randn((NB, bs, KV, hd), generator=gen, device=sm90).to(dtype)
    vp = torch.randn((NB, bs, KV, hd), generator=gen, device=sm90).to(dtype)
    _check_paged(q, kp, vp, bt, ln)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_paged_attention_quant_aliased_prefix_blocks_match_plain(sm90, kv_bits):
    B, KV, G, hd, bs, nb = 4, 2, 16, 128, 16, 19
    NB, bt, ln = _aliased_tables(sm90, B, nb, ALIASED, 2)
    gen = torch.Generator(device=sm90).manual_seed(12)
    kc, vc, ks, vs, _ = _quant_pool(NB, bs, KV, hd, kv_bits, gen, sm90)
    q = torch.randn((B, KV, G, hd), generator=gen, device=sm90).to(torch.bfloat16)
    _check_paged_quant(q, kc, vc, ks, vs, bt, ln)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_fused_attend_aliased_prefix_blocks_match_plain(sm90, kv_bits):
    """The fused decode's attend launch over rows that share prefix
    blocks: codes and scales bitwise, output within its bound."""
    from repro_torch.kernels.fused_decode import fused_attend_cuda

    x, ws, args, H, KV = _fused_case(sm90, kv_bits, ALIASED, 19, seed=13)
    _, bt, ln = _aliased_tables(sm90, 4, 19, ALIASED, 3)
    args = (*args[:4], bt, ln, *args[6:])
    proj = torch.cat([tref.qmm_ref(x, w.planes, w.scale, w.bits) for w in ws], dim=1)
    got = fused_attend_cuda(proj, torch.bfloat16, *args, H)
    torch.cuda.synchronize()
    plain = tref.fused_decode_attend_ref(proj, *args, H, KV, torch.bfloat16)
    for g, p in zip(got[1:], plain[1:]):
        assert torch.equal(g, p)
    og, op = got[0].reshape(4, 1, H, -1), plain[0].float()
    assert (og - op).abs().max().item() <= 1e-2 * op.abs().max().item()


def _shared_pools(sm, sp, dev, kv_bits, n=2):
    """``n`` pools fed alike: row 0 prefills a 40-token prompt and
    publishes its two full blocks; row 1 maps them (a hit of 32 tokens)
    and prefills its own 8-token tail; row 2 repeats the first 32 tokens
    exactly (an aligned full hit: its last shared block is copied at
    admission).  Returns the pools and the rows' lengths."""
    from repro_torch.serve.cache import PagedCachePool

    rng = np.random.default_rng(21)
    head = rng.integers(0, 1000, 32)
    prompts = [np.concatenate([head, rng.integers(0, 1000, 8)]),
               np.concatenate([head, rng.integers(0, 1000, 8)]), head]
    pools = [PagedCachePool(sm, 4, 80, block_size=16, device=dev, kv_bits=kv_bits)
             for _ in range(n)]
    for pool in pools:
        for prompt in prompts:
            seq = pool.alloc_seq()
            hit = pool.map_shared(seq, prompt)
            assert pool.ensure(seq, len(prompt) + 1)
            for lo in range(hit, len(prompt), 16):
                valid = min(16, len(prompt) - lo)
                buf = np.zeros((1, 16), np.int32)
                buf[0, :valid] = prompt[lo:lo + valid]
                _, cache = sm.prefill_chunk(sp, pool.step_cache(),
                                            torch.from_numpy(buf).to(dev), seq, lo, valid)
                pool.accept(cache)
            pool.record_tokens(seq, prompt)
    assert pools[0].prefix_hits == 2 and pools[0].cow_copies == 1
    return pools, {s: len(p) for s, p in enumerate(prompts)}


@pytest.mark.gpu
@pytest.mark.parametrize("bits,kv_bits", HOTPATH_CELLS, ids=HOTPATH_IDS)
def test_cow_block_bitwise_and_no_recapture(sm90, bits, kv_bits):
    """On the card: the admission copy of a shared block equals its
    source in every paged leaf (fp, packed int4 with its scales, int8),
    the leaves keep their addresses, and a decode step captured before a
    later copy is not captured again; its logits and every pool byte equal
    the eager step's on a twin pool at each step."""
    from repro_torch.train.serve import GraphedDecodeStep

    sm, sp = _small_served(bits, sm90)
    (eager_pool, pool), lengths = _shared_pools(sm, sp, sm90, kv_bits)
    src, dst = pool._seq_blocks[0][1], pool._seq_blocks[2][1]
    assert src != dst and pool._seq_blocks[1][:2] == pool._seq_blocks[0][:2]
    for key in pool.paged_keys:
        leaf = pool.cache[key]
        assert torch.equal(leaf[:, dst].view(torch.uint8), leaf[:, src].view(torch.uint8)), key
    graphed = GraphedDecodeStep(sm)
    ptrs = {k: v.data_ptr() for k, v in pool.cache.items() if k != "length"}
    rng = np.random.default_rng(5)
    for i in range(4):
        if i == 2:        # a later admission that copies again between replays
            for p in (eager_pool, pool):
                seq = p.alloc_seq()
                p.map_shared(seq, p._seq_tokens[2])
                assert p.ensure(seq, 33) and p.cow_copies == 2
            lengths[3] = 32
        for p in (eager_pool, pool):
            for seq, n in lengths.items():
                assert p.ensure(seq, n + 1) and p.cow_for_write(seq, n)
        feed = torch.from_numpy(rng.integers(0, 1000, (4, 1)).astype(np.int32)).to(sm90)
        outs = []
        for p, fn in ((eager_pool, sm.decode_step), (pool, graphed)):
            cache = p.step_cache()
            cache["length"] = torch.tensor([lengths.get(s, 0) for s in range(4)],
                                           dtype=torch.int32, device=sm90)
            logits, cache = fn(sp, cache, feed)
            p.accept(cache)
            outs.append(logits.clone())
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]), f"step {i}"
        for key, leaf in eager_pool.cache.items():
            assert torch.equal(leaf, pool.cache[key]), f"step {i}: {key}"
        lengths = {s: n + 1 for s, n in lengths.items()}
    assert (graphed.captures, graphed.recaptures) == (1, 0)
    assert {k: v.data_ptr() for k, v in pool.cache.items() if k != "length"} == ptrs


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_fused_decode_writes_only_the_private_last_block(sm90, kv_bits):
    """A fused decode step over rows that share prefix blocks changes, in
    every paged leaf, only each live row's private write block and the
    garbage block 0 (the dead row's sink): the shared blocks stay as they
    were."""
    sm, sp = _small_served(4, sm90)
    (pool,), lengths = _shared_pools(sm, sp, sm90, kv_bits, n=1)
    for seq, n in lengths.items():
        assert pool.ensure(seq, n + 1) and pool.cow_for_write(seq, n)
    before = {k: pool.cache[k].clone() for k in pool.paged_keys}
    cache = pool.step_cache()
    cache["length"] = torch.tensor([lengths.get(s, 0) for s in range(4)], dtype=torch.int32,
                                   device=sm90)
    ops.reset_counts()
    _, cache = sm.decode_step(sp, cache, torch.ones((4, 1), dtype=torch.int32, device=sm90))
    pool.accept(cache)
    torch.cuda.synchronize()
    assert ops.counts["fused_qkv_paged_decode"] == sm.cfg.num_layers
    own = {pool._seq_blocks[s][n // 16] for s, n in lengths.items()}
    shared = {b for b, c in pool._refcount.items() if c > 1}
    assert shared and not (own & shared)
    for key in pool.paged_keys:
        leaf = pool.cache[key]
        changed = {b for b in range(pool.num_blocks)
                   if not torch.equal(leaf[:, b], before[key][:, b])}
        assert changed <= own | {0} and own <= changed, (key, changed, own)


@pytest.mark.gpu
@pytest.mark.parametrize("bits,kv_bits", HOTPATH_CELLS[:2], ids=HOTPATH_IDS[:2])
def test_spec_engine_graphs_equal_eager(sm90, bits, kv_bits):
    """Speculative decoding on the card (k = 4, 2-bit self-draft): the
    target's and the draft's captured decode steps each capture once and
    never again, and the greedy streams equal the same run through the
    eager ``model.decode_step``, with the same window counts."""
    from repro_torch.serve import ServeEngine
    from repro_torch.spec import SpecConfig

    sm, sp = _small_served(bits, sm90)
    rng = np.random.default_rng(9)
    work = [(rng.integers(0, 1000, int(n)), 20) for n in (9, 40, 17, 31, 24, 16)]
    runs = {}
    for name, kw in (("eager", {"decode_fn": sm.decode_step}), ("graphed", {})):
        eng = ServeEngine(sm, sp, num_slots=4, max_len=64, block_size=16, prefill_chunk=16,
                          device=sm90, kv_bits=kv_bits,
                          spec=SpecConfig(k=4, draft_bits=2), **kw)
        for prompt, n in work:
            eng.submit(prompt, n)
        ops.reset_counts()
        eng.run_until_drained()
        torch.cuda.synchronize()
        assert ops.counts["plain"] == 0 and ops.counts["qmm_bitserial"] > 0
        runs[name] = ([eng.output(r) for r in range(len(work))], eng.metrics(),
                      eng.graph_captures)
    assert runs["graphed"][0] == runs["eager"][0]
    m, captures = runs["graphed"][1], runs["graphed"][2]
    assert m["spec"] == runs["eager"][1]["spec"] and m["spec"]["windows"] > 0
    assert m["recompiles"] == 0 and captures["decode"] == 1 and captures["draft"] == 1


# ---------------------------------------------------------------------------
# sliding-window (ring) serving at head dim 120 (h2o-danube-3-4b)
# ---------------------------------------------------------------------------


def _ring_tables(B, nb, lengths, dev, seed=4):
    """Ring block tables: each row a full, shuffled set of nb blocks of its
    own (the newest token sits mid-table once a ring has wrapped)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(B * nb) + 1
    bt = torch.from_numpy(perm.reshape(B, nb)).to(dev, torch.int32)
    return B * nb + 1, bt, torch.tensor(lengths, dtype=torch.int32, device=dev)


RING_LENGTHS = [1, 17, 255, 256]     # min(length + 1, Tc) at a ring of 16 x 16


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_paged_attention_hd120_ring_tables_match_plain(sm90, dtype):
    """Row 2 at h2o-danube's decode head shape (KV 8, G 4, hd 120, bs 16)
    over ring tables: within 1e-4 * max|plain|, bitwise across two calls."""
    NB, bt, ln = _ring_tables(4, 16, RING_LENGTHS, sm90)
    gen = torch.Generator(device=sm90).manual_seed(12)
    q = torch.randn((4, 8, 4, 120), generator=gen, device=sm90).to(dtype)
    kp, vp = (torch.randn((NB, 16, 8, 120), generator=gen, device=sm90).to(dtype)
              for _ in range(2))
    _check_paged(q, kp, vp, bt, ln)


def _offset_view(t, offset: int):
    """A contiguous copy of ``t`` whose data starts ``offset`` bytes past a
    256-byte-aligned allocation."""
    flat = torch.empty(t.numel() * t.element_size() + offset, dtype=torch.uint8, device=t.device)
    view = flat[offset:].view(t.dtype).view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 256 == offset % 256
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 4, 1], ids=["aligned", "4-byte", "1-byte"])
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_paged_attention_quant_hd120_ring_tables_match_plain(sm90, kv_bits, offset):
    """Row 3 at hd 120 over ring tables: int8 rows of 120 bytes (8-byte
    staging pieces) and packed int4 rows of 60 (4-byte pieces), the pools'
    base aligned, 4 bytes past alignment (int8 rows then take byte loads,
    int4 rows stay on cp.async) and 1 byte past (byte loads for both)."""
    NB, bt, ln = _ring_tables(4, 16, RING_LENGTHS, sm90)
    gen = torch.Generator(device=sm90).manual_seed(13 + kv_bits)
    kc, vc, ks, vs, _ = _quant_pool(NB, 16, 8, 120, kv_bits, gen, sm90)
    q = torch.randn((4, 8, 4, 120), generator=gen, device=sm90).to(torch.bfloat16)
    _check_paged_quant(q, _offset_view(kc, offset), _offset_view(vc, offset), ks, vs, bt, ln)


def _small_ring_served(bits, dev, window=64):
    """A narrow windowed model of h2o-danube's head dim (2 layers, d_model
    480, 4 heads over 2 KV heads of 120 dims, window 64), its serving params
    at ``bits`` on ``dev``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.quant.qat import policy_for
    from repro_torch.train.serve import quantize_for_serving

    cfg = dataclasses.replace(get_config("h2o-danube-3-4b", smoke=True), num_layers=2,
                              d_model=480, num_heads=4, num_kv_heads=2, head_dim=120,
                              d_ff=1280, vocab_size=1000, sliding_window=window)
    sm = build_model(cfg)
    params = sm.init(seed=6, device="cpu")
    return sm, quantize_for_serving(sm, params, policy_for(sm, bits), device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [None, 8, 4], ids=["fp", "int8", "int4"])
def test_graphed_ring_decode_step_equals_eager_bitwise(sm90, kv_bits):
    """Twin ring pools (window 64, blocks of 16) fed the same prefills and
    tokens: the captured step's logits, every pool byte and ``length``
    equal the eager step's over replays that wrap both rows past the ring;
    a windowed layer never launches the fused kernel, even with packed
    q/k/v over int4 blocks; one capture."""
    from repro_torch.serve.cache import PagedCachePool
    from repro_torch.train.serve import GraphedDecodeStep

    sm, sp = _small_ring_served(4, sm90)
    pools = [PagedCachePool(sm, 2, 200, block_size=16, device=sm90, kv_bits=kv_bits)
             for _ in range(2)]
    assert pools[0].blocks_per_seq * pools[0].block_size == 64
    graphed = GraphedDecodeStep(sm)
    rng = np.random.default_rng(5)
    for n in (60, 90):                    # row 1 has wrapped in its prefill
        toks = torch.from_numpy(rng.integers(0, 1000, (1, 32)).astype(np.int32)).to(sm90)
        for pool in pools:
            seq = pool.alloc_seq()
            assert pool.ensure(seq, n + 1)
            for lo in range(0, n, 32):
                _, cache = sm.prefill_chunk(sp, pool.step_cache(), toks, seq, lo,
                                            min(32, n - lo))
                pool.accept(cache)
    for i in range(8):                    # row 0 wraps at its fifth replay
        feed = torch.from_numpy(rng.integers(0, 1000, (2, 1)).astype(np.int32)).to(sm90)
        outs, counts = [], []
        for pool, fn in zip(pools, (sm.decode_step, graphed)):
            ops.reset_counts()
            logits, cache = fn(sp, pool.step_cache(), feed)
            pool.accept(cache)
            torch.cuda.synchronize()
            outs.append(logits.clone())
            counts.append(dict(ops.counts))
        assert torch.equal(outs[0], outs[1]), f"replay {i}: logits differ"
        for key, leaf in pools[0].cache.items():
            assert torch.equal(leaf, pools[1].cache[key]), f"replay {i}: {key} differs"
        want = "paged_attention" if kv_bits is None else "paged_attention_quant"
        assert counts[0][want] == 2 and counts[0]["fused_qkv_paged_decode"] == 0, counts
        assert counts[0]["plain"] == 0
    assert (graphed.captures, graphed.recaptures) == (1, 0)


@pytest.mark.gpu
def test_graphed_slot_decode_step_equals_eager_bitwise(sm90):
    """The captured step over a contiguous ring cache (the slot pool and the
    static loop: no block tables), fed by the full-prompt prefill: logits,
    the K/V rows and ``length`` equal the eager step's past the wrap."""
    from repro_torch.train.serve import GraphedDecodeStep

    sm, sp = _small_ring_served(4, sm90)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 1000, (3, 50))
                            .astype(np.int32)).to(sm90)
    caches = [sm.prefill(sp, tokens=toks, max_len=200)[1] for _ in range(2)]
    graphed = GraphedDecodeStep(sm)
    feed = toks[:, -1:]
    for i in range(20):                   # the ring of 64 wraps at step 14
        outs = []
        for j, fn in enumerate((sm.decode_step, graphed)):
            logits, caches[j] = fn(sp, caches[j], feed)
            outs.append(logits.clone())
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]), f"step {i}: logits differ"
        for key in caches[0]:
            assert torch.equal(caches[0][key], caches[1][key]), f"step {i}: {key} differs"
        feed = torch.argmax(outs[0][:, -1], -1).to(torch.int32)[:, None]
    assert (graphed.captures, graphed.recaptures) == (1, 0)


# ---------------------------------------------------------------------------
# the recurrent families' shapes (hymba-1.5b, rwkv6-1.6b)
# ---------------------------------------------------------------------------

HYMBA_RING = [1, 17, 1023, 1024]     # min(length + 1, Tc) over 1024-token rings


@pytest.mark.gpu
def test_paged_attention_g5_hd64_ring_tables_match_plain(sm90):
    """Row 2 at hymba's decode head shape (KV 5, G 5: one full warp of 4
    heads and one more, hd 64, bs 16) over 1024-token ring tables."""
    NB, bt, ln = _ring_tables(4, 64, HYMBA_RING, sm90, seed=21)
    gen = torch.Generator(device=sm90).manual_seed(21)
    q = torch.randn((4, 5, 5, 64), generator=gen, device=sm90).to(torch.bfloat16)
    kp, vp = (torch.randn((NB, 16, 5, 64), generator=gen, device=sm90).to(torch.bfloat16)
              for _ in range(2))
    _check_paged(q, kp, vp, bt, ln)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_paged_attention_quant_g5_hd64_ring_tables_match_plain(sm90, kv_bits):
    """Row 3 at hymba's shape: 64-byte int8 and 32-byte packed int4 code
    rows, G 5, over 1024-token ring tables."""
    NB, bt, ln = _ring_tables(4, 64, HYMBA_RING, sm90, seed=22)
    gen = torch.Generator(device=sm90).manual_seed(22 + kv_bits)
    kc, vc, ks, vs, _ = _quant_pool(NB, 16, 5, 64, kv_bits, gen, sm90)
    q = torch.randn((4, 5, 5, 64), generator=gen, device=sm90).to(torch.bfloat16)
    _check_paged_quant(q, kc, vc, ks, vs, bt, ln)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("path,M", [("bitserial", 4), ("dequant", 256)])
@pytest.mark.parametrize("K,N", [(1600, 320), (1600, 32001), (3200, 1600), (5504, 1600),
                                 (2048, 7168), (7168, 2048)])
def test_qmm_recurrent_family_shapes_match_plain(sm90, K, N, path, M, dtype):
    """Both qmm bodies at hymba's and RWKV's shapes: K 1600 (a partial last
    128-wide K step), N 320 (k/v of 5 heads), N 32001 (hymba's lm_head,
    planes not 16-byte aligned); f32 activations as RWKV's token-shift
    mixes feed its projections.  Bitwise repeatable."""
    from repro_torch.kernels.qmm import qmm_cuda

    x, planes, scale = _qmm_inputs(M, K, N, 4, sm90, seed=K + N + M)
    x = x.to(dtype)
    got = qmm_cuda(x, planes, scale, 4, path)
    again = qmm_cuda(x, planes, scale, 4, path)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    plain = tref.qmm_ref(x, planes, scale, 4)
    assert (got - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("path,M", [("bitserial", 1), ("bitserial", 5), ("bitserial", 20),
                                    ("dequant", 64), ("dequant", 130)])
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 7168)])
def test_qmm_f32_activations_match_plain(sm90, K, N, path, M):
    """The tensor-core bodies at RWKV's f32 activations (three bf16 terms)
    at every row count its served path gives them (decode 1-4, verify 20,
    prefill chunks)."""
    from repro_torch.kernels.qmm import qmm_cuda

    x, planes, scale = _qmm_inputs(M, K, N, 4, sm90, seed=M + N)
    x = x.float()
    got = qmm_cuda(x, planes, scale, 4, path)
    torch.cuda.synchronize()
    plain = tref.qmm_ref(x, planes, scale, 4)
    assert (got - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_recurrent_decode_and_chunk_paths_agree_at_full_width(sm90, arch):
    """Two layers at the published widths: the logits after a prompt fed
    through chunked prefill and then the decode step, one token at a time,
    against the same tokens all through chunked prefill, within the bf16
    logit bound (2e-2 * max|logit|), on the card and on the CPU alike."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.quant.qat import policy_for
    from repro_torch.serve.cache import PagedCachePool
    from repro_torch.train.serve import quantize_for_serving

    sm = build_model(dataclasses.replace(get_config(arch), num_layers=2, vocab_size=1000))
    params = sm.init(seed=3, device="cpu")
    toks = np.random.default_rng(3).integers(0, 1000, 72).astype(np.int32)
    for dev in (sm90, torch.device("cpu")):
        sp = quantize_for_serving(sm, params, policy_for(sm, 4), device=dev)
        rows = []
        for decoded in (8, 0):
            pool = PagedCachePool(sm, 1, 80, block_size=16, device=dev, prefix_cache=False)
            seq = pool.alloc_seq()
            assert pool.ensure(seq, 73)
            n = len(toks) - decoded
            for lo in range(0, n, 32):
                buf = np.zeros((1, 32), np.int32)
                buf[0, :min(32, n - lo)] = toks[lo:min(lo + 32, n)]
                logits, cache = sm.prefill_chunk(sp, pool.step_cache(),
                                                 torch.from_numpy(buf).to(dev), seq, lo,
                                                 min(32, n - lo))
                pool.accept(cache)
            for t in toks[n:]:
                logits, cache = sm.decode_step(sp, pool.step_cache(),
                                               torch.tensor([[int(t)]], device=dev))
                pool.accept(cache)
            rows.append(logits[0, 0].float().cpu())
        err = (rows[0] - rows[1]).abs().max().item()
        assert err <= 2e-2 * rows[1].abs().max().item(), (dev, err)


def _small_recurrent_served(arch, dev, bits=4):
    """2-layer models of the recurrent families at narrow widths (RWKV:
    d_model 256, 4 heads of 64; hymba: d_model 320, 5 heads over 1 KV head
    of 64, window 64), their serving params at ``bits`` on ``dev``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.quant.qat import policy_for
    from repro_torch.train.serve import quantize_for_serving

    over = (dict(d_model=256, num_heads=4, num_kv_heads=4, head_dim=64, d_ff=896,
                 wkv_lora_rank=64, chunk_size=16) if arch == "rwkv6-1.6b" else
            dict(d_model=320, num_heads=5, num_kv_heads=1, head_dim=64, d_ff=1088,
                 sliding_window=64, ssm_state=16, chunk_size=64))
    cfg = dataclasses.replace(get_config(arch, smoke=True), num_layers=2, vocab_size=1000,
                              **over)
    sm = build_model(cfg)
    params = sm.init(seed=8, device="cpu")
    return sm, quantize_for_serving(sm, params, policy_for(sm, bits), device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kv_bits", [("rwkv6-1.6b", None), ("hymba-1.5b", None),
                                          ("hymba-1.5b", 8), ("hymba-1.5b", 4)],
                         ids=["rwkv", "hymba-fp", "hymba-int8", "hymba-int4"])
def test_graphed_recurrent_decode_step_equals_eager_bitwise(sm90, arch, kv_bits):
    """Twin pools fed the same chunked prefills and tokens: the captured
    step's logits and every pool byte (the recurrent state leaves, updated
    in place inside the graph, and hymba's ring blocks past the wrap) equal
    the eager step's; hymba never launches the fused kernel; one capture."""
    from repro_torch.serve.cache import PagedCachePool
    from repro_torch.train.serve import GraphedDecodeStep

    sm, sp = _small_recurrent_served(arch, sm90)
    pools = [PagedCachePool(sm, 2, 200, block_size=16, device=sm90, kv_bits=kv_bits)
             for _ in range(2)]
    graphed = GraphedDecodeStep(sm)
    rng = np.random.default_rng(9)
    for n in (60, 90):
        toks = torch.from_numpy(rng.integers(0, 1000, (1, 32)).astype(np.int32)).to(sm90)
        for pool in pools:
            seq = pool.alloc_seq()
            assert pool.ensure(seq, n + 1)
            for lo in range(0, n, 32):
                _, cache = sm.prefill_chunk(sp, pool.step_cache(), toks, seq, lo,
                                            min(32, n - lo))
                pool.accept(cache)
    for i in range(8):
        feed = torch.from_numpy(rng.integers(0, 1000, (2, 1)).astype(np.int32)).to(sm90)
        outs, counts = [], []
        for pool, fn in zip(pools, (sm.decode_step, graphed)):
            ops.reset_counts()
            logits, cache = fn(sp, pool.step_cache(), feed)
            pool.accept(cache)
            torch.cuda.synchronize()
            outs.append(logits.clone())
            counts.append(dict(ops.counts))
        assert torch.equal(outs[0], outs[1]), f"replay {i}: logits differ"
        for key, leaf in pools[0].cache.items():
            assert torch.equal(leaf, pools[1].cache[key]), f"replay {i}: {key} differs"
        if i:   # a capture's warm-up is a real step, counted on top of replay 0
            assert counts[1] == counts[0], counts
        assert counts[0]["plain"] == 0 and counts[0]["qmm_bitserial"] > 0, counts
        assert counts[0]["fused_qkv_paged_decode"] == 0, counts
    assert (graphed.captures, graphed.recaptures) == (1, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kv_bits", [("rwkv6-1.6b", None), ("hymba-1.5b", 4)],
                         ids=["rwkv", "hymba-int4"])
def test_spec_engine_recurrent_fixup_graphed_equals_eager(sm90, arch, kv_bits):
    """The spec engine (k 4, 2-bit draft) with the captured draft and target
    steps against the same engine run eagerly: equal streams and window
    counts, at least one fix-up, no fused launch on hymba's windowed layers,
    and no plain call."""
    from repro_torch.serve import ServeEngine
    from repro_torch.spec import SpecConfig

    sm, sp = _small_recurrent_served(arch, sm90)
    rng = np.random.default_rng(10)
    work = [(rng.integers(0, 1000, n).astype(np.int32), 24) for n in (9, 30, 17, 21)]
    runs = {}
    for name, kw in (("graphed", {}), ("eager", {"decode_fn": sm.decode_step})):
        eng = ServeEngine(sm, sp, num_slots=4, max_len=64, block_size=16, prefill_chunk=16,
                          device=sm90, kv_bits=kv_bits, spec=SpecConfig(k=4, draft_bits=2),
                          **kw)
        for prompt, n in work:
            eng.submit(prompt, n)
        ops.reset_counts()
        eng.run_until_drained()
        torch.cuda.synchronize()
        assert ops.counts["plain"] == 0 and ops.counts["fused_qkv_paged_decode"] == 0
        runs[name] = ([eng.output(r) for r in range(len(work))], eng.metrics(),
                      int(eng.obs.get("spec.fixups").value))
    assert runs["graphed"][0] == runs["eager"][0]
    assert runs["graphed"][1]["spec"] == runs["eager"][1]["spec"]
    assert runs["graphed"][2] == runs["eager"][2] > 0
    assert runs["graphed"][1]["recompiles"] == 0


# ---------------------------------------------------------------------------
# the moe, vlm and audio families' shapes (moonshot-v1-16b-a3b, qwen2-vl-7b,
# musicgen-large)
# ---------------------------------------------------------------------------

# (KV, G, hd): moonshot (16 heads over 16 KV), musicgen (32 over 32, hd 64),
# qwen2-vl (28 over 4: G 7, a warp's last head slot idle)
MVA_HEADS = [(16, 1, 128), (32, 1, 64), (4, 7, 128)]
MVA_IDS = ["g1-hd128", "g1-hd64", "g7-hd128"]
MVA_LENGTHS = [1, 17, 100, 300]


@pytest.mark.gpu
@pytest.mark.parametrize("KV,G,hd", MVA_HEADS, ids=MVA_IDS)
def test_paged_attention_g1_g7_match_plain(sm90, KV, G, hd):
    """Row 2 at G 1 (hd 128 and 64) and G 7, shuffled blocks of 16."""
    NB, bt, ln = _tables(4, 19, MVA_LENGTHS, sm90)
    gen = torch.Generator(device=sm90).manual_seed(31 + G)
    q = torch.randn((4, KV, G, hd), generator=gen, device=sm90).to(torch.bfloat16)
    kp, vp = (torch.randn((NB, 16, KV, hd), generator=gen, device=sm90).to(torch.bfloat16)
              for _ in range(2))
    _check_paged(q, kp, vp, bt, ln)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("KV,G,hd", MVA_HEADS, ids=MVA_IDS)
def test_paged_attention_quant_g1_g7_match_plain(sm90, KV, G, hd, kv_bits):
    """Row 3 at the same shapes, int8 and packed int4 codes."""
    NB, bt, ln = _tables(4, 19, MVA_LENGTHS, sm90)
    gen = torch.Generator(device=sm90).manual_seed(37 + G + kv_bits)
    kc, vc, ks, vs, _ = _quant_pool(NB, 16, KV, hd, kv_bits, gen, sm90)
    q = torch.randn((4, KV, G, hd), generator=gen, device=sm90).to(torch.bfloat16)
    _check_paged_quant(q, kc, vc, ks, vs, bt, ln)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_fused_decode_g1_matches_plain(sm90, kv_bits):
    """Row 4 at moonshot's decode shape: H 16 over KV 16 (G 1), hd 128,
    D 2048, 4-bit q/k/v, at the fused decode's tolerances."""
    from repro_torch.kernels.fused_decode import fused_qkv_paged_decode_cuda
    from repro_torch.models.common import rope_cos_sin
    from repro_torch.quant.pack import Packed, kv_unpack_int4

    B, KV, G, hd, bs, nb, D = 4, 16, 1, 128, 16, 19, 2048
    H = KV * G
    gen = torch.Generator(device=sm90).manual_seed(41)
    NB, bt, ln = _tables(B, nb, [0, 16, 41, nb * bs - 1], sm90)
    kc, vc, ks, vs, qmax = _quant_pool(NB, bs, KV, hd, kv_bits, gen, sm90)
    ws = []
    for n in (H * hd, KV * hd, KV * hd):
        planes, scale = pack_weight(torch.randn((D, n), generator=gen, device=sm90) * D ** -0.5, 4)
        ws.append(Packed(planes, scale, 4))
    x = torch.randn((B, D), generator=gen, device=sm90).to(torch.bfloat16)
    cos, sin = rope_cos_sin(ln, hd, 5e4)
    qm = torch.tensor(qmax, device=sm90)
    got = fused_qkv_paged_decode_cuda(x, *ws, kc, vc, ks, vs, bt, ln, cos, sin, qm, H)
    again = fused_qkv_paged_decode_cuda(x, *ws, kc, vc, ks, vs, bt, ln, cos, sin, qm, H)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    plain = tref.fused_qkv_paged_decode_ref(x, *ws, kc, vc, ks, vs, bt, ln, cos, sin, qm, H, KV)
    out, po = got[0].reshape(B, 1, H, hd), plain[0].float()
    assert (out - po).abs().max().item() <= 2e-2 * po.abs().max().item()
    for g, p in zip(got[3:], plain[3:]):
        assert ((g - p).abs() <= 2.0 ** -7 * p.abs()).all()
    unpack = kv_unpack_int4 if kv_bits == 4 else (lambda c: c)
    for g, p in zip(got[1:3], plain[1:3]):
        assert (unpack(g).int() - unpack(p).int()).abs().max().item() <= 1


# (K, N, bits, M of the bit-serial and the dequant body): moonshot's experts
# (32 rows a decode step: 4 rows x capacity 8; 384 a 64-token chunk) and
# lm_head, qwen2-vl's MLP and lm_head, musicgen's MLP and 2048-wide lm_head
MVA_QMM = [(2048, 1408, 4, 32, 384), (1408, 2048, 4, 32, 384), (2048, 163840, 8, 4, 64),
           (3584, 18944, 4, 4, 64), (18944, 3584, 4, 4, 64), (3584, 152064, 8, 4, 64),
           (2048, 8192, 4, 4, 64), (8192, 2048, 4, 4, 64), (2048, 2048, 8, 4, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["bitserial", "dequant"])
@pytest.mark.parametrize("K,N,bits,Mb,Md", MVA_QMM,
                         ids=[f"{k}x{n}@{b}" for k, n, b, _, _ in MVA_QMM])
def test_qmm_moe_vlm_audio_shapes_match_plain(sm90, K, N, bits, Mb, Md, path):
    """Both qmm bodies at the experts' (K 1408 / N 1408), qwen2-vl's,
    musicgen's and the three lm_heads' shapes; bitwise on two calls."""
    from repro_torch.kernels.qmm import qmm_cuda

    M = Mb if path == "bitserial" else Md
    x, planes, scale = _qmm_inputs(M, K, N, bits, sm90, seed=K + N)
    got = qmm_cuda(x, planes, scale, bits, path)
    again = qmm_cuda(x, planes, scale, bits, path)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    plain = tref.qmm_ref(x, planes, scale, bits)
    assert (got - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


def _small_moe_served(dev, arch="moonshot-v1-16b-a3b", bits=4):
    """A 2-layer MoE model at narrow widths (d_model 256, 2 heads over 2 KV
    of 128, 8 experts top-2 of d_ff 128, vocab 1000), its serving params
    at ``bits`` on ``dev``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.quant.qat import policy_for
    from repro_torch.train.serve import quantize_for_serving

    cfg = dataclasses.replace(get_config(arch, smoke=True), num_layers=2, d_model=256,
                              num_heads=2, num_kv_heads=2, head_dim=128, d_ff=128,
                              vocab_size=1000, num_experts=8, experts_per_token=2)
    sm = build_model(cfg)
    params = sm.init(seed=8, device="cpu")
    return sm, quantize_for_serving(sm, params, policy_for(sm, bits), device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [None, 4], ids=["fp", "int4"])
def test_graphed_moe_decode_step_equals_eager_bitwise(sm90, kv_bits):
    """Twin pools fed the same chunked prefills and tokens: the captured
    MoE step's logits and every pool byte equal the eager step's (the
    routing sort, the sentinel scatter and the fixed-order combine inside
    the graph); one qmm launch per expert and matrix; one capture."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    sm, sp = _small_moe_served(sm90)
    twin = chip_smoke.graphed_twin_replays(torch, sm, sp, kv_bits, device=sm90)
    assert twin["mismatch"] is None, twin["mismatch"]
    assert len(twin["counts"]) == 8 and twin["captures"] == (1, 0)
    # 2 layers x 8 experts x 3 matrices, + wo (+ q/k/v unfused) + lm_head
    qkv = 0 if kv_bits == 4 else 3
    for i, (eager, graphed) in enumerate(twin["counts"]):
        if i:
            assert graphed == eager, (eager, graphed)
        assert eager["qmm_bitserial"] == 2 * (8 * 3 + 1 + qkv) + 1, eager
        assert eager["fused_qkv_paged_decode"] == (2 if kv_bits == 4 else 0)
        assert eager["plain"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("no_drop", [False, True], ids=["drop", "no-drop"])
def test_moe_ffn_card_matches_cpu(sm90, no_drop):
    """``moe_ffn`` on packed 4-bit banks (moonshot's expert widths, 16
    experts top-6, 64 bf16 tokens a row) on the card against its CPU
    result: the same choices where the CPU's k-th and (k+1)-th gates are
    more than 1e-4 apart, and outputs within 2e-2 * max|cpu| on the rows
    whose choices all agree."""
    from repro_torch.models import moe
    from repro_torch.quant.pack import Packed

    E, k, D, F, B, S = 16, 6, 2048, 1408, 2, 64
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((B, S, D), generator=gen).to(torch.bfloat16)
    p = {"router": torch.randn((D, E), generator=gen) * D ** -0.5}
    for name, (din, dout) in (("wg", (D, F)), ("wu", (D, F)), ("wd", (F, D))):
        pairs = [pack_weight(torch.randn((din, dout), generator=gen) * din ** -0.5, 4)
                 for _ in range(E)]
        p[name] = Packed(torch.stack([a for a, _ in pairs]), torch.stack([s for _, s in pairs]), 4)
    cuda = {n: (Packed(w.planes.to(sm90), w.scale.to(sm90), 4) if isinstance(w, Packed)
                else w.to(sm90)) for n, w in p.items()}
    want, want_aux = moe.moe_ffn(x, p, k=k, no_drop=no_drop)
    ops.reset_counts()
    got, got_aux = moe.moe_ffn(x.to(sm90), cuda, k=k, no_drop=no_drop)
    torch.cuda.synchronize()
    assert ops.counts["plain"] == 0 and ops.counts["qmm_dequant"] + ops.counts["qmm_bitserial"] == 3 * E
    gates, _, idx = moe._route(x, p["router"], k)
    _, _, idx_card = moe._route(x.to(sm90), cuda["router"], k)
    v = torch.sort(gates, dim=-1, descending=True).values
    clear = (v[..., k - 1] - v[..., k]) > 1e-4
    assert torch.equal(idx_card.cpu()[clear], idx[clear])
    same = (idx_card.cpu() == idx).all(dim=-1)
    if no_drop:   # drop-free: a token's output depends on its own choices only
        got, want = got.cpu()[same].float(), want[same].float()
    else:         # capacity: a flipped choice moves later tokens of its row
        rows = same.all(dim=-1)
        got, want = got.cpu()[rows].float(), want[rows].float()
    if want.numel():
        assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()
    assert abs(float(got_aux) - float(want_aux)) <= 1e-4 * float(want_aux) or not bool(same.all())


# ---- the autotune service's card paths: engine timing, hot swap, threads ----
def _lm_cell_served(layers: int = 4):
    """glm4-9b at its published widths, ``layers`` deep, random bf16 params
    drawn on the card (chip_smoke.py's LM cell)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("glm4-9b"), num_layers=layers)
    model = build_model(cfg)
    return model, model.init(seed=0, device="cuda")


@pytest.mark.gpu
def test_engine_latency_evaluator_repeatable_and_low_bits_faster(sm90):
    """Three fresh evaluators time the 8-bit reference (device synchronized
    before each clock); their spread is printed and stays within 15 %;
    the all-2-bit candidate (frozen groups at 8) measures below every one."""
    from repro_torch.autotune import EngineLatencyEvaluator

    model, params = _lm_cell_served()
    refs, low = [], None
    for _ in range(3):
        ev = EngineLatencyEvaluator(model, params)
        two = {n: ev.frozen.get(n, 2) for n in ev.group_names}
        lat, ref = ev(two)
        refs.append(ref)
        low = lat if low is None else min(low, lat)
        assert all(r["event_s"] > 0 for r in ev.records)
    spread = (max(refs) - min(refs)) / min(refs)
    print(f"8-bit s/step {refs}, spread {spread:.3f}; all-2-bit {low}")
    assert spread <= 0.15
    assert low < min(refs)


@pytest.mark.gpu
def test_hot_swap_graphed_pipelined_engine_recaptures(sm90):
    """A graphed, pipelined engine with rows running and queued: the swap
    drains, holds the queue, flushes the prefix cache, and the next decode
    step captures again; the queued and the later requests' streams equal
    a fresh engine's at the new params bitwise.  A second swap to another
    policy changes the live engine's tokens."""
    from repro_torch.autotune import ab_parity_check, hot_swap
    from repro_torch.quant.qat import policy_for
    from repro_torch.serve import ServeEngine
    from repro_torch.train.serve import quantize_for_serving

    sm, sp8 = _small_served(8, sm90)
    params = sm.init(seed=5, device="cpu")
    sp4 = quantize_for_serving(sm, params, policy_for(sm, 4), device=sm90)
    sp2 = quantize_for_serving(sm, params, policy_for(sm, 2), device=sm90)
    kw = dict(num_slots=2, max_len=64, block_size=16, prefill_chunk=16, device=sm90)
    eng = ServeEngine(sm, sp8, **kw)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 1000, int(n)) for n in (20, 33, 17, 26)]
    ids = [eng.submit(p, 12) for p in prompts]
    eng.step()
    eng.step()
    assert eng.num_running == 2 and eng.num_queued == 2
    report = hot_swap(eng, sp4)
    assert report["drained_steps"] >= 1 and report["prefix_cache_flushed"]
    assert eng.num_running == 0 and eng.num_queued == 2 and eng.pool.prefix_cached_blocks == 0
    eng.run_until_drained()
    m = eng.metrics()
    assert m["recompiles"] >= 1 and m["pipeline"]["lookahead_steps"] > 0
    fresh = ServeEngine(sm, sp4, **kw)
    fids = [fresh.submit(p, 12) for p in prompts[2:]]
    fresh.run_until_drained()
    assert [eng.output(i) for i in ids[2:]] == [fresh.output(i) for i in fids]
    gate = ab_parity_check(eng, sm, sp4, prompts[:2], 10)
    assert gate["match"]
    hot_swap(eng, sp2)
    after = ab_parity_check(eng, sm, sp2, prompts[:2], 10)
    assert after["match"] and after["outputs"]["live"] != gate["outputs"]["live"]
    assert eng.metrics()["recompiles"] >= 2


@pytest.mark.gpu
def test_graph_capture_with_another_thread_on_the_card(sm90):
    """A second thread launches qmm, allocates and copies to the host the
    whole time the decode step is captured: the capture (thread-local mode)
    succeeds, records the launches of a capture made alone and nothing of
    the other thread's, and its replay gives the eager step's logits
    bitwise; the other thread's products equal the ones it makes alone."""
    import threading
    import time

    from repro_torch.serve.cache import PagedCachePool
    from repro_torch.train.serve import GraphedDecodeStep

    sm, sp = _small_served(4, sm90)
    x, planes, scale = _qmm_inputs(4, 4096, 256, 4, sm90)
    want = ops.qmm(x, planes, scale, bits=4)
    torch.cuda.synchronize()

    def pool_with_prompt():
        pool = PagedCachePool(sm, 2, 64, block_size=16, device=sm90)
        seq = pool.alloc_seq()
        pool.ensure(seq, 17)
        toks = torch.arange(16, dtype=torch.int32, device=sm90)[None]
        _, cache = sm.prefill_chunk(sp, pool.step_cache(), toks, seq, 0, 16)
        pool.accept(cache)
        return pool

    tok = torch.full((2, 1), 7, dtype=torch.int32, device=sm90)
    alone = GraphedDecodeStep(sm)
    alone(sp, pool_with_prompt().step_cache(), tok)
    eager_pool = pool_with_prompt()
    eager, _ = sm.decode_step(sp, eager_pool.step_cache(), tok)
    torch.cuda.synchronize()

    stop, errors, done, launched = threading.Event(), [], [0], {}

    def other():
        try:
            with ops.recording() as rec:
                while not stop.is_set():
                    got = ops.qmm(x.clone(), planes, scale, bits=4)
                    if not torch.equal(got.cpu(), want.cpu()):
                        errors.append("product differs")
                    done[0] += 1
            launched.update(rec)
        except Exception as e:   # reported by the main thread
            errors.append(repr(e))

    t = threading.Thread(target=other)
    t.start()
    while done[0] < 3 and not errors:
        time.sleep(0.001)
    before = done[0]
    graphed = GraphedDecodeStep(sm)
    pool = pool_with_prompt()
    logits, _ = graphed(sp, pool.step_cache(), tok)
    during = done[0] - before
    logits = logits.clone()
    stop.set()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    print(f"other thread: {done[0]} qmm calls, {during} during the capture")
    assert during > 0
    assert graphed._graph.launches == alone._graph.launches
    assert launched == {"qmm_bitserial": done[0]}
    assert torch.equal(logits, eager)


# ---------------------------------------------------------------------------
# head dim 16: every smoke config's (KV 2, G 2, d_model 64), so that the
# launchers' default commands run on the card
# ---------------------------------------------------------------------------
HD16 = (2, 2, 16, 16, 64)            # KV, G, hd, bs, D
HD16_LENGTHS = [1, 16, 17, 300]      # a page's first token, its end, the next, 19 pages


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_paged_attention_hd16_matches_plain(sm90, dtype):
    """Lanes 16-31 hold no P.V dims; 19 shuffled pages in 10 splits."""
    KV, G, hd, bs, _ = HD16
    case = _paged_case(sm90, 4, KV, G, hd, bs, 19, HD16_LENGTHS, dtype, seed=16)
    _check_paged(*case)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_paged_attention_quant_hd16_matches_plain(sm90, kv_bits):
    """16-byte int8 / 8-byte int4 rows staged into padded 32-dim rows."""
    KV, G, hd, bs, _ = HD16
    case = _quant_case(sm90, 4, KV, G, hd, bs, 19, HD16_LENGTHS, kv_bits, seed=16 + kv_bits)
    _check_paged_quant(*case)


@pytest.mark.gpu
@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_fused_decode_hd16_matches_plain(sm90, kv_bits, act):
    """The whole op at the smoke shape (K 64: half of one 128-row K step)
    against the plain version within its stated code tolerances; its
    launch (B) alone bitwise in codes and scales; the whole op equal to
    its two launches alone, and repeatable."""
    from repro_torch.kernels.fused_decode import (fused_attend_cuda, fused_project_cuda,
                                                  fused_qkv_paged_decode_cuda)
    from repro_torch.quant.pack import kv_unpack_int4

    x, ws, args, H, KV = _fused_case(sm90, kv_bits, HD16_LENGTHS, 19, bits=(4, 3, 8),
                                     seed=16, shape=HD16)
    x = x.to(act)
    B, hd = x.shape[0], HD16[2]
    got = fused_qkv_paged_decode_cuda(x, *ws, *args, H)
    again = fused_qkv_paged_decode_cuda(x, *ws, *args, H)
    staged = fused_attend_cuda(tref.finish_projection(fused_project_cuda(x, *ws, H, KV), *ws),
                               act, *args, H)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, staged):
        assert torch.equal(a, b) and torch.equal(a, c)
    plain = tref.fused_qkv_paged_decode_ref(x, *ws, *args, H, KV)
    out, po = got[0].reshape(B, 1, H, hd), plain[0].float()
    assert (out - po).abs().max().item() <= 2e-2 * po.abs().max().item()
    for g, p in zip(got[3:], plain[3:]):
        assert ((g - p).abs() <= 2.0 ** -7 * p.abs()).all()
    unpack = kv_unpack_int4 if kv_bits == 4 else (lambda c: c)
    for g, p in zip(got[1:3], plain[1:3]):
        assert (unpack(g).int() - unpack(p).int()).abs().max().item() <= 1
    proj = torch.cat([tref.qmm_ref(x, w.planes, w.scale, w.bits) for w in ws], dim=1)
    got_b = fused_attend_cuda(proj, act, *args, H)
    torch.cuda.synchronize()
    plain_b = tref.fused_decode_attend_ref(proj, *args, H, KV, act)
    for g, p in zip(got_b[1:], plain_b[1:]):
        assert torch.equal(g, p)
    ob, pb = got_b[0].reshape(B, 1, H, hd), plain_b[0].float()
    assert (ob - pb).abs().max().item() <= 1e-2 * pb.abs().max().item()


@pytest.mark.gpu
def test_op_count_evaluator_allocates_nothing_on_the_card(sm90):
    """``launch/autotune.py --device cuda --hw hlo``'s evaluator builds and
    counts every candidate on meta tensors: the card's allocation and its
    peak do not move."""
    from repro_torch.configs import get_config
    from repro_torch.launch import autotune
    from repro_torch.models import build_model

    model = build_model(get_config("glm4-9b", smoke=True))
    args = autotune.build_parser().parse_args(["--device", "cuda", "--hw", "hlo"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ev = autotune._latency_eval(args, model, None, model.quant_groups(), model.frozen_bits())
    low, ref = ev({n: ev.frozen.get(n, 2) for n in ev.group_names})
    assert 0 < low < ref
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert torch.cuda.max_memory_allocated() == before


# ---- repro_torch.dist on NCCL at world size 1 -----------------------------------------
@pytest.fixture
def nccl_mesh(sm90):
    """A world-size-1 NCCL group and its (1, 1) mesh, destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    assert not dist.is_initialized()
    mesh = make_host_mesh((1, 1), device="cuda")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("axis_size", [None, 1], ids=["all_gather", "two_phase"])
def test_compressed_allreduce_nccl_codes_match_the_cpu(nccl_mesh, axis_size):
    """Both constructions over NCCL: the uint8 codes handed to the wire,
    the output and ``fb`` bit for bit the CPU's ``_fp8_planes`` and its
    dequantized sum, on f32 and bf16 leaves (1 element to 2^20)."""
    import torch.distributed as dist

    from repro_torch.dist import collectives as col

    gen = torch.Generator().manual_seed(3)
    leaves = [torch.randn((1 << 20,), generator=gen) * 3, torch.randn((1,), generator=gen),
              torch.zeros((7,)), torch.randn((37, 5), generator=gen).to(torch.bfloat16)]
    sent, real = [], dist.all_gather_into_tensor

    def gather(out, x, group=None):
        if x.dtype == torch.uint8:
            sent.append(x.cpu().clone())
        return real(out, x, group=group)

    col.dist.all_gather_into_tensor = gather
    try:
        for x in leaves:
            sent.clear()
            out, fb = col.compressed_allreduce(x.cuda(), (nccl_mesh, "data"), planes=2,
                                               axis_size=axis_size)
            torch.cuda.synchronize()
            q, s, r = col._fp8_planes(x.float().reshape(1, -1) if axis_size else x.float(), 2)
            if axis_size:   # one chunk: phase 2 re-compresses the dequantized sum
                assert len(sent) == 1
                mine = col._dequant_sum(q, s.reshape(-1, 1))
                q2, s2, r2 = col._fp8_planes(mine.reshape(-1), 2)
                assert torch.equal(sent[0].reshape(q2.shape), q2)
                want_o = col._dequant_sum(q2.unsqueeze(0), s2.unsqueeze(0)).reshape(x.shape)
                want_fb = (r.reshape(-1) + r2).reshape(x.shape)
            else:
                assert torch.equal(sent[0].reshape(q.shape), q)
                want_o = col._dequant_sum(q.unsqueeze(0), s.unsqueeze(0))
                want_fb = r
            assert torch.equal(out.cpu(), want_o.to(x.dtype))
            assert torch.equal(fb.cpu(), want_fb.to(x.dtype))
    finally:
        col.dist.all_gather_into_tensor = real


def _narrow_lm():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    return build_model(dataclasses.replace(get_config("glm4-9b", smoke=True), d_model=256,
                                           num_heads=4, head_dim=64, d_ff=512))


@pytest.mark.gpu
def test_dp_step_planes0_bitwise_the_plain_step_on_the_card(nccl_mesh):
    """A narrow model's data-parallel step at planes 0 over NCCL (a mean
    over one rank) against the plain step, 3 steps from one seed: losses,
    grad norms and every new param bitwise; kernel 5'' launched once each
    way a step on both."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist.elastic import whole
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.quant.qat import bits_assignment, bits_to_device, policy_for
    from repro_torch.train.train_step import (init_dp_state, init_state, make_dp_train_step,
                                              make_train_step)

    model = _narrow_lm()
    opt = AdamW(lr=1e-3)
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 4)), "cuda")
    runs = {}
    for kind in ("plain", "dp"):
        data = SyntheticLMData(seed=0, global_batch=2, seq_len=128, vocab=model.cfg.vocab_size)
        if kind == "plain":
            state, step = init_state(model, opt, 0, "cuda"), make_train_step(model, opt)
        else:
            state = init_dp_state(model, opt, 0, nccl_mesh)
            step = make_dp_train_step(model, opt, nccl_mesh, planes=0)
        out = []
        for _ in range(3):
            ops.reset_counts()
            state, m = step(state, data.next(), bm)
            torch.cuda.synchronize()
            assert ops.counts["fake_quant_group_col"] == 1
            assert ops.counts["fake_quant_group_col_bwd"] == 1 and ops.counts["plain"] == 0
            out.append((m["loss"].item(), m["grad_norm"].item()))
        runs[kind] = (out, [whole(p) for p in tree_leaves(state["params"])])
    assert runs["dp"][0] == runs["plain"][0]
    for a, b in zip(runs["dp"][1], runs["plain"][1]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_elastic_save_and_restore_on_the_card(nccl_mesh, tmp_path):
    """A DP state after a compressed step (bf16 ``ef``), saved and restored
    through ``Trainer(mesh=)`` onto another state of its shapes on the
    card: every leaf bitwise, placed as before, on the card; the next
    step's loss equal to the uninterrupted one's."""
    from repro_torch import ckpt as ckpt_lib
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist.elastic import whole
    from repro_torch.dist.sharding import named_leaves
    from repro_torch.optim import AdamW
    from repro_torch.quant.qat import bits_assignment, bits_to_device, policy_for
    from repro_torch.train.train_step import init_dp_state, make_dp_train_step
    from repro_torch.train.trainer import Trainer

    model = _narrow_lm()
    opt = AdamW(lr=1e-3)
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 8)), "cuda")
    step = make_dp_train_step(model, opt, nccl_mesh, planes=2)
    data = SyntheticLMData(seed=0, global_batch=2, seq_len=128, vocab=model.cfg.vocab_size)
    state, _ = step(init_dp_state(model, opt, 0, nccl_mesh), data.next(), bm)
    ckpt_lib.save(str(tmp_path), 1, state, meta={"data": data.state_dict()})
    tr = Trainer(model=model, optimizer=opt, data=data, step_fn=step, bits_map=bm,
                 ckpt_dir=str(tmp_path), mesh=nccl_mesh)
    # a template that has stepped too: its ef already in the gradients' dtype
    template, _ = step(init_dp_state(model, opt, 1, nccl_mesh), data.eval_batch(2), bm)
    restored, _, at = tr._reload(template)
    assert at == 1
    for (names, a), (_, b) in zip(named_leaves(restored), named_leaves(state)):
        if not isinstance(b, torch.Tensor):
            assert a == b
            continue
        assert a.placements == b.placements and a.to_local().is_cuda, names
        assert a.dtype == b.dtype and torch.equal(whole(a), whole(b)), names
    batch = data.next()
    _, m1 = step(restored, batch, bm)
    _, m2 = step(state, batch, bm)
    assert m1["loss"].item() == m2["loss"].item()


# ---- kernel 5'' split into its passes, as the tensor-parallel step runs it ----------------
# 3j's nine leaves (glm4-9b, 4 layers) and moonshot's three banks (2 layers) with its wo
COL_SPLIT_CELLS = {
    "glm4": [(151552, 4096), (4, 4096, 4096), (4, 4096, 256), (4, 4096, 256),
             (4, 4096, 4096), (4, 4096, 13696), (4, 4096, 13696), (4, 13696, 4096),
             (4096, 151552)],
    "moonshot": [(2, 64, 2048, 1408), (2, 64, 2048, 1408), (2, 64, 1408, 2048),
                 (2, 2048, 2048)],
}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(COL_SPLIT_CELLS))
def test_fake_quant_col_split_passes_with_allreduce_bitwise_one_call(nccl_mesh, cell):
    """The max pass, an all_reduce MAX of its scales over a world-size-1
    NCCL group (as ``dist.tp`` reduces a row-parallel leaf's), then the QDQ
    pass: scales and outputs bitwise the one-call forward's, and the STE
    at the reduced scales bitwise the STE at the one-call scales (bf16,
    bits cycling over the layers); one launch of each pass."""
    from repro_torch.dist import tp as tpm

    shapes = COL_SPLIT_CELLS[cell]
    gen = torch.Generator(device="cuda").manual_seed(41)
    ws = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in shapes]
    bits = [torch.tensor([(2, 3, 4, 5, 6, 8, 32)[(i + l) % 7] for l in range(s[0])]
                         if len(s) > 2 else 8, dtype=torch.int32, device="cuda")
            for i, s in enumerate(shapes)]
    ops.reset_counts()
    scales = ops.fake_quant_group_col_max(ws)
    for s in scales:
        tpm.all_reduce(s, nccl_mesh.get_group("model"), torch.distributed.ReduceOp.MAX)
    outs = ops.fake_quant_group_col_qdq(ws, bits, scales)
    one, one_scales = ops.fake_quant_group_col(ws, bits)
    torch.cuda.synchronize()
    for i in range(len(ws)):
        assert _same_bits(scales[i], one_scales[i]), (cell, i)
        assert _same_bits(outs[i], one[i]), (cell, i)
    del outs, one
    gs = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in shapes]
    got = ops.fake_quant_group_col_bwd(ws, gs, scales)
    want = ops.fake_quant_group_col_bwd(ws, gs, one_scales)
    torch.cuda.synchronize()
    for i in range(len(ws)):
        assert _same_bits(got[i], want[i]), (cell, i)
    assert {k: v for k, v in ops.counts.items() if v} == {
        "fake_quant_group_col_max": 1, "fake_quant_group_col_qdq": 1,
        "fake_quant_group_col": 1, "fake_quant_group_col_bwd": 2}
