"""The hand-written CUDA kernels against their plain versions, on an sm_90
card (skipped elsewhere).  No JAX here: the machine with the card runs
only the port.  Run there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: both versions sum exact f32 products (bf16 activations times
integer codes, or bf16 scores) in different orders over up to K = 13696
terms, so 1e-4 * max|plain| — the bound chip_smoke.py states.  The fused
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
                          "fake_quant_group": 0, "fake_quant_group_bwd": 0, "plain": 0}


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


# ---- the bit-serial body: tensor cores (bf16 x), split-K with an in-launch
# combine, its f32 SIMT route
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
def test_qmm_bitserial_f32_activations_take_the_simt_body(sm90, K, N, M):
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


# ---- the wgmma dequant body (bf16 x), its f32 SIMT route and split-K
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
def test_qmm_dequant_f32_activations_take_the_simt_body(sm90, K, N, M):
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
@pytest.mark.parametrize("hd", [64, 96, 128])
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
@pytest.mark.parametrize("hd", [64, 96, 128])
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
def _fused_case(dev, kv_bits, lengths, nb, bits=(4, 4, 4), B=4, seed=5):
    from repro_torch.models.common import rope_cos_sin
    from repro_torch.quant.pack import Packed

    KV, G, hd, bs, D = 2, 16, 128, 16, 4096
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
    projections; bf16 x takes the tensor-core body, f32 x the SIMT one."""
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
