"""The grouped fake-quant of the QAT path (``kernels.ops.fake_quant_group``,
its STE ``fake_quant_group_bwd`` and ``quant.wrpn.fake_quant_ste_group``)
and its launch plan, against the JAX package on the CPU.

On a CPU tensor every op takes its plain version, so these tests hold the
plain versions, which the card tests hold the CUDA kernels against, to
``repro.quant.wrpn`` (and to the Pallas kernel in interpret mode).

Tolerances, each with its reason:
- QDQ values, scales and STE gradients are elementwise IEEE f32 (a max for
  the scale) in both packages: bitwise, compared as bit patterns so the
  sign of zero and NaN are held.  Two exceptions, neither the port's
  arithmetic: (a) torch's CPU f32 -> bf16 rounding writes every NaN as
  0xFFFF (0x7FC0 in a scalar tail) where XLA keeps a quiet NaN's sign, so
  in bf16 a NaN is held as a NaN and every other element bit for bit;
  (b) the Pallas kernel's level count at 16 bits in f32 (see
  ``tests/test_torch_releq.py``): within one quantization step there.
- The ResNet-20 train step: f32 convolutions sum in other orders (XLA
  against oneDNN): 1e-5 * max, as the LeNet step of test_torch_releq.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets torch's CPU threads)
from repro.cnn import models as jmodels
from repro.cnn.train import CNNTask as JCNNTask
from repro.kernels.fake_quant import fake_quant_pallas
from repro.quant import wrpn as jwrpn
from repro_torch.cnn import CNNTask
from repro_torch.cnn.models import build_cnn
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.kernels import fake_quant as fq
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.quant import wrpn as twrpn

BITS = (1, 2, 3, 4, 5, 6, 7, 8, 16, 32)
NETS = ("lenet", "resnet20")
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
WG = (4096, 13696)                       # glm4-9b's wg, chip_smoke's FQ_EXTRA


def _shapes(net):
    return [tuple(p["w"].shape) for p in build_cnn(net).init(0, device="cpu").values()]


def _pair(x: np.ndarray, dt: str):
    """The same bits as a JAX array and a torch tensor (f32 data rounded
    once to bf16 by ml_dtypes for ``bf16``)."""
    if dt == "f32":
        x = np.ascontiguousarray(x, np.float32)
        return jnp.asarray(x), torch.from_numpy(x.copy())
    xb = np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)
    return jnp.asarray(xb), torch.from_numpy(xb.view(np.int16).copy()).view(torch.bfloat16)


def _pattern(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int32).numpy().view(np.uint32) if x.dtype == torch.float32
                else x.view(torch.int16).numpy().view(np.uint16))
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x.view(np.uint16)


def _assert_same_bits(got, want):
    """Bit for bit; in bf16 a NaN only as a NaN (module docstring, (a))."""
    g, w = _pattern(got), _pattern(want)
    assert g.shape == w.shape and g.dtype == w.dtype
    if g.dtype == np.uint16:
        w_nan = (w & 0x7FFF) > 0x7F80
        assert np.array_equal((g & 0x7FFF) > 0x7F80, w_nan)
        g, w = g[~w_nan], w[~w_nan]
    assert np.array_equal(g, w), int(np.sum(g != w))


def _pallas_interpret(w, bits, scale):
    """``fake_quant_pallas`` in interpret mode, on 2-D rows padded to the
    (128, 128) block grid and sliced back (the reference ops' wrapping)."""
    shape = w.shape
    w2 = w.reshape(-1, shape[-1])
    M, N = w2.shape
    bm, bn = min(128, M), min(128, N)
    w2p = jnp.pad(w2, ((0, -M % bm), (0, -N % bn)))
    out = fake_quant_pallas(w2p, jnp.int32(bits), scale, block=(bm, bn), interpret=True)
    return out[:M, :N].reshape(shape)


def _group(net, dt, seed):
    rng = np.random.default_rng(seed)
    pairs = []
    for shape in _shapes(net):
        x = rng.standard_normal(shape).astype(np.float32)
        x.reshape(-1)[:3] = [0.0, -0.0, -np.abs(x).max()]   # zeros and a negative max
        pairs.append(_pair(x, dt))
    return pairs


@pytest.mark.parametrize("offset", [0, 3, 7])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("net", NETS)
def test_group_matches_reference_and_pallas_per_tensor(net, dt, offset):
    pairs = _group(net, dt, seed=offset)
    bits = [BITS[(i + offset) % len(BITS)] for i in range(len(pairs))]
    tws = [t for _, t in pairs]
    vec = torch.tensor(bits, dtype=torch.int32)
    plain, plain_s = tref.fake_quant_group_ref(tws, vec)
    before = dict(ops.counts)
    got, got_s = ops.fake_quant_group(tws, vec)
    assert ops.counts["plain"] == before["plain"] + 1
    assert ops.counts["fake_quant_group"] == before["fake_quant_group"]
    for i, ((jw, tw), b) in enumerate(zip(pairs, bits)):
        jscale = jwrpn.tensor_scale(jw)
        want = jwrpn.fake_quant_ste(jw, jnp.int32(b))
        _assert_same_bits(got_s[i], jscale)
        _assert_same_bits(plain_s[i], jscale)
        for out in (got[i], plain[i]):
            assert out.dtype == tw.dtype and out.shape == tw.shape
            _assert_same_bits(out, want)
        pallas = np.asarray(_pallas_interpret(jw, b, jscale), np.float32)
        if b == 16 and dt == "f32":          # the Pallas kernel's exp2 (docstring, (b))
            step = float(jscale) / (2 ** 15 - 1)
            assert np.abs(got[i].numpy() - pallas).max() <= step * (1 + 1e-6)
        else:
            assert np.array_equal(got[i].float().numpy(), pallas)


def _edge_arrays(dt):
    """An all-zero tensor (the eps floor), one holding a NaN, -0.0 entries
    beside the max, and one whose max sits where the floor's dtype decides
    the scale: f32 just above 1e-8 and below bf16(1e-8) = 1.0012e-8, bf16
    just below 1e-8 (the next bf16 up is bf16(1e-8) itself)."""
    rng = np.random.default_rng(5)
    nan = rng.standard_normal((33, 7)).astype(np.float32)
    nan[3, 2] = np.nan
    signed = rng.standard_normal((6, 5)).astype(np.float32)
    signed[0, :3] = [-0.0, 0.0, -0.0]
    near = 1.0005e-8 if dt == "f32" else 9.95e-9
    return {"zeros": np.zeros((5, 9), np.float32), "nan": nan, "signed zeros": signed,
            "near eps": (np.linspace(-1, 1, 301) * near).astype(np.float32)}


@pytest.mark.parametrize("bits", [2, 4, 8, 32])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", ["zeros", "nan", "signed zeros", "near eps"])
def test_group_edge_cases_match_reference(case, dt, bits):
    jw, tw = _pair(_edge_arrays(dt)[case], dt)
    outs, scales = ops.fake_quant_group([tw, tw], torch.tensor([bits, 32], dtype=torch.int32))
    jscale = jwrpn.tensor_scale(jw)
    _assert_same_bits(scales[0], jscale)
    _assert_same_bits(outs[0], jwrpn.fake_quant_ste(jw, jnp.int32(bits)))
    _assert_same_bits(outs[1], tw)           # 32 bits: the weights themselves
    if case == "near eps":                   # the floor in the weights' dtype decides
        floor = float(jnp.asarray(1e-8, DTYPES[dt]))
        assert float(scales[0]) == (floor if dt == "bf16" else float(np.float32(1.0005e-8)))
    if case == "zeros":
        assert float(scales[0]) == float(jnp.asarray(1e-8, DTYPES[dt]))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("net", NETS)
def test_group_ste_gradients_match_jax_grad_bitwise(net, dt):
    """The grouped STE through autograd against ``jax.vjp`` of the
    reference's ``fake_quant_ste``, per tensor, with cotangents holding
    +-inf, NaN and negative values (g * 0 gives -0.0 or NaN)."""
    pairs = _group(net, dt, seed=11)
    arrays = _edge_arrays(dt)
    pairs += [_pair(arrays[k], dt) for k in ("zeros", "nan", "near eps")]
    bits = [BITS[i % len(BITS)] for i in range(len(pairs))]
    rng = np.random.default_rng(12)
    cots = []
    for jw, _ in pairs:
        c = rng.standard_normal(jw.shape).astype(np.float32)
        c.reshape(-1)[:4] = [np.inf, np.nan, -3.0, -np.inf]
        cots.append(_pair(c, dt))
    leaves = [t.clone().requires_grad_(True) for _, t in pairs]
    outs = twrpn.fake_quant_ste_group(leaves, torch.tensor(bits, dtype=torch.int32))
    grads = torch.autograd.grad(outs, leaves, [tc for _, tc in cots])
    for (jw, _), (jc, _), b, out, g in zip(pairs, cots, bits, outs, grads):
        jout, vjp = jax.vjp(lambda w, b=b: jwrpn.fake_quant_ste(w, jnp.int32(b)), jw)
        _assert_same_bits(out, jout)
        _assert_same_bits(g, vjp(jc)[0])


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", ["zeros", "nan", "signed zeros", "near eps"])
def test_tensor_scale_without_the_host_copy_is_unchanged(case, dt):
    """``tensor_scale`` builds its floor with a fill on the weights' device
    now; the value is the one the host copy gave, and JAX's."""
    jw, tw = _pair(_edge_arrays(dt)[case], dt)
    s = tw.abs().amax()
    before = torch.maximum(s, torch.tensor(1e-8, dtype=s.dtype, device=s.device)).float()
    after = twrpn.tensor_scale(tw)
    assert _pattern(after).tolist() == _pattern(before).tolist()
    _assert_same_bits(after, jwrpn.tensor_scale(jw))
    per_col = twrpn.tensor_scale(tw.reshape(-1, tw.shape[-1]), axis=0)
    _assert_same_bits(per_col, jwrpn.tensor_scale(jw.reshape(-1, jw.shape[-1]), axis=0))


def _bwd_fits(n):
    return fq.BWD_PARAM_BYTES[0] + fq.BWD_PARAM_BYTES[1] * n <= fq.PARAM_CAP


@pytest.mark.parametrize("net,dtype,cluster,ctas,vecs", [
    ("lenet", torch.float32, 4, 16, 1),       # largest 2,400 weights: 600 per CTA
    ("lenet", torch.bfloat16, 2, 8, 1),
    ("resnet20", torch.float32, 8, 160, 5),   # 36,864 weights: 4,608 per CTA, 18 KB
    ("resnet20", torch.bfloat16, 8, 160, 3),
])
def test_group_plan_at_the_qat_groups(net, dtype, cluster, ctas, vecs):
    numels = [int(np.prod(s)) for s in _shapes(net)]
    plan = fq.fake_quant_group_plan(numels, dtype)
    assert (plan.cluster, plan.ctas, plan.vecs, plan.threads) == (cluster, (ctas,), vecs, 256)
    assert plan.second_read == () and plan.launches == ((0, len(numels)),)
    per = 16 // torch.empty((), dtype=dtype).element_size()
    assert plan.bwd_ctas == (sum(-(-n // (256 * fq.BWD_VECS * per)) for n in numels),)
    assert ctas <= 2 * 132 and all(max(b) <= fq.PARAM_CAP for b in plan.param_bytes)
    # every tensor's run of 16-byte vectors fits vecs per thread
    assert max(-(-(-(-n // per)) // cluster) for n in numels) <= 256 * vecs


def test_group_plan_reads_a_tensor_beyond_the_registers_twice():
    numels = [int(np.prod(s)) for s in _shapes("resnet20")] + [WG[0] * WG[1]]
    for dtype in (torch.float32, torch.bfloat16):
        plan = fq.fake_quant_group_plan(numels, dtype)
        assert plan.cluster == fq.MAX_CLUSTER and plan.second_read == (len(numels) - 1,)
        assert plan.ctas == (len(numels) * fq.MAX_CLUSTER,)


def test_group_plan_splits_at_the_parameter_cap():
    assert _bwd_fits(fq.GROUP_MAX) and not _bwd_fits(fq.GROUP_MAX + 1)
    assert fq.FWD_PARAM_BYTES[0] + fq.FWD_PARAM_BYTES[1] * fq.GROUP_MAX <= fq.PARAM_CAP
    plan = fq.fake_quant_group_plan([100] * 250, torch.float32)
    assert plan.launches == ((0, 102), (102, 204), (204, 250))
    assert plan.ctas == (102, 102, 46) and plan.param_bytes[0] == (2472, 4096)
    with pytest.raises(ValueError):
        fq.fake_quant_group_plan([], torch.float32)
    with pytest.raises(ValueError):
        fq.fake_quant_group_plan([4, 0], torch.float32)
    with pytest.raises(TypeError):
        fq.fake_quant_group_plan([4], torch.float16)


def test_group_of_one_and_the_flat_op_agree_on_the_cpu():
    jw, tw = _pair(np.random.default_rng(3).standard_normal((16, 6, 5, 5)), "f32")
    for b in BITS:
        (got,), scale = ops.fake_quant_group([tw], torch.tensor([b], dtype=torch.int32))
        flat = ops.fake_quant(tw, torch.tensor(b, dtype=torch.int32), twrpn.tensor_scale(tw))
        assert torch.equal(got, flat) and torch.equal(scale[0], twrpn.tensor_scale(tw))
        assert torch.equal(twrpn.fake_quant_ste(tw, b), got)
    with pytest.raises(ValueError):
        twrpn.fake_quant_ste_group([tw, tw], torch.tensor([4], dtype=torch.int32))
    with pytest.raises(ValueError):
        twrpn.fake_quant_ste_group([], [])


def test_cuda_wrappers_refuse_cpu_tensors():
    w = torch.ones(4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        fq.fake_quant_group_cuda([w], torch.tensor([4], dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        fq.fake_quant_group_bwd_cuda([w], [w], torch.ones(1))


def test_qat_forward_and_backward_are_one_group_call_each():
    task = CNNTask("lenet", seed=0, batch=4, device="cpu")
    bits = {"conv1": 3, "conv2": 2, "fc1": 5, "fc2": 32}
    ops.reset_counts()
    params, _ = task.train(1, bits)
    assert ops.counts["plain"] == 2          # one grouped forward, one grouped STE
    task.accuracy(params, bits)
    assert ops.counts["plain"] == 4          # two validation batches
    assert ops.counts["fake_quant"] == 0 and ops.counts["fake_quant_group"] == 0


def _assert_cnn_params_close(tp, jp, tol):
    jt = cnn_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for n in jt:
        for k in ("w", "b"):
            ref = jt[n][k].numpy()
            assert np.abs(tp[n][k].numpy() - ref).max() <= tol * max(np.abs(ref).max(), 1e-30), (n, k)


def test_resnet20_qat_step_matches_reference():
    jt = JCNNTask("resnet20", seed=0, batch=4)
    tt = CNNTask("resnet20", seed=0, batch=4, device="cpu")
    tt.params = cnn_params_from_numpy(jax.tree.map(np.asarray, jt.params), device="cpu")
    tt.mom = tt._zeros_like(tt.params)
    names = [g.name for g in jmodels.build_cnn("resnet20").quant_groups()]
    assert names == tt.names
    bits = {n: (2, 3, 4, 5, 6, 8, 32)[i % 7] for i, n in enumerate(names)}
    jp, jm = jt.train(1, bits)
    tp, tm = tt.train(1, bits)
    _assert_cnn_params_close(tp, jp, 1e-5)
    _assert_cnn_params_close(tm, jm, 1e-5)
    assert tt.accuracy(tp, bits) == jt.accuracy(jp, bits)
