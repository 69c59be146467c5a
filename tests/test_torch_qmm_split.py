"""The exact three-term bf16 split of f32 activations that the qmm kernels
use on the tensor cores (``csrc/bitserial.cuh::split3``, plain version
``kernels/ref.py::split_bf16x3``), held on the CPU.

The split: x1 is x truncated to bf16, x2 the remainder truncated, x3 what
is left; a non-finite x is x1 alone.  Its sum is x exactly wherever x is
a multiple of 2^-133 (bf16's least subnormal) -- every |x| >= 2^-110 and
every bf16 value -- and elsewhere x with its bits below 2^-133 dropped
toward zero, which no bf16 value can hold.

The kernels multiply each term by the integer codes u - n (exact in bf16)
and add the three products into one f32 accumulator.  That product,
emulated here with f32 matmuls, is held against the port's ``qmm_ref``
and the JAX package's on the same numpy inputs.  Tolerance 1e-5 *
max|ref|: every product is exact, and the f32 sums only run in another
order.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_parity  # noqa: F401  (sets torch's CPU threads)
from repro.kernels.ref import qmm_ref as jax_qmm_ref
from repro_torch.kernels.ref import qmm_ref, split_bf16x3
from repro_torch.quant.pack import pack_weight, unpack_bitplanes

TINY = 2.0 ** -133          # bf16's least subnormal: the split's quantum
EXACT_FROM = 2.0 ** -110    # from here up every f32 value is a multiple of TINY


def _f32(bits: int) -> torch.Tensor:
    return torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)


def _bf16_bits(t: torch.Tensor) -> int:
    return int(t.view(torch.int16).item()) & 0xFFFF


EDGES = [
    0x00000000, 0x80000000,              # +-0
    0x7F800000, 0xFF800000,              # +-inf
    0x7FC00000, 0xFFC00000,              # quiet NaNs
    0x7F800001, 0xFF80FFFF, 0x7F80A5A5,  # NaNs whose payload lies only in the low 16 bits
    0x7FBF0000,                          # a signalling NaN already bf16-shaped
    0x7F7FFFFF, 0xFF7FFFFF,              # f32 max (above bf16's largest finite)
    0x7F7F8000,                          # between bf16 max and f32 max
    0x00000001, 0x807FFFFF, 0x00010000,  # subnormals: the least, the largest, a bf16 one
    0x00800000, 0x00800001,              # the least normal, one ulp above
    0x0C7FFFFF,                          # just below 2^-102 with every bit set
    0x3F800001, 0x3FAAAAAB, 0xC2F6E979,  # values bf16 cannot hold
]


def _check_split(bits: int) -> None:
    x = _f32(bits)
    terms = split_bf16x3(x)
    assert all(t.dtype == torch.bfloat16 and t.shape == x.shape for t in terms)
    xv = float(x.item())
    x1, x2, x3 = (float(t.float().item()) for t in terms)
    if math.isnan(xv):
        # a NaN stays a NaN: quiet bit set, sign and high payload kept
        assert math.isnan(x1) and x2 == 0.0 and x3 == 0.0
        assert _bf16_bits(terms[0]) == (bits | 0x00400000) >> 16
        return
    if math.isinf(xv):
        assert x1 == xv and x2 == 0.0 and x3 == 0.0
        return
    assert all(math.isfinite(v) for v in (x1, x2, x3))     # truncation never overflows
    total = x1 + x2 + x3                                     # exact in f64: 24 bits at most
    assert total == math.trunc(xv / TINY) * TINY
    if abs(xv) >= EXACT_FROM or (bits & 0xFFFF) == 0:       # a bf16 value, or not tiny
        assert total == xv
    # each term carries x's sign and is below 2^-7 of the one before
    for hi, lo in ((x1, x2), (x2, x3)):
        assert lo == 0.0 or (math.copysign(1, lo) == math.copysign(1, xv)
                             and abs(lo) < abs(hi) * 2.0 ** -7)


@settings(max_examples=2000, deadline=None)
@given(st.integers(0, 2 ** 32 - 1))
def test_split_bf16x3_reconstructs_x(bits):
    _check_split(bits)


@pytest.mark.parametrize("bits", EDGES, ids=[f"{b:#010x}" for b in EDGES])
def test_split_bf16x3_edge_values(bits):
    _check_split(bits)


def test_split_bf16x3_is_elementwise_on_tensors():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 2 ** 32, size=(64, 96), dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(raw.view(np.float32).copy())
    whole = split_bf16x3(x)
    for i in (0, 17, 63):
        for t, row in zip(whole, split_bf16x3(x[i])):
            assert torch.equal(t[i].view(torch.int16), row.view(torch.int16))


def three_term_qmm(x: torch.Tensor, planes: torch.Tensor, scale: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """The f32 qmm as the tensor-core bodies compute it: each bf16 term of
    x times the codes u - n, the three products summed in f32, then / n *
    scale."""
    codes = unpack_bitplanes(planes, bits).float()
    acc = torch.zeros((x.shape[0], codes.shape[1]), dtype=torch.float32)
    for term in split_bf16x3(x):
        acc = acc + term.float() @ codes
    n = float(2 ** (bits - 1) - 1)
    return acc / n * scale


QMM_CASES = [(1, 64, 8, 4), (4, 256, 96, 4), (20, 512, 64, 2), (64, 136, 13, 8),
             (33, 512, 130, 3), (256, 128, 32, 4)]


@pytest.mark.parametrize("M,K,N,bits", QMM_CASES)
def test_three_term_product_matches_both_references(M, K, N, bits):
    rng = np.random.default_rng(M * 1000 + K + bits)
    row_scale = np.exp(rng.uniform(-8, 8, (M, 1)))
    x_np = (rng.standard_normal((M, K)) * row_scale).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)) * K ** -0.5
    planes, scale = pack_weight(w, bits)
    x = torch.from_numpy(x_np)
    assert not torch.equal(x, x.to(torch.bfloat16).float())   # x is not bf16
    got = three_term_qmm(x, planes, scale, bits)
    ref = qmm_ref(x, planes, scale, bits)
    jref = torch.from_numpy(np.array(jax_qmm_ref(jnp.asarray(x_np), jnp.asarray(planes.numpy()),
                                                 jnp.asarray(scale.numpy()), bits)))
    tol = 1e-5 * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= tol
    assert (got - jref).abs().max().item() <= tol
    # x1 alone (x cut to bf16) lands far outside the bound: the test sees a lost term
    one = (split_bf16x3(x)[0].float() @ unpack_bitplanes(planes, bits).float()
           / float(2 ** (bits - 1) - 1) * scale)
    assert (one - ref).abs().max().item() > 10 * tol
