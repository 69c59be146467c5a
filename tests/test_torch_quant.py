"""repro_torch.quant against repro.quant: WRPN codes, scales, QDQ values
and bitplane packing are BITWISE equal for bits 2..8, including
contraction and output widths that are not multiples of 128 (the ragged
d_ff = 13696 edge of glm4-9b, scaled down).  The arithmetic is
elementwise IEEE f32 in both packages, so no tolerance applies."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets torch's CPU threads)
from repro.quant import pack as jpack
from repro.quant import wrpn as jwrpn
from repro_torch.quant import pack as tpack
from repro_torch.quant import wrpn as twrpn

BITS = [2, 3, 4, 5, 6, 7, 8]
SHAPES = [(136, 200), (64, 48), (8, 3)]  # (K, N): K//8 = 17, N = 200 ragged


def _weights(shape, seed, dtype=np.float32):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero column takes the eps floor of the scale
    return w.astype(dtype)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_to_int_bitwise(bits, shape):
    w = _weights(shape, bits)
    for axis in (0, None):
        jc, js = jwrpn.quantize_to_int(jnp.asarray(w), bits, axis=axis)
        tc, ts = twrpn.quantize_to_int(torch.from_numpy(w), bits, axis=axis)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert tc.dtype == torch.int8
        np.testing.assert_array_equal(
            twrpn.dequantize_from_int(tc, bits, ts).numpy(),
            np.asarray(jwrpn.dequantize_from_int(jc, bits, js)))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", SHAPES)
def test_pack_weight_and_bitplanes_bitwise(bits, shape):
    w = _weights(shape, 100 + bits)
    jp, js = jpack.pack_weight(jnp.asarray(w), bits)
    tp, ts = tpack.pack_weight(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tp.dtype == torch.uint8 and tuple(tp.shape) == (bits, shape[0] // 8, shape[1])
    # unpack inverts pack, and agrees with the reference's unpack
    codes = tpack.unpack_bitplanes(tp, bits)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jpack.unpack_bitplanes(jp, bits)))
    tc, _ = twrpn.quantize_to_int(torch.from_numpy(w), bits, axis=0)
    np.testing.assert_array_equal(codes.numpy(), tc.numpy().astype(np.int32))
    np.testing.assert_array_equal(
        tpack.dequant_packed(tp, ts, bits).numpy(),
        np.asarray(jpack.dequant_packed(jp, js, bits)))


@pytest.mark.parametrize("bits", BITS)
def test_fake_quant_bitwise_bf16(bits):
    """The serving embedding's QDQ (bf16 table, per-column scale) and the
    per-tensor form."""
    w32 = _weights((251, 64), 200 + bits)
    jw = jnp.asarray(w32).astype(jnp.bfloat16)
    tw = torch.from_numpy(w32).to(torch.bfloat16)
    for axis in (0, None):
        ref = np.asarray(jwrpn.fake_quant(jw, bits, axis=axis).astype(jnp.float32))
        got = twrpn.fake_quant(tw, bits, axis=axis)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), ref)


def test_pack_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tpack.pack_bitplanes(torch.zeros((12, 4), dtype=torch.int8), 4)
    with pytest.raises(ValueError):
        tpack.pack_bitplanes(torch.zeros((16, 4), dtype=torch.int8), 9)
    with pytest.raises(ValueError):
        tpack.unpack_bitplanes(torch.zeros((3, 2, 4), dtype=torch.uint8), 4)
