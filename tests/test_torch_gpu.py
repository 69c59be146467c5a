"""The hand-written CUDA kernels against their plain versions, on an sm_90
card (skipped elsewhere).  No JAX here: the machine with the card runs
only the port.  Run there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: both versions sum exact f32 products (bf16 activations times
integer codes, or bf16 scores) in different orders over up to K = 13696
terms, so 1e-4 * max|plain| — the bound chip_smoke.py states.
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
                          "paged_attention": 0, "plain": 0}
