"""The vlm and audio families in the port against the JAX package: their
position schemes and the models that use them, with the reference's own
weights carried over by ``repro_torch.convert``.

- ``apply_mrope`` with three distinct position streams (t, h, w), at
  qwen2-vl's head dim 128 and sections (16, 24, 24) and at a narrow head
  dim, within 1e-6 * max|ref| in f32; the sinusoids ``_abs_sin`` within
  1e-6 at positions below 16, and beyond within the position times a few
  ulps of each frequency (XLA's and torch's f32 ``exp`` round some
  frequencies one ulp apart).
- qwen2-vl-7b (M-RoPE; the smoke head dim 16 takes sections (2, 3, 3),
  so every stream rotates some frequencies) and musicgen-large (absolute
  sinusoids, GELU MLP): ``forward`` from precomputed ``embeds`` (the
  frontends are stubs) with explicit (3, B, S) positions for qwen2-vl,
  the full-prompt ``prefill`` and ``decode_step``, within 1e-4 * max|ref|
  in f32 and 2e-2 in bf16 (the dense model's bounds,
  ``tests/test_torch_model.py``).
- Served greedy streams equal the reference engine's, run op by op, at 4
  bits with fp, int8 and int4 KV.
- The fused decode op rotates by RoPE: with packed q/k/v over int4
  blocks, neither family ever takes it.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.common import apply_mrope as jax_apply_mrope
from repro.quant.qat import policy_for as jax_policy_for
from repro.serve import ServeEngine as JaxEngine
from repro.train.serve import quantize_for_serving as jax_qfs
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model
from repro_torch.models.common import apply_mrope
from repro_torch.serve import SamplingParams, ServeEngine
from torch_parity import models, rel_err, to_port

QWEN, MUSICGEN = "qwen2-vl-7b", "musicgen-large"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
OP_BY_OP = dict(sample_device=False, pipeline=False)
SMOKE_SECTIONS = (2, 3, 3)   # the smoke head dim 16: a half-dim of 8


def _positions3(B, S, seed):
    """Three distinct (B, S) streams: time, and a height/width grid."""
    rng = np.random.default_rng(seed)
    t = np.arange(S)[None, :] + rng.integers(0, 50, (B, 1))
    h = rng.integers(0, 40, (B, S))
    w = rng.integers(0, 40, (B, S))
    return np.stack([t, h, w]).astype(np.int32)


@pytest.mark.parametrize("hd,sections", [(128, (16, 24, 24)), (16, SMOKE_SECTIONS)])
def test_apply_mrope_matches_reference(hd, sections):
    B, S, H = 2, 7, 3
    x = np.random.default_rng(hd).standard_normal((B, S, H, hd)).astype(np.float32)
    pos = _positions3(B, S, seed=hd)
    assert len({pos[i].tobytes() for i in range(3)}) == 3
    want = jax_apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= 1e-6
    # a stream moved alone moves exactly its own section of frequencies
    for s in range(3):
        moved = pos.copy()
        moved[s] += 5
        diff = (apply_mrope(torch.from_numpy(x), torch.from_numpy(moved), 1e6, sections)
                - got).abs().amax(dim=(0, 1, 2))
        lo, hi = sum(sections[:s]), sum(sections[:s + 1])
        changed = (diff[:hd // 2] > 0) | (diff[hd // 2:] > 0)
        assert changed[lo:hi].all() and not changed[:lo].any() and not changed[hi:].any()


def test_abs_sin_matches_reference():
    """Within 1e-6 at positions below 16.  The angle ``position * freq``
    carries the f32 ``exp`` of each frequency, and XLA's and torch's
    ``exp`` round some frequencies one ulp apart (neither is correctly
    rounded everywhere), so further out the two part by up to the
    position times a few ulps of the frequency: at every element within
    1e-6 + angle * 2^-21 (4 relative ulps), up to position 4095."""
    jm, tm = models(MUSICGEN)
    rng = np.random.default_rng(0)
    for D in (64, 2048):
        pos = rng.integers(0, 16, (2, 9)).astype(np.int32)
        want = jm._abs_sin(jnp.asarray(pos), D)
        got = tm._abs_sin(torch.from_numpy(pos), D)
        assert got.shape == (2, 9, D) and got.dtype == torch.float32
        assert rel_err(got.numpy(), want) <= 1e-6
        pos = rng.integers(0, 4096, (2, 9)).astype(np.int32)
        want = np.asarray(jm._abs_sin(jnp.asarray(pos), D), np.float64)
        got = tm._abs_sin(torch.from_numpy(pos), D).numpy().astype(np.float64)
        half = D // 2
        ang = pos[..., None] * np.exp(-math.log(10_000.0) * np.arange(half) / half)
        bound = 1e-6 + np.concatenate([ang, ang], axis=-1) * 2.0 ** -21
        assert (np.abs(got - want) <= bound).all()


def _models(arch, dtype):
    jcfg, tcfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    over = {"dtype": dtype}
    if arch == QWEN:
        over["mrope_sections"] = SMOKE_SECTIONS
    return (jax_build_model(dataclasses.replace(jcfg, **over)),
            build_model(dataclasses.replace(tcfg, **over)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [QWEN, MUSICGEN])
def test_model_matches_reference(arch, dtype):
    jm, tm = _models(arch, dtype)
    jp = jm.init(jax.random.PRNGKey(0))
    tp, tol = to_port(jp), TOL[dtype]
    B, S, D = 2, 11, jm.cfg.d_model
    rng = np.random.default_rng(4)
    embeds = (rng.standard_normal((B, S, D)) * 0.5).astype(np.float32)
    kw_j, kw_t = {"embeds": jnp.asarray(embeds)}, {"embeds": torch.from_numpy(embeds)}
    if arch == QWEN:
        pos = _positions3(B, S, seed=1)
        kw_j["positions"], kw_t["positions"] = jnp.asarray(pos), torch.from_numpy(pos)
    jl, jaux = jm.forward(jp, **kw_j)
    tl, taux = tm.forward(tp, **kw_t)
    assert tl.dtype == torch.float32 and tl.shape == (B, S, jm.cfg.vocab_size)
    assert rel_err(tl.numpy(), jl) <= tol and float(taux) == float(jaux) == 0.0
    # the full-prompt prefill from embeds, then decode steps from tokens
    jl, jc = jm.prefill(jp, embeds=jnp.asarray(embeds), max_len=S + 3)
    tl, tc = tm.prefill(tp, embeds=torch.from_numpy(embeds), max_len=S + 3)
    assert rel_err(tl.numpy(), jl) <= tol
    for key in ("k", "v"):
        assert rel_err(tc[key].float().numpy(), np.asarray(jc[key], np.float32)) <= tol
    toks = np.asarray(np.argmax(np.asarray(jl)[:, -1], -1)[:, None], np.int32)
    for _ in range(2):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks))
        assert rel_err(tl.numpy(), jl) <= tol
        toks = np.asarray(np.argmax(np.asarray(jl)[:, -1], -1)[:, None], np.int32)


# ----------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def served():
    out = {}
    for arch in (QWEN, MUSICGEN):
        jm, tm = models(arch)
        jsp = jax_qfs(jm, jm.init(jax.random.PRNGKey(0)), jax_policy_for(jm, 4))
        out[arch] = (jm, tm, jsp, to_port(jsp))
    return out


def _workload(vocab: int, lens=(5, 11, 8), gen: int = 8, seed: int = 5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n).astype(np.int32), gen - i) for i, n in enumerate(lens)]


def _streams(engine, work, arrival_every=2):
    launcher.drive(engine, work, arrival_every, SamplingParams())
    return [engine.output(r) for r in range(len(work))]


KW = dict(num_slots=3, max_len=24, block_size=4, prefill_chunk=4)


@pytest.mark.parametrize("kv_bits", [None, 8, 4], ids=["fp", "int8", "int4"])
@pytest.mark.parametrize("arch", [QWEN, MUSICGEN])
def test_streams_equal_reference_op_by_op(served, arch, kv_bits):
    jm, tm, jsp, tsp = served[arch]
    work = _workload(jm.cfg.vocab_size)
    ref = JaxEngine(jm, jsp, prefill_fn=jm.prefill_chunk, decode_fn=jm.decode_step,
                    kv_bits=kv_bits, **OP_BY_OP, **KW)
    want = _streams(ref, work)
    got = _streams(ServeEngine(tm, tsp, device="cpu", kv_bits=kv_bits, **KW), work)
    assert got == want
    assert [len(s) for s in got] == [g for _, g in work]


@pytest.mark.parametrize("arch", [QWEN, MUSICGEN])
def test_fused_decode_never_runs(served, arch, monkeypatch):
    """Packed q/k/v over int4 blocks: the unfused quantized attention
    runs every layer of every decode step, never the fused op."""
    jm, tm, _, tsp = served[arch]

    def refuse(*a, **k):
        raise AssertionError(f"the fused decode ran on a {tm.cfg.rope} model")

    monkeypatch.setattr(ops, "fused_qkv_paged_decode", refuse)
    attend = []
    paged = ops.paged_attention

    def counted(*a, **k):
        attend.append(1)
        return paged(*a, **k)

    monkeypatch.setattr(ops, "paged_attention", counted)
    work = _workload(jm.cfg.vocab_size, gen=4)
    eng = ServeEngine(tm, tsp, device="cpu", kv_bits=4, **KW)
    assert [len(s) for s in _streams(eng, work)] == [g for _, g in work]
    assert len(attend) == tm.cfg.num_layers * eng.metrics()["decode_steps"] > 0
