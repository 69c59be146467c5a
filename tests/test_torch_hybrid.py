"""The hybrid family (hymba-1.5b's smoke config: attention beside a Mamba
SSM branch, a sliding window of 8) in the port against the JAX package,
with the reference's own weights carried over by ``repro_torch.convert``.

- ``mamba_forward`` (with and without a carried ``init_state``, with
  per-row ``valid`` lengths, lengths on and off the chunk) and
  ``mamba_step`` within 1e-5 * max|ref| in f32, the returned state too:
  the in-chunk scan repeats ``jax.lax.associative_scan``'s combine tree,
  and ``exp`` and the small products differ in rounding only.
- Logits of ``forward``, ``prefill`` and ``decode_step``, and the cache
  leaves (ring K/V and ``ssm_h``/``ssm_conv``), within 1e-4 * max|ref| in
  f32 and 2e-2 in bf16 (the bf16 reference run op by op, as in
  ``test_torch_rwkv.py``).
- ``quant_groups``/``frozen_bits`` equal (``ssm.in_x``, ``ssm.in_z``,
  ``ssm.out`` per layer), and the packed serving params bitwise.
- The paged engine over ring blocks plus SSM slot rows gives the reference
  engine's greedy streams, run op by op, with fp, int8 and int4 ring
  blocks at prefill chunks 4 and 16; slot and paged pools give equal
  streams with rows reused; the prefix cache is off.
- With packed q/k/v over int4 ring blocks the fused decode never runs
  (the layers are windowed), in plain decode and in a spec window.
- Speculative decoding on a model with a 32-token window (so windows are
  not all capped): streams equal the non-spec ones and the reference spec
  engine's, fix-ups run, and the SSM state handed to every verify and
  fix-up is bitwise the pre-draft state; with int4 ring blocks too (no
  fused launch).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import mamba as jmamba
from repro.quant.pack import Packed as JPacked
from repro.quant.qat import policy_for as jax_policy_for
from repro.serve import ServeEngine as JaxEngine
from repro.spec import SpecConfig as JaxSpec
from repro.train.serve import quantize_for_serving as jax_qfs
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model
from repro_torch.models import mamba as tmamba
from repro_torch.quant.pack import Packed
from repro_torch.quant.qat import policy_for
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.spec import SpecConfig
from repro_torch.train.serve import quantize_for_serving
from torch_parity import (ReplayedEagerly, jax_to_numpy, models, own_path_replay, rel_err,
                          to_port, watch_spec_state)

ARCH = "hymba-1.5b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
OP_BY_OP = dict(sample_device=False, pipeline=False)
SSM = ("ssm_h", "ssm_conv")


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_tree(tree):
    from repro_torch.convert import params_from_numpy

    return params_from_numpy(jax_to_numpy(tree), device="cpu")


@pytest.fixture(scope="module")
def served():
    jm, tm = models(ARCH)
    jsp = jax_qfs(jm, jm.init(jax.random.PRNGKey(0)), jax_policy_for(jm, 4))
    return jm, tm, jsp, to_port(jsp)


# ------------------------------------------------------------- the scan
def _mamba_params(D=16, Di=32, N=4, ks=4, dtype=jnp.float32):
    jp = jmamba.init_mamba(jax.random.PRNGKey(3), D, Di, N, ks, dtype)
    return jp, _port_tree(jp)


@pytest.mark.parametrize("S,chunk", [(13, 4), (16, 8), (2, 64), (70, 64)])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "init_state"])
def test_mamba_forward_matches_reference(S, chunk, carried):
    jp, tp = _mamba_params()
    rng = np.random.default_rng(S)
    B = 2
    x = rng.normal(size=(B, S, 16)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if carried:
        h0 = rng.normal(size=(B, 32, 4)).astype(np.float32)
        conv0 = rng.normal(size=(B, 3, 32)).astype(np.float32)
        valid = np.array([S, max(S - 3, 1)], np.int32)
        kw_j = dict(init_state={"h": jnp.asarray(h0), "conv": jnp.asarray(conv0)},
                    valid=jnp.asarray(valid))
        kw_t = dict(init_state={"h": _t(h0), "conv": _t(conv0)}, valid=_t(valid))
    jy, js = jmamba.mamba_forward(jnp.asarray(x), jp, chunk=chunk, return_state=True, **kw_j)
    ty, ts = tmamba.mamba_forward(_t(x), tp, chunk=chunk, return_state=True, **kw_t)
    assert rel_err(ty.numpy(), jy) <= 1e-5
    assert rel_err(ts["h"].numpy(), js["h"]) <= 1e-5
    assert rel_err(ts["conv"].numpy(), js["conv"]) <= 1e-5   # in_x's product
    ty2, none = tmamba.mamba_forward(_t(x), tp, chunk=chunk, **kw_t)
    assert none is None and torch.equal(ty2, ty)


def test_mamba_step_matches_reference():
    jp, tp = _mamba_params()
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 1, 16)).astype(np.float32)
    h = rng.normal(size=(3, 32, 4)).astype(np.float32)
    conv = rng.normal(size=(3, 3, 32)).astype(np.float32)
    jy, js = jmamba.mamba_step(jnp.asarray(x), jp, {"h": jnp.asarray(h), "conv": jnp.asarray(conv)})
    ty, ts = tmamba.mamba_step(_t(x), tp, {"h": _t(h), "conv": _t(conv)})
    assert rel_err(ty.numpy(), jy) <= 1e-5
    assert rel_err(ts["h"].numpy(), js["h"]) <= 1e-5
    np.testing.assert_array_equal(ts["conv"].numpy(), np.asarray(js["conv"]))


# ----------------------------------------------------------------- model
def _op_by_op(dtype):
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_reference(dtype):
    jm, tm = models(ARCH, dtype=dtype)
    jp = jm.init(jax.random.PRNGKey(0))
    tp, tol = to_port(jp), TOL[dtype]
    toks = np.random.default_rng(4).integers(0, jm.cfg.vocab_size, (2, 11)).astype(np.int32)
    got, _ = tm.forward(tp, tokens=_t(toks))
    with _op_by_op(dtype):
        want, _ = jm.forward(jp, tokens=jnp.asarray(toks))
        jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks), max_len=20)
    assert rel_err(got.numpy(), want) <= tol
    tl, tc = tm.prefill(tp, tokens=_t(toks), max_len=20)
    assert rel_err(tl.numpy(), jl) <= tol
    assert set(tc) == set(jc)
    for key in ("k", "v") + SSM:
        assert rel_err(tc[key].float().numpy(), np.asarray(jc[key], np.float32)) <= tol, key
    t = np.array([[3], [5]], np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(t))
        state = {k: tc[k] for k in SSM}
        tl, tc = tm.decode_step(tp, tc, _t(t))
        assert all(tc[k] is state[k] for k in SSM)   # written in place
        assert rel_err(tl.numpy(), jl) <= tol
        t = np.asarray(np.argmax(np.asarray(jl)[:, -1], -1)[:, None], np.int32)
    for key in SSM:
        assert rel_err(tc[key].float().numpy(), np.asarray(jc[key], np.float32)) <= tol, key


def test_loss_refused():
    """``loss``, refused until item 9b was ported, now trains the hybrid
    family: loss, nll and aux on the reference's params (f32, no QAT)
    within 1e-5 of the reference's (``tests/test_torch_train_families.py``
    holds the gradients)."""
    jm, tm = models(ARCH, dtype="float32")
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, 251, (2, 24)).astype(np.int32) for k in ("tokens", "labels")}
    jl, jmet = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmet = tm.loss(to_port(jp), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert rel_err(tl.numpy(), jl) <= 1e-5 and rel_err(tmet["nll"].numpy(), jmet["nll"]) <= 1e-5
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0


def test_quant_groups_frozen_bits_and_serving_params_match_reference():
    jm, tm = models(ARCH)
    jg, tg = jm.quant_groups(), tm.quant_groups()
    assert [(g.name, g.path, g.shape, g.n_weights, g.n_macs, g.layer) for g in tg] == \
        [(g.name, g.path, g.shape, g.n_weights, g.n_macs, g.layer) for g in jg]
    assert sum(g.name.endswith(("ssm.in_x", "ssm.in_z", "ssm.out")) for g in tg) == 6
    assert tm.frozen_bits() == jm.frozen_bits()
    jp = jm.init(jax.random.PRNGKey(2))
    jsp = jax_qfs(jm, jp, jax_policy_for(jm, default_bits=4))
    tsp = quantize_for_serving(tm, to_port(jp), policy_for(tm, default_bits=4), device="cpu")
    n = 0
    for jl, tl in zip(jsp["blocks"][0], tsp["blocks"][0]):
        for grp, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wg", "wu", "wd")),
                           ("ssm", ("in_x", "in_z", "out"))):
            for name in names:
                jw, tw = jl[grp][name], tl[grp][name]
                assert isinstance(jw, JPacked) and isinstance(tw, Packed) and tw.bits == 4
                np.testing.assert_array_equal(tw.planes.numpy(), np.asarray(jw.planes))
                np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
                n += 1
        for name in ("conv", "w_B", "w_C", "dt1", "dt2", "dt_bias", "A_log", "D_skip"):
            np.testing.assert_array_equal(tl["ssm"][name].numpy(), np.asarray(jl["ssm"][name]))
        assert tl["mix"].shape == () and float(tl["mix"]) == float(jl["mix"])
    assert n == 10 * jm.cfg.num_layers


# ------------------------------------------------------------- the engine
def _workload(vocab: int, lens=(5, 19, 13), gen: int = 7, seed: int = 5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n).astype(np.int32), gen - i) for i, n in enumerate(lens)]


def _kw(chunk: int, work, **extra):
    return dict(num_slots=3, max_len=max(len(p) + g for p, g in work) + 1, block_size=4,
                prefill_chunk=chunk, **extra)


def _streams(engine, work, arrival_every=2):
    launcher.drive(engine, work, arrival_every, SamplingParams())
    return [engine.output(r) for r in range(len(work))]


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("kv_bits", [None, 8, 4], ids=["fp", "int8", "int4"])
def test_streams_equal_reference_op_by_op(served, kv_bits, chunk):
    """Prompts of 5-19 tokens past the 8-token ring; chunk 16 is longer
    than the ring."""
    jm, tm, jsp, tsp = served
    work = _workload(jm.cfg.vocab_size)
    kw = _kw(chunk, work, kv_bits=kv_bits)
    ref = JaxEngine(jm, jsp, prefill_fn=jm.prefill_chunk, decode_fn=jm.decode_step,
                    **OP_BY_OP, **kw)
    want = _streams(ref, work)
    eng = ServeEngine(tm, tsp, device="cpu", **kw)
    assert _streams(eng, work) == want
    pool = eng.pool
    assert pool.recurrent_keys == SSM and pool.blocks_per_seq * pool.block_size == 8
    assert pool.length_bound is None and not pool.prefix_cache
    assert eng.metrics()["prefix_cache"]["enabled"] is False


def test_paged_equals_slot_with_row_reuse(served):
    jm, tm, jsp, tsp = served
    work = _workload(jm.cfg.vocab_size, lens=(4, 6, 5, 9, 3), gen=6, seed=11)
    kw = dict(num_slots=2, max_len=24, block_size=4, prefill_chunk=4)
    want = _streams(ServeEngine(tm, tsp, device="cpu", cache="slot", **kw), work, 0)
    assert _streams(ServeEngine(tm, tsp, device="cpu", **kw), work, 0) == want


@pytest.mark.parametrize("arch,kv_bits", [(ARCH, None), (ARCH, 8), (ARCH, 4), ("glm4-9b", 8),
                                          ("rwkv6-1.6b", None)])
def test_recurrent_keys_one_list(arch, kv_bits):
    """The pool's row state, the spec snapshot and the graphed step's
    capture all read ``models.model.recurrent_keys``: the O(1) state
    leaves only, never K/V blocks, their scales or the bookkeeping."""
    from repro_torch.models.model import recurrent_keys
    from repro_torch.serve.cache import PagedCachePool

    _, tm = models(arch)
    pool = PagedCachePool(tm, 2, 40, block_size=4, kv_bits=kv_bits, device="cpu")
    want = {ARCH: SSM, "glm4-9b": (), "rwkv6-1.6b": ("wkv", "x_tm", "x_cm")}[arch]
    assert pool.recurrent_keys == want == recurrent_keys(pool.step_cache())


def _refuse_fused(monkeypatch):
    from repro_torch.kernels import ops

    def refuse(*a, **k):
        raise AssertionError("the fused decode ran on a windowed hybrid layer")

    monkeypatch.setattr(ops, "fused_qkv_paged_decode", refuse)


def test_fused_decode_never_runs(served, monkeypatch):
    jm, tm, jsp, tsp = served
    _refuse_fused(monkeypatch)
    work = _workload(jm.cfg.vocab_size, gen=6)
    eng = ServeEngine(tm, tsp, device="cpu", **_kw(4, work, kv_bits=4))
    assert all(len(s) == g for s, (_, g) in zip(_streams(eng, work), work))


# --------------------------------------------------------- speculation
@pytest.fixture(scope="module")
def wide_window():
    """hymba smoke with a 32-token window: spec windows are not all capped."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), sliding_window=32)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), sliding_window=32)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jsp = jax_qfs(jm, jm.init(jax.random.PRNGKey(5)), jax_policy_for(jm, 4))
    return jm, tm, jsp, to_port(jsp)


@pytest.mark.parametrize("kv_bits", [None, 4], ids=["fp", "int4"])
def test_spec_streams_fixups_and_snapshot(wide_window, kv_bits, monkeypatch):
    jm, tm, jsp, tsp = wide_window
    _refuse_fused(monkeypatch)
    work = _workload(jm.cfg.vocab_size, lens=(5, 7, 9), gen=8)
    kw = _kw(4, work, kv_bits=kv_bits)
    want = _streams(ServeEngine(tm, tsp, device="cpu", **kw), work, arrival_every=0)
    eng = ServeEngine(tm, tsp, device="cpu", spec=SpecConfig(k=3, draft_bits=2), **kw)
    seen = watch_spec_state(eng)
    assert _streams(eng, work, arrival_every=0) == want
    if kv_bits is None:   # and the reference spec engine's streams and counts
        ref = JaxEngine(jm, jsp, spec=JaxSpec(k=3, draft_bits=2), prefill_fn=jm.prefill_chunk,
                        decode_fn=jm.decode_step, verify_fn=jm.verify_chunk, **OP_BY_OP, **kw)
        assert _streams(ref, work, arrival_every=0) == want
        assert eng.metrics()["spec"] == ref.metrics()["spec"]
    fixups = int(eng.obs.get("spec.fixups").value)
    assert fixups > 0 and fixups == sum(len(s["verify"]) == 2 for s in seen)
    for s in seen:
        for got in s["verify"]:
            for key in SSM:
                assert torch.equal(got[key], s["draft"][key]), key


@pytest.mark.parametrize("kv_bits,broken", [(None, False), (8, False), (None, True)],
                         ids=["fp", "int8", "fp_fixup_skipped"])
def test_own_path_replay(wide_window, kv_bits, broken, monkeypatch):
    """chip_smoke's 3r check over ring blocks (fp and int8): every spec
    token is the argmax of a plain replay of its windows and decode steps,
    every base token of its decode steps; skipping the fix-ups fails it."""
    jm, tm, jsp, tsp = wide_window
    _refuse_fused(monkeypatch)
    work = _workload(jm.cfg.vocab_size, lens=(5, 7, 9), gen=12)
    kw = _kw(4, work, kv_bits=kv_bits)
    if broken:
        with pytest.raises(SystemExit):
            own_path_replay(tm, tsp, work, kw, skip_fixup=True)
        return
    own, dec = own_path_replay(tm, tsp, work, kw)
    n = sum(g for _, g in work)
    assert own.exact == dec.exact == n and not own.ties and not dec.ties


@pytest.mark.parametrize("spec", [None, 3], ids=["decode", "spec"])
def test_graphed_steps_advance_the_ssm_state_once(wide_window, monkeypatch, spec):
    """The captured target and draft steps with a stand-in graph whose
    warm-up is a real step: the SSM state is put back after each capture,
    so the streams are the eager engine's."""
    from repro_torch.serve import engine as engine_mod
    from repro_torch.train import serve as tserve

    jm, tm, jsp, tsp = wide_window
    work = _workload(jm.cfg.vocab_size, lens=(5, 9), gen=8)
    kw = _kw(4, work, spec=SpecConfig(k=spec, draft_bits=2) if spec else None)
    want = _streams(ServeEngine(tm, tsp, device="cpu", **kw), work, arrival_every=0)
    monkeypatch.setattr(tserve, "_Graph", ReplayedEagerly)
    steps = []

    def graphed(model, device=None):
        steps.append(tserve.GraphedDecodeStep(model))
        return steps[-1]

    monkeypatch.setattr(engine_mod, "make_decode_step", graphed)
    assert _streams(ServeEngine(tm, tsp, device="cpu", **kw), work, arrival_every=0) == want
    assert len(steps) == (2 if spec else 1) and all(s.recaptures == 0 for s in steps)
