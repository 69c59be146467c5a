"""The MoE family in the port (``repro_torch.models.moe`` and the MoE
subs of ``TransformerLM``) against the JAX package, with the reference's
own weights carried over by ``repro_torch.convert``.  Smoke configs:
moonshot-v1-16b-a3b (2 layers, 4 experts top-2) and
llama4-maverick-400b-a17b (4 layers, interleave 2, a shared expert,
top-1).

- ``_route``, ``_dispatch``, ``_undispatch``, ``_aux_loss`` and
  ``moe_ffn``, dropping and drop-free: expert indices and the dispatch
  metadata (``order``, ``src``, ``dst``, ``valid``) and buffers exactly
  equal; gates within 1e-6; outputs within 1e-5 * max|ref| in f32 and
  2e-2 in bf16.  Exact gate ties go to the lower expert index, as
  ``jax.lax.top_k`` breaks them.
- A packed bank: the port multiplies each expert through
  ``kernels.ops.qmm`` (one call per expert and matrix), the function
  ``x @ dequant(bank)``.  The reference dequantizes the bank to the
  activation dtype first (``moe.py:44-54``), so in bf16 its weights are
  rounded where the port's are not: within 2e-2 * max|ref|, exactly as
  close in f32 as the dense bank.
- Whole models: ``forward`` (logits and aux), the full-prompt ``prefill``
  and ``decode_step``, within 1e-4 * max|ref| in f32 and 2e-2 in bf16.  A
  routing decision near a tie may flip between two bf16 computations that
  round apart, and moves that token's logits far more than rounding does;
  in bf16 a sequence is compared up to its first token whose chosen
  experts differ between the port and the reference in some layer (causal
  attention carries a flip only forward, and the dispatch is per
  sequence), and at least half the forward's tokens and one row of each
  prefill and decode must be compared.  f32 takes no flags.
- ``quantize_for_serving`` (the ``n_sub`` list of per-layer lists, banks
  packed expert by expert into 4-D planes) and ``low_bit_view``'s 2-bit
  draft bitwise the reference's.
- Served greedy streams equal the reference engine's, run op by op, for
  moonshot with fp, int8 and int4 KV, with spec decoding (k 4, 2-bit
  draft) and with the prefix cache, and maverick with fp KV.  Here the
  reference's bank product is taken per expert through its own
  ``repro.kernels.ops.qmm``, the function the port computes (the
  reference's bf16 rounding of the whole bank, the one deliberate
  difference, is bounded above).
- The reference's ``test_moe_decode_matches_dropfree_forward``, on the
  port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.models.common import swiglu as jax_swiglu
from repro.quant.pack import Packed as JPacked
from repro.quant.qat import policy_for as jax_policy_for
from repro.serve import ServeEngine as JaxEngine
from repro.spec import SpecConfig as JaxSpec
from repro.spec.draft import low_bit_view as jax_low_bit_view
from repro.train.serve import _pack_bank as jax_pack_bank
from repro.train.serve import quantize_for_serving as jax_qfs
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.quant.pack import Packed
from repro_torch.quant.qat import policy_for
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.spec import SpecConfig, low_bit_view
from repro_torch.train.serve import quantize_for_serving
from torch_parity import models, rel_err, to_port

MOONSHOT, MAVERICK = "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FFN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
OP_BY_OP = dict(sample_device=False, pipeline=False)


def _capacity(S, k, E, cf, no_drop):
    C = S * k if no_drop else int(-(-S * k * cf // E))
    return max(8, -(-C // 8) * 8)


def _layer_inputs(dtype, B=2, S=24, D=64, E=4, F=96, seed=0, skew=2.0):
    """x (B, S, D) and one MoE layer's params as JAX arrays; ``skew``
    biases the router toward expert 0, so a dropping capacity drops."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32) + 0.5
    router = rng.standard_normal((D, E)).astype(np.float32) * D ** -0.5
    router[:, 0] += skew / D
    p = {"router": jnp.asarray(router),
         "wg": jnp.asarray(rng.standard_normal((E, D, F)) * D ** -0.5, dtype),
         "wu": jnp.asarray(rng.standard_normal((E, D, F)) * D ** -0.5, dtype),
         "wd": jnp.asarray(rng.standard_normal((E, F, D)) * F ** -0.5, dtype)}
    return jnp.asarray(x, dtype), p


def _max_rel(got, want):
    return rel_err(np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got,
                              np.float64), np.asarray(want, np.float32))


# ---------------------------------------------------------------- the layer
@pytest.mark.parametrize("no_drop", [False, True], ids=["drop", "no-drop"])
def test_route_dispatch_undispatch_match_reference(no_drop):
    k, E = 2, 4
    jx, jp = _layer_inputs(jnp.float32)
    tx, tp = to_port(jx), to_port(jp)
    B, S, D = jx.shape
    jg, jgk, jik = jmoe._route(jx, jp["router"], k)
    tg, tgk, tik = tmoe._route(tx, tp["router"], k)
    np.testing.assert_array_equal(tik.numpy(), np.asarray(jik))
    assert float(np.abs(tg.numpy() - np.asarray(jg)).max()) <= 1e-6
    assert float(np.abs(tgk.numpy() - np.asarray(jgk)).max()) <= 1e-6
    assert abs(float(tmoe._aux_loss(tg, tik, E, k)) - float(jmoe._aux_loss(jg, jik, E, k))) <= 1e-6
    C = _capacity(S, k, E, 1.25, no_drop)
    jbuf, jmeta = jax.vmap(lambda x2, i, g: jmoe._dispatch(x2, i, g, E, C, k))(jx, jik, jgk)
    tbuf, tmeta = tmoe._dispatch(tx, tik, E, C, k)
    for name, got, want in zip(("order", "src", "dst", "valid"), tmeta, jmeta):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    # the premise: the skewed router overfills expert 0 unless drop-free
    assert bool((~tmeta[3]).any()) != no_drop
    y_e = np.random.default_rng(1).standard_normal(jbuf.shape).astype(np.float32)
    want = jax.vmap(lambda ye, gk, m: jmoe._undispatch(ye, gk, m, S, k))(
        jnp.asarray(y_e), jgk, jmeta)
    got = tmoe._undispatch(torch.from_numpy(y_e), tgk, tmeta, S, k)
    assert rel_err(got.numpy(), want) <= 1e-5


def test_gate_ties_go_to_the_lower_expert():
    """Rows whose gates tie exactly (a zero input: every gate 1/E; a
    router with equal columns): the port's top-k picks the experts
    ``jax.lax.top_k`` picks."""
    D, E, k = 8, 6, 3
    router = np.zeros((D, E), np.float32)
    router[:, 1] = router[:, 4] = 0.5
    router[:, 2] = router[:, 5] = -0.25
    x = np.zeros((2, 3, D), np.float32)
    x[1] = 1.0
    _, _, jik = jmoe._route(jnp.asarray(x), jnp.asarray(router), k)
    _, _, tik = tmoe._route(torch.from_numpy(x), torch.from_numpy(router), k)
    np.testing.assert_array_equal(tik.numpy(), np.asarray(jik))
    assert tik[0, 0].tolist() == [0, 1, 2] and tik[1, 0].tolist() == [1, 4, 0]


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed4"])
@pytest.mark.parametrize("no_drop", [False, True], ids=["drop", "no-drop"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(dtype, no_drop, packed):
    jx, jp = _layer_inputs(jnp.dtype(dtype))
    if packed:
        jp = dict(jp, **{m: jax_pack_bank(jp[m], 4) for m in ("wg", "wu", "wd")})
    tx, tp = to_port(jx), to_port(jp)
    want, jaux = jmoe.moe_ffn(jx, jp, k=2, capacity_factor=1.25, no_drop=no_drop)
    ops.reset_counts()
    got, taux = tmoe.moe_ffn(tx, tp, k=2, capacity_factor=1.25, no_drop=no_drop)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert _max_rel(got, want) <= FFN_TOL[dtype]
    assert abs(float(taux) - float(jaux)) <= 1e-6
    # one qmm per expert and matrix on a packed bank (the plain version here)
    assert ops.counts["plain"] == (3 * 4 if packed else 0)


# ------------------------------------------------------------ whole models
class Routes:
    """The expert choices of every routing decision in one run of the
    port (``moe.RouteLog``) and of the reference (its ``_route``'s
    ``idx_k`` read out of its layer scan by ``jax.debug.callback``), in
    call order: layer by layer."""

    def __init__(self, monkeypatch):
        self.port, self.ref = tmoe.RouteLog(), []
        orig = jmoe._route

        def route(x, router, k):
            out = orig(x, router, k)
            jax.debug.callback(lambda i: self.ref.append(np.asarray(i)), out[2], ordered=True)
            return out

        monkeypatch.setattr(jmoe, "_route", route)

    def __enter__(self):
        self.port.__enter__()
        self.port.idx.clear()
        self.ref.clear()
        return self

    def __exit__(self, *exc):
        self.port.__exit__(*exc)

    def checked(self, B, S):
        """(B, S) mask of the tokens before each sequence's first token
        whose set of chosen experts differs between the port and the
        reference in some layer (causal attention carries a flip only
        forward, and the dispatch is per sequence)."""
        assert len(self.port.idx) == len(self.ref) > 0
        flipped = np.zeros((B, S), bool)
        for t, j in zip(self.port.idx, self.ref):
            t = np.sort(t.numpy()[:, -S:], axis=-1)
            j = np.sort(j.reshape(t.shape[0], -1, t.shape[-1])[:, -S:], axis=-1)
            flipped |= (t != j).any(axis=-1)
        return np.cumsum(flipped, axis=1) == 0


def _within(got, want, tol, mask=None, least=1):
    """``got`` within ``tol`` * max|want| of ``want``, on the ``mask``ed
    entries where one is given: at least ``least`` of them."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if mask is not None:
        assert mask.sum() >= least, f"{mask.sum()} of {mask.size} compared, want {least}"
        got, want = got[mask], want[mask]
    return rel_err(got, want) <= tol


MODEL_CASES = [(arch, dt, packed) for arch in (MOONSHOT, MAVERICK)
               for dt, packed in (("float32", False), ("bfloat16", False), ("bfloat16", True))]


@pytest.mark.parametrize("arch,dtype,packed", MODEL_CASES,
                         ids=[f"{a.split('-')[0]}-{d}-{'packed4' if p else 'dense'}"
                              for a, d, p in MODEL_CASES])
def test_model_matches_reference(arch, dtype, packed, monkeypatch):
    jm, tm = models(arch, dtype=dtype)
    jp = jm.init(jax.random.PRNGKey(0))
    tol, bf16 = TOL[dtype], dtype == "bfloat16"
    routes = Routes(monkeypatch)
    B, S = 2, 12
    toks = np.random.default_rng(3).integers(0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    if not packed:   # the training forward over the stacked layout (drops)
        with routes:
            jl, jaux = jm.forward(jp, tokens=jnp.asarray(toks))
            tl, taux = tm.forward(to_port(jp), tokens=torch.from_numpy(toks))
        assert tl.dtype == torch.float32 and tl.shape == (B, S, jm.cfg.vocab_size)
        mask = routes.checked(B, S) if bf16 else None
        assert _within(tl.numpy(), jl, tol, mask, least=B * S // 2)
        # a flipped choice moves aux by about E * gate / (B * S * k): 1-2 %
        assert abs(float(taux) - float(jaux)) <= (5e-2 if bf16 else 1e-5) * float(jaux)
    else:
        jp = jax_qfs(jm, jp, jax_policy_for(jm, 4))
    tp = to_port(jp)
    with routes:
        jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks[:, :-1]), max_len=S + 2)
        tl, tc = tm.prefill(tp, tokens=torch.from_numpy(toks[:, :-1]), max_len=S + 2)
    mask = routes.checked(B, S - 1)[:, -1] if bf16 else None
    assert _within(tl.numpy()[:, 0], np.asarray(jl)[:, 0], tol, mask)
    with routes:
        jd, _ = jm.decode_step(jp, jc, jnp.asarray(toks[:, -1:]))
        td, _ = tm.decode_step(tp, tc, torch.from_numpy(toks[:, -1:]))
    if bf16:   # a row decodes after its prefix: flipped there, or at this token
        mask = mask & routes.checked(B, 1)[:, 0]
    assert _within(td.numpy()[:, 0], np.asarray(jd)[:, 0], tol, mask)


@pytest.mark.parametrize("arch", [MOONSHOT, MAVERICK])
def test_moe_decode_matches_dropfree_forward(arch):
    """The reference's test on the port: at capacity factor 8 the
    training forward drops nothing, and a prefill + one decode step give
    its logits."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), capacity_factor=8.0)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    B, S = 2, 12
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(0))
    full, _ = model.forward(params, tokens=toks)
    _, cache = model.prefill(params, tokens=toks[:, :S - 1], max_len=S + 2)
    ld, _ = model.decode_step(params, cache, toks[:, S - 1:])
    assert float((ld[:, 0] - full[:, S - 1]).abs().max()) < 0.15


# ------------------------------------------------------------ serving params
def _same_tree(t, j, path=""):
    """The port's serving tree against the reference's: Packed leaves
    bitwise (planes, scales, bits), dense leaves bitwise."""
    if isinstance(j, JPacked):
        assert isinstance(t, Packed) and t.bits == j.bits, path
        np.testing.assert_array_equal(t.planes.numpy(), np.asarray(j.planes), err_msg=path)
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale), err_msg=path)
        return 1
    if isinstance(j, dict):
        assert set(t) == set(j), path
        return sum(_same_tree(t[k], j[k], f"{path}/{k}") for k in j)
    if isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j), path
        return sum(_same_tree(a, b, f"{path}/{i}") for i, (a, b) in enumerate(zip(t, j)))
    if hasattr(j, "w"):          # the QDQ embedding: the dense table under it
        np.testing.assert_array_equal(t.w.float().numpy(), np.asarray(j.w, np.float32))
        return 0
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32), err_msg=path)
    return 0


@pytest.mark.parametrize("arch", [MOONSHOT, MAVERICK])
def test_serving_params_and_draft_bitwise(arch):
    jm, tm = models(arch)
    jp = jm.init(jax.random.PRNGKey(0))
    jsp = jax_qfs(jm, jp, jax_policy_for(jm, 4))
    tsp = quantize_for_serving(tm, to_port(jp), policy_for(tm, 4), device="cpu")
    assert len(tsp["blocks"]) == tm.n_sub and all(len(sub) == tm.L_super for sub in tsp["blocks"])
    moe = tsp["blocks"][-1][0]["moe"]
    E, D, Fd = tm.cfg.num_experts, tm.cfg.d_model, tm.cfg.d_ff
    assert tuple(moe["wg"].planes.shape) == (E, 4, D // 8, Fd)
    assert tuple(moe["wd"].scale.shape) == (E, 1, D)
    assert moe["router"].dtype == torch.float32
    n = _same_tree(tsp, jsp)
    shared = 3 if tm.cfg.shared_expert else 0
    assert n == tm.L_super * (tm.n_sub * 4 + 3 + shared + 3 * (tm.n_sub - 1)) + 1
    draft = low_bit_view(tm, to_port(jsp), 2)
    jdraft = jax_low_bit_view(jm, jsp, 2)
    _same_tree(draft, jdraft)
    assert draft["blocks"][-1][0]["moe"]["wu"].bits == 2


# ----------------------------------------------------------------- streams
def _ref_bank(x, w, dtype):
    if isinstance(w, JPacked):
        return jnp.stack([jops.qmm(x[e], w.planes[e], w.scale[e], bits=w.bits).astype(dtype)
                          for e in range(x.shape[0])])
    return jnp.einsum("emk,ekn->emn", x, w)


def _ref_expert_ffn_per_expert_qmm(bufe, p, dtype):
    """The reference's expert FFN with each packed expert's product through
    the reference's own ``kernels.ops.qmm``: the port's function."""
    B, E, C, D = bufe.shape
    xe = jnp.transpose(bufe, (1, 0, 2, 3)).reshape(E, B * C, D)
    h = jax_swiglu(_ref_bank(xe, p["wg"], dtype), _ref_bank(xe, p["wu"], dtype))
    return jnp.transpose(_ref_bank(h, p["wd"], dtype).reshape(E, B, C, D), (1, 0, 2, 3))


@pytest.fixture(scope="module")
def served():
    out = {}
    for arch in (MOONSHOT, MAVERICK):
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


STREAM_CASES = [(MOONSHOT, None), (MOONSHOT, 8), (MOONSHOT, 4), (MAVERICK, None)]


@pytest.mark.parametrize("arch,kv_bits", STREAM_CASES,
                         ids=[f"{a.split('-')[0]}-{'fp' if b is None else f'int{b}'}"
                              for a, b in STREAM_CASES])
def test_streams_equal_reference_op_by_op(served, arch, kv_bits, monkeypatch):
    jm, tm, jsp, tsp = served[arch]
    work = _workload(jm.cfg.vocab_size)
    kw = dict(num_slots=3, max_len=24, block_size=4, prefill_chunk=4, kv_bits=kv_bits)
    monkeypatch.setattr(jmoe, "_expert_ffn", _ref_expert_ffn_per_expert_qmm)
    ref = JaxEngine(jm, jsp, prefill_fn=jm.prefill_chunk, decode_fn=jm.decode_step,
                    **OP_BY_OP, **kw)
    want = _streams(ref, work)
    got = _streams(ServeEngine(tm, tsp, device="cpu", **kw), work)
    assert got == want
    assert [len(s) for s in got] == [g for _, g in work]


def test_spec_and_prefix_streams_equal_reference(served, monkeypatch):
    """moonshot: spec decoding (k 4, 2-bit draft; window counts equal)
    and the launcher's ``--tenants 2`` workload through the prefix cache
    (hits and hit tokens equal), each against the reference engine op by
    op."""
    jm, tm, jsp, tsp = served[MOONSHOT]
    monkeypatch.setattr(jmoe, "_expert_ffn", _ref_expert_ffn_per_expert_qmm)
    work = _workload(jm.cfg.vocab_size, lens=(5, 7), gen=7, seed=6)
    kw = dict(num_slots=2, max_len=24, block_size=4, prefill_chunk=4)
    ref = JaxEngine(jm, jsp, spec=JaxSpec(k=4, draft_bits=2), prefill_fn=jm.prefill_chunk,
                    decode_fn=jm.decode_step, verify_fn=jm.verify_chunk, **OP_BY_OP, **kw)
    eng = ServeEngine(tm, tsp, device="cpu", spec=SpecConfig(k=4, draft_bits=2), **kw)
    assert _streams(eng, work, 0) == _streams(ref, work, 0)
    assert eng.metrics()["spec"] == ref.metrics()["spec"]
    assert eng.metrics()["spec"]["windows"] > 0

    args = launcher.parse_args(["--device", "cpu", "--requests", "4", "--gen", "4",
                                "--tenants", "2", "--prompt-len", "16", "--block-size", "4",
                                "--prefill-chunk", "4"])
    work = launcher.synthetic_workload(args, jm.cfg.vocab_size)
    kw = dict(num_slots=args.num_slots, max_len=args.prompt_len + args.gen + 1,
              block_size=4, prefill_chunk=4, prefix_cache=True)
    ref = JaxEngine(jm, jsp, prefill_fn=jm.prefill_chunk, decode_fn=jm.decode_step,
                    **OP_BY_OP, **kw)
    eng = ServeEngine(tm, tsp, device="cpu", **OP_BY_OP, **kw)
    assert _streams(eng, work) == _streams(ref, work)
    m, rm = eng.metrics(), ref.metrics()
    assert m["prefix_hits"] == rm["prefix_hits"] > 0
    assert m["prefix_cache"]["hit_tokens"] == rm["prefix_cache"]["hit_tokens"]


def test_fused_decode_runs_at_kv_int4(served, monkeypatch):
    """moonshot's RoPE layers with packed q/k/v over int4 blocks take the
    fused decode op, once a layer per decode step."""
    jm, tm, _, tsp = served[MOONSHOT]
    calls = []
    fused = ops.fused_qkv_paged_decode

    def counted(*a, **k):
        calls.append(1)
        return fused(*a, **k)

    monkeypatch.setattr(ops, "fused_qkv_paged_decode", counted)
    work = _workload(jm.cfg.vocab_size, gen=4)
    eng = ServeEngine(tm, tsp, device="cpu", num_slots=3, max_len=24, block_size=4,
                      prefill_chunk=4, kv_bits=4)
    assert [len(s) for s in _streams(eng, work)] == [g for _, g in work]
    assert len(calls) == tm.cfg.num_layers * eng.metrics()["decode_steps"]
