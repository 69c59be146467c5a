"""Training every family the port serves, against the JAX package on the
CPU: the moe (moonshot-v1-16b-a3b; llama4-maverick-400b-a17b with two
stacked subs and a shared expert), vlm (qwen2-vl-7b: M-RoPE positions of
three streams and precomputed ``embeds``), audio (musicgen-large:
absolute sinusoids), hybrid (hymba-1.5b: attention beside a Mamba branch,
mixed) and ssm (rwkv6-1.6b) smoke configs, with the reference's own
weights carried over by ``repro_torch.convert`` and batches from the
numpy data pipeline.

Tolerances, each with its reason:
- loss, nll, aux and every gradient of the QAT loss at a mixed policy
  (bits 2-8, 16, 32 cycling over the groups; an expert bank's bits one
  per stacked layer): 1e-5 relative in f32 and 2e-2 in bf16, the bounds
  of ``tests/test_torch_lm_train.py``.  The bf16 reference is compiled
  with ``xla_allow_excess_precision`` off: with it on (XLA's default)
  the compiler keeps f32 between fused bf16 operations, so the jit'd
  reference rounds at other points than the same function run op by op
  (its routing alone moves moonshot's router gradient by 6e-2); with it
  off it rounds after every operation, as torch does.
- rwkv6's f32 gradients: 5e-4.  They are ill-conditioned: at its smoke
  config the port's own f32 gradients lie 1.4e-4 from the same port
  evaluated in f64 (``scripts/grad_conditioning.py``; glm4-9b's 1.4e-6),
  so two f32 evaluations that sum in other orders differ by about that
  much (here the reference and the port: 1.2e-4).  Its loss and nll stay
  at 1e-5.
- moonshot runs at capacity factor 0.5, and choices must drop at
  capacity; the routing is in f32 and bf16 the reference's (checked
  through the gradients: a flipped route moves them far past the bound).
- remat none / full / dots give the same loss and gradients (MoE and
  hybrid) within the same bounds.
- the per-column QDQ and its STE with an expert bank's ``(L,)`` bits
  broadcast over its experts: bit for bit ``repro.quant.qat._qdq``.
- one train step through ``make_train_step``: the bounds of
  ``tests/test_torch_lm_train.py::test_train_step_matches_reference``.
- trained, saved with ``--ckpt-dir`` and served from it: greedy streams
  bitwise those of the trainer's final params served from memory.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets torch's CPU threads)
from repro.configs import get_config as jget_config
from repro.data import SyntheticLMData as JData
from repro.models import build_model as jbuild_model
from repro.optim import AdamW as JAdamW
from repro.quant.policy import QuantPolicy as JPolicy
from repro.quant.qat import _qdq as jqdq
from repro.quant.qat import bits_assignment as jbits_assignment
from repro.quant.qat import quantize_params as jquantize_params
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model
from repro_torch.models.moe import RouteLog, capacity
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves, tree_unflatten
from repro_torch.quant import wrpn as twrpn
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qat import bits_assignment, bits_to_device, quantize_params
from repro_torch.train.train_step import make_train_step
from torch_parity import rel_err, to_port

MOONSHOT, MAVERICK = "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"
QWEN, MUSICGEN, HYMBA, RWKV = "qwen2-vl-7b", "musicgen-large", "hymba-1.5b", "rwkv6-1.6b"
ARCHS = (MOONSHOT, MAVERICK, QWEN, MUSICGEN, HYMBA, RWKV)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {(RWKV, "float32"): 5e-4}
MIXED = (2, 3, 4, 5, 6, 7, 8, 16, 32)
B, S = 2, 32


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _models(arch, dtype):
    """(jax model, port model) of ``arch``'s smoke config in ``dtype``;
    moonshot at capacity factor 0.5, so that choices drop."""
    over = {"dtype": dtype}
    if arch == MOONSHOT:
        over["capacity_factor"] = 0.5
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    return jbuild_model(jcfg), build_model(tcfg)


def _bits_maps(jm, tm):
    names = tuple(g.name for g in jm.quant_groups())
    bits = [MIXED[i % len(MIXED)] for i in range(len(names))]
    jbm = {k: jnp.asarray(v)
           for k, v in jbits_assignment(jm.quant_groups(), JPolicy.from_array(names, bits)).items()}
    tbm = bits_to_device(bits_assignment(tm.quant_groups(), QuantPolicy.from_array(names, bits)),
                         "cpu")
    return jbm, tbm


def _batch(arch, D):
    """numpy batch: tokens and labels; qwen2-vl takes ``embeds`` and three
    distinct M-RoPE streams (t, h, w) instead of tokens."""
    batch = JData(seed=0, global_batch=B, seq_len=S, vocab=251).next()
    if arch == QWEN:
        rng = np.random.default_rng(5)
        pos = np.arange(S, dtype=np.int32)
        batch = {"labels": batch["labels"],
                 "embeds": rng.standard_normal((B, S, D)).astype(np.float32),
                 "positions": np.broadcast_to(np.stack([pos, pos // 4, pos % 4])[:, None],
                                              (3, B, S)).copy()}
    return batch


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    """The reference's loss, metrics and gradients, and everything the
    port needs to run the same function: (jm, tm, jp, tp, tbm, batch,
    (loss, metrics, grads))."""
    jm, tm = _models(arch, dtype)
    jp = jm.init(jax.random.PRNGKey(0))
    jbm, tbm = _bits_maps(jm, tm)
    batch = _batch(arch, jm.cfg.d_model)
    groups = jm.quant_groups()

    def jloss(p):
        return jm.loss(jquantize_params(p, jbm, groups),
                       {k: jnp.asarray(v) for k, v in batch.items()})

    fn = jax.jit(jax.value_and_grad(jloss, has_aux=True)).lower(jp).compile(
        {"xla_allow_excess_precision": False})
    (jl, jmet), jg = fn(jp)
    return jm, tm, jp, to_port(jp), tbm, batch, (jl, jmet, jg)


def _port_loss_and_grads(tm, tp, tbm, batch, remat):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    # the routing is recorded in the plain forward only: a recomputed
    # layer must save what its forward saved, and the log's gaps add
    # saved tensors
    with RouteLog() if remat == "none" else contextlib.nullcontext() as log:
        loss, met = tm.loss(quantize_params(tree_unflatten(tp, leaves), tbm, tm.quant_groups()),
                            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                            remat=remat)
    # allow_unused: the reference draws musicgen's ``mlp/wu``, which its
    # GELU MLP never reads (its gradient is exactly 0 there)
    return loss, met, torch.autograd.grad(loss, leaves, allow_unused=True), log


def _dropped(tm, log) -> int:
    """Choices past capacity over every MoE call of the loss's forward."""
    cfg = tm.cfg
    C = capacity(S, cfg.experts_per_token, cfg.num_experts, cfg.capacity_factor)
    hits = [(idx.reshape(B, -1, 1) == torch.arange(cfg.num_experts)).sum(dim=1)
            for idx in log.idx]
    return int(sum((h - C).clamp(min=0).sum() for h in hits))


def _check(arch, dtype, remat):
    jm, tm, jp, tp, tbm, batch, (jl, jmet, jg) = _reference(arch, dtype)
    loss, met, grads, log = _port_loss_and_grads(tm, tp, tbm, batch, remat)
    tol = TOL[dtype]
    assert set(met) == {"nll", "aux"} and all(isinstance(v, torch.Tensor) and v.ndim == 0
                                              for v in met.values())
    assert rel_err(_np(loss), jl) <= tol and rel_err(_np(met["nll"]), jmet["nll"]) <= tol
    assert rel_err(_np(met["aux"]), np.float32(jmet["aux"])) <= tol
    if tm.cfg.num_experts:
        assert float(met["aux"].detach()) > 0
    else:
        assert float(met["aux"].detach()) == 0.0
    if arch == MOONSHOT and remat == "none":
        assert _dropped(tm, log) > 0
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    gtol = GRAD_TOL.get((arch, dtype), tol)
    assert len(grads) == len(paths)
    for path, a, b in zip(paths, grads, jax.tree.leaves(jg)):
        if a is None:
            assert not np.any(np.asarray(b)), path
            continue
        assert rel_err(_np(a), b) <= gtol, (path, rel_err(_np(a), b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype):
    _check(arch, dtype, "none")


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [MOONSHOT, HYMBA])
def test_remat_loss_and_grads_match_reference(arch, dtype, remat):
    _check(arch, dtype, remat)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bank_bits_broadcast_bitwise_reference_qdq(dtype):
    """An expert bank (L, E, K, N) at (L,) bits, a stacked (L, K, N) leaf at
    (L,) bits and a matrix at one: the plain per-column pair (through the
    STE group) bit for bit ``repro.quant.qat._qdq`` and its vjp."""
    rng = np.random.default_rng(9)
    shapes = ((3, 4, 24, 40), (3, 24, 40), (17, 9))
    bits = (np.array([2, 5, 8], np.int32), np.array([16, 3, 32], np.int32), np.int32(4))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ws = [jnp.asarray(rng.standard_normal(s), jdt) for s in shapes]
    cots = [jnp.asarray(rng.standard_normal(s), jdt) for s in shapes]
    want, vjp = jax.vjp(lambda *w: [jqdq(x, jnp.asarray(b)) for x, b in zip(w, bits)], *ws)
    want_g = vjp(cots)
    tw = [torch.from_numpy(np.asarray(w, np.float32)).to(dtype).requires_grad_(True)
          for w in ws]
    got = twrpn.fake_quant_ste_group_col(tw, [torch.from_numpy(np.asarray(b)) for b in bits])
    got_g = torch.autograd.grad(got, tw, [torch.from_numpy(np.asarray(c, np.float32)).to(dtype)
                                          for c in cots])
    for a, b in zip(got, want):
        assert np.array_equal(_np(a), np.asarray(b, np.float32))
    for a, b in zip(got_g, want_g):
        assert np.array_equal(_np(a), np.asarray(b, np.float32))
    # the plain version's broadcast: a run of E layers a bit, or one for the leaf
    w = torch.zeros((3, 4, 2, 2))
    assert tref.col_bits_view(w, torch.tensor([2, 5, 8])).shape == (3, 4, 1, 1)
    assert tref.col_bits_view(w, torch.tensor([2, 5, 8])).reshape(-1).tolist() == \
        [2] * 4 + [5] * 4 + [8] * 4
    with pytest.raises(ValueError, match="divisor"):
        tref.col_bits_view(w, torch.tensor([2, 5, 8, 3, 4]))


def test_train_step_matches_reference():
    """One QAT train step of moonshot (choices dropped at capacity, f32)
    through ``make_train_step`` against the reference's: loss, nll, aux
    and grad norm within 1e-5; new params within 1e-6, or where a clipped
    gradient element sits within a few eps of 0, within what a rounding
    noise of 1e-5 of the leaf's largest gradient moves Adam's first step
    (the rule of ``test_torch_lm_train.py``)."""
    jm, tm, jp, tp, tbm, batch, (_, _, jg) = _reference(MOONSHOT, "float32")
    jbm, _ = _bits_maps(jm, tm)
    lr = 1e-3
    jopt, topt = JAdamW(lr=lr), AdamW(lr=lr)
    js, jout = jmake_train_step(jm, jopt, donate=False)({"params": jp, "opt": jopt.init(jp)},
                                                       batch, jbm)
    ts, tout = make_train_step(tm, topt, remat="full")({"params": tp, "opt": topt.init(tp)},
                                                      batch, tbm)
    assert set(tout) == {"loss", "grad_norm", "nll", "aux"}
    assert all(isinstance(v, torch.Tensor) and v.ndim == 0 for v in tout.values())
    for k in ("loss", "grad_norm", "nll", "aux"):
        assert rel_err(_np(tout[k]), jout[k]) <= 1e-5, k
    clip = min(1.0, 1.0 / max(float(jout["grad_norm"]), 1e-9))
    noisy = total = 0
    for a, b, g in zip(tree_leaves(ts["params"]), jax.tree.leaves(js["params"]),
                       jax.tree.leaves(jg)):
        d = np.abs(_np(a) - np.asarray(b, np.float32))
        g = np.abs(np.asarray(g, np.float64)) * clip
        bound = np.minimum(2 * lr, lr * 1e-8 * 1e-5 * g.max() / (g + 1e-8) ** 2) + 1e-6
        assert np.all(d <= bound)
        noisy += int(np.sum(d > 1e-6))
        total += d.size
    assert noisy < total / 1000, (noisy, total)


@pytest.mark.parametrize("arch", [MOONSHOT, RWKV])
def test_train_then_serve_from_ckpt_dir(arch, tmp_path):
    """``launch/train.py --ckpt-dir`` then ``launch/serve.py --ckpt-dir``:
    the restored params' greedy streams equal the trainer's final params
    served from memory, bitwise; only ``params`` is read back."""
    from repro_torch import ckpt as ckpt_lib
    from repro_torch.launch import serve as launcher
    from repro_torch.launch import train
    from repro_torch.quant.qat import policy_for
    from repro_torch.train.serve import quantize_for_serving

    run = train.main(["--device", "cpu", "--arch", arch, "--steps", "3", "--seq-len", "32",
                      "--global-batch", "2", "--ckpt-dir", str(tmp_path)])
    params, _, step = ckpt_lib.restore(str(tmp_path), device="cpu", subtree="params")
    assert step == 3
    for a, b in zip(tree_leaves(params), tree_leaves(run["state"]["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    flags = ["--device", "cpu", "--arch", arch, "--requests", "3", "--gen", "6",
             "--prompt-len", "12"]
    restored = launcher.main(flags + ["--ckpt-dir", str(tmp_path)])
    args = launcher.parse_args(flags)
    model = run["model"]
    policy = policy_for(model, args.bits)
    memory = launcher.continuous(args, model.cfg, model,
                                 quantize_for_serving(model, run["state"]["params"], policy,
                                                      device="cpu"), policy)
    got = [restored.output(i) for i in range(3)]
    assert all(got) and got == [memory.output(i) for i in range(3)]
