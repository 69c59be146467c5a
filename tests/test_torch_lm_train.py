"""The LM QAT training path of repro_torch (data, blocked attention,
chunked CE, the per-column QAT transform, the training loss, 8-bit Adam
moments, the train step, checkpoints and the Trainer, the train launcher)
against the JAX package on the CPU, at the glm4-9b smoke size (2 layers,
d_model 64, vocab 251, seq 32).  Params come from JAX through
``torch_parity.to_port``.  The LM path runs no Pallas kernel.

Tolerances, each with its reason:
- data batches (numpy), the per-column QDQ and its STE (elementwise IEEE
  f32 in the reference's order, a max for the scale), fp8 moment codes
  and their scales: bitwise.
- blocked attention and chunked CE in f32: the same tiles and online
  softmax, einsums summed in other orders (XLA against oneDNN): 1e-5 of
  the largest value.
- loss and grads: 1e-5 relative in f32; 2e-2 in bf16, where activations
  are rounded to bf16 after every op and the sums run in other orders.
- AdamW on identical gradients: 1e-6 of the largest param (one schedule
  value, ``cos``, may differ by an ulp between XLA and torch).
- one train step from equal params: loss and grad norm 1e-5 relative; new
  params within 1e-6 absolute, plus, where the clipped gradient element g
  is within a few eps (1e-8) of 0, what a rounding noise of 1e-5 of the
  leaf's largest gradient moves Adam's first step lr * g / (|g| + eps)
  by: lr * eps * noise / (|g| + eps)^2, at most 2 lr.  Elements that
  differ by more than 1e-6 are counted and must be fewer than 1 in 1,000.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets torch's CPU threads)
from repro.data import SyntheticLMData as JData
from repro.models import common as jcommon
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jcosine
from repro.quant import int8_opt as jint8
from repro.quant.policy import QuantPolicy as JPolicy
from repro.quant.qat import bits_assignment as jbits_assignment
from repro.quant.qat import quantize_params as jquantize_params
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import ckpt as ckpt_lib
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import common as tcommon
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves, tree_unflatten
from repro_torch.quant import int8_opt as tint8
from repro_torch.quant import wrpn as twrpn
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qat import bits_assignment, bits_to_device, quantize_params
from repro_torch.train.train_step import make_dp_train_step, make_train_step
from repro_torch.train.trainer import Trainer
from torch_parity import models, rel_err, to_port

MIXED = (2, 3, 4, 5, 6, 7, 8, 16, 32)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _mixed_policies(groups):
    names = tuple(g.name for g in groups)
    bits = [MIXED[i % len(MIXED)] for i in range(len(names))]
    return JPolicy.from_array(names, bits), QuantPolicy.from_array(names, bits)


def _bits_maps(jm, tm):
    jp, tp = _mixed_policies(jm.quant_groups())
    jbm = {k: jnp.asarray(v) for k, v in jbits_assignment(jm.quant_groups(), jp).items()}
    tbm = bits_to_device(bits_assignment(tm.quant_groups(), tp), "cpu")
    return jbm, tbm


@pytest.fixture(scope="module")
def f32():
    jm, tm = models(dtype="float32")
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, to_port(jp)


# ---- data ------------------------------------------------------------------
@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 2)])
def test_synthetic_lm_data_bitwise(shard, num_shards):
    kw = dict(seed=3, global_batch=4, seq_len=24, vocab=251, shard=shard,
              num_shards=num_shards)
    jd, td = JData(**kw), SyntheticLMData(**kw)
    for _ in range(3):
        a, b = jd.next(), td.next()
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    for k in ("tokens", "labels"):
        assert np.array_equal(jd.eval_batch(3)[k], td.eval_batch(3)[k])
    assert jd.state_dict() == td.state_dict()


# ---- blocked attention and chunked CE ----------------------------------------
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("H,KV,S,cq,ck", [(4, 2, 37, 16, 8), (2, 2, 40, 8, 16)])
def test_blocked_attention_forward_and_grads(H, KV, S, cq, ck, window):
    rng = np.random.default_rng(S + H)
    q = rng.standard_normal((2, S, H, 16), np.float32)
    k = rng.standard_normal((2, S, KV, 16), np.float32)
    v = rng.standard_normal((2, S, KV, 16), np.float32)
    g = rng.standard_normal((2, S, H, 16), np.float32)
    kw = dict(causal=True, window=window, q_chunk=cq, kv_chunk=ck)
    jout, vjp = jax.vjp(lambda a, b, c: jcommon.blocked_attention(a, b, c, **kw), q, k, v)
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tout = tcommon.blocked_attention(tq, tk, tv, **kw)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(g))
    assert rel_err(_np(tout), jout) <= 1e-5
    for a, b in zip(tgrads, jgrads):
        assert rel_err(_np(a), b) <= 1e-5


def test_chunked_ce_and_its_grad():
    rng = np.random.default_rng(1)
    B, S, D, V = 2, 37, 16, 50
    h = rng.standard_normal((B, S, D), np.float32)
    w = rng.standard_normal((D, V), np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)

    def jf(hh):
        nll, z2 = jcommon.chunked_ce(lambda hc: hc @ jnp.asarray(w), hh, jnp.asarray(labels),
                                     chunk=16)
        return nll + 0.5 * z2, (nll, z2)

    (_, (jnll, jz2)), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    tnll, tz2 = tcommon.chunked_ce(lambda hc: hc @ torch.from_numpy(w), th,
                                   torch.from_numpy(labels), chunk=16)
    (tg,) = torch.autograd.grad(tnll + 0.5 * tz2, th)
    assert rel_err(_np(tnll), jnll) <= 1e-5 and rel_err(_np(tz2), jz2) <= 1e-5
    assert rel_err(_np(tg), jg) <= 1e-5


# ---- the per-column QAT transform ---------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_and_ste_bitwise(dtype):
    jm, tm = models(dtype=dtype)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = to_port(jp)
    jbm, tbm = _bits_maps(jm, tm)
    groups = jm.quant_groups()
    jq, vjp = jax.vjp(lambda p: jquantize_params(p, jbm, groups), jp)
    # cotangents: a fixed random tree over every leaf
    rng = np.random.default_rng(2)
    cot = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), jq)
    (jgrad,) = vjp(cot)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    ops.reset_counts()
    tq = quantize_params(tree_unflatten(tp, leaves), tbm, tm.quant_groups())
    assert ops.counts["plain"] == 1                   # one grouped call, plain on the CPU
    tq_leaves = tree_leaves(tq)
    tgrad = torch.autograd.grad(tq_leaves, leaves, [to_port(c) for c in jax.tree.leaves(cot)])
    for a, b in zip(tq_leaves, jax.tree.leaves(jq)):
        assert np.array_equal(_np(a), np.asarray(b, np.float32))
    for a, b in zip(tgrad, jax.tree.leaves(jgrad)):
        assert np.array_equal(_np(a), np.asarray(b, np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_col_group_equals_per_column_fake_quant(dtype):
    gen = torch.Generator().manual_seed(0)
    ws = [torch.randn(s, generator=gen).to(dtype) for s in ((3, 7, 30), (9, 5), (2, 16, 8))]
    ws[0][1, :, 4] = 0.0                      # an all-zero column: the eps floor
    bits = [torch.tensor([2, 8, 32], dtype=torch.int32), torch.tensor(5, dtype=torch.int32),
            torch.tensor([1, 16], dtype=torch.int32)]
    outs, scales = tref.fake_quant_group_col_ref(ws, bits)
    for w, b, o, s in zip(ws, bits, outs, scales):
        b3 = b.reshape(b.shape + (1,) * (w.ndim - b.ndim))
        assert torch.equal(o, twrpn.fake_quant(w, b3, axis=-2))
        assert torch.equal(s, twrpn.tensor_scale(w, axis=w.ndim - 2))
    # fake_quant_ste(axis=0) of a matrix is a per-column group of one
    w = ws[1].clone().requires_grad_(True)
    out = twrpn.fake_quant_ste(w, 5, axis=0)
    assert torch.equal(out, twrpn.fake_quant(ws[1], 5, axis=0))
    (g,) = torch.autograd.grad(out, w, torch.ones_like(out))
    assert torch.equal(g, torch.ones_like(g))      # max|w| per column: all inside
    with pytest.raises(ValueError):
        twrpn.fake_quant_ste(ws[0], 4, axis=0)     # a 3-d leaf reduces dim 1


# ---- the training loss -----------------------------------------------------------
@pytest.mark.parametrize("dtype,remat,tol", [("float32", "none", 1e-5),
                                             ("float32", "full", 1e-5),
                                             ("float32", "dots", 1e-5),
                                             ("bfloat16", "full", 2e-2)])
def test_loss_and_grads_at_mixed_bits(dtype, remat, tol):
    jm, tm = models(dtype=dtype)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = to_port(jp)
    jbm, tbm = _bits_maps(jm, tm)
    batch = JData(seed=0, global_batch=2, seq_len=32, vocab=251).next()
    groups = jm.quant_groups()

    def jloss(p):
        return jm.loss(jquantize_params(p, jbm, groups),
                       {k: jnp.asarray(v) for k, v in batch.items()})

    (jl, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    tl, tmet = tm.loss(quantize_params(tree_unflatten(tp, leaves), tbm, tm.quant_groups()),
                       {k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat)
    tg = torch.autograd.grad(tl, leaves)
    assert rel_err(_np(tl), jl) <= tol and rel_err(_np(tmet["nll"]), jmet["nll"]) <= tol
    assert float(tmet["aux"]) == 0.0
    for a, b in zip(tg, jax.tree.leaves(jg)):
        assert rel_err(_np(a), b) <= tol


def test_forward_logits_match_reference(f32):
    jm, tm, jp, tp = f32
    toks = np.random.default_rng(4).integers(0, 251, (2, 20)).astype(np.int32)
    jl, _ = jm.forward(jp, tokens=jnp.asarray(toks))
    tl, aux = tm.forward(tp, tokens=torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 20, 251)
    assert rel_err(_np(tl), jl) <= 1e-5 and float(aux) == 0.0


# ---- 8-bit moments and AdamW --------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 512), (4, 96), (7, 5), (1000,)])
def test_qtensor_codes_and_scales_bitwise(shape):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32) * 1e-3
    x.reshape(-1)[:3] = [0.0, -0.0, 1e-12]
    for jq_fn, tq_fn, jd_fn, td_fn in ((jint8.quantize_state, tint8.quantize_state,
                                        jint8.dequantize_state, tint8.dequantize_state),
                                       (jint8.quantize_state_sq, tint8.quantize_state_sq,
                                        jint8.dequantize_state_sq, tint8.dequantize_state_sq)):
        a, b = jq_fn(jnp.asarray(np.abs(x) if jq_fn is jint8.quantize_state_sq else x)), \
            tq_fn(torch.from_numpy(np.abs(x) if tq_fn is tint8.quantize_state_sq else x))
        if shape[-1] < 8:
            assert not isinstance(b, tint8.QTensor)     # stays f32, as the reference
            continue
        assert isinstance(b, tint8.QTensor) and b.shape == a.shape
        assert np.array_equal(b.codes.view(torch.uint8).numpy(),
                              np.asarray(a.codes).view(np.uint8))
        assert np.array_equal(b.scale.numpy(), np.asarray(a.scale))
        assert np.array_equal(td_fn(b).numpy(), np.asarray(jd_fn(a)))


def test_tree_order_matches_jax_with_lists_and_cnn_params():
    from repro_torch.cnn.models import build_cnn

    tree = {"b": [{"y": 1, "x": 2}, 3], "a": {"z": [4, 5]}, "c": 6}
    assert tree_leaves(tree) == jax.tree.leaves(tree) == [4, 5, 2, 1, 3, 6]
    assert tree_unflatten(tree, list(range(6))) == {"a": {"z": [0, 1]},
                                                     "b": [{"x": 2, "y": 3}, 4], "c": 5}
    cnn = build_cnn("resnet20").init(0, device="cpu")
    names = [n for n in sorted(cnn) for _ in sorted(cnn[n])]
    assert len(tree_leaves(cnn)) == len(names)
    assert [t.data_ptr() for t in tree_leaves(cnn)] == [
        cnn[n][k].data_ptr() for n in sorted(cnn) for k in sorted(cnn[n])]


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_adamw_over_lm_params_with_cosine_schedule(f32, moments):
    jm, tm, jp, tp = f32
    kw = dict(b1=0.9, b2=0.95, weight_decay=0.1, moments=moments)
    jopt = JAdamW(lr=jcosine(3e-3, warmup=2, total=5), **kw)
    topt = AdamW(lr=cosine_schedule(3e-3, warmup=2, total=5), **kw)
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(6)
    for _ in range(4):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 1e-2,
                             jp)
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, grads), js)
        tp, ts = topt.update(tp, to_port(grads), ts)
    top = max(float(np.max(np.abs(np.asarray(x)))) for x in jax.tree.leaves(jp))
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert np.max(np.abs(_np(a) - np.asarray(b, np.float32))) <= 1e-6 * top
    is_q = lambda x: isinstance(x, jint8.QTensor)       # noqa: E731
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(ts[key]), jax.tree.leaves(js[key], is_leaf=is_q)):
            da = _np(tint8.dequantize_state(a))
            db = np.asarray(jint8.dequantize_state(b), np.float32)
            assert np.max(np.abs(da - db)) <= 1e-6 * max(np.max(np.abs(db)), 1e-30) + 1e-12
    assert ts["step"] == int(js["step"]) == 4
    assert cosine_schedule(3e-3, 2, 5)(3) == float(jcosine(3e-3, 2, 5)(3))


# ---- the train step -------------------------------------------------------------
@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_train_step_matches_reference(f32, moments):
    jm, tm, jp, tp = f32
    jbm, tbm = _bits_maps(jm, tm)
    lr = 1e-3
    jopt, topt = JAdamW(lr=lr, moments=moments), AdamW(lr=lr, moments=moments)
    batch = JData(seed=1, global_batch=2, seq_len=32, vocab=251).next()
    js, jout = jmake_train_step(jm, jopt, donate=False)(
        {"params": jp, "opt": jopt.init(jp)}, batch, jbm)
    ts, tout = make_train_step(tm, topt, remat="full")(
        {"params": tp, "opt": topt.init(tp)}, batch, tbm)
    assert set(tout) == {"loss", "grad_norm", "nll", "aux"}
    assert all(isinstance(v, torch.Tensor) and v.ndim == 0 for v in tout.values())
    for k in ("loss", "grad_norm", "nll"):
        assert rel_err(_np(tout[k]), jout[k]) <= 1e-5, k
    # Adam's first step is lr * g / (|g| + eps): where the clipped gradient
    # is within a few eps of 0 its size (and sign) rests on rounding noise
    # in g, taken as 1e-5 of the leaf's largest element; those elements may
    # move by lr * eps * noise / (|g| + eps)^2, at most 2 lr, and are counted
    jg = jax.grad(lambda p: jm.loss(jquantize_params(p, jbm, jm.quant_groups()),
                                    {k: jnp.asarray(v) for k, v in batch.items()})[0])(jp)
    gn = float(jout["grad_norm"])
    clip = min(1.0, 1.0 / max(gn, 1e-9))
    noisy = total = 0
    for a, b, g in zip(tree_leaves(ts["params"]), jax.tree.leaves(js["params"]),
                       jax.tree.leaves(jg)):
        d = np.abs(_np(a) - np.asarray(b, np.float32))
        g = np.abs(np.asarray(g, np.float64)) * clip
        noise = 1e-5 * g.max()
        bound = np.minimum(2 * lr, lr * 1e-8 * noise / (g + 1e-8) ** 2) + 1e-6
        assert np.all(d <= bound)
        noisy += int(np.sum(d > 1e-6))
        total += d.size
    assert noisy < total / 1000, (noisy, total)
    if moments == "int8":
        assert any(isinstance(x, tint8.QTensor) for x in tree_leaves(ts["opt"]["m"]))


def test_unported_train_paths_raise(tmp_path):
    """The data-parallel step and ``Trainer(mesh=)`` run on the CPU at world
    size 1: at planes 0 the step's loss is bitwise the plain step's (a mean
    over one rank), at planes 2 its ``ef`` takes the gradients' dtype, and
    a checkpoint's ``ef`` keeps its leading rank axis.  A compressed step
    with no ``ef`` in its state raises."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.quant.qat import policy_for
    from repro_torch.train.train_step import init_dp_state, init_state

    _, model = models()
    opt = AdamW(lr=1e-3)
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 8)), "cpu")
    batch = SyntheticLMData(seed=0, global_batch=2, seq_len=16,
                            vocab=model.cfg.vocab_size).next()
    try:
        mesh = make_host_mesh((1, 1), device="cpu")
        _, plain = make_train_step(model, opt)(init_state(model, opt, 0, "cpu"), batch, bm)
        state = init_dp_state(model, opt, 0, mesh)
        _, exact = make_dp_train_step(model, opt, mesh, planes=0)(state, batch, bm)
        assert exact["loss"].item() == plain["loss"].item()
        state = init_dp_state(model, opt, 0, mesh)
        new, m = make_dp_train_step(model, opt, mesh, planes=2)(state, batch, bm)
        assert math.isfinite(m["loss"].item())
        ef = tree_leaves(new["ef"])
        # each residual takes its gradient's dtype: bf16 weights, f32 norm gains
        assert [e.dtype for e in ef] == [p.dtype for p in tree_leaves(new["params"])]
        assert torch.bfloat16 in {e.dtype for e in ef}
        assert all(e.shape[0] == 1 for e in ef) and any(e.to_local().any() for e in ef)
        tr = Trainer(model=model, optimizer=opt, data=None, step_fn=None, bits_map=bm,
                     ckpt_dir=str(tmp_path), mesh=mesh)
        ckpt_lib.save(str(tmp_path), 1, new)
        restored, _, step = tr._reload(new)
        assert step == 1 and tuple(tree_leaves(restored["ef"])[0].shape) == tuple(ef[0].shape)
        with pytest.raises(ValueError, match="ef"):
            make_dp_train_step(model, opt, mesh, planes=2)(
                {k: state[k] for k in ("params", "opt")}, batch, bm)
    finally:
        dist.destroy_process_group()


# ---- checkpoints and the Trainer --------------------------------------------------
class TestCheckpoint:
    def test_roundtrip_with_qtensor(self, tmp_path):
        tree = {"a": torch.arange(5.0), "q": tint8.quantize_state(torch.ones((512,))),
                "nested": {"b": torch.full((2, 3), 1.00390625, dtype=torch.bfloat16)},
                "list": [torch.tensor([1, 2], dtype=torch.int32), 7]}
        ckpt_lib.save(str(tmp_path), 7, tree, meta={"x": 1})
        back, meta, step = ckpt_lib.restore(str(tmp_path), device="cpu")
        assert step == 7 and meta["x"] == 1
        assert isinstance(back["q"], tint8.QTensor) and back["q"].shape == (512,)
        assert torch.equal(back["q"].codes.view(torch.uint8), tree["q"].codes.view(torch.uint8))
        assert torch.equal(back["q"].scale, tree["q"].scale)
        assert torch.equal(back["a"], torch.arange(5.0))
        assert back["nested"]["b"].dtype == torch.bfloat16
        assert torch.equal(back["nested"]["b"], tree["nested"]["b"])
        assert torch.equal(back["list"][0], tree["list"][0]) and back["list"][1] == 7

    def test_prune_and_latest(self, tmp_path):
        for s in (1, 2, 3, 4, 5):
            ckpt_lib.save(str(tmp_path), s, {"x": torch.tensor(s)}, keep=2)
        assert ckpt_lib.latest_step(str(tmp_path)) == 5
        _, _, step = ckpt_lib.restore(str(tmp_path), step=4, device="cpu")
        assert step == 4
        with pytest.raises(FileNotFoundError):
            ckpt_lib.restore(str(tmp_path), step=1, device="cpu")  # pruned

    def test_restore_reads_what_np_load_reads_and_checks_each_crc(self, tmp_path):
        """``restore`` reads each member straight from the stored zip: the
        arrays ``np.load`` gives (0-d, empty, bf16 and fp8 as their bits),
        and a flipped byte fails the member's CRC."""
        tree = {"z": torch.tensor(3.5), "e": torch.zeros((0, 4)),
                "b": torch.randn(7, 5).to(torch.bfloat16),
                "f8": torch.randn(33).to(torch.float8_e4m3fn), "i": torch.arange(6, dtype=torch.int32)}
        path = ckpt_lib.save(str(tmp_path), 1, tree)
        back, _, _ = ckpt_lib.restore(str(tmp_path), device="cpu")
        with np.load(os.path.join(path, "leaves.npz")) as ref:
            for i, key in enumerate(sorted(tree)):
                got = back[key]
                if got.dtype == torch.float8_e4m3fn:
                    got = got.view(torch.uint8).numpy()
                elif got.dtype == torch.bfloat16:
                    got = got.view(torch.int16).numpy().view(np.uint16)
                else:
                    got = got.numpy()
                np.testing.assert_array_equal(got, ref[f"leaf_{i}"])
                assert back[key].dtype == tree[key].dtype and back[key].shape == tree[key].shape
        import zipfile

        npz = os.path.join(path, "leaves.npz")
        with zipfile.ZipFile(npz) as zf:        # the last data byte of leaf_0 (b)
            info = zf.getinfo("leaf_0.npy")
        with open(npz, "r+b") as f:
            f.seek(info.header_offset + 26)
            name_len, extra_len = np.frombuffer(f.read(4), "<u2")
            at = info.header_offset + 30 + int(name_len) + int(extra_len) + info.file_size - 1
            f.seek(at)
            byte = f.read(1)
            f.seek(at)
            f.write(bytes([byte[0] ^ 1]))
        with pytest.raises(ValueError, match="leaf_0 fails its CRC"):
            ckpt_lib.restore(str(tmp_path), device="cpu")

    def test_incomplete_tmp_ignored(self, tmp_path):
        ckpt_lib.save(str(tmp_path), 1, {"x": torch.tensor(1)})
        os.makedirs(tmp_path / "step_00000009.tmp")  # crashed write
        assert ckpt_lib.latest_step(str(tmp_path)) == 1


def _trainer_parts(opt8=False):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.quant.qat import policy_for

    model = build_model(get_config("phi3-mini-3.8b", smoke=True))
    opt = AdamW(lr=1e-3, moments="int8" if opt8 else "fp32")
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 8)), "cpu")
    return model, opt, bm, make_train_step(model, opt)


class TestTrainerRestart:
    @pytest.mark.parametrize("opt8", [False, True])
    def test_resume_identical_loss_curve(self, tmp_path, opt8):
        """Crash after step 6, restart; steps 7-10 must match a straight run."""
        from repro_torch.train.train_step import init_state

        model, opt, bm, step_fn = _trainer_parts(opt8)

        def mk_trainer(ckpt_dir):
            data = SyntheticLMData(seed=0, global_batch=4, seq_len=16,
                                   vocab=model.cfg.vocab_size)
            return Trainer(model=model, optimizer=opt, data=data, step_fn=step_fn,
                           bits_map=bm, ckpt_dir=ckpt_dir, ckpt_interval=3, log_every=0)

        t0 = mk_trainer(None)
        t0.run(init_state(model, opt, seed=0, device="cpu"), 10)
        ref = [h["loss"] for h in t0.history]
        t1 = mk_trainer(str(tmp_path))
        t1.run(init_state(model, opt, seed=0, device="cpu"), 6)
        t2 = mk_trainer(str(tmp_path))
        t2.run(init_state(model, opt, seed=0, device="cpu"), 10)   # restored inside
        assert [h["loss"] for h in t2.history] == ref[6:]

    def test_straggler_detection(self):
        import time as _t

        from repro_torch.train.train_step import init_state

        model, opt, bm, inner = _trainer_parts()
        calls = {"n": 0}

        def slow_step(state, batch, bmm):
            calls["n"] += 1
            if calls["n"] == 8:
                _t.sleep(1.0)  # injected straggler
            return inner(state, batch, bmm)

        flagged = []
        tr = Trainer(model=model, optimizer=opt,
                     data=SyntheticLMData(seed=0, global_batch=4, seq_len=16,
                                          vocab=model.cfg.vocab_size),
                     step_fn=slow_step, bits_map=bm, ckpt_dir=None, straggler_factor=3.0,
                     log_every=0, on_straggler=lambda s, dt, ema: flagged.append(s))
        tr.run(init_state(model, opt, seed=0, device="cpu"), 10)
        assert tr.straggler_count >= 1 and flagged

    def test_nan_loss_is_quarantined(self, tmp_path):
        from repro_torch.train.train_step import init_state

        model, opt, bm, inner = _trainer_parts()
        calls = {"n": 0}

        def poisoned(state, batch, bmm):
            calls["n"] += 1
            new, m = inner(state, batch, bmm)
            if calls["n"] == 5:
                m = dict(m, loss=torch.tensor(float("nan")))
            return new, m

        tr = Trainer(model=model, optimizer=opt,
                     data=SyntheticLMData(seed=0, global_batch=4, seq_len=16,
                                          vocab=model.cfg.vocab_size),
                     step_fn=poisoned, bits_map=bm, ckpt_dir=str(tmp_path), ckpt_interval=2,
                     log_every=0)
        tr.run(init_state(model, opt, seed=0, device="cpu"), 6)
        assert [h["step"] for h in tr.history][-1] == 6
        assert all(np.isfinite(h["loss"]) for h in tr.history)


    @pytest.mark.parametrize("opt8", [False, True], ids=["fp32", "int8"])
    def test_nan_loss_without_a_checkpoint_raises(self, opt8):
        """No checkpoint to reload: the run raises at the poisoned step
        instead of looping (AdamW has already consumed that step's
        gradients in place).  The run goes on a thread of its own with a
        time limit, and the step function refuses to run past a bound, so
        a regression fails here instead of hanging."""
        import threading

        from repro_torch.train.train_step import init_state

        model, opt, bm, inner = _trainer_parts(opt8)
        calls = {"n": 0}

        def poisoned(state, batch, bmm):
            calls["n"] += 1
            if calls["n"] > 20:
                raise AssertionError("the trainer looped past the poisoned step")
            new, m = inner(state, batch, bmm)
            if calls["n"] == 3:
                m = dict(m, loss=torch.tensor(float("nan")))
            return new, m

        tr = Trainer(model=model, optimizer=opt,
                     data=SyntheticLMData(seed=0, global_batch=4, seq_len=16,
                                          vocab=model.cfg.vocab_size),
                     step_fn=poisoned, bits_map=bm, ckpt_dir=None, log_every=0)
        caught = []

        def run():
            try:
                tr.run(init_state(model, opt, seed=0, device="cpu"), 6)
            except Exception as e:          # handed to the test's thread
                caught.append(e)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive(), "the trainer did not return within 120 s"
        assert len(caught) == 1 and isinstance(caught[0], FloatingPointError), caught
        assert "step 3" in str(caught[0]) and calls["n"] == 3
        assert [h["step"] for h in tr.history] == [1, 2]


# ---- the launcher -----------------------------------------------------------------
def test_train_launcher_on_cpu(tmp_path):
    from repro_torch.launch import train

    out = train.main(["--device", "cpu", "--steps", "3", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in out["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert ckpt_lib.latest_step(str(tmp_path)) == 3
    out8 = train.main(["--device", "cpu", "--steps", "2", "--opt8", "--bits", "4",
                       "--remat", "dots", "--arch", "glm4-9b"])
    assert len(out8["history"]) == 2


def test_train_launcher_refuses_without_a_card_and_mesh():
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])
    # what the tensor-parallel step does not take is refused before a
    # process group starts: MODEL > 1 for the hybrid family, 8-bit moments
    # under the tensor-parallel step across ranks (the moe family's at any mesh)
    with pytest.raises(NotImplementedError, match="hybrid family.*item 11b-iv"):
        train.main(["--device", "cpu", "--mesh", "2,4", "--arch", "hymba-1.5b"])
    args = train.parse_args(["--device", "cpu", "--mesh", "2,1", "--opt8",
                             "--arch", "moonshot-v1-16b-a3b"])
    with pytest.raises(NotImplementedError, match="--opt8.*item 11b-iv"):
        train.setup(args)
    assert not torch.distributed.is_initialized()
