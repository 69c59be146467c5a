"""The ReLeQ search loop of repro_torch (WRPN QAT through the fake-quant
kernel's plain version, the CNN zoo, the LSTM-PPO agent, AdamW, the
episode loop) against the JAX package, on the CPU.

Tolerances, each with its reason:
- fake-quant, its STE and the data batches are elementwise IEEE f32 (or
  numpy) in both packages: bitwise.  One exception is the reference's
  own: the Pallas kernel computes its level count as ``exp2(bits-1) - 1``
  and XLA's CPU ``exp2`` gives 32766.984 for 2^15 - 1, so at 16 bits in
  f32 the Pallas interpret output sits up to one quantization step from
  ``repro.quant.wrpn.fake_quant`` (the function the QAT path runs, and
  the kernel's oracle).  There the port is held bitwise to that oracle,
  and to the Pallas interpret output within one step.
- CNN logits and train steps: f32 convolutions and matmuls sum in other
  orders (XLA against oneDNN), ~1e-7 relative per op: 1e-5 * max.
- The agent, the PPO loss and its gradients: f32 matmuls, 1e-5 (* max).
- AdamW on identical gradients: 1e-6 absolute (lr 1e-3 steps).  One PPO
  update (3 epochs): 1e-6 absolute, except where a gradient element is
  below 1e-6 of its leaf's max: there the sign of Adam's first step
  (size lr) rests on rounding noise.  Those elements are counted and
  printed, not compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets torch's CPU threads)
from repro.cnn import data as jdata
from repro.cnn import models as jmodels
from repro.cnn.train import CNNTask as JCNNTask
from repro.core import agent as jagent
from repro.core import costmodel as jcm
from repro.core import env as jenv
from repro.core import ppo as jppo
from repro.core import reward as jreward
from repro.kernels import ref as jkref
from repro.kernels.fake_quant import fake_quant_pallas
from repro.optim.adamw import AdamW as JAdamW
from repro.quant import wrpn as jwrpn
from repro_torch.cnn import data as tdata
from repro_torch.cnn import models as tmodels
from repro_torch.cnn.train import CNNTask
from repro_torch.convert import agent_params_from_numpy, cnn_params_from_numpy
from repro_torch.core import agent as tagent
from repro_torch.core import costmodel as tcm
from repro_torch.core import env as tenv
from repro_torch.core import ppo as tppo
from repro_torch.core import reward as treward
from repro_torch.core.search import ReLeQSearch
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.optim import AdamW
from repro_torch.quant import wrpn as twrpn

FQ_BITS = [1, 2, 3, 4, 5, 6, 7, 8, 16, 32]
FQ_SHAPES = [(256, 256), (7, 300), (3, 3, 16, 32)]   # aligned, ragged, HWIO conv
NETS = sorted(jmodels.CNN_ZOO)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


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


def _weights(shape, dtype, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w.reshape(-1)[:3] = [0.0, -0.0, np.abs(w).max()]   # zeros and the max itself
    return jnp.asarray(w, dtype), torch.from_numpy(w).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("shape", FQ_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", FQ_BITS)
def test_fake_quant_plain_matches_reference_and_pallas(bits, dtype, shape):
    jw, tw = _weights(shape, dtype, seed=bits)
    jscale = jwrpn.tensor_scale(jw)
    tscale = twrpn.tensor_scale(tw)
    assert np.array_equal(np.asarray(jscale), tscale.numpy())
    want = np.asarray(jkref.fake_quant_ref(jw, jnp.int32(bits), jscale), np.float32)
    pallas = np.asarray(_pallas_interpret(jw, bits, jscale), np.float32)
    before = dict(ops.counts)
    got_ops = ops.fake_quant(tw, torch.tensor(bits, dtype=torch.int32), tscale)
    assert ops.counts["plain"] == before["plain"] + 1
    assert ops.counts["fake_quant"] == before["fake_quant"]
    for got in (tref.fake_quant_ref(tw, bits, tscale), got_ops,
                ops.fake_quant(tw, bits), twrpn.fake_quant(tw, bits)):
        assert got.dtype == tw.dtype and tuple(got.shape) == shape
        assert np.array_equal(_np(got), want)
    if bits == 16 and dtype == jnp.float32:   # the reference kernel's exp2 (docstring)
        step = float(jscale) / (2 ** 15 - 1)
        assert np.abs(_np(got_ops) - pallas).max() <= step * (1 + 1e-6)
    else:
        assert np.array_equal(_np(got_ops), pallas)


def test_fake_quant_keeps_nan_and_takes_a_bits_vector_entry():
    w = torch.tensor([[float("nan"), 0.5, -2.0, 1.0]])
    scale = torch.tensor(2.0)
    vec = torch.tensor([32, 3, 2], dtype=torch.int32)
    got = ops.fake_quant(w, vec[1], scale)
    assert torch.isnan(got[0, 0]) and torch.equal(got[0, 1:], torch.tensor([0.6666667, -2.0, 1.3333334]))
    assert torch.equal(ops.fake_quant(w, vec[0], scale)[0, 1:], w[0, 1:])
    want = np.asarray(jwrpn.fake_quant(jnp.asarray(w.numpy()), jnp.int32(3), jnp.float32(2.0)))
    assert np.isnan(want[0, 0]) and np.array_equal(want[0, 1:], got[0, 1:].numpy())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8, 32])
def test_fake_quant_ste_values_and_grads_bitwise(bits, dtype):
    jw, tw = _weights((24, 40), dtype, seed=100 + bits)
    cot = np.random.default_rng(bits).standard_normal((24, 40)).astype(np.float32)
    jc = jnp.asarray(cot, dtype)

    def f(w):
        return jnp.sum((jwrpn.fake_quant_ste(w, jnp.int32(bits)) * jc).astype(jnp.float32))

    jval = jwrpn.fake_quant_ste(jw, jnp.int32(bits))
    jgrad = jax.grad(f)(jw)
    tw = tw.requires_grad_(True)
    tval = twrpn.fake_quant_ste(tw, torch.tensor(bits, dtype=torch.int32))
    (tgrad,) = torch.autograd.grad(tval, tw, grad_outputs=torch.from_numpy(
        np.array(jc, np.float32)).to(tw.dtype))
    assert np.array_equal(_np(tval), np.asarray(jval, np.float32))
    assert np.array_equal(_np(tgrad), np.asarray(jgrad, np.float32))
    # outside the clip region (|w| > scale) the STE passes no gradient
    scale = twrpn.tensor_scale(tw.detach()) * 0.5
    (g_half,) = ops.fake_quant_group_bwd([tw.detach()], [torch.ones_like(tw)], scale.reshape(1))
    assert torch.equal(g_half != 0, tw.detach().abs().float() <= scale)


def test_unported_paths_raise_with_their_roadmap_item():
    """The data- and tensor-parallel steps and ``Trainer(mesh=)`` build on
    the CPU at world size 1; tensor-parallel ``--mesh`` parses for every
    family and refuses those it does not take (rwkv6's ssm family), naming
    their item."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import lm_search, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train.train_step import make_dp_train_step, make_tp_train_step
    from repro_torch.train.trainer import Trainer

    model = build_model(get_config("glm4-9b", smoke=True))
    try:
        mesh = make_host_mesh((1,), ("data",), device="cpu")
        assert callable(make_dp_train_step(model, AdamW(), mesh))
        assert callable(make_tp_train_step(model, AdamW(), mesh))
        tr = Trainer(model=model, optimizer=AdamW(), data=None, step_fn=None, bits_map={},
                     mesh=mesh)
        assert tr.mesh is mesh
    finally:
        dist.destroy_process_group()
    args = train.parse_args(["--device", "cpu", "--mesh", "1,2", "--arch", "rwkv6-1.6b"])
    assert args.mesh == (1, 2)
    with pytest.raises(NotImplementedError, match="item 11b-iv"):
        train.make_mesh(args, get_config("rwkv6-1.6b", smoke=True), "cpu")
    assert not lm_search.parse_args(["--device", "cpu"]).lockstep   # async by default


@pytest.mark.parametrize("name", sorted(jdata._SPECS))
def test_cnn_data_batches_bitwise(name):
    jd, td = jdata.make_dataset(name, 3), tdata.make_dataset(name, 3)
    for split, index in (("train", 0), ("train", 17), ("val", 1), ("test", 2)):
        (jx, jy), (tx, ty) = jd.batch(16, index, split), td.batch(16, index, split)
        assert np.array_equal(jx, tx) and np.array_equal(jy, ty)
    assert tdata.DATASET_FOR == jdata.DATASET_FOR


@pytest.mark.parametrize("net", NETS)
def test_cnn_model_matches_reference(net):
    jm, tm = jmodels.build_cnn(net), tmodels.build_cnn(net)
    assert [tuple(vars(g).values()) for g in tm.quant_groups()] == \
        [tuple(vars(g).values()) for g in jm.quant_groups()]
    assert tm.frozen_bits() == jm.frozen_bits()
    jp = jm.init(jax.random.PRNGKey(1))
    tp = cnn_params_from_numpy(_to_numpy_tree(jp), device="cpu")
    own = tm.init(1, device="cpu")       # the port's own init: same shapes
    assert {n: {k: tuple(t.shape) for k, t in p.items()} for n, p in own.items()} == \
        {n: {k: tuple(t.shape) for k, t in p.items()} for n, p in tp.items()}
    x, _ = jdata.make_dataset(jdata.DATASET_FOR[net]).batch(3, 0)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, jm.num_classes)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("size,k,stride,want", [(32, 3, 1, (1, 1)), (32, 3, 2, (0, 1)),
                                                (28, 5, 2, (1, 2)), (14, 5, 2, (1, 2)),
                                                (8, 1, 1, (0, 0)), (16, 3, 2, (0, 1))])
def test_same_padding_is_xla_same(size, k, stride, want):
    assert tmodels.same_padding(size, k, stride) == want
    x = np.random.default_rng(size + k).standard_normal((1, size, size, 2)).astype(np.float32)
    w = np.random.default_rng(stride).standard_normal((k, k, 2, 3)).astype(np.float32)
    ref = np.asarray(jmodels._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tmodels._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                        torch.from_numpy(w).permute(3, 2, 0, 1), stride)
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def _lenet_pair(batch=32):
    jt = JCNNTask("lenet", seed=0, batch=batch)
    tt = CNNTask("lenet", seed=0, batch=batch, device="cpu")
    tt.params = cnn_params_from_numpy(_to_numpy_tree(jt.params), device="cpu")
    tt.mom = tt._zeros_like(tt.params)
    return jt, tt


def _assert_cnn_params_close(tp, jp, tol):
    jt = cnn_params_from_numpy(_to_numpy_tree(jp), device="cpu")
    for n in jt:
        for k in ("w", "b"):
            ref = jt[n][k].numpy()
            assert np.abs(tp[n][k].numpy() - ref).max() <= tol * max(np.abs(ref).max(), 1e-30), (n, k)


def test_lenet_train_step_and_accuracy_match_reference():
    jt, tt = _lenet_pair()
    bits = {"conv1": 3, "conv2": 2, "fc1": 5, "fc2": 32}
    jp, jm = jt.train(2, bits)
    tp, tm = tt.train(2, bits)
    assert jt._index == tt._index == 2
    _assert_cnn_params_close(tp, jp, 1e-5)
    _assert_cnn_params_close(tm, jm, 1e-5)
    assert tt.accuracy(tp, bits) == jt.accuracy(jp, bits)
    assert tt.accuracy(tp) == jt.accuracy(jp)
    # the task's own params are untouched by train()
    _assert_cnn_params_close(tt.params, jt.params, 0.0)


def test_cnn_task_weight_std_and_env_factory_match_reference():
    jt, tt = _lenet_pair()
    jstd, tstd = jt.weight_std(), tt.weight_std()
    assert jstd.keys() == tstd.keys()
    assert all(abs(jstd[n] - tstd[n]) <= 1e-6 * jstd[n] for n in jstd)
    env = tt.make_env_factory(retrain_steps=1)(0)
    assert env.T == 4 and env.bitset == (2, 3, 4, 5, 6, 7, 8)


def _groups():
    return tmodels.build_cnn("resnet20").quant_groups(), jmodels.build_cnn("resnet20").quant_groups()


def test_costmodel_matches_reference_on_random_bits():
    tg, jg = _groups()
    rng = np.random.default_rng(0)
    for _ in range(20):
        bits = rng.integers(1, 17, size=len(tg)).tolist()
        for t_fn, j_fn in ((tcm.stripes_time, jcm.stripes_time),
                           (tcm.tvm_cpu_time, jcm.tvm_cpu_time)):
            assert t_fn(bits, tg) == j_fn(bits, jg)
            assert tcm.speedup_vs_8bit(t_fn, bits, tg) == jcm.speedup_vs_8bit(j_fn, bits, jg)
        assert tcm.state_of_quantization(bits, tg) == jcm.state_of_quantization(bits, jg)
        assert tcm.stripes_energy(bits, tg) == jcm.stripes_energy(bits, jg)
        assert tcm.energy_reduction_vs_8bit(bits, tg) == jcm.energy_reduction_vs_8bit(bits, jg)
    assert not hasattr(tcm, "tpu_decode_time")


def test_rewards_match_reference():
    for mode in jreward.REWARDS:
        for acc in np.linspace(-0.1, 1.6, 18):
            for q in np.linspace(0.0, 1.2, 13):
                assert treward.REWARDS[mode](acc, q) == jreward.REWARDS[mode](acc, q)


@pytest.mark.parametrize("eval_mode", ["per_step", "episode_end", "deferred"])
def test_env_episode_matches_reference(eval_mode):
    tg, jg = _groups()
    std = {g.name: 0.1 + 0.01 * i for i, g in enumerate(tg)}
    frozen = {"stem": 8, "fc": 8}

    def evaluate(bits):
        return 1.0 - 0.004 * sum(8 - b for b in bits.values())

    envs = [mod.QuantEnv(groups=g, evaluate=evaluate, weight_std=std, frozen=frozen,
                         eval_mode=eval_mode)
            for mod, g in ((tenv, tg), (jenv, jg))]
    assert envs[0].T == envs[1].T == 18
    obs = [e.reset() for e in envs]
    assert np.array_equal(*obs)
    actions = np.random.default_rng(1).integers(0, 7, size=18)
    for a in actions:
        outs = [e.step(int(a)) for e in envs]
        assert np.array_equal(outs[0][0], outs[1][0])
        assert outs[0][1:] == outs[1][1:]
    assert envs[0].reward_for(0.95, 0.4) == envs[1].reward_for(0.95, 0.4)


def _agent_pair(seed=0, actions=7):
    jp = jagent.init_agent(jax.random.PRNGKey(seed), jenv.STATE_DIM, actions)
    return jp, agent_params_from_numpy(_to_numpy_tree(jp), device="cpu")


@pytest.mark.parametrize("use_lstm", [True, False])
def test_agent_step_and_rollout_match_reference(use_lstm):
    jp, tp = _agent_pair()
    own = tagent.init_agent(0, tenv.STATE_DIM, 7, device="cpu")
    assert {k: {n: t.shape for n, t in p.items()} for k, p in own.items()} == \
        {k: {n: t.shape for n, t in p.items()} for k, p in tp.items()}
    states = np.random.default_rng(2).standard_normal((3, 6, jenv.STATE_DIM)).astype(np.float32)
    carry = tuple(np.random.default_rng(3).standard_normal((2, 3, 128)).astype(np.float32))
    jc, jl, jv = jagent.agent_step(jp, tuple(map(jnp.asarray, carry)),
                                   jnp.asarray(states[:, 0]), use_lstm)
    tc, tl, tv = tagent.agent_step(tp, tuple(map(torch.from_numpy, carry)),
                                   torch.from_numpy(states[:, 0]), use_lstm)
    for t, j in ((tl, jl), (tv, jv), (tc[0], jc[0]), (tc[1], jc[1])):
        assert np.abs(t.numpy() - np.asarray(j)).max() <= 1e-5
    jl, jv = jagent.rollout_logits(jp, jnp.asarray(states), use_lstm)
    tl, tv = tagent.rollout_logits(tp, torch.from_numpy(states), use_lstm)
    assert tl.shape == (3, 6, 7) and tv.shape == (3, 6)
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= 1e-5
    assert np.abs(tv.numpy() - np.asarray(jv)).max() <= 1e-5


def _trajectories(B=2, T=6, A=7, seed=4):
    rng = np.random.default_rng(seed)
    return {"states": rng.standard_normal((B, T, jenv.STATE_DIM)).astype(np.float32),
            "actions": rng.integers(0, A, size=(B, T)).astype(np.int32),
            "logp_old": np.log(rng.uniform(0.05, 0.3, size=(B, T))).astype(np.float32),
            "rewards": rng.uniform(-1, 1, size=(B, T)).astype(np.float32),
            "values": rng.standard_normal((B, T)).astype(np.float32) * 0.1}


def _batch(traj, cfg, to):
    adv, ret = jppo.gae_advantages(traj["rewards"], traj["values"], cfg.gamma, cfg.lam)
    tadv, tret = tppo.gae_advantages(traj["rewards"], traj["values"], cfg.gamma, cfg.lam)
    assert np.array_equal(adv, tadv) and np.array_equal(ret, tret)
    b = {"states": traj["states"], "actions": traj["actions"], "logp_old": traj["logp_old"],
         "adv": adv, "returns": ret}
    return {k: to(v) for k, v in b.items()}


@pytest.mark.parametrize("use_lstm", [True, False])
def test_ppo_loss_and_grads_match_reference(use_lstm):
    cfg_j, cfg_t = jppo.PPOConfig(use_lstm=use_lstm), tppo.PPOConfig(use_lstm=use_lstm)
    jp, tp = _agent_pair(1)
    traj = _trajectories()
    jb = _batch(traj, cfg_j, jnp.asarray)
    tb = _batch(traj, cfg_t, lambda a: torch.from_numpy(np.array(a)))
    jtotal, jm = jppo.ppo_loss(jp, jb, cfg_j)
    ttotal, tm = tppo.ppo_loss(tp, tb, cfg_t)
    assert abs(float(ttotal) - float(jtotal)) <= 1e-5 * max(abs(float(jtotal)), 1.0)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * max(abs(float(jm[k])), 1.0), k
    jg = jax.grad(lambda p: jppo.ppo_loss(p, jb, cfg_j)[0])(jp)
    tg = tppo.ppo_grads(tp, tb, cfg_t)
    for k in jg:
        for n in jg[k]:
            ref = np.asarray(jg[k][n])
            assert np.abs(tg[k][n].numpy() - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1e-12), (k, n)


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(5)
    shapes = {"a": {"w": (16, 8), "b": (8,)}, "z": {"w": (5, 3)}}
    p0 = {k: {n: rng.standard_normal(s).astype(np.float32) for n, s in v.items()}
          for k, v in shapes.items()}
    jopt = JAdamW(lr=1e-3, weight_decay=0.01, clip_norm=1.0)
    topt = AdamW(lr=1e-3, weight_decay=0.01, clip_norm=1.0)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()} for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):   # the first step is clipped (global norm > 1), later ones not
        g = {k: {n: (rng.standard_normal(s) * (3.0 if step == 0 else 0.01)).astype(np.float32)
                 for n, s in v.items()} for k, v in shapes.items()}
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = topt.update(tp, {k: {n: torch.from_numpy(a) for n, a in v.items()}
                                  for k, v in g.items()}, ts)
        assert ts["step"] == int(js["step"]) == step + 1
        for k in shapes:
            for n in shapes[k]:
                assert np.abs(tp[k][n].numpy() - np.asarray(jp[k][n])).max() <= 1e-6
                assert np.abs(ts["m"][k][n].numpy() - np.asarray(js["m"][k][n])).max() <= 1e-6
                assert np.abs(ts["v"][k][n].numpy() - np.asarray(js["v"][k][n])).max() <= 1e-6


def test_one_ppo_update_matches_reference():
    jp, tp = _agent_pair(2)
    traj = _trajectories(B=1, T=18, seed=6)
    ref = jppo.PPO(jp)
    cfg = ref.cfg
    jb = _batch(traj, cfg, jnp.asarray)
    # the reference's update, step by step, to see each epoch's gradient
    params, state, noisy = ref.params, ref.opt_state, None
    for _ in range(cfg.epochs):
        g = ref._grad(params, jb)
        small = jax.tree.map(lambda x: np.abs(np.asarray(x)) < 1e-6 * np.abs(np.asarray(x)).max(), g)
        noisy = small if noisy is None else jax.tree.map(np.logical_or, noisy, small)
        params, state = ref.opt.update(params, g, state)
    jm = ref.update(traj)          # the same update through the public method
    port = tppo.PPO(tp)
    tm = port.update(traj)
    excluded = compared = excluded_off = 0
    for k in params:
        for n in params[k]:
            want = np.asarray(params[k][n])
            assert np.array_equal(want, np.asarray(ref.params[k][n]))
            mask = ~noisy[k][n]
            diff = np.abs(port.params[k][n].numpy() - want)
            assert diff[mask].max(initial=0.0) <= 1e-6, (k, n)
            excluded += int((~mask).sum())
            excluded_off += int((diff[~mask] > 1e-6).sum())
            compared += int(mask.sum())
    print(f"PPO update: {compared} elements within 1e-6; {excluded} excluded (a gradient "
          f"below 1e-6 of its leaf's max, mostly dead ReLU units), {excluded_off} of them "
          f"off by more than 1e-6")
    for k in jm:
        assert abs(tm[k] - jm[k]) <= 1e-5 * max(abs(jm[k]), 1.0), k


def test_quickstart_twin_runs_end_to_end_on_cpu():
    from repro_torch.launch import quickstart

    before = dict(ops.counts)
    out = quickstart.main(["--device", "cpu", "--pretrain-steps", "20", "--episodes", "2",
                           "--long-retrain-steps", "3"])
    task, res = out["task"], out["result"]
    assert ops.counts["fake_quant"] == before["fake_quant"]
    assert ops.counts["plain"] > before["plain"]
    assert 0.0 <= out["fp_acc"] <= 1.0 and out["fp_acc"] == task.fp_acc
    assert [e["episode"] for e in res.episodes] == [0, 1]
    assert res.best_reward == max(e["reward"] for e in res.episodes)
    assert res.best_bits in [e["bits"] for e in res.episodes]
    assert set(out["bits"]) == set(task.names)
    assert all(b in (2, 3, 4, 5, 6, 7, 8) for b in out["bits"].values())
    assert out["avg_bits"] == res.average_bits(task.names)
    assert np.array(res.prob_evolution).shape == (2, 4, 7)
    assert np.allclose(np.array(res.prob_evolution).sum(-1), 1.0, atol=1e-5)
    assert res.cache_stats["misses"] >= 1
    vec = [out["bits"][n] for n in task.names]
    assert out["stripes_speedup"] == tcm.speedup_vs_8bit(tcm.stripes_time, vec, task.groups)
    assert np.isfinite(out["rel_acc"]) and out["rel_acc"] > 0


def test_resnet20_episode_end_search_runs_on_cpu():
    """Phase 3e's path at full width on the CPU, at a tiny batch and a
    single episode: ResNet-20's 18 searchable layers, one short retrain
    at the episode's end, one PPO update."""
    task = CNNTask("resnet20", batch=4, device="cpu")
    task.fp_acc = task.accuracy(task.params)
    assert sum(g.n_weights for g in task.groups) == 268_336 and len(task.groups) == 20
    factory = task.make_env_factory(retrain_steps=1, eval_mode="episode_end")
    search = ReLeQSearch(factory, seed=3, device="cpu")
    res = search.run(episodes=1)
    assert len(res.episodes) == 1 and res.cache_stats["misses"] == 1
    assert res.best_bits["stem"] == res.best_bits["fc"] == 8
    assert np.array(res.prob_evolution).shape == (1, 18, 7)


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.launch import quickstart

    with pytest.raises(RuntimeError, match="CUDA"):
        CNNTask("lenet")
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])
    task = CNNTask("lenet", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ReLeQSearch(task.make_env_factory())
    with pytest.raises(RuntimeError, match="CUDA"):
        tagent.init_agent(0, 6, 7)
