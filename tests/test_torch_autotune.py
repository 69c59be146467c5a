"""repro_torch.autotune and what it needs (the archive, the decode
roofline, per-group spec drafts, the reader of checkpoints the JAX
trainer wrote) against the JAX package, on the CPU.

- The archive: the same offers from one numpy stream give the reference's
  entries, ``select`` picks and saved JSON exactly; ``as_archive`` on
  an enumerated space equals the reference's; each package warm-starts
  from the other's file.
- The cost model: ``weight_stream_decode_time`` at the V5E rates equals
  ``repro.core.costmodel.tpu_decode_time`` bitwise; its defaults are one
  H100's data-sheet rates.
- The service: the reference's ``TestService`` cases run on the port; a
  parity run against the reference's service (``in_order=True``, both
  actors' actions forced from one numpy stream, logp taken from the
  agent's own probabilities on each side) gives equal bits, rewards,
  ``q_eff`` and archive, and agent params within 1e-6 after every PPO
  update, the elements excluded exactly as ``tests/test_torch_releq.py``
  excludes them (a gradient below 1e-6 of its leaf's max in some epoch
  so far: the sign of Adam's first step there rests on rounding noise).
- The engine evaluators on the smoke glm4: measured, memoized, the
  engine dropped after each candidate; ``kv.*`` groups become the pool's
  ``kv_bits`` (uniform 4 the nibble-packed container).
- ``hot_swap`` with a queued request held, on a pipelined engine whose
  decode step is a ``GraphedDecodeStep`` (its graph replaced by an eager
  stand-in that replays the captured closure, so a graph that kept the
  old weights would serve them): it captures again, and the streams equal
  the JAX engine's after the same swap, run op by op.  ``deploy`` with
  its parity gate, and its roll-back when the gate fails.
- ``SpecConfig(draft_policy=DraftSelector().policy(...))`` streams equal
  the JAX spec engine's (op by op).
- ``launch/autotune.py`` with ``--device cpu`` (``--hw analytic|engine``,
  ``--deploy``, ``--layers``, ``--archive`` warm start, ``--task
  cnn:lenet``; ``--hw hlo`` refused for a CNN task); the async default
  of ``launch/lm_search.py`` is in ``tests/test_torch_lm_search.py``.
- A checkpoint the JAX ``Trainer`` writes (bf16 params, int8 moments) is
  served by ``launch/serve.py --ckpt-dir`` with the greedy streams of the
  params ``convert.py`` carries, without unpickling; a wrong template
  raises and names the leaf.
"""
import json
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets torch's CPU threads)
from repro.autotune import (
    AnalyticLatencyEvaluator as JAnalytic,
    AutotuneService as JService,
    ParetoArchive as JArchive,
    ServiceConfig as JServiceConfig,
    hot_swap as jhot_swap,
)
from repro.cnn import models as jcnn
from repro.core import costmodel as jcm
from repro.core import pareto as jpareto
from repro.core.env import QuantEnv as JEnv
from repro.core.ppo import gae_advantages as jgae
from repro.models.model import QuantGroup as JGroup
from repro.quant.qat import policy_for as jpolicy_for
from repro.serve import ServeEngine as JaxEngine
from repro.spec import DraftSelector as JDraftSelector
from repro.spec import SpecConfig as JaxSpec
from repro.train.serve import quantize_for_serving as jqfs
from repro_torch.autotune import (
    AnalyticLatencyEvaluator,
    AutotuneService,
    DraftabilityEvaluator,
    EngineLatencyEvaluator,
    ParetoArchive,
    ServiceConfig,
    compile_policy,
    deploy,
    hot_swap,
)
from repro_torch.cnn import models as tcnn
from repro_torch.convert import agent_params_from_numpy
from repro_torch.core import costmodel as tcm
from repro_torch.core import pareto as tpareto
from repro_torch.core.env import QuantEnv
from repro_torch.core.ppo import PPO
from repro_torch.core.search import ReLeQSearch
from repro_torch.models.model import QuantGroup
from repro_torch.quant.qat import policy_for
from repro_torch.serve import ServeEngine
from repro_torch.spec import DraftSelector, SpecConfig
from repro_torch.train import serve as tserve
from test_torch_pipeline import _ReplayedEagerly
from torch_parity import models, to_port

HOST = dict(sample_device=False, pipeline=False)
KW = dict(num_slots=1, max_len=24, block_size=8, prefill_chunk=8)


# ================================================================ archive
def _offers(seed, n=40):
    """(bits, acc, sq, latency, reward, meta) offers from one numpy stream,
    with repeats and ties."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bits = {f"L{j}": int(b) for j, b in enumerate(rng.choice([2, 4, 8], 3))}
        acc = float(rng.choice([0.5, 0.8, 0.9, 0.95, 1.0]))
        sq = float(np.round(rng.uniform(0.2, 1.0), 2))
        lat = float(np.round(rng.uniform(1.0, 3.0), 1))
        out.append((bits, acc, sq, lat, float(rng.uniform()), {"episode": i}))
    return out + out[:5]


def _same_archive(t, j):
    assert len(t) == len(j) and (t.offered, t.accepted) == (j.offered, j.accepted)
    assert [e.__dict__ for e in t.entries()] == [e.__dict__ for e in j.entries()]
    assert json.dumps(t.to_dict()) == json.dumps(j.to_dict())


@pytest.mark.parametrize("objectives,seed", [(("acc", "sq", "latency"), 0),
                                             (("acc", "sq"), 1), (("acc", "latency"), 2)])
def test_archive_matches_reference(objectives, seed, tmp_path):
    t, j = ParetoArchive(objectives), JArchive(objectives)
    for bits, acc, sq, lat, rew, meta in _offers(seed):
        assert t.add(bits, acc=acc, sq=sq, latency=lat, reward=rew, meta=meta) == \
            j.add(bits, acc=acc, sq=sq, latency=lat, reward=rew, meta=meta)
    _same_archive(t, j)
    for mode in ("knee", "accuracy", "efficiency", "latency", "reward"):
        for floor in (0.9, 0.99):
            assert vars(t.select(mode, acc_floor=floor)) == vars(j.select(mode, acc_floor=floor))
    t.save(str(tmp_path / "t.json"))
    j.save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    # each package warm-starts from the other's file, also re-ranked
    _same_archive(ParetoArchive.warm_start(str(tmp_path / "j.json"), objectives),
                  JArchive.warm_start(str(tmp_path / "t.json"), objectives))
    _same_archive(ParetoArchive.warm_start(str(tmp_path / "j.json"), ("acc", "sq")),
                  JArchive.warm_start(str(tmp_path / "t.json"), ("acc", "sq")))
    t.merge(ParetoArchive.load(str(tmp_path / "j.json")))
    j.merge(JArchive.load(str(tmp_path / "t.json")))
    _same_archive(t, j)


def _enum_acc(bits):
    v = sorted(bits.items())
    return round(1.0 - sum((8 - b) ** 2 * (i + 1) for i, (_, b) in enumerate(v)) / 900.0, 3)


@pytest.mark.parametrize("with_latency", [False, True])
def test_as_archive_matches_reference(with_latency):
    tg, jg = tcnn.build_cnn("lenet").quant_groups(), jcnn.build_cnn("lenet").quant_groups()
    kw = dict(bitset=(2, 3, 4, 6, 8))
    tpts, jpts = tpareto.enumerate_space(tg, _enum_acc, **kw), jpareto.enumerate_space(
        jg, _enum_acc, **kw)
    lat = (lambda b: float(sum(b.values()))) if with_latency else None
    t, j = tpareto.as_archive(tpts, latency_fn=lat), jpareto.as_archive(jpts, latency_fn=lat)
    _same_archive(t, j)
    if not with_latency:   # the 2-objective archive IS the paper's frontier
        assert t.objective_set() == {(p["acc"], p["quant"])
                                     for p in tpareto.pareto_frontier(tpts)}


# ============================================================= cost model
def test_decode_roofline_matches_reference_at_v5e_rates():
    rng = np.random.default_rng(3)
    for n in (1, 4, 17):
        tg = [QuantGroup(f"g{i}", ("blocks",), i, (8, 8), int(w), int(w) * 3)
              for i, w in enumerate(rng.integers(1, 10 ** 8, n))]
        jg = [JGroup(g.name, g.path, g.layer, g.shape, g.n_weights, g.n_macs) for g in tg]
        for batch in (1, 8, 4096):
            bits = rng.integers(1, 17, n).tolist()
            got = tcm.weight_stream_decode_time(bits, tg, batch=batch, peak=jcm.V5E_PEAK_FLOPS,
                                                bw=jcm.V5E_HBM_BW)
            assert got == jcm.tpu_decode_time(bits, jg, batch=batch)
            assert tcm.speedup_vs_8bit(tcm.weight_stream_decode_time, bits, tg,
                                       peak=jcm.V5E_PEAK_FLOPS, bw=jcm.V5E_HBM_BW) == \
                jcm.speedup_vs_8bit(jcm.tpu_decode_time, bits, jg)
    assert (tcm.H100_PEAK_FLOPS, tcm.H100_HBM_BW) == (989e12, 3.35e12)
    assert not any(n.startswith("V5E") for n in dir(tcm))


# ================================================================ service
GROUPS = [QuantGroup(f"L{i}", ("blocks",), i, (64, 64), 64 * 64, 64 * 64 * 50)
          for i in range(4)]
JGROUPS = [JGroup(g.name, g.path, g.layer, g.shape, g.n_weights, g.n_macs) for g in GROUPS]
SENS = [2.0, 2.0, 6.0, 2.5]


def sensitivity_evaluate(bits):
    """The reference tests' LeNet-scale oracle: layer 2 needs high bits."""
    acc = 1.0
    for i, g in enumerate(GROUPS):
        acc *= 1.0 / (1.0 + np.exp(-(bits[g.name] - SENS[i]) * 2.2))
    return acc


def make_factory(eval_mode="episode_end", evaluate=sensitivity_evaluate, env=QuantEnv,
                 groups=GROUPS):
    def factory(i):
        return env(groups=groups, evaluate=evaluate,
                   weight_std={g.name: 0.5 for g in groups}, eval_mode=eval_mode)
    return factory


class TestService:
    """``tests/test_autotune.py::TestService``, on the port."""

    def test_deferred_episode_matches_episode_end(self):
        calls = []

        def spy(bits):
            calls.append(1)
            return sensitivity_evaluate(bits)

        env_d = make_factory("deferred", evaluate=spy)(0)
        env_e = make_factory("episode_end")(0)
        env_d.reset(), env_e.reset()
        for a in [0, 3, 6, 2]:
            _, r_d, done, info_d = env_d.step(a)
            _, r_e, _, info_e = env_e.step(a)
            if not done:
                assert r_d == r_e
        assert not calls
        acc = sensitivity_evaluate(info_d["bits"])
        assert env_d.reward_for(acc, info_d["quant"]) == pytest.approx(r_e)
        assert info_d["bits"] == info_e["bits"]

    def test_async_reaches_lockstep_best_reward(self):
        res_lock = ReLeQSearch(make_factory(), num_envs=1, seed=0, device="cpu").run(episodes=25)
        service = AutotuneService(make_factory(), device="cpu", config=ServiceConfig(
            num_workers=1, in_order=True, max_inflight=4, batch_episodes=1, seed=0))
        res_async = service.run(episodes=25)
        service.shutdown()
        assert res_async.best_reward >= res_lock.best_reward - 1e-6
        assert len(res_async.episodes) == 25
        assert res_async.service_stats["updates"] == 25
        assert len(service.archive) >= 1
        assert service.archive.select("reward").bits_dict() == res_async.best_bits

    def test_out_of_order_consumption_and_staleness_bound(self):
        service = AutotuneService(make_factory(), accuracy_thread_safe=True, device="cpu",
                                  config=ServiceConfig(num_workers=4, max_inflight=8,
                                                       batch_episodes=3, max_staleness=1,
                                                       seed=2))
        res = service.run(episodes=18)
        service.shutdown()
        s = res.service_stats
        assert len(res.episodes) == 18 and s["updates"] >= 1
        assert s["stale_dropped"] >= 0 and s["pool"]["completed"] == 18
        assert np.isfinite(res.best_reward)
        # the obs counters agree with the record
        snap = service.obs.snapshot()
        assert snap["autotune.episodes"]["value"] == 18
        assert snap["autotune.ppo_updates"]["value"] == s["updates"]
        assert snap["autotune.stale_dropped"]["value"] == s["stale_dropped"]

    def test_hw_weight_blends_latency_into_reward(self):
        service = AutotuneService(
            make_factory(), latency_eval=AnalyticLatencyEvaluator(GROUPS), device="cpu",
            config=ServiceConfig(num_workers=1, in_order=True, batch_episodes=2,
                                 hw_weight=1.0, seed=0))
        res = service.run(episodes=4)
        service.shutdown()
        for ep in res.episodes:
            assert ep["latency"] is not None and 0 < ep["latency_ratio"] <= 1.0
            assert ep["q_eff"] == pytest.approx(min(ep["latency_ratio"], 1.0))
        assert service.archive.objectives == ("acc", "sq", "latency")
        assert len(service.archive) >= 1

    def test_latency_archive_without_evaluator_rejected_early(self):
        with pytest.raises(ValueError, match="latency"):
            AutotuneService(make_factory(), archive=ParetoArchive(), device="cpu")


def _forced_act(act, actions, port: bool):
    """Wrap ``ppo.act``: keep the agent's carry, value and probabilities,
    take the action from ``actions`` and its logp from the probabilities."""
    stream = iter(actions)

    def forced(carry, state, key):
        carry, _, _, val, probs = act(carry, state, key)
        a = next(stream)
        logp = np.log(np.asarray(probs, np.float32)[:, a])
        if port:
            return carry, torch.tensor([a]), torch.from_numpy(logp), val, probs
        return carry, np.array([a]), logp, val, probs
    return forced


def _np_tree(p):
    return {k: {n: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                for n, v in d.items()} for k, d in p.items()}


def test_service_matches_reference_with_forced_actions():
    """In order, one worker, a PPO update every 2 episodes, the analytic
    latency at the V5E rates on both sides (hw_weight 0.5)."""
    episodes, T = 6, len(GROUPS)
    actions = np.random.default_rng(11).integers(0, 7, episodes * T).tolist()
    cfg = dict(num_workers=1, in_order=True, max_inflight=3, batch_episodes=2, seed=0)
    jsvc = JService(make_factory(env=JEnv, groups=JGROUPS),
                    latency_eval=JAnalytic(JGROUPS), config=JServiceConfig(**cfg))
    tsvc = AutotuneService(make_factory(), device="cpu", config=ServiceConfig(**cfg),
                           latency_eval=AnalyticLatencyEvaluator(
                               GROUPS, peak=jcm.V5E_PEAK_FLOPS, bw=jcm.V5E_HBM_BW))
    tsvc.ppo = PPO(agent_params_from_numpy(_np_tree(jsvc.ppo.params), device="cpu"),
                   tsvc.ppo.cfg)
    jsvc.ppo.act = _forced_act(jsvc.ppo.act, actions, port=False)
    tsvc.ppo.act = _forced_act(tsvc.ppo.act, actions, port=True)

    # the reference's update, epoch by epoch, to see each epoch's gradient
    jppo, jsnaps, tsnaps, noisy = jsvc.ppo, [], [], [None]

    def j_update(traj):
        import jax.numpy as jnp

        adv, ret = jgae(traj["rewards"], traj["values"], jppo.cfg.gamma, jppo.cfg.lam)
        batch = {"states": jnp.asarray(traj["states"], jnp.float32),
                 "actions": jnp.asarray(traj["actions"], jnp.int32),
                 "logp_old": jnp.asarray(traj["logp_old"], jnp.float32),
                 "adv": jnp.asarray(adv), "returns": jnp.asarray(ret)}
        for _ in range(jppo.cfg.epochs):
            g = _np_tree(jppo._grad(jppo.params, batch))
            small = {k: {n: np.abs(a) < 1e-6 * np.abs(a).max() for n, a in d.items()}
                     for k, d in g.items()}
            noisy[0] = small if noisy[0] is None else {
                k: {n: noisy[0][k][n] | m for n, m in d.items()} for k, d in small.items()}
            jppo.params, jppo.opt_state = jppo.opt.update(jppo.params, jax.tree.map(
                jnp.asarray, g), jppo.opt_state)
        jsnaps.append((_np_tree(jppo.params), noisy[0]))
        return {}

    t_update = tsvc.ppo.update

    def t_update_snap(traj):
        out = t_update(traj)
        tsnaps.append(_np_tree(tsvc.ppo.params))
        return out

    jppo.update = j_update
    tsvc.ppo.update = t_update_snap
    jres, tres = jsvc.run(episodes), tsvc.run(episodes)
    jsvc.shutdown(), tsvc.shutdown()

    keys = ("episode", "bits", "reward", "acc", "quant", "q_eff", "latency",
            "latency_ratio", "version", "staleness")
    assert [{k: e[k] for k in keys} for e in tres.episodes] == \
        [{k: e[k] for k in keys} for e in jres.episodes]
    assert (tres.best_bits, tres.best_reward) == (jres.best_bits, jres.best_reward)
    _same_archive(tsvc.archive, jsvc.archive)
    assert len(tsnaps) == len(jsnaps) == episodes // 2
    for (want, mask), got in zip(jsnaps, tsnaps):
        for k in want:
            for n in want[k]:
                diff = np.abs(got[k][n] - want[k][n])
                assert diff[~mask[k][n]].max(initial=0.0) <= 1e-6, (k, n)


# ========================================================== evaluators
@pytest.fixture(scope="module")
def glm():
    """Smoke glm4: the reference model and params, and the port's copies."""
    jm, tm = models()
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, to_port(jp)


@pytest.fixture(scope="module")
def jax_sparams(glm):
    """The reference's serving params at 8 and at 4 bits (packed once)."""
    jm, _, jp, _ = glm
    return {b: jqfs(jm, jp, jpolicy_for(jm, b)) for b in (8, 4)}


def test_engine_latency_evaluator_measures_and_memoizes(glm):
    _, tm, _, tp = glm
    ev = EngineLatencyEvaluator(tm, tp, num_slots=2, prompt_len=4, decode_steps=3,
                                warmup_steps=1)
    bits = {n: ev.frozen.get(n, 4) for n in ev.group_names}
    lat, ref = ev(bits)
    assert lat > 0 and ref > 0
    misses = ev.cache.stats()["misses"]
    assert ev(bits) == (lat, ref) and ev.cache.stats()["misses"] == misses == 2
    assert [r["avg_bits"] for r in ev.records] == [8.0, pytest.approx(
        np.mean([bits[n] for n in ev.weight_group_names]))]
    assert all(r["event_s"] is None and r["kv_bits"] is None for r in ev.records)
    # the draftability twin: a 2-bit draft under the 8-bit target
    dv = DraftabilityEvaluator(tm, tp, k=2, num_slots=2, decode_steps=2, warmup_steps=1)
    d_lat, d_ref = dv({n: dv.frozen.get(n, 2) for n in dv.group_names})
    assert d_lat > 0 and d_ref > 0 and len(dv.records) == 2


@pytest.mark.parametrize("kv", ["mixed 4/8", "uniform 4"])
def test_engine_latency_kv_groups_become_kv_bits(glm, kv, monkeypatch):
    _, tm, _, tp = glm
    pools = []
    real = ServeEngine.from_params

    def spy(*a, **k):
        eng = real(*a, **k)
        pools.append((eng.pool.kv_bits, eng.pool.cache["k"].dtype))
        return eng

    monkeypatch.setattr(ServeEngine, "from_params", staticmethod(spy))
    ev = EngineLatencyEvaluator(tm, tp, kv_quant=True, num_slots=2, prompt_len=4,
                                decode_steps=2, warmup_steps=1)
    L = tm.cfg.num_layers
    assert ev.kv_group_names == tuple(f"kv.L{l:02d}" for l in range(L))
    kv_bits = [4 if (kv == "uniform 4" or l % 2) else 8 for l in range(L)]
    bits = {**{n: ev.frozen.get(n, 4) for n in ev.weight_group_names},
            **dict(zip(ev.kv_group_names, kv_bits))}
    lat, ref = ev(bits)
    assert lat > 0 and ref > 0
    # the 8-bit reference runs an int8 pool; the candidate its own bits
    assert pools[0] == ([8] * L, torch.int8)
    assert pools[1] == (kv_bits, torch.uint8 if kv == "uniform 4" else torch.int8)
    assert ev.records[-1]["kv_bits"] == kv_bits


# =============================================================== deploy
def _jax_run(engine, prompts, gen):
    ids = [engine.submit(p, gen) for p in prompts]
    engine.run_until_drained()
    return [engine.output(i) for i in ids]


def test_hot_swap_holds_queued_requests_and_recaptures(glm, jax_sparams, monkeypatch):
    """The reference's queued-request case on a pipelined port engine whose
    decode step is a GraphedDecodeStep (eager stand-in graph), against the
    JAX engine run op by op through the same swap."""
    monkeypatch.setattr(tserve, "_Graph", _ReplayedEagerly)
    jm, tm, jp, tp = glm
    rng = np.random.default_rng(3)
    first, queued = rng.integers(0, tm.cfg.vocab_size, 6), rng.integers(0, tm.cfg.vocab_size, 6)

    step = tserve.GraphedDecodeStep(tm)
    eng = ServeEngine.from_params(tm, tp, policy_for(tm, 8), device="cpu", decode_fn=step, **KW)
    jeng = JaxEngine(jm, jax_sparams[8], prefill_fn=jm.prefill_chunk,
                     decode_fn=jm.decode_step, **HOST, **KW)
    ids = []
    for e in (eng, jeng):
        a = e.submit(first, 6)
        e.step()                         # admitted into the only row
        b = e.submit(queued, 5)          # no free row -> queued
        assert e.num_running == 1 and e.num_queued == 1
        ids.append((a, b))
    sp4 = compile_policy(tm, tp, policy_for(tm, 4))
    report = hot_swap(eng, sp4)
    jreport = jhot_swap(jeng, jax_sparams[4])
    assert report == jreport
    assert report["drained_steps"] >= 1 and report["prefix_cache_flushed"]
    assert eng.num_running == 0 and eng.num_queued == 1 and eng.sparams is sp4
    assert eng.pool.prefix_cached_blocks == 0
    eng.run_until_drained()
    jeng.run_until_drained()
    got, want = ([e.output(r) for r in rids] for e, rids in zip((eng, jeng), ids))
    assert got == want and len(got[1]) == 5
    assert step.recaptures == 1 and eng.metrics()["recompiles"] == 1
    # the queued request ran on the new weights alone: a fresh engine agrees
    fresh = ServeEngine(tm, sp4, device="cpu", **KW)
    assert _jax_run(fresh, [queued], 5) == [got[1]]


def _archive(groups, Archive, cost):
    arch = Archive(objectives=("acc", "sq"))
    for b, acc in ((4, 0.97), (8, 1.0), (2, 0.5)):
        arch.add({g.name: b for g in groups}, acc=acc,
                 sq=cost.state_of_quantization([b] * len(groups), groups))
    return arch


def test_deploy_parity_gate_and_rollback(glm, jax_sparams, monkeypatch):
    jm, tm, jp, tp = glm
    arch = _archive(tm.quant_groups(), ParetoArchive, tcm)
    eng = ServeEngine.from_params(tm, tp, policy_for(tm, 8), device="cpu", **KW)
    rng = np.random.default_rng(0)
    pre = eng.submit(rng.integers(0, tm.cfg.vocab_size, 6), 4)
    eng.run_until_drained()
    served_before = eng.output(pre)
    prompts = [rng.integers(0, tm.cfg.vocab_size, 6) for _ in range(2)]
    policy, report = deploy(arch, tm, tp, eng, select="efficiency", acc_floor=0.9,
                            parity_prompts=prompts, max_new_tokens=5)
    assert all(policy.get(n) == 4 for n in policy.searchable)
    assert report["parity"]["match"] and eng.output(pre) == served_before
    # the JAX engine through the same swap serves the same streams
    jeng = JaxEngine(jm, jax_sparams[8], prefill_fn=jm.prefill_chunk,
                     decode_fn=jm.decode_step, **HOST, **KW)
    jhot_swap(jeng, jax_sparams[4])
    assert report["parity"]["outputs"]["live"] == _jax_run(jeng, prompts, 5)

    # a failing gate rolls the live engine back to the policy it served
    deploy_mod = sys.modules["repro_torch.autotune.deploy"]
    live = eng.sparams
    monkeypatch.setattr(deploy_mod, "ab_parity_check",
                        lambda *a, **k: {"match": False, "outputs": {}})
    with pytest.raises(AssertionError, match="rolled back"):
        deploy(arch, tm, tp, eng, select="accuracy", parity_prompts=prompts)
    assert eng.sparams is live


def test_spec_draft_policy_streams_equal_reference(glm, jax_sparams):
    jm, tm, jp, tp = glm
    groups = tm.quant_groups()
    arch = ParetoArchive(objectives=("acc", "sq"))
    jarch = JArchive(objectives=("acc", "sq"))
    # the floor drops the all-2-bit entry; the cheapest left is the mixed one
    for acc, rule in ((0.96, lambda n: 4 if n.endswith("wq") else 2), (0.99, lambda n: 4),
                      (0.5, lambda n: 2)):
        bits = {g.name: rule(g.name) for g in groups}
        sq = tcm.state_of_quantization(list(bits.values()), groups)
        arch.add(bits, acc=acc, sq=sq)
        jarch.add(bits, acc=acc, sq=sq)
    pol, jpol = DraftSelector().policy(tm, arch), JDraftSelector().policy(jm, jarch)
    assert pol.group_names == jpol.group_names and pol.bits == jpol.bits
    assert {pol.get(n) for n in pol.searchable} == {2, 4}
    tsp = compile_policy(tm, tp, policy_for(tm, 8))
    jsp = jax_sparams[8]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n) for n in (5, 9)]
    kw = dict(KW, max_len=48)
    eng = ServeEngine(tm, tsp, device="cpu", spec=SpecConfig(k=7, draft_policy=pol), **kw)
    jeng = JaxEngine(jm, jsp, spec=JaxSpec(k=7, draft_policy=jpol), prefill_fn=jm.prefill_chunk,
                     decode_fn=jm.decode_step, verify_fn=jm.verify_chunk, **HOST, **kw)
    got, want = _jax_run(eng, prompts, 10), _jax_run(jeng, prompts, 10)
    assert got == want
    assert eng.metrics()["spec"] == jeng.metrics()["spec"]
    assert eng.metrics()["spec"]["windows"] > 0
    # pre-packed draft params win over a policy, a policy over bits
    pre = SpecConfig(k=3, draft_bits=2, draft_policy=pol, draft_sparams=tsp)
    assert ServeEngine(tm, tsp, device="cpu", spec=pre, **kw)._draft_sparams is tsp
    both = ServeEngine(tm, tsp, device="cpu", spec=SpecConfig(k=3, draft_bits=8,
                                                             draft_policy=pol), **kw)
    assert both._draft_sparams["blocks"][0][0]["attn"]["wq"].bits == pol.get("L00.attn.wq")


def test_spec_config_draft_sources():
    with pytest.raises(ValueError, match="needs a draft"):
        SpecConfig(k=2)
    assert SpecConfig(k=2, draft_sparams={}).draft_bits is None
    with pytest.raises(ValueError):
        SpecConfig(k=2, draft_bits=9, draft_policy=None)


# ============================================================ launchers
@pytest.mark.parametrize("flags", [
    ["--hw", "engine", "--deploy", "--select", "efficiency", "--layers", "1"],
    ["--hw", "analytic", "--select", "knee", "--deploy"],
    ["--task", "cnn:lenet", "--hw", "analytic"],
], ids=["engine-deploy", "analytic-deploy", "cnn"])
def test_autotune_launcher_on_cpu(flags, tmp_path):
    from repro_torch.launch import autotune

    path = str(tmp_path / "archive.json")
    base = ["--device", "cpu", "--episodes", "2", "--pretrain-steps", "2", "--workers", "2",
            "--batch-episodes", "1", "--archive", path, "--gen", "4", *flags]
    out = autotune.main(base)
    res, arch = out["result"], out["archive"]
    assert len(res.episodes) == 2 and len(arch) >= 1
    saved = ParetoArchive.load(path)
    assert [e.key() for e in saved.entries()] == [e.key() for e in arch.entries()]
    if "--deploy" in flags:
        assert out["report"]["parity"]["match"] and out["report"]["drained_steps"] == 0
    if "--layers" in flags:
        assert out["model"].cfg.num_layers == 1
    # a second run warm-starts from the saved archive
    again = autotune.main(base[:3] + ["1"] + base[4:])
    assert again["archive"].offered >= len(saved) + 1


def test_autotune_launcher_refuses_hlo():
    """``--hw hlo`` counts an LM's packed decode step; a CNN task has none
    and is refused (the LM case runs in
    ``tests/test_torch_op_costs.py``)."""
    from repro_torch.launch import autotune

    with pytest.raises(SystemExit, match="--hw hlo needs the LM serving stack"):
        autotune.main(["--device", "cpu", "--episodes", "1", "--pretrain-steps", "1",
                       "--task", "cnn:lenet", "--hw", "hlo"])


# =========================================================== checkpoints
@pytest.fixture(scope="module")
def jax_checkpoint(glm, tmp_path_factory):
    """Two steps of the JAX Trainer (bf16 params, int8 moments) saved to a
    directory, and the params it saved."""
    from repro.data import SyntheticLMData
    from repro.optim.adamw import AdamW as JAdamW
    from repro.quant.qat import bits_assignment
    from repro.train.train_step import make_train_step
    from repro.train.trainer import Trainer

    jm, _, jp, _ = glm
    opt = JAdamW(lr=1e-3, moments="int8")
    data = SyntheticLMData(seed=0, global_batch=2, seq_len=8, vocab=jm.cfg.vocab_size)
    bm = {k: jax.numpy.asarray(v) for k, v in bits_assignment(
        jm.quant_groups(), jpolicy_for(jm, 8)).items()}
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    state = Trainer(jm, opt, data, make_train_step(jm, opt, donate=False), bm, ckpt_dir=d,
                    log_every=0).run({"params": jp, "opt": opt.init(jp)}, 2)
    return d, state["params"]


def test_ckpt_dir_serves_a_jax_checkpoint(glm, jax_checkpoint, monkeypatch):
    from repro_torch.launch import serve as launcher

    _, tm, _, _ = glm
    d, jparams = jax_checkpoint
    manifest = json.loads(open(f"{d}/step_00000002/manifest.json").read())
    assert {"bfloat16", "float8_e4m3fn"} <= {leaf["dtype"] for leaf in manifest["leaves"]}

    def no_unpickling(*a, **k):
        raise AssertionError("the checkpoint reader unpickled")

    monkeypatch.setattr(pickle, "load", no_unpickling)
    monkeypatch.setattr(pickle, "Unpickler", no_unpickling)
    args = launcher.parse_args(["--device", "cpu", "--requests", "3", "--gen", "6",
                                "--ckpt-dir", d])
    _, model, sparams, policy = launcher.build(args)
    carried = compile_policy(tm, to_port(jparams), policy)
    outs = []
    for sp in (sparams, carried):
        eng = ServeEngine(model, sp, device="cpu", num_slots=args.num_slots,
                          max_len=args.prompt_len + args.gen + 1, block_size=args.block_size,
                          prefill_chunk=args.prefill_chunk)
        work = launcher.synthetic_workload(args, tm.cfg.vocab_size)
        outs.append(_jax_run(eng, [p for p, _ in work], 6))
    assert outs[0] == outs[1] and all(len(o) == 6 for o in outs[0])


@pytest.mark.parametrize("arch,dtype", [("glm4-9b", "float32"), ("moonshot-v1-16b-a3b", None)],
                         ids=["dtype", "structure"])
def test_jax_checkpoint_wrong_template_names_the_leaf(jax_checkpoint, arch, dtype):
    from repro_torch.convert import params_from_jax_checkpoint

    _, other = models(arch, dtype=dtype)
    with pytest.raises(ValueError, match=r"leaf \S+ \(checkpoint leaf \d+\)"):
        params_from_jax_checkpoint(jax_checkpoint[0], other, device="cpu")
