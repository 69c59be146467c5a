"""The LM ReLeQ search of repro_torch (``core.search.make_lm_env_factory``
and the ``launch/lm_search.py`` twin of ``examples/releq_lm_search.py``)
against the JAX package on the CPU, at the glm4-9b smoke size, and over
the moonshot-v1-16b-a3b smoke MoE (its banks' groups one per stacked
layer, the std over a layer's (E, K, N) slice).

Tolerances: the factory's ``compute`` (2 short-retrain steps of QAT at a
mixed policy from transferred params, then the eval NLL ratio) within
1e-4 of the reference's: the retrain's f32 grads agree to ~1e-6 and
Adam's first steps (lr 1e-4) to ~1e-7, which moves the NLLs by far less;
the per-group weight std (a population std in f32) within 1e-6 relative.
"""
import jax
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets torch's CPU threads)
from repro.core.search import make_lm_env_factory as jmake_factory
from repro.data import SyntheticLMData as JData
from repro_torch.core.search import make_lm_env_factory
from repro_torch.data import SyntheticLMData
from torch_parity import models, to_port


@pytest.fixture(scope="module")
def factories():
    return _factories("glm4-9b")


def _factories(arch):
    jm, tm = models(arch, dtype="float32")
    jp = jm.init(jax.random.PRNGKey(0))
    kw = dict(seed=0, global_batch=2, seq_len=16, vocab=jm.cfg.vocab_size)
    jd, td = JData(**kw), SyntheticLMData(**kw)
    jf = jmake_factory(jm, jp, jd, finetune_steps=2)
    tf = make_lm_env_factory(tm, to_port(jp), td, finetune_steps=2)
    return jm, jf, tf, jd, td


@pytest.fixture(scope="module")
def moe_factories():
    return _factories("moonshot-v1-16b-a3b")


def test_lm_env_factory_compute_matches_reference(factories):
    _compute_matches(*factories)


def test_lm_env_factory_compute_matches_reference_moe(moe_factories):
    jm = moe_factories[0]
    banks = [g for g in jm.quant_groups() if ".moe." in g.name]
    assert banks and all(g.layer is not None and len(g.shape) == 3 for g in banks)
    _compute_matches(*moe_factories)


def _compute_matches(jm, jf, tf, jd, td):
    names = [g.name for g in jm.quant_groups()]
    mixed = {n: (2, 3, 4, 5, 6, 7, 8)[i % 7] for i, n in enumerate(names)}
    mixed.update(jf(0).frozen)
    for bits in (mixed, {n: 8 for n in names}):
        a, b = tf.compute(bits), jf.compute(bits)
        assert np.isfinite(a) and a > 0
        assert abs(a - b) <= 1e-4, (a, b)
    assert td.state_dict() == jd.state_dict()        # the same batches consumed
    jw, tw = jf(0).weight_std, tf(0).weight_std
    assert set(jw) == set(tw)
    assert all(abs(tw[n] - jw[n]) <= 1e-6 * jw[n] for n in jw)


def test_lm_env_evaluate_memoized(factories):
    """Repeated bit-vectors skip the short retrain: the second evaluate of
    the same policy consumes no training data (as tests/test_core_rl.py
    holds the reference)."""
    jm, _, tf, _, td = factories
    env = tf(0)
    bits = {g.name: 8 for g in jm.quant_groups()}
    first = env.evaluate(dict(bits))
    cursor = td.state_dict()["index"]
    assert env.evaluate(dict(bits)) == first          # memo hit
    assert td.state_dict()["index"] == cursor         # ...without retraining
    env.evaluate({**bits, "L00.attn.wq": 4})          # different vector
    assert td.state_dict()["index"] > cursor          # -> retrains again
    stats = tf.eval_cache.stats()
    assert stats["entries"] == 2 and stats["hits"] == 1 and stats["misses"] == 2


def test_lm_search_launcher_lockstep_on_cpu():
    _launcher_lockstep([])


def test_lm_search_launcher_lockstep_on_cpu_moe():
    _launcher_lockstep(["--arch", "moonshot-v1-16b-a3b"])


def _launcher_lockstep(flags):
    from repro_torch.launch import lm_search

    out = lm_search.main(["--lockstep", "--device", "cpu", "--episodes", "2",
                          "--pretrain-steps", "2", *flags])
    res, model = out["result"], out["model"]
    assert len(res.episodes) == 2
    assert set(res.best_bits) == {g.name for g in model.quant_groups()}
    assert all(np.isfinite(e["acc"]) and e["acc"] > 0 for e in res.episodes)
    for name, b in model.frozen_bits().items():
        assert res.best_bits[name] == b
    assert res.cache_stats["misses"] >= 1


def test_lm_search_launcher_refusals():
    """Without ``--lockstep`` the launcher runs the asynchronous service
    (once refused here) with the analytic latency evaluator; without a
    card, the default device is refused."""
    from repro_torch.launch import lm_search

    out = lm_search.main(["--device", "cpu", "--episodes", "2", "--pretrain-steps", "2"])
    res, service = out["result"], out["service"]
    assert len(res.episodes) == 2 and res.service_stats["episodes"] == 2
    assert service.archive.objectives == ("acc", "sq", "latency") and len(service.archive) >= 1
    assert all(e["latency"] is not None and 0 < e["latency_ratio"] for e in res.episodes)
    for name, b in out["model"].frozen_bits().items():
        assert res.best_bits[name] == b
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lm_search.main(["--lockstep", "--episodes", "1"])
