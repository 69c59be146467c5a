"""The paper's baselines in the port against the JAX package: the Fig 6
design-space enumeration and Pareto frontier (``core.pareto``, a numpy
copy) and the Table 4 ADMM bitwidth selector (``core.admm_baseline``,
whose squared errors go through the port's fake-quant).

- ``enumerate_space``, ``pareto_frontier`` and ``distance_to_frontier``
  give the reference's points, frontier and distance exactly on one
  deterministic numpy ``evaluate``, over LeNet's and ResNet-20's groups,
  with frozen layers and a ``limit``.
- ``layer_quant_errors`` within 1e-5 of the reference's (f32 sums taken in
  another order), and ``admm_select`` gives the reference's bits on LeNet
  weights carried across, at budgets of 3, 4 and 5 average bits, with and
  without frozen layers; the budget holds.
- The LeNet enumeration properties of ``tests/test_cnn_releq.py`` hold on
  the port's ``CNNTask`` after 250 pretraining steps from the reference
  task's initial weights.
- ``as_archive`` lifts an enumerated space into the autotune archive.
"""
import jax
import numpy as np
import pytest

from repro.cnn import CNNTask as JCNNTask
from repro.cnn import models as jmodels
from repro.core import admm_baseline as jadmm
from repro.core import pareto as jpareto
from repro_torch.cnn import models as tmodels
from repro_torch.cnn.train import CNNTask
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.core import admm_baseline as tadmm
from repro_torch.core import pareto as tpareto


def _evaluate(bits: dict) -> float:
    """A deterministic accuracy stand-in: smooth in the bits, with ties."""
    v = sorted(bits.items())
    return round(1.0 - sum((8 - b) ** 2 * (i + 1) for i, (_, b) in enumerate(v)) / 900.0, 3)


@pytest.mark.parametrize("net,bitset,frozen,limit", [
    ("lenet", (2, 3, 4, 6, 8), None, None),
    ("lenet", (2, 4, 8), {"conv1": 8}, None),
    ("resnet20", (2, 8), {"conv1": 8, "fc": 8}, 300),
])
def test_pareto_matches_reference(net, bitset, frozen, limit):
    tg, jg = tmodels.build_cnn(net).quant_groups(), jmodels.build_cnn(net).quant_groups()
    kw = dict(bitset=bitset, frozen=frozen, limit=limit)
    want = jpareto.enumerate_space(jg, _evaluate, **kw)
    got = tpareto.enumerate_space(tg, _evaluate, **kw)
    assert got == want
    if net == "lenet" and frozen is None:
        assert len(got) == 5 ** 4            # the Fig 6 space, 625 points
    jf, tf = jpareto.pareto_frontier(want), tpareto.pareto_frontier(got)
    assert tf == jf and 1 <= len(tf) <= len(got)
    for p in got[::37]:
        assert tpareto.distance_to_frontier(p, tf) == jpareto.distance_to_frontier(p, jf)


def test_as_archive_refused():
    """Once a refusal (``as_archive`` waited for ``autotune.archive``); now
    the enumerated LeNet space lifts into the archive, whose 2-objective
    frontier is ``pareto_frontier``'s, as the reference's is.  The
    comparison with the reference's archive is in
    ``tests/test_torch_autotune.py``."""
    tg = tmodels.build_cnn("lenet").quant_groups()
    pts = tpareto.enumerate_space(tg, _evaluate, bitset=(2, 4, 8))
    arch = tpareto.as_archive(pts)
    assert arch.objectives == ("acc", "sq") and arch.offered == 3 ** 4
    assert arch.objective_set() == {(p["acc"], p["quant"]) for p in tpareto.pareto_frontier(pts)}
    assert tpareto.as_archive([], latency_fn=len).objectives == ("acc", "sq", "latency")


@pytest.fixture(scope="module")
def lenet_weights():
    """LeNet weights from the reference task, after 30 training steps, as
    the reference (HWIO) and the port (OIHW) hold them."""
    jt = JCNNTask("lenet", seed=0, batch=32)
    params, _ = jt.train(30)
    jw = {n: params[n]["w"] for n in jt.names}
    tp = cnn_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jt.groups, tmodels.build_cnn("lenet").quant_groups(), jw, \
        {n: tp[n]["w"] for n in jt.names}


def test_layer_quant_errors_match_reference(lenet_weights):
    _, _, jw, tw = lenet_weights
    want, got = jadmm.layer_quant_errors(jw), tadmm.layer_quant_errors(tw)
    assert got.keys() == want.keys()
    for n in want:
        assert got[n].keys() == want[n].keys()
        for b, e in want[n].items():
            assert abs(got[n][b] - e) <= 1e-5 * abs(e), (n, b)


@pytest.mark.parametrize("budget", [3.0, 4.0, 5.0])
@pytest.mark.parametrize("frozen", [None, {"conv1": 8, "fc2": 8}], ids=["all", "frozen"])
def test_admm_select_matches_reference(lenet_weights, budget, frozen):
    jg, tg, jw, tw = lenet_weights
    want = jadmm.admm_select(jg, jw, budget_avg_bits=budget, frozen=frozen)
    got = tadmm.admm_select(tg, tw, budget_avg_bits=budget, frozen=frozen)
    assert got == want
    searchable = [g for g in tg if g.name not in (frozen or {})]
    used = sum(g.n_weights * got[g.name] for g in searchable)
    assert used <= budget * sum(g.n_weights for g in searchable) + 1e-6


def test_lenet_enumeration_on_the_port():
    """tests/test_cnn_releq.py's enumeration properties on the port's task,
    started from the reference task's initial weights (its fixture's)."""
    task = CNNTask("lenet", seed=0, device="cpu")
    jt = JCNNTask("lenet", seed=0)
    task.params = cnn_params_from_numpy(jax.tree.map(np.asarray, jt.params), device="cpu")
    task.mom = task._zeros_like(task.params)
    task.pretrain(250)
    assert task.fp_acc > 0.8
    assert set(task.weights_by_name()) == set(task.names)
    pts = tpareto.enumerate_space(task.groups,
                                  lambda b: task.evaluate_bits(b, retrain_steps=0),
                                  bitset=(2, 4, 8))
    assert len(pts) == 3 ** 4
    front = tpareto.pareto_frontier(pts)
    assert 1 <= len(front) <= len(pts)
    accs = [p["acc"] for p in front]
    quants = [p["quant"] for p in front]
    assert accs == sorted(accs) and quants == sorted(quants)
    best = max(pts, key=lambda p: p["acc"] - p["quant"])
    assert tpareto.distance_to_frontier(best, front) < 0.2
    bits = tadmm.admm_select(task.groups, task.weights_by_name(), budget_avg_bits=4.0)
    w = {g.name: g.n_weights for g in task.groups}
    assert sum(w[n] * b for n, b in bits.items()) / sum(w.values()) <= 4.0 + 1e-6
    assert set(bits) == set(task.names)
