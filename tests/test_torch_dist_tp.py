"""The tensor- and expert-parallel QAT step of ``repro_torch``
(``dist/tp.py``, ``train_step.make_tp_train_step``, ``models.moe.moe_ep``,
the split per-column fake-quant) over gloo ranks, against ``repro``'s GSPMD
step under ``jax.set_mesh`` (the ``tp`` profile) on fake CPU devices.

A JAX subprocess (``XLA_FLAGS`` as ``tests/test_distributed.py`` sets it)
runs the reference on the parameters made here while two spawns of gloo
ranks run the port:

- 4 ranks: glm4-9b and moonshot smoke at meshes (1, 2) and (2, 2) in f32,
  one step's loss, nll, aux and every gradient (each rank's stored shard
  against the reference's whole gradient, sliced) within 1e-5 of the
  reference's (f32 sums in other orders), and llama4-maverick smoke
  (dense and MoE layers interleaved, a shared expert) at (2, 2); glm4 at
  (2, 2) with a vocab of 256, which 2 divides, so the embed, readout and
  cross-entropy run vocab-parallel; the same four cases in bf16, the loss within 2e-2 (the
  reference compiled with ``xla_allow_excess_precision`` off, as
  ``tests/test_torch_train_families.py`` does).  Moonshot at capacity
  factor 0.5 (choices dropped) at (2, 1) and (1, 2): the reference's
  ``_moe_ep`` routes each rank's tokens flattened, with capacity from their
  count, which the port's step equals and its meshless step (capacity per
  sequence) does not.  Then ``launch/train.py --mesh 2,2 --ckpt-dir`` for
  glm4 and moonshot, ``--mesh 4,1`` for moonshot, and the glm4 checkpoint
  restored onto (4, 1) through ``Trainer(mesh=)``, bitwise.
- 8 ranks on a (2, 4) mesh: the twin of the reference's
  ``test_small_mesh_train_step_runs`` (moonshot smoke, 3 steps, loss
  falling and within 2e-2 of the reference's at every step); the twin of
  ``test_moe_ep_matches_meshless`` (B, S, D, F, E, k = 4, 8, 16, 24, 8, 2,
  no drops) within 1e-5; the split per-column QDQ and its STE of every
  quant-group leaf of glm4 (vocab 256) and moonshot on its stored shard,
  bitwise the whole leaf's, sliced; and glm4 smoke at (2, 4) in f32, whose
  2 KV heads do not split 4 ways, so wk and wv stay column-sharded, their
  K/V columns gathered and their gradient reduce-scattered: one step's
  loss, nll, aux and every stored shard's gradient within 1e-5 of the
  reference's, as at 4 ranks.

Inside a (1, 2) or (2, 1) case on 4 ranks, each row of the world's (2, 2)
mesh runs the case.

Tensor-parallel serving, on 2 ranks at (1, 2) in f32, against the one-rank
port: the forward's logits with the prompt arriving sequence-sharded
(glm4 smoke with its KV heads split; with one KV head, whose columns
split and are gathered; with a vocab of 256, split), and 4 greedy decode
steps over a contiguous cache after a full-prompt prefill (the same three
and moonshot, whose MoE layers take ``_moe_ep``'s decode fallback), the
logits and the cache within 1e-5; the step at a (1, 1, 2) ("pod", "data",
"model") mesh equal to (1, 2)'s; and the fallback's output and aux loss at
S = 1 against the reference's ``_moe_ep`` on 2 fake JAX devices.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_workers as workers  # noqa: E402
from torch_parity import jax_to_numpy, rel_err  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.quant.qat import (bits_assignment, bits_to_device, policy_for,  # noqa: E402
                                   quantize_params)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GLM, MOON, MAV = "glm4-9b", "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"
B, S = 4, 16
TP_STEPS, LAUNCH_STEPS = 3, 3


def _case(name, arch, shape, dtype="float32", remat="none", grads=True, **kw):
    return {"name": name, "arch": arch, "shape": shape, "dtype": dtype, "remat": remat,
            "grads": grads, "params": arch + (f"-v{kw['vocab']}" if kw.get("vocab") else ""),
            **kw}


CASES = [
    _case("glm4-1x2", GLM, (1, 2)),
    _case("glm4-2x2-v256", GLM, (2, 2), remat="full", vocab=256),
    _case("moonshot-1x2", MOON, (1, 2)),
    _case("moonshot-2x2", MOON, (2, 2), remat="full"),
    _case("maverick-2x2", MAV, (2, 2)),
    _case("moonshot-drops-2x1", MOON, (2, 1), cf=0.5),
    _case("moonshot-drops-1x2", MOON, (1, 2), cf=0.5),
    _case("glm4-1x2-bf16", GLM, (1, 2), "bfloat16", "full", False),
    _case("glm4-2x2-bf16", GLM, (2, 2), "bfloat16", "full", False),
    _case("moonshot-1x2-bf16", MOON, (1, 2), "bfloat16", "full", False),
    _case("moonshot-2x2-bf16", MOON, (2, 2), "bfloat16", "full", False),
]
# cases of the 8-rank spawn
EIGHT = [_case("glm4-2x4", GLM, (2, 4))]
GRADS = [c for c in CASES + EIGHT if c["grads"]]
BF16 = [c for c in CASES if not c["grads"]]
DROPS = [c for c in CASES if c.get("cf")]

_REF = """
import dataclasses, os, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.dist import sharding as shd
from repro.models import build_model
from repro.optim import AdamW
from repro.quant.qat import bits_assignment, policy_for, quantize_params

data_path, out_path = sys.argv[1:3]
with open(data_path, "rb") as f:
    data = pickle.load(f)
OPTS = {"xla_allow_excess_precision": False}


def config(case):
    kw = {"dtype": case["dtype"]}
    if case.get("vocab"):
        kw["vocab_size"] = case["vocab"]
    if case.get("cf"):
        kw["capacity_factor"] = case["cf"]
    return dataclasses.replace(get_config(case["arch"], smoke=True), **kw)


def params_of(model, tree):
    like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda l, a: jnp.asarray(a).astype(l.dtype), like, tree)


def mesh_of(shape):
    n = shape[0] * shape[1]
    return jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def setup(case):
    model = build_model(config(case))
    groups = model.quant_groups()
    bm = {k: jnp.asarray(v) for k, v in bits_assignment(groups, policy_for(model, 8)).items()}
    batch = {k: jnp.asarray(v) for k, v in data["batch"][case.get("vocab") or 0].items()}
    return model, groups, bm, batch, params_of(model, data["params"][case["params"]])


out = {}
for case in data["cases"]:
    model, groups, bm, batch, params = setup(case)

    def lf(p):
        return model.loss(quantize_params(p, bm, groups), batch, remat=case["remat"])

    mesh = mesh_of(case["shape"])
    with jax.set_mesh(mesh):
        p = jax.device_put(params, shd.to_named(shd.param_specs(params, mesh), mesh))
        fn = jax.jit(jax.value_and_grad(lf, has_aux=True)).lower(p).compile(OPTS)
        (l, m), g = fn(p)
    out[case["name"]] = {"loss": float(l), **{k: float(v) for k, v in m.items()},
                         "grads": [np.asarray(x.astype(jnp.float32))
                                   for x in jax.tree.leaves(g)] if case["grads"] else None}

# the reference's test_small_mesh_train_step_runs, from these params
case = {"arch": "moonshot-v1-16b-a3b", "dtype": "bfloat16", "params": "moonshot-v1-16b-a3b",
        "remat": "full"}
model, groups, bm, batch, params = setup(case)
opt = AdamW(lr=1e-3)


def step(state, batch, bmm):
    def loss_fn(p):
        return model.loss(quantize_params(p, bmm, groups), batch, remat="full")
    (l, m), g = jax.value_and_grad(loss_fn, has_aux=True)(state["params"])
    p2, o2 = opt.update(state["params"], g, state["opt"])
    return {"params": p2, "opt": o2}, l


mesh = mesh_of((2, 4))
with jax.set_mesh(mesh):
    state = {"params": params, "opt": opt.init(params)}
    st_specs = shd.to_named(shd.state_specs(state, mesh), mesh)
    state = jax.device_put(state, st_specs)
    jstep = jax.jit(step, in_shardings=(st_specs, None, None)).lower(state, batch, bm).compile(
        OPTS)
    losses = []
    for _ in range(int(sys.argv[3])):
        state, l = jstep(state, batch, bm)
        losses.append(float(l))
out["small_mesh"] = losses
with open(out_path, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""

torch.set_num_threads(1)


def _f32_params(arch, vocab=None):
    cfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32")
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return jax_to_numpy(jax_build_model(cfg).init(jax.random.PRNGKey(0)))


def _moe_inputs(path):
    """The reference test's MoE layer: B, S, D, F, E, k = 4, 8, 16, 24, 8, 2,
    f32, drawn from a numpy seed."""
    Bm, Sm, D, F, E, k = 4, 8, 16, 24, 8, 2
    rng = np.random.default_rng(1)
    np.savez(path, x=rng.standard_normal((Bm, Sm, D)).astype(np.float32),
             router=(rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32),
             wg=(rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
             wu=(rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
             wd=(rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32), k=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(4-rank results, 8-rank results, the reference's results, the data
    both ran on)."""
    tmp = tmp_path_factory.mktemp("tp")
    data = {"params": {GLM: _f32_params(GLM), f"{GLM}-v256": _f32_params(GLM, 256),
                       MOON: _f32_params(MOON), MAV: _f32_params(MAV)},
            "batch": {v: SyntheticLMData(seed=0, global_batch=B, seq_len=S,
                                         vocab=v or 251).next() for v in (0, 256)},
            "cases": CASES + EIGHT}
    path, ref_path = str(tmp / "data.pkl"), str(tmp / "ref.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    moe_path = str(tmp / "moe.npz")
    _moe_inputs(moe_path)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REF), path, ref_path,
                             str(TP_STEPS)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        four = workers.spawn("tp_four", 4, str(tmp), params=path,
                             cases=[{**c, "batch": None} for c in CASES],
                             launch_steps=LAUNCH_STEPS)
        eight = workers.spawn("tp_eight", 8, str(tmp), params=path, moe_inputs=moe_path,
                              steps=TP_STEPS, cases=[{**c, "batch": None} for c in EIGHT])
    finally:
        stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0 and "OK" in stdout, stderr[-3000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    return four, eight, ref, data


_FALLBACK_REF = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.models import moe

inp = np.load(sys.argv[1])
p = {k: jnp.asarray(inp[k]) for k in ("router", "wg", "wu", "wd")}
mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
with jax.set_mesh(mesh):
    y, aux = jax.jit(lambda x, p: moe.moe_ffn(x, p, k=int(inp["k"]), no_drop=True))(
        jnp.asarray(inp["x"]), p)
np.savez(sys.argv[2], y=np.asarray(y), aux=np.asarray(aux))
print("OK")
"""


def _fallback_inputs(path):
    """A MoE layer's inputs at S = 1 (a decode step): B, D, F, E, k = 4, 16,
    24, 8, 2, f32, drawn from a numpy seed."""
    Bm, D, F, E, k = 4, 16, 24, 8, 2
    rng = np.random.default_rng(5)
    np.savez(path, x=rng.standard_normal((Bm, 1, D)).astype(np.float32),
             router=(rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32),
             wg=(rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
             wu=(rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
             wd=(rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32), k=k)


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """(the 2-rank results of ``torch_dist_workers.tp_serve``, the
    reference's fallback output)."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    inputs, ref_path = str(tmp / "fallback.npz"), str(tmp / "fallback_ref.npz")
    _fallback_inputs(inputs)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu", "REPRO_SHARD_PROFILE": "tp"}
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_FALLBACK_REF), inputs,
                             ref_path], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        two = workers.spawn("tp_serve", 2, str(tmp), moe_inputs=inputs)
    finally:
        stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "OK" in stdout, stderr[-3000:]
    return two, dict(np.load(ref_path))


SERVE = ["glm4", "glm4-kv1", "glm4-v256"]


@pytest.mark.parametrize("name", SERVE)
def test_tp_prefill_logits_match_one_rank(serve_runs, name):
    """The forward under ``TensorParallel(seq_shard=True)`` at (1, 2), each
    rank given its half of the prompt, within 1e-5 of the one-rank forward
    (relative to the largest logit); the split each case exercises."""
    two, _ = serve_runs
    for r in range(2):
        got = two[r][f"prefill/{name}"]
        assert got["err"] <= 1e-5, (r, got)
        assert (got["kv"], got["kv_cols"], got["vocab"]) == {
            "glm4": (True, False, False), "glm4-kv1": (False, True, False),
            "glm4-v256": (True, False, True)}[name], got


@pytest.mark.parametrize("name", SERVE + ["moonshot"])
def test_tp_decode_matches_one_rank(serve_runs, name):
    """4 tensor-parallel decode steps at (1, 2) over a contiguous cache of
    every KV head: each step's logits within 1e-5 of the one-rank step's
    (relative to the largest) and the cache's K/V within 1e-5."""
    two, _ = serve_runs
    for r in range(2):
        got = two[r][f"decode/{name}"]
        assert len(got["logits"]) == workers.SERVE_STEPS and got["heads"], got
        assert max(got["logits"]) <= 1e-5 and max(got["kv"]) <= 1e-5, (r, got)


def test_pod_axis_step_equals_the_data_model_mesh(serve_runs):
    """The tensor-parallel step at (1, 1, 2) over ("pod", "data", "model")
    gives (1, 2)'s loss, metrics, norm and every stored-shard gradient."""
    two, _ = serve_runs
    for r in range(2):
        got = two[r]["pod"]
        assert got["leaves"] > 0 and got["metrics"] == got["grads"] == got["norm"] == 0.0, got


def test_moe_decode_fallback_matches_reference(serve_runs):
    """``moe_ep`` at S = 1, which model axis 2 does not divide, keeps the
    tokens whole on both ranks: its output within 1e-5 and its aux loss
    within 1e-6 of the reference's ``_moe_ep`` on 2 fake devices, on every
    rank."""
    two, ref = serve_runs
    for r in range(2):
        got = two[r]["fallback"]
        assert np.abs(got["y"] - ref["y"]).max() <= 1e-5 * np.abs(ref["y"]).max(), r
        assert abs(got["aux"] - float(ref["aux"])) <= 1e-6, (r, got["aux"], ref["aux"])


def _shard(whole: np.ndarray, slices) -> np.ndarray:
    idx = tuple(slice(None) if s is None else slice(s[1] * (n := whole.shape[d] // s[0]),
                                                    (s[1] + 1) * n)
                for d, s in enumerate(slices))
    return whole[idx]


@pytest.mark.parametrize("case", GRADS, ids=[c["name"] for c in GRADS])
def test_tp_step_loss_and_gradients_match_reference(runs, case):
    """f32: loss, nll and aux within 1e-5, and every rank's gradient of
    every stored shard within 1e-5 of the reference's (relative to the
    leaf's largest); the global norm within 1e-5.  glm4 at (2, 4) takes
    the column-sharded K/V route (``kv_cols``), the others do not."""
    four, eight, ref, _ = runs
    want = ref[case["name"]]
    ranks = eight if case in EIGHT else four
    for r in range(len(ranks)):
        got = ranks[r][case["name"]]
        assert got["kv_cols"] == (case["name"] == "glm4-2x4"), (r, got["kv_cols"])
        for key in ("loss", "nll", "aux"):
            assert rel_err(got[key], want[key]) <= 1e-5, (r, key, got[key], want[key])
        assert len(got["grads"]) == len(want["grads"])
        errs = {name: rel_err(g, _shard(w, sl))
                for (name, sl, g), w in zip(got["grads"], want["grads"])}
        bad = {k: v for k, v in errs.items() if v > 1e-5}
        assert not bad, (r, bad)
        norm = float(np.sqrt(sum(np.sum(np.square(w.astype(np.float64)))
                                 for w in want["grads"])))
        assert rel_err(got["norm"], norm) <= 1e-5, (r, got["norm"], norm)


@pytest.mark.parametrize("case", BF16, ids=[c["name"] for c in BF16])
def test_tp_step_bf16_loss_matches_reference(runs, case):
    four, _, ref, _ = runs
    want = ref[case["name"]]
    for r in range(4):
        got = four[r][case["name"]]
        assert rel_err(got["loss"], want["loss"]) <= 2e-2, (r, got["loss"], want["loss"])
        assert np.isfinite(got["loss"])


@pytest.mark.parametrize("case", DROPS, ids=[c["name"] for c in DROPS])
def test_tp_step_drops_as_the_reference_and_not_as_meshless(runs, case):
    """At capacity factor 0.5 the reference's sharded step routes each
    rank's tokens flattened: the port's step equals it (the gradient test
    holds it), and the port's meshless step, capacity per sequence, is
    further from it than 1e-4."""
    four, _, ref, data = runs
    want = ref[case["name"]]["loss"]
    cfg = workers.tp_config(case)
    model = build_model(cfg)
    params = workers.from_reference(model, data["params"][case["params"]])
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 8)), "cpu")
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in data["batch"][0].items()}
    with torch.no_grad():
        meshless, _ = model.loss(quantize_params(params, bm, model.quant_groups()), batch)
    assert rel_err(float(meshless), want) > 1e-4, (float(meshless), want)
    assert rel_err(four[0][case["name"]]["loss"], want) <= 1e-5


def test_small_mesh_train_step_twin(runs):
    """Moonshot smoke, (2, 4), 8 ranks, 3 steps on one batch: finite, falling,
    every step within 2e-2 of the reference's, equal on every rank."""
    _, eight, ref, _ = runs
    want = ref["small_mesh"]
    for r in range(8):
        got = eight[r]["losses"]
        assert len(got) == TP_STEPS and all(np.isfinite(got)), got
        assert got[-1] < got[0], got
        for a, b in zip(got, want):
            assert rel_err(a, b) <= 2e-2, (r, got, want)
        assert got == eight[0]["losses"]


def test_moe_ep_matches_meshless_twin(runs):
    _, eight, _, _ = runs
    for r in range(8):
        assert eight[r]["moe_ep"]["err"] < 1e-5, eight[r]["moe_ep"]


@pytest.mark.parametrize("arch", [GLM, MOON])
def test_split_per_column_qdq_is_bitwise_the_whole_leafs(runs, arch):
    """Under (2, 4) specs every quant-group leaf's QDQ (and its STE) on its
    stored shard is bitwise that rank's slice of the whole leaf's; the
    leaves that take the split (contraction dim on "model") are wo and wd,
    and glm4's vocab-256 embed."""
    _, eight, _, _ = runs
    for r in range(8):
        got = eight[r]["qdq"][arch]
        assert got["bad"] == [] and got["leaves"] > 0, got
        kinds = {k.split("/")[-1] for k in got["split"]}
        want = {"wo", "wd", "embed"} if arch == GLM else {"wo"}
        assert kinds == want, got["split"]


@pytest.mark.parametrize("key", ["glm4 2,2", "moonshot 2,2", "moonshot 4,1"])
def test_launcher_mesh_trains(runs, key):
    """``launch/train.py --mesh``: the tensor-parallel step at 2,2 for both,
    and for moonshot at 4,1; finite losses, equal on every rank."""
    four, _, _, _ = runs
    for r in range(4):
        got = four[r][key]
        assert got["tp"] and len(got["losses"]) == LAUNCH_STEPS
        assert all(np.isfinite(got["losses"])), got
        assert got["losses"] == four[0][key]["losses"]


def test_launcher_checkpoint_restores_onto_another_mesh(runs):
    """Saved under --mesh 2,2, restored onto (4, 1) through Trainer(mesh=):
    every leaf bitwise the saved one's slice."""
    four, _, _, _ = runs
    for r in range(4):
        got = four[r]["restored"]
        assert got["step"] == got["saved_step"] == LAUNCH_STEPS
        assert got["bad"] == [] and got["leaves"] > 0, got


def test_launcher_refusals():
    """What the tensor-parallel step does not take raises ``not_ported``
    naming item 11b-iv, before any process group starts."""
    from repro_torch.launch import train

    for argv, arch in ((["--mesh", "1,2"], "hymba-1.5b"),
                       (["--mesh", "1,2", "--opt8"], GLM),
                       (["--mesh", "2,1", "--opt8"], MOON)):
        args = train.parse_args(["--device", "cpu", "--arch", arch, *argv])
        with pytest.raises(NotImplementedError, match="11b-iv"):
            train.make_mesh(args, get_config(arch, smoke=True), torch.device("cpu"))
    os.environ["REPRO_SHARD_PROFILE"] = "fsdp"
    try:
        args = train.parse_args(["--device", "cpu", "--arch", GLM, "--mesh", "1,2"])
        with pytest.raises(NotImplementedError, match="11b-iv"):
            train.make_mesh(args, get_config(GLM, smoke=True), torch.device("cpu"))
    finally:
        del os.environ["REPRO_SHARD_PROFILE"]
