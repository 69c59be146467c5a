"""The data-parallel QAT step, ``launch/train.py --mesh`` and elastic
restore of ``repro_torch`` over gloo, against ``repro``.

Two spawns of gloo ranks:
- 2 ranks: ``make_dp_train_step`` for 4 steps from the reference's own
  params (carried through ``convert``) at glm4-9b smoke in f32, planes 2
  and 0, and moonshot smoke at planes 2, while a JAX subprocess runs the
  reference's ``make_dp_train_step`` on 2 fake devices (``XLA_FLAGS`` as
  ``tests/test_distributed.py`` sets it, ``REPRO_SHARD_PROFILE=dp``) on
  the same params and batches; then ``launch/train.py --mesh 2,1
  --ckpt-dir`` for 3 steps, against the single-process run of the same
  global batch here.
- 4 ranks: the 2-rank checkpoint restored onto meshes (4, 1) and (2, 2),
  every local shard bitwise the saved leaf's slice, and the launcher at
  ``--mesh 4,1`` resuming it through ``Trainer(mesh=)``.

Tolerances: the loss at every step within 1e-5 of the reference's, and of
the single-process run's (f32 sums in other orders: XLA against torch,
one batch against two half batches averaged).  Both MoE steps compute
capacity over the rank's local tokens.
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
from torch_parity import jax_to_numpy  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("glm4-9b", "moonshot-v1-16b-a3b")
CASES = (("glm4-9b", 2), ("glm4-9b", 0), ("moonshot-v1-16b-a3b", 2))

_REF = """
import os, pickle, sys
os.environ["REPRO_SHARD_PROFILE"] = "dp"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.data import SyntheticLMData
from repro.models import build_model
from repro.optim import AdamW
from repro.quant.qat import bits_assignment, policy_for
from repro.train.train_step import make_dp_train_step

params_path, out_path, arch = sys.argv[1:4]
planes, B, S, STEPS = (int(a) for a in sys.argv[4:8])
LR = float(sys.argv[8])
with open(params_path, "rb") as f:
    params = jax.tree.map(jnp.asarray, pickle.load(f)[arch])
mesh = jax.make_mesh((2,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
model = build_model(cfg)
opt = AdamW(lr=LR)
bm = {k: jnp.asarray(v) for k, v in bits_assignment(
    model.quant_groups(), policy_for(model, 8)).items()}
state = {"params": params, "opt": opt.init(params),
         "ef": jax.tree.map(lambda p: jnp.zeros((2,) + p.shape, jnp.float32), params)}
data = SyntheticLMData(seed=0, global_batch=B, seq_len=S, vocab=cfg.vocab_size)
losses, norms, states = [], [], []
with jax.set_mesh(mesh):
    step = make_dp_train_step(model, opt, mesh, planes=planes, donate=False)
    for _ in range(STEPS):
        states.append(jax.tree.map(np.asarray, state))
        batch = {k: jnp.asarray(v) for k, v in data.next().items()}
        state, m = step(state, batch, bm)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
ef = max(float(jnp.max(jnp.abs(e))) for e in jax.tree.leaves(state["ef"]))
with open(out_path + ".tmp", "wb") as f:
    pickle.dump({"losses": losses, "norms": norms, "ef": ef, "states": states}, f)
os.rename(out_path + ".tmp", out_path)
print("OK")
"""

torch.set_num_threads(1)


def _f32_jax_params(arch):
    cfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32")
    return jax_to_numpy(jax_build_model(cfg).init(jax.random.PRNGKey(0)))


def ref_path(tmp, arch, planes) -> str:
    return os.path.join(tmp, f"ref_{arch}_{planes}.pkl")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(2-rank results, 4-rank results, the reference's results, the
    single-process launcher's losses)."""
    tmp = tmp_path_factory.mktemp("dp")
    params = str(tmp / "params.pkl")
    with open(params, "wb") as f:
        pickle.dump({arch: _f32_jax_params(arch) for arch in ARCHS}, f)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF), params, ref_path(tmp, arch, planes), arch]
        + [str(v) for v in (planes, workers.DP_BATCH, workers.DP_SEQ, workers.DP_STEPS,
                            workers.DP_LR)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, planes in CASES]
    try:
        single, _ = workers.launcher_run(["--device", "cpu", "--arch", "glm4-9b", "--steps", "3"],
                                         workers.f32_smoke("glm4-9b"), 3)
        two = workers.spawn("dp", 2, str(tmp), params=params,
                            refs={c: ref_path(tmp, *c) for c in CASES})
        four = workers.spawn("elastic", 4, str(tmp))
    finally:
        outs = [p.communicate(timeout=600) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0 and "OK" in stdout, stderr[-3000:]
    ref = {}
    for case in CASES:
        with open(ref_path(tmp, *case), "rb") as f:
            ref[case] = pickle.load(f)
    return two, four, ref, single


@pytest.mark.parametrize("arch,planes", CASES, ids=[f"{a}-planes{p}" for a, p in CASES])
def test_dp_step_matches_reference(runs, arch, planes):
    """Each step from the reference's state before it: loss and grad norm
    within 1e-5 (relative for the norm)."""
    two, _, ref, _ = runs
    want = ref[(arch, planes)]
    for r in range(2):
        losses, norms, ef = two[r][("forced", arch, planes)]
        np.testing.assert_allclose(losses, want["losses"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(norms, want["norms"], rtol=1e-5)
        assert (ef > 0) == (planes > 0) and (want["ef"] > 0) == (planes > 0), (ef, want["ef"])
    assert two[0][("forced", arch, planes)][0] == two[1][("forced", arch, planes)][0]


@pytest.mark.parametrize("arch,planes", CASES, ids=[f"{a}-planes{p}" for a, p in CASES])
def test_dp_step_runs_with_the_reference(runs, arch, planes):
    """Four steps run on: at planes 0 the losses stay within 1e-5 of the
    reference's.  At planes 2 a gradient element far below its leaf's
    largest rounds to a zero code on one side and to the least nonzero on
    the other when the two backward passes differ in the last ulp, and
    Adam's first update turns that into a whole ``lr`` on the element: the
    losses stay within 1e-4.  ``ef`` takes the gradients' dtype (f32 here)
    and is 0 at planes 0."""
    two, _, ref, _ = runs
    want = ref[(arch, planes)]
    for r in range(2):
        losses, norms, ef, ef_dtypes = two[r][(arch, planes)]
        np.testing.assert_allclose(losses, want["losses"], rtol=0,
                                   atol=1e-4 if planes else 1e-5)
        assert ef_dtypes == ["torch.float32"]
        assert (ef > 0) == (planes > 0), ef
    assert two[0][(arch, planes)][0] == two[1][(arch, planes)][0]   # one mean on both


def test_dp_compressed_step_tracks_the_exact_one(runs):
    """The reference's band: 2 fp8 planes + EF within 0.05 of the exact
    mean's loss, which falls."""
    two, _, _, _ = runs
    comp, exact = two[0][("glm4-9b", 2)][0], two[0][("glm4-9b", 0)][0]
    assert all(np.isfinite(comp)) and comp[-1] < comp[0], comp
    assert abs(comp[-1] - exact[-1]) < 0.05, (comp, exact)


def test_launcher_mesh_matches_the_single_process_run(runs):
    two, _, _, single = runs
    for r in range(2):
        np.testing.assert_allclose(two[r]["launcher"], single, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["mesh4x1", "mesh2x2"])
def test_elastic_restore_is_bitwise_on_every_rank(runs, shape):
    _, four, _, _ = runs
    for r in range(4):
        got = four[r][shape]
        assert got["step"] == four[r]["step"] == 3
        assert got["bad"] == [] and got["leaves"] > 0
        # on (2, 2) the rule table shards the projections over "model"
        assert (got["sharded"] > 0) == (shape == (2, 2)), got


def test_elastic_restore_continues_the_loss(runs):
    """Saved at 2 ranks, resumed at 4 through ``Trainer(mesh=)``: the loss
    continues below the last saved one + 0.5 (the reference's twin)."""
    two, four, _, _ = runs
    l1 = two[0]["launcher"][-1]
    for r in range(4):
        resumed = four[r]["resumed"]
        assert len(resumed) == 2 and np.all(np.isfinite(resumed))
        assert resumed[-1] < l1 + 0.5, (l1, resumed)
    assert four[0]["resumed"] == four[3]["resumed"]
