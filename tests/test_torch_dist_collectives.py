"""``repro_torch.dist.collectives`` over gloo against ``repro.dist.collectives``
under ``shard_map`` on as many fake CPU devices.

One spawn of 4 gloo ranks runs both constructions (the all-gather form
and the two-phase all-to-all / all-gather form) over a group of ranks
{0, 1} and over all 4, on f32 and bf16 leaves: 1,000 elements, 37 (not a
multiple of the rank count: the two-phase form pads), 1, and zeros.  A
JAX subprocess (``XLA_FLAGS`` as ``tests/test_collectives.py`` sets it)
runs the reference on the same inputs meanwhile.

What is held, and how closely:
- the stage-1 codes that crossed the wire (uint8) are bitwise the
  reference's ``_fp8_planes`` codes of every peer's input, compiled;
- outputs and ``fb`` agree with the reference's within 1e-6 of the
  largest input magnitude (f32 sums of up to ``n·planes`` terms added in
  another order can differ in the last ulp, and a stage-2 code built on
  such a sum may round the other way; bf16 outputs within one bf16 ulp);
- the reference's own gates (``tests/test_collectives.py``): within 5 %
  of an exact all-reduce with ``|fb| < 0.1``; and with error feedback the
  time average of eight 1-plane reductions errs below half the first
  reduction's error and below 0.02.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_workers as workers  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
LEAVES = {"big": (1000,), "odd": (37,), "one": (1,), "zeros": (5,), "big_bf16": (8, 125)}

torch.set_num_threads(1)

_REF = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.dist.collectives import compressed_allreduce, _fp8_planes

data = dict(np.load(sys.argv[1]))
out = {}
planes_jit = jax.jit(_fp8_planes, static_argnums=1)
for n in (2, 4):
    mesh = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,))
    for key, x in data.items():
        if not key.startswith(f"n{n}_") or key.endswith("_ef"):
            continue
        leaf = key[len(f"n{n}_"):]
        x = jnp.asarray(x)
        if leaf.endswith("bf16"):
            x = x.astype(jnp.bfloat16)
        for form, size in (("ag", None), ("rs", n)):
            def local(xs, size=size):
                o, fb = compressed_allreduce(xs[0], "data", planes=2, axis_size=size)
                return o[None], fb[None]
            spec = P("data", *([None] * (x.ndim - 1)))
            f = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=spec, out_specs=(spec, spec)))
            o, fb = f(x)
            out[(n, leaf, form)] = (np.asarray(o.astype(jnp.float32)),
                                    np.asarray(fb.astype(jnp.float32)), o.dtype.name)
        # stage-1 codes of each peer's input, compiled as the step compiles them
        xf = x.astype(jnp.float32)
        out[(n, leaf, "codes_ag")] = [np.asarray(planes_jit(xf[r], 2)[0]) for r in range(n)]
        flat = xf.reshape(n, -1)
        c = -(-flat.shape[1] // n)
        padded = jnp.pad(flat, ((0, 0), (0, n * c - flat.shape[1]))).reshape(n, n, c)
        out[(n, leaf, "codes_rs")] = [np.asarray(planes_jit(padded[r], 2)[0]) for r in range(n)]
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's per-rank results, the reference's results, the inputs)."""
    tmp = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)
    data = {}
    for n in (2, WORLD):
        for leaf, shape in LEAVES.items():
            x = rng.normal(size=(n,) + shape).astype(np.float32)
            data[f"n{n}_{leaf}"] = np.zeros_like(x) if leaf == "zeros" else x
        data[f"n{n}_ef"] = rng.normal(size=(n, 512)).astype(np.float32)
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **data)
    env = {**os.environ, "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}",
           "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    ref_path = str(tmp / "ref.pkl")
    ref_proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REF), inputs, ref_path],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
    try:
        port = workers.spawn("collectives", WORLD, str(tmp), inputs=inputs)
    finally:
        stdout, stderr = ref_proc.communicate(timeout=300)
    assert ref_proc.returncode == 0 and "OK" in stdout, stderr[-3000:]
    import pickle

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    return port, ref, data


CASES = [(n, leaf, form) for n in (2, WORLD) for leaf in LEAVES for form in ("ag", "rs")]


@pytest.mark.parametrize("n,leaf,form", CASES, ids=[f"{n}ranks-{leaf}-{form}"
                                                     for n, leaf, form in CASES])
def test_compressed_allreduce_matches_reference(runs, n, leaf, form):
    port, ref, data = runs
    x = data[f"n{n}_{leaf}"]
    tol = 1e-6 * max(float(np.abs(x).max()), 1e-30)
    want_o, want_fb, want_dtype = ref[(n, leaf, form)]
    ref_codes = ref[(n, leaf, f"codes_{form}")]
    for r in range(n):
        got_o, got_fb, got_dtype, wire = port[r][(n, leaf, form)]
        assert got_dtype.removeprefix("torch.") == want_dtype
        if leaf.endswith("bf16"):   # one bf16 ulp of the output's magnitude
            o_tol = max(tol, 2.0 ** -7 * float(np.abs(want_o[r]).max()))
        else:
            o_tol = tol
        np.testing.assert_allclose(got_o, want_o[r], rtol=0, atol=o_tol)
        np.testing.assert_allclose(got_fb, want_fb[r], rtol=0, atol=o_tol)
        # the stage-1 codes on the wire are the reference's, bit for bit
        kind, payload = wire[0]
        if form == "ag":
            assert kind == "all_gather"
            for peer in range(n):
                np.testing.assert_array_equal(payload[peer], ref_codes[peer].reshape(-1))
        else:
            assert kind == "all_to_all"   # (n, planes, c): from peer j, chunk r
            for peer in range(n):
                np.testing.assert_array_equal(payload[peer], ref_codes[peer][:, r])


@pytest.mark.parametrize("n,form", [(n, f) for n in (2, WORLD) for f in ("ag", "rs")])
def test_within_five_percent_of_exact_allreduce(runs, n, form):
    port, _, data = runs
    want = data[f"n{n}_big"].mean(axis=0)
    for r in range(n):
        exact = port[r][(n, "big", "exact")]
        np.testing.assert_allclose(exact, want, rtol=0, atol=1e-6)
        got, fb, _, _ = port[r][(n, "big", form)]
        rel = np.abs(got - exact).max() / np.abs(exact).max()
        assert rel < 0.05, rel
        assert np.abs(fb).max() < 0.1


@pytest.mark.parametrize("n,form", [(n, f) for n in (2, WORLD) for f in ("ag", "rs")])
def test_error_feedback_time_average_converges(runs, n, form):
    port, _, data = runs
    want = data[f"n{n}_ef"].mean(axis=0)
    for r in range(n):
        outs = port[r][(n, "ef", form)]
        first = np.abs(outs[0] - want).max() / np.abs(want).max()
        avg = np.abs(np.mean(outs, axis=0) - want).max() / np.abs(want).max()
        assert avg < first / 2, (first, avg)
        assert avg < 0.02, avg
