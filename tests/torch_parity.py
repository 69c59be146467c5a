"""Helpers shared by the tests that hold ``repro_torch`` against ``repro``:
carry JAX params across as numpy, and build matching smoke models."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.quant.pack import QDQ, Packed
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model

# the CPU tests run tiny ops; one intra-op thread avoids pool start-up
# costs that dwarf the work
torch.set_num_threads(1)


def jax_to_numpy(tree):
    """JAX params -> nested dicts/lists of numpy arrays, with Packed and
    QDQ leaves written out as the plain dicts ``repro_torch.convert``
    reads."""
    def leaf(x):
        if isinstance(x, Packed):
            return {"planes": np.asarray(x.planes), "scale": np.asarray(x.scale),
                    "bits": x.bits}
        if isinstance(x, QDQ):
            return {"w": np.asarray(x.w), "bits": x.bits}
        return np.asarray(x)

    return jax.tree.map(leaf, tree, is_leaf=lambda x: isinstance(x, (Packed, QDQ)))


def to_port(jax_params):
    """JAX params (any layout) -> the port's params on the CPU."""
    return params_from_numpy(jax_to_numpy(jax_params), device="cpu")


def models(arch: str = "glm4-9b", dtype: str | None = None):
    """(jax model, port model) for the smoke config, optionally at another
    activation dtype."""
    jcfg, tcfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    return jax_build_model(jcfg), build_model(tcfg)


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref|, both as float64 numpy."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


class ReplayedEagerly:
    """Stands in for ``repro_torch.train.serve._Graph`` on the CPU: the step
    runs once at "capture" (the real graph's warm-up, a real step) and
    again at every replay, writing into the first run's output buffers."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs, self.launches, self.seconds = fn, inputs, {}, 0.0
        self.outputs = fn(*inputs)

    def replay(self):
        for buf, new in zip(self.outputs, self.fn(*self.inputs)):
            buf.copy_(new)
        return self.outputs


def watch_spec_state(eng):
    """Wrap a spec engine's draft step and verify: per spec step, record the
    recurrent state the first draft call reads and the state each verify
    call (the window's, then a fix-up's) reads."""
    seen = []
    draft, verify = eng._draft_decode, eng._verify

    def snap(cache):
        return {k: cache[k].clone() for k in eng.pool.recurrent_keys}

    def draft_call(params, cache, toks):
        if not seen or seen[-1]["verify"]:
            seen.append({"draft": snap(cache), "verify": []})
        return draft(params, cache, toks)

    def verify_call(params, cache, *args):
        seen[-1]["verify"].append(snap(cache))
        return verify(params, cache, *args)

    eng._draft_decode, eng._verify = draft_call, verify_call
    return seen


def own_path_replay(model, sparams, work, kw, skip_fixup=False):
    """``chip_smoke.py``'s phase 3r check on the CPU: serve ``work`` with
    a spec engine (k 3, 2-bit draft) and without, log the spec run
    (``chip_smoke.SpecLog``) and replay each stream on its own path
    (``chip_smoke.PathReplay``): the spec run's windows through the chunk
    path, the base run's tokens through decode steps.  ``skip_fixup``
    drops the spec engine's fix-up verifies, a broken engine the replay
    must reject (``chip_smoke.fail`` raises SystemExit).  Returns (spec
    replay, decode replay)."""
    import importlib.util
    import types
    from pathlib import Path

    from repro_torch.launch import serve as launcher
    from repro_torch.serve import SamplingParams, ServeEngine
    from repro_torch.spec import SpecConfig

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    base = ServeEngine(model, sparams, device="cpu", **kw)
    launcher.drive(base, work, 2, SamplingParams())
    eng = ServeEngine(model, sparams, device="cpu", spec=SpecConfig(k=3, draft_bits=2), **kw)
    log = cs.SpecLog(eng)
    verify = eng._verify

    def verify_call(params, cache, *args):
        if skip_fixup and log.open:   # the step's second verify: its fix-up
            return None, cache
        return verify(params, cache, *args)

    eng._verify = verify_call
    launcher.drive(eng, work, 2, SamplingParams())
    r = {"model": model, "sparams": sparams, "work": work,
         "args": types.SimpleNamespace(prefill_chunk=kw["prefill_chunk"])}
    outs = {rid: eng.output(rid) for rid in range(len(work))}
    base_outs = {rid: base.output(rid) for rid in range(len(work))}
    own = cs.PathReplay(torch, r, eng.pool, "spec, chunk path")
    own.spec(log.numpy(), outs)
    dec = cs.PathReplay(torch, r, base.pool, "base, decode path")
    dec.decode({rid: len(out) - 1 for rid, out in base_outs.items()}, base_outs)
    return own, dec
