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
