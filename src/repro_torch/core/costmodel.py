"""Cost models: the paper's State-of-Quantization metric and its
bit-serial hardware models; a numpy-only copy of ``repro.core.costmodel``.

State of Quantization (paper §2.4, verbatim formula):

    SQ = Σ_l (n_w_l · E_mem/E_mac + n_mac_l) · bits_l
         ───────────────────────────────────────────────
         Σ_l (n_w_l · E_mem/E_mac + n_mac_l) · bits_max

with E_mem/E_mac ≈ 120 (TETRIS [16]).  SQ ∈ (0, 1]; smaller = cheaper.

Hardware models (paper §4.4-4.5):
- **stripes**: bit-serial weight execution — per-layer time ∝ n_mac·bits;
  energy adds the memory term.  Analytic estimates of Fig 9 / Table 4.
- **tvm_cpu**: bit-serial vector ops on CPU — same bits-proportional
  compute law (activations stay 8-bit), Fig 8.

The reference's serving model (``tpu_decode_time`` and its rate
constants) is not copied: ROADMAP.md queue 1, slice D.
"""
from __future__ import annotations

import numpy as np

E_MEM_OVER_E_MAC = 120.0


def _weights(groups):
    return np.asarray([g.n_weights for g in groups], np.float64)


def _macs(groups):
    return np.asarray([g.n_macs for g in groups], np.float64)


def state_of_quantization(bits, groups, max_bits: int = 8,
                          e_ratio: float = E_MEM_OVER_E_MAC) -> float:
    """The paper's SQ metric.  bits: per-group vector (fp groups -> max_bits)."""
    b = np.minimum(np.asarray(bits, np.float64), max_bits)
    w, m = _weights(groups), _macs(groups)
    cost = w * e_ratio + m
    return float(np.sum(cost * b) / np.sum(cost * max_bits))


def stripes_time(bits, groups) -> float:
    """Bit-serial accelerator: cycles ∝ Σ n_mac·bits (weights serialized)."""
    return float(np.sum(_macs(groups) * np.asarray(bits, np.float64)))


def stripes_energy(bits, groups, e_ratio: float = E_MEM_OVER_E_MAC) -> float:
    """MAC energy ∝ bits; weight-memory energy ∝ n_w·bits·E_mem."""
    b = np.asarray(bits, np.float64)
    return float(np.sum(_macs(groups) * b + _weights(groups) * b * e_ratio / 8.0))


def tvm_cpu_time(bits, groups, act_bits: int = 8) -> float:
    """Bit-serial popcount GEMM: ops ∝ weight_bits × act_bits."""
    return float(np.sum(_macs(groups) * np.asarray(bits, np.float64) * act_bits))


def speedup_vs_8bit(time_fn, bits, groups, **kw) -> float:
    eight = np.full(len(groups), 8.0)
    return time_fn(eight, groups, **kw) / max(time_fn(bits, groups, **kw), 1e-30)


def energy_reduction_vs_8bit(bits, groups) -> float:
    eight = np.full(len(groups), 8.0)
    return stripes_energy(eight, groups) / max(stripes_energy(bits, groups), 1e-30)
