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
- **decode roofline** (:func:`weight_stream_decode_time`): the
  reference's serving model (its ``tpu_decode_time``) with the rates as
  arguments, defaulting to one NVIDIA H100 SXM's data-sheet rates.  Decode
  is weight-traffic-bound, so time ~ max(flops / peak, bytes(bits) / bw)
  per layer, and the speedup over 8 bits comes from bitplane packing.
"""
from __future__ import annotations

import numpy as np

E_MEM_OVER_E_MAC = 120.0

# NVIDIA H100 80GB SXM, 700 W (data sheet, dense rates)
H100_PEAK_FLOPS = 989e12      # bf16 tensor cores
H100_HBM_BW = 3.35e12         # bytes/s
# The card's memory as torch.cuda.get_device_properties(0).total_memory
# reports it on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit.
H100_HBM_BYTES = 85_017_493_504


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


def weight_stream_decode_time(bits, groups, batch: int = 1,
                              peak=H100_PEAK_FLOPS, bw=H100_HBM_BW) -> float:
    """Per-token decode latency estimate: per-layer max(compute, weight
    traffic), the reference's ``tpu_decode_time`` formula at ``peak``
    flop/s and ``bw`` bytes/s.

    Weight bytes stream at bits/8 per weight (bitplane packing); compute is
    2·n_w·batch flops at bf16.
    """
    b = np.asarray(bits, np.float64)
    w = _weights(groups)
    t_comp = 2.0 * w * batch / peak
    t_mem = (w * b / 8.0) / bw
    return float(np.sum(np.maximum(t_comp, t_mem)))


def speedup_vs_8bit(time_fn, bits, groups, **kw) -> float:
    eight = np.full(len(groups), 8.0)
    return time_fn(eight, groups, **kw) / max(time_fn(bits, groups, **kw), 1e-30)


def energy_reduction_vs_8bit(bits, groups) -> float:
    eight = np.full(len(groups), 8.0)
    return stripes_energy(eight, groups) / max(stripes_energy(bits, groups), 1e-30)
