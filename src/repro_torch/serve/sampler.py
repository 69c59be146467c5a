"""On-device fused sampling for the serve hotpath (torch port of
``repro.serve.sampler``).

The engine fetches a ``(num_slots,) int32`` token vector per decode step
instead of the ``(num_slots, V)`` logits, and selects on the device:

- **greedy** (``temperature <= 0``) is ``torch.argmax`` over the f32 row,
  which returns the first maximal index, as ``jnp.argmax`` and
  ``Request.select_token`` do: bitwise the host oracle's token.
- **temperature / top-k / top-p** mirror ``request.warp_probs`` without a
  sort: the k-th largest logit and the nucleus cut are found by 32
  integer halvings over the sortable key space of the f32 bits
  (:func:`_bisect_threshold`), tie-complete at the cut, as in the
  reference.  The draw is an inverse CDF of one uniform.
- **the uniform** is the reference's, bit for bit: ``jax.random``'s
  threefry-2x32 (20 rounds) keyed by ``PRNGKey(seed)`` = (0, seed), then
  ``fold_in`` of the request id, the position and ``KIND_TOKEN`` (each
  ``fold_in(key, d)`` = ``threefry2x32(key, (0, d))``), and the f32
  uniform from ``bits = x0 ^ x1`` of ``threefry2x32(key, (0, 0))`` as
  ``float32_from_bits((bits >> 9) | 0x3f800000) - 1``.  torch's
  ``uint32`` lacks most operations on CUDA, so the 32-bit words and the
  sort keys ride in ``int64`` masked with ``& 0xFFFFFFFF``: the CPU and
  the card compute the same bits.  The stream is a pure function of
  (seed, request id, position, kind), so sampling is batch-composition-
  and pipeline-invariant; no ``torch.Generator`` is involved.

Sums (softmax total, nucleus mass, CDF) run in torch's order, not XLA's,
so a sampled token can differ from the reference's where ``u * total``
falls within rounding of a CDF boundary; ``tests/test_torch_sampler.py``
flags and counts such draws.

Inactive rows carry ``temperature = 0`` and reduce to the argmax.

``sample_rows`` and ``greedy_rows`` are module-level callables shared by
every engine, like the reference's module-level jit: on CPU tensors they
run the plain torch below, on CUDA tensors they replay one captured CUDA
graph per shape (``train.serve.GraphedFn``).  ``greedy_rows`` is the
bare argmax the engine takes when every running row is greedy (known on
the host from the row arrays): the same token by construction, without
the two bisections.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.train.serve import GraphedFn

# draw-kind namespace shared with the speculative sampler: the baseline
# token draw is kind 0 there too
KIND_TOKEN = 0

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, as ``jax.random``'s: int64 tensors
    holding 32-bit words -> the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _fold_in(key, data):
    zero = torch.zeros_like(data)
    return threefry2x32(key[0], key[1], zero, data & M32)


def _stream_key(seed, rid, position):
    """Per-(request, position, kind) key words, folded in the reference's
    order (seed, then rid, position, ``KIND_TOKEN``)."""
    seed = seed.to(torch.int64) & M32
    key = (torch.zeros_like(seed), seed)
    key = _fold_in(key, rid.to(torch.int64))
    key = _fold_in(key, position.to(torch.int64))
    return _fold_in(key, torch.full_like(seed, KIND_TOKEN))


def uniform(seed, rid, position) -> torch.Tensor:
    """The f32 uniform in [0, 1) each row draws: ``jax.random.uniform(
    _stream_key(seed, rid, position))`` bit for bit."""
    k0, k1 = _stream_key(seed, rid, position)
    zero = torch.zeros_like(k0)
    x0, x1 = threefry2x32(k0, k1, zero, zero)
    bits = x0 ^ x1
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _sort_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> 32-bit key (in int64) with the float's ordering: negative
    floats flipped, non-negative ones offset by 2^31; -inf lowest."""
    b = x.to(torch.float32).view(torch.int32).to(torch.int64) & M32
    return torch.where((b >> 31) == 1, ~b & M32, b | 0x80000000)


def _bisect_threshold(keys: torch.Tensor, good) -> torch.Tensor:
    """Per row, the largest 32-bit ``t`` with ``good(keys >= t)`` true, by
    32 integer halvings (upper mid).  ``keys`` (B, V); ``good`` maps the
    (B, V) mask to a (B,) bool and must be monotone non-increasing in
    ``t`` and true at ``t = 0``.  Returns (B,) int64."""
    B = keys.shape[0]
    lo = torch.zeros((B,), dtype=torch.int64, device=keys.device)
    hi = torch.full((B,), M32, dtype=torch.int64, device=keys.device)
    for _ in range(32):
        span = hi - lo
        mid = lo + span // 2 + span % 2
        ok = good(keys >= mid[:, None])
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    return lo


def _sample_rows_impl(logits, temps, top_ks, top_ps, seeds, rids, positions):
    """(B, V) logits and (B,) per-row parameters -> (B,) int32 tokens; the
    reference's ``_sample_row`` written out over the batch."""
    v = logits.shape[-1]
    f = logits.to(torch.float32)
    greedy = torch.argmax(f, dim=-1).to(torch.int32)

    # warped distribution; temp <= 0 rows use t = 1 only to stay finite
    t = torch.where(temps > 0.0, temps, torch.ones_like(temps))
    z = f / t[:, None]
    # top-k, tie-complete; top_k == 0 degenerates to k = V (threshold = min)
    k = torch.where(top_ks > 0, top_ks.clamp(1, v), torch.full_like(top_ks, v))
    zkeys = _sort_key(z)
    kth = _bisect_threshold(zkeys, lambda m: m.sum(-1) >= k)
    z = torch.where(zkeys < kth[:, None], float("-inf"), z)
    z = z - z.amax(-1, keepdim=True)
    p = torch.exp(z)
    p = p / p.sum(-1, keepdim=True)
    # top-p nucleus: the highest cut whose tail mass still reaches top_p of
    # the realized f32 total (so top_p = 1 keeps everything)
    pkeys = _sort_key(p)
    target = top_ps * p.sum(-1)
    pcut = _bisect_threshold(
        pkeys, lambda m: torch.where(m, p, 0.0).sum(-1) >= target)
    p = torch.where((top_ps < 1.0)[:, None] & (pkeys < pcut[:, None]), 0.0, p)
    # inverse-CDF draw, u scaled by the total mass; right=True skips
    # zero-probability tokens
    u = uniform(seeds, rids, positions)
    cdf = torch.cumsum(p, -1)
    drawn = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)[:, 0]
    drawn = drawn.clamp(0, v - 1).to(torch.int32)
    return torch.where(temps <= 0.0, greedy, drawn)


def _greedy_rows_impl(logits):
    """(B, V) logits -> (B,) int32 first-index argmax."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


sample_rows = GraphedFn(_sample_rows_impl)
greedy_rows = GraphedFn(_greedy_rows_impl)


def row_arrays(num_slots: int, rows) -> tuple[np.ndarray, ...]:
    """Pack per-row sampling parameters for ``sample_rows``.

    ``rows`` yields ``(slot, request)`` pairs for the running sequences;
    idle slots default to greedy (temperature 0).  The engine uploads the
    result once per batch composition, not per step."""
    temps = np.zeros((num_slots,), np.float32)
    top_ks = np.zeros((num_slots,), np.int32)
    top_ps = np.ones((num_slots,), np.float32)
    seeds = np.zeros((num_slots,), np.uint32)
    rids = np.zeros((num_slots,), np.int32)
    for slot, req in rows:
        s = req.sampling
        temps[slot] = s.temperature
        top_ks[slot] = s.top_k
        top_ps[slot] = s.top_p
        seeds[slot] = np.uint32(s.seed & 0xFFFFFFFF)
        rids[slot] = req.request_id
    return temps, top_ks, top_ps, seeds, rids
