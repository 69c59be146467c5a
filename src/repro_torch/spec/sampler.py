"""Distribution-exact rejection sampling for speculative windows (a copy
of ``repro.spec.sampler``: numpy only, on the port's ``serve.request``).

Pure host-side math (numpy, no jax): given the draft's k proposed tokens
and the target's logits at all k + 1 positions (one batched
``verify_chunk`` call), decide how many proposals survive and what to
emit.  The classic speculative-sampling argument applies per position:

    accept d ~ q with probability min(1, p(d) / q(d));
    on rejection emit a draw from the residual norm(max(p - q, 0)).

The emitted token is then *exactly* distributed as p — for ANY proposal
q — so speculation changes throughput, never the served distribution
(chi-square-pinned for the reference in tests/test_spec.py).  Greedy (temperature 0) is
the degenerate case: accept while the draft token equals the target
argmax, emit the target argmax at the first disagreement — which makes
greedy spec output token-identical to non-spec decode, the engine parity
gate.

Randomness is drawn through the request's per-position streams
(``Request.rng_for``): each (output position, draw kind) pair is an
independent deterministic stream, so results are invariant to batch
composition and to how positions are grouped into windows.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serve.request import SamplingParams, warp_probs

# Draw kinds for Request.rng_for — one independent stream per decision a
# speculative step can make at a given output position.
KIND_TOKEN = 0      # baseline token draw (also the bonus token)
KIND_DRAFT = 1      # draft proposal draw
KIND_ACCEPT = 2     # accept/reject uniform
KIND_RESIDUAL = 3   # residual draw after a rejection


def draft_token(logits: np.ndarray, sampling: SamplingParams,
                rng: np.random.Generator) -> tuple[int, np.ndarray | None]:
    """Draw one draft proposal; -> (token, warped q or None for greedy).

    The draft warps with the SAME sampling params as the target — the
    accept ratio p(d)/q(d) is only meaningful when both sides went
    through identical temperature/top-k/top-p shaping.
    """
    q = warp_probs(logits, sampling)
    if q is None:
        return int(np.argmax(np.asarray(logits, np.float64).reshape(-1))), None
    return int(rng.choice(q.size, p=q)), q


def greedy_window(draft_tokens, target_tops) -> tuple[list[int], int]:
    """Resolve one all-greedy window from PRE-COMPUTED target argmaxes;
    -> (emitted tokens, num accepted).

    Equivalent to :func:`spec_window` when every request in the batch is
    greedy (pinned for the reference in tests/test_sampler_device.py) — but it only needs the
    verifier's ``(k + 1,)`` int32 argmax row, not the ``(k + 1, V)``
    logits, which is what lets the engine's device-sampling fast path
    fetch accepted-token vectors instead of the full logits tensor.
    ``target_tops[j]`` must be the argmax of the target's position-``j``
    logits row (computed on device with the same first-index
    tie-breaking as the host oracle)."""
    emitted: list[int] = []
    accepted = 0
    for j, d in enumerate(draft_tokens):
        top = int(target_tops[j])
        if int(d) == top:
            emitted.append(top)
            accepted += 1
            continue
        emitted.append(top)
        return emitted, accepted
    emitted.append(int(target_tops[len(draft_tokens)]))
    return emitted, accepted


def spec_window(draft_tokens, target_logits, sampling: SamplingParams,
                rng_for, *, base_pos: int,
                q_probs=None) -> tuple[list[int], int]:
    """Resolve one speculative window; -> (emitted tokens, num accepted).

    - ``draft_tokens``: the k proposals, in order.
    - ``target_logits``: (k + 1, V) — row j is the target's distribution
      for output position ``base_pos + j`` (the verifier's all-position
      logits; row k is the "bonus" position past the last proposal).
    - ``rng_for(position, kind)``: per-position stream factory
      (:meth:`repro_torch.serve.request.Request.rng_for`).
    - ``base_pos``: output index of the first token this window emits.
    - ``q_probs``: the draft's warped distributions, one per proposal
      (None entries / None list => greedy draft).

    Always emits at least one token (k = 0 degenerates to plain decode
    from row 0).  On full acceptance the bonus token is drawn from row k
    with the SAME stream plain decode would use at that position.
    """
    k = len(draft_tokens)
    emitted: list[int] = []
    accepted = 0
    for j in range(k):
        p = warp_probs(target_logits[j], sampling)
        d = int(draft_tokens[j])
        pos = base_pos + j
        if p is None:  # greedy: accept iff the draft matches the argmax
            top = int(np.argmax(
                np.asarray(target_logits[j], np.float64).reshape(-1)))
            if d == top:
                emitted.append(d)
                accepted += 1
                continue
            emitted.append(top)
            return emitted, accepted
        q = None if q_probs is None else q_probs[j]
        if q is None:
            # greedy draft under a sampled target: a point mass at d
            ratio = p[d]
        else:
            ratio = 1.0 if q[d] <= 0.0 else p[d] / q[d]
        if rng_for(pos, KIND_ACCEPT).random() < ratio:
            emitted.append(d)
            accepted += 1
            continue
        if q is None:  # point-mass proposal: residual is p with d removed
            resid = p.copy()
            resid[d] = 0.0
        else:
            resid = np.maximum(p - q, 0.0)
        s = resid.sum()
        if s <= 0.0:  # q covers p exactly at this position: any p-draw
            emitted.append(int(rng_for(pos, KIND_RESIDUAL)
                               .choice(p.size, p=p)))
        else:
            emitted.append(int(rng_for(pos, KIND_RESIDUAL)
                               .choice(p.size, p=resid / s)))
        return emitted, accepted
    # every proposal survived: bonus token from the k-th target row
    p = warp_probs(target_logits[k], sampling)
    if p is None:
        emitted.append(int(np.argmax(
            np.asarray(target_logits[k], np.float64).reshape(-1))))
    else:
        emitted.append(int(rng_for(base_pos + k, KIND_TOKEN)
                           .choice(p.size, p=p)))
    return emitted, accepted
