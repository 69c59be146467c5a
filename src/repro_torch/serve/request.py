"""Request objects for the continuous-batching engine.

A ``Request`` is one generation job: a prompt, a token budget, and
sampling parameters.  ``max_new_tokens`` counts every emitted token
*including* the one produced from the prefill logits — so a request with
``max_new_tokens = G + 1`` reproduces the legacy static loop's
``--gen G`` output exactly (prefill argmax + G decode steps).

Token selection lives here too (``select_token``): greedy when
``temperature == 0`` (the parity-critical default), otherwise
temperature/top-k sampling from a per-request, per-POSITION deterministic
stream: the generator key folds in (seed, request_id, position, kind), so
the token drawn at output position ``i`` does not depend on batch
composition, scheduling order, or — crucially for the speculative parity
gate — on how many positions a spec window emitted at once.  ``kind``
separates the independent draws speculative decoding makes at one
position (draft proposal, accept/reject uniform, residual draw) from the
baseline token draw.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"        # submitted, waiting for a free slot
    RUNNING = "running"      # prefilled into a slot, decoding
    FINISHED = "finished"    # budget exhausted or EOS emitted


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # 0 -> greedy argmax
    top_k: int = 0             # 0 -> full distribution
    top_p: float = 1.0         # nucleus: smallest prefix with mass >= top_p
    seed: int = 0              # per-request sampling stream


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                  # (S,) int32 token ids
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    eos_id: int | None = None
    state: RequestState = RequestState.QUEUED
    output_tokens: list[int] = field(default_factory=list)
    # wall-clock metrics (perf_counter seconds)
    arrival_time: float = field(default_factory=time.perf_counter)
    # when the request last entered the queue: arrival, or the most
    # recent preempt-requeue — queue-wait observability measures from
    # here, so a preempted request's second wait is its own sample
    queued_time: float = field(default_factory=time.perf_counter)
    first_token_time: float | None = None
    finish_time: float | None = None
    # engine-step metrics (deterministic; tests key on these)
    arrival_step: int | None = None
    first_token_step: int | None = None
    preemptions: int = 0       # times evicted-and-requeued (paged engine)
    # replay tokens served from the prefix trie instead of prefill,
    # summed over (re-)admissions (paged engine, prefix_cache=True)
    prefix_cached_tokens: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    # ------------------------------------------------------------------
    @property
    def done(self) -> bool:
        if len(self.output_tokens) >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and self.output_tokens
                and self.output_tokens[-1] == self.eos_id)

    def total_len(self) -> int:
        """Tokens the slot must hold: prompt + full decode budget."""
        return int(self.prompt.size) + self.max_new_tokens

    def cache_tokens_needed(self) -> int:
        """Cache tokens admission must cover now: the (replayed) prefix
        plus the first decode write.  Grows with emitted tokens so a
        preempted request re-admits with room for its whole replay."""
        return int(self.prompt.size) + max(len(self.output_tokens), 1)

    def replay_tokens(self) -> np.ndarray:
        """Tokens to prefill on (re-)admission: the prompt, plus — after a
        preemption — every emitted token except the last, which becomes
        the next decode input (exactly the pre-preemption state)."""
        if not self.output_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.output_tokens[:-1], np.int32)])

    def ttft(self) -> float | None:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def rng_for(self, position: int, kind: int = 0) -> np.random.Generator:
        """Deterministic stream for one (output position, draw kind).

        Seeded from ``SeedSequence((seed, request_id, position, kind))`` —
        a fresh generator per draw, so the value consumed at a position is
        a pure function of the request identity, independent of batch
        composition or whether the position was reached by plain decode or
        inside a speculative window."""
        return np.random.default_rng(np.random.SeedSequence(
            (self.sampling.seed, self.request_id, position, kind)))

    def select_token(self, logits: np.ndarray) -> int:
        """Pick the next token from a (V,) float32 logits row."""
        return select_token(logits, self.sampling,
                            self.rng_for(len(self.output_tokens)))


def _nucleus_mask(p: np.ndarray, top_p: float) -> np.ndarray:
    """Boolean keep-mask for the smallest stable-sorted prefix of ``p``
    whose mass reaches ``top_p`` — WITHOUT sorting the whole vocab.

    ``np.argpartition`` pulls the top-``m`` candidates in O(V); every
    element >= the m-th value joins the candidate set (ties included, so
    the set is closed under the stable order), and a stable sort of just
    the candidates reproduces the global stable prefix exactly — same
    comparison keys, same original-index tie-breaking, same sequential
    ``cumsum`` partial sums, hence a bitwise-identical mask (regression-
    gated against the full-sort reference in tests/test_sampler_device).
    ``m`` doubles until the candidate mass covers ``top_p``; flat
    distributions degrade to one full sort, peaked ones (the serving
    common case) stop at m = 64."""
    v = p.size
    m = 64
    while m < v:
        top_idx = np.argpartition(-p, m - 1)[:m]
        thresh = p[top_idx].min()
        cand = np.nonzero(p >= thresh)[0]  # tie-complete candidate set
        cand = cand[np.argsort(-p[cand], kind="stable")]
        csum = np.cumsum(p[cand])
        if csum[-1] >= top_p:
            cut = int(np.searchsorted(csum, top_p) + 1)
            mask = np.zeros(v, bool)
            mask[cand[:cut]] = True
            return mask
        m *= 2
    order = np.argsort(-p, kind="stable")
    csum = np.cumsum(p[order])
    cut = int(np.searchsorted(csum, top_p) + 1)
    mask = np.zeros(v, bool)
    mask[order[:cut]] = True
    return mask


def warp_probs(logits: np.ndarray,
               sampling: SamplingParams) -> np.ndarray | None:
    """Logits -> the warped sampling distribution (V,) float64, or ``None``
    for greedy (temperature 0).  Temperature, then top-k, then nucleus —
    the single definition shared by baseline decode and the speculative
    rejection sampler (which must warp draft and target *identically* for
    the accept ratio p/q to be meaningful).  Both truncations use partial
    selection (``np.partition`` / ``np.argpartition``), not a full vocab
    sort — this runs per row per step on the host oracle path."""
    logits = np.asarray(logits, np.float64).reshape(-1)
    if sampling.temperature <= 0.0:
        return None
    z = logits / sampling.temperature
    if sampling.top_k:
        kth = np.partition(z, -sampling.top_k)[-sampling.top_k]
        z = np.where(z < kth, -np.inf, z)
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    if sampling.top_p < 1.0:
        # nucleus: keep the smallest probability-sorted prefix whose mass
        # reaches top_p (the top token always survives), renormalize
        p = np.where(_nucleus_mask(p, sampling.top_p), p, 0.0)
        p /= p.sum()
    return p


def select_token(logits: np.ndarray, sampling: SamplingParams,
                 rng: np.random.Generator) -> int:
    p = warp_probs(logits, sampling)
    if p is None:
        return int(np.argmax(np.asarray(logits, np.float64).reshape(-1)))
    return int(rng.choice(p.size, p=p))
