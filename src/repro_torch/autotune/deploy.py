"""Deploy an archived ReLeQ policy into a live serving engine (torch port
of ``repro.autotune.deploy``).

The search's output (a Pareto-archive entry) becomes a served model in
one call: select a winner, bit-pack the weights at its per-layer policy
(``quant.pack`` via ``train.serve.quantize_for_serving``), and hot-swap
the packed params into a *running* :class:`~repro_torch.serve.ServeEngine`.

Hot-swap contract: the engine's running rows are drained first (their KV
caches were produced by the old weights — greedy continuations under new
weights would silently fork from the served stream) while queued
admissions are held back; queued and future requests then prefill and
decode entirely under the new policy.  The engine passes ``sparams`` to
every prefill and decode call, so the swap is one attribute store.  On
the card the decode step is a captured graph bound to the params'
addresses (``train.serve.GraphedDecodeStep``): its next call sees new
addresses, captures again and counts in ``serve.recompiles``, so the
graph never replays the old weights.

``ab_parity_check`` is the acceptance gate: the swapped engine must
serve token-identical greedy output to a fresh engine built directly
with the new policy, on the same device and KV layout.
"""
from __future__ import annotations

from repro_torch.autotune.archive import ArchiveEntry, ParetoArchive
from repro_torch.quant.policy import QuantPolicy
from repro_torch.serve.request import SamplingParams


def policy_from_entry(model, entry: ArchiveEntry) -> QuantPolicy:
    """Archive entry -> QuantPolicy aligned with the model's groups."""
    names = tuple(g.name for g in model.quant_groups())
    bits = entry.bits_dict()
    missing = [n for n in names if n not in bits]
    if missing:
        raise KeyError(f"archive entry lacks bits for groups: {missing}")
    return QuantPolicy.from_array(names, [bits[n] for n in names],
                                  frozen=model.frozen_bits())


def compile_policy(model, params, policy: QuantPolicy):
    """Bit-pack training params at ``policy`` (the serving layout), on
    the params' device."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.serve import quantize_for_serving

    return quantize_for_serving(model, params, policy,
                                device=tree_leaves(params)[0].device)


def hot_swap(engine, sparams, *, drain: bool = True,
             max_steps: int = 100_000) -> dict:
    """Swap packed weights into a running engine; -> swap report.

    ``drain=True`` finishes every *mid-decode* sequence under the old
    weights first (their KV caches were prefilled by those weights).
    Queued requests are held back during the drain — a queued request
    has no KV yet, so it prefills *and* decodes entirely under the new
    policy, exactly like post-swap submissions.  The swap itself is
    atomic w.r.t. the engine loop: ``step()`` reads ``engine.sparams``
    once per call.  The paged pool's prefix trie is flushed either way:
    its cached KV blocks were computed under the old weights, and a
    post-swap request hitting them would decode against stale state —
    the weight policy is a key dimension of the prefix cache, realized
    as invalidation-on-swap.
    """
    drained_steps = 0
    if drain:
        # hold admissions back so the drain can't start old-weight prefills
        held = []
        while engine.queue:
            held.append(engine.queue.pop())
        try:
            while engine.num_running:
                if drained_steps >= max_steps:
                    raise RuntimeError(
                        f"hot_swap: engine not drained after {max_steps} "
                        f"steps")
                engine.step()
                drained_steps += 1
        finally:
            for req in reversed(held):  # restore FIFO order at the head
                engine.queue.push_front(req)
    engine.sparams = sparams
    flush = getattr(engine.pool, "flush_prefix_cache", None)
    if flush is not None:
        flush()
    return {"drained_steps": drained_steps,
            "swapped_at_step": engine.steps,
            "prefix_cache_flushed": flush is not None}


def _engine_geometry(engine) -> dict:
    kw = dict(num_slots=engine.pool.num_slots, max_len=engine.pool.max_len,
              cache=engine.cache_kind, device=engine.device)
    if engine.cache_kind == "paged":
        kw.update(block_size=engine.pool.block_size,
                  num_blocks=engine.pool.num_blocks,
                  prefill_chunk=engine.prefill_chunk,
                  prefix_cache=engine.pool.prefix_cache,
                  kv_bits=engine.pool.kv_bits, kv_oracle=engine.pool.kv_oracle)
    return kw


def ab_parity_check(engine, model, sparams, prompts, max_new_tokens: int,
                    *, max_steps: int = 100_000) -> dict:
    """A/B gate: the (swapped) engine vs a fresh engine at ``sparams``.

    Greedy-decodes every prompt on both engines and compares token
    streams.  -> report with ``match`` plus the per-prompt outputs.
    Raises nothing — the caller decides whether a mismatch is fatal.
    """
    from repro_torch.serve.engine import ServeEngine

    fresh = ServeEngine(model, sparams, **_engine_geometry(engine))
    greedy = SamplingParams()  # temperature 0 = deterministic argmax
    outputs = {"live": [], "fresh": []}
    for label, eng in (("live", engine), ("fresh", fresh)):
        ids = [eng.submit(p, max_new_tokens, sampling=greedy)
               for p in prompts]
        eng.run_until_drained(max_steps=max_steps)
        outputs[label] = [eng.output(i) for i in ids]
    match = outputs["live"] == outputs["fresh"]
    return {"match": match, "prompts": len(prompts),
            "outputs": outputs}


def deploy(archive: ParetoArchive, model, params, engine, *,
           select: str = "knee", acc_floor: float = 0.95,
           parity_prompts=None, max_new_tokens: int = 8,
           drain: bool = True) -> tuple[QuantPolicy, dict]:
    """Archive winner -> packed weights -> hot-swap (+ optional parity).

    One-command path from "search finished" to "policy is serving":
    select an entry, compile it, swap it into ``engine``, and (when
    ``parity_prompts`` given) verify token parity against a fresh engine.
    -> (deployed policy, report).
    """
    entry = archive.select(select, acc_floor=acc_floor)
    if entry is None:
        raise ValueError("archive is empty — nothing to deploy")
    policy = policy_from_entry(model, entry)
    sparams = compile_policy(model, params, policy)
    report = {"entry": {"acc": entry.acc, "sq": entry.sq,
                        "latency": entry.latency, "reward": entry.reward},
              "select": select,
              "avg_bits": policy.average_bits()}
    old_sparams = engine.sparams
    report.update(hot_swap(engine, sparams, drain=drain))
    if parity_prompts is not None:
        report["parity"] = ab_parity_check(
            engine, model, sparams, parity_prompts, max_new_tokens)
        if not report["parity"]["match"]:
            # a policy that fails its own gate must not stay live
            engine.sparams = old_sparams
            raise AssertionError(f"A/B parity failed (rolled back to the "
                                 f"previous policy): {report['parity']}")
    return policy, report
