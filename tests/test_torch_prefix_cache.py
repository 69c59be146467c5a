"""Prefix caching in the port (``repro_torch.serve.cache``), held against
the JAX package's.

- The pool: the reference's refcounted-allocator property test
  (``tests/test_prefix_cache.py``), run on the port's pool and the
  reference's in lockstep: after every operation the block tables, the
  counters and the invariants agree (one refcount per owning sequence,
  never negative; no shared block on the free heap;
  ``owned + heap + cached == num_blocks - 1``); the eviction and flush
  lifecycle; copy-on-write copies a block bitwise (fp, int8, nibble-packed
  int4, and the f32 scales) in place, so every leaf keeps its address.
- The engine, on the launcher's ``--tenants 2`` workload with the
  reference's weights: the port's greedy streams and its prefix counters
  (hits, lookups, hit tokens, copies, prefill launches) equal those of the
  reference engine run op by op (``prefix_cache=True``, host sampling, no
  pipeline); the port's defaults (device sampling, the lookahead) give
  the same streams; a decode step "captured" through a stand-in for the
  card's graph is not captured again after a copy-on-write.
- Inside the port: a prefix hit gives the cold run's tokens, with fp,
  int8 and int4 KV blocks, under preemption, after a divergent tail and
  past a decoded block; the admission gate counts new blocks only.
"""
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.quant.qat import policy_for as jax_policy_for
from repro.serve import ServeEngine as JaxEngine
from repro.serve.cache import PagedCachePool as JaxPool
from repro.train.serve import quantize_for_serving as jax_qfs
from repro_torch.launch import serve as launcher
from repro_torch.quant.qat import policy_for
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.serve.cache import PagedCachePool
from repro_torch.train.serve import quantize_for_serving
from test_torch_pipeline import _ReplayedEagerly
from test_torch_serve import _args, _engine_kw
from torch_parity import models, to_port


@pytest.fixture(scope="module")
def port():
    _, tm = models()
    sp = quantize_for_serving(tm, tm.init(seed=3, device="cpu"), policy_for(tm, 4),
                              device="cpu")
    return tm, sp


def _prompt(tm, n, seed):
    return np.random.default_rng(seed).integers(0, tm.cfg.vocab_size, n)


def _serve(tm, sp, prompts, gens, *, stagger=1, **kw):
    """Staggered submission (one request per ``stagger`` steps), so a
    later request sees an earlier one's published blocks.  Returns
    (streams, engine, peak concurrency)."""
    kw = {"num_slots": 3, "max_len": 24, "block_size": 4, "prefill_chunk": 4, **kw}
    eng = ServeEngine(tm, sp, device="cpu", **kw)
    rids, sub, peak = [], 0, 0
    while sub < len(prompts) or eng.scheduler.has_work():
        while sub < len(prompts) and eng.steps >= sub * stagger:
            rids.append(eng.submit(prompts[sub], gens[sub]))
            sub += 1
        eng.step()
        peak = max(peak, eng.num_running)
    return [eng.output(r) for r in rids], eng, peak


def _conserved(pool):
    return len(pool._free_blocks) + len(pool._cached) == pool.num_blocks - 1


# ------------------------------------------------------------------ the pool
class _FakeKV:
    """A one-layer paged KV cache: enough for the pool alone."""

    class cfg:
        sliding_window = None

    def init_cache(self, batch, max_len, dtype=None, device=None):
        return {"k": torch.zeros((1, batch, max_len, 1, 2)),
                "v": torch.zeros((1, batch, max_len, 1, 2)),
                "length": torch.zeros((batch,), dtype=torch.int32)}


class _JaxFakeKV(_FakeKV):
    def init_cache(self, batch, max_len, dtype=None):
        import jax.numpy as jnp

        return {k: jnp.asarray(v.numpy()) for k, v in super().init_cache(batch, max_len).items()}


def _pool_state(pool):
    return (np.asarray(pool.block_tables).tolist(), dict(pool._refcount),
            sorted(pool._free_blocks), sorted(pool._cached), pool.prefix_lookups,
            pool.prefix_hits, pool.prefix_hit_tokens, pool.cow_copies,
            pool.prefix_evictions, pool.blocks_shared, pool.prefix_cached_blocks)


@settings(max_examples=30, deadline=None)
@given(ops=st.lists(st.tuples(st.integers(0, 9), st.integers(0, 5)), min_size=1, max_size=50))
def test_refcounted_allocator_invariants_and_reference_lockstep(ops):
    """The reference's property test on the port's pool, with the
    reference's pool fed the same operations: the same answers and the
    same state after every operation, the invariants hold, and the pool
    drains to its initial state."""
    pools = [PagedCachePool(_FakeKV(), 3, max_len=16, block_size=4, num_blocks=9,
                            device="cpu"),
             JaxPool(_JaxFakeKV(), 3, max_len=16, block_size=4, num_blocks=9)]
    pool = pools[0]
    # three token streams with shared prefixes: real trie collisions
    streams = [list(range(16)), list(range(8)) + list(range(50, 58)), list(range(200, 216))]
    live: dict[int, list[int]] = {}

    def both(fn):
        a, b = (fn(p) for p in pools)
        assert a == b
        return a

    for op, arg in ops:
        if op <= 3:                            # admit (map + ensure)
            toks = streams[arg % 3][:4 + 4 * (arg % 3)]
            if not both(lambda p: bool(p.num_free and p.can_admit(len(toks), 0, toks))):
                continue
            seq = both(lambda p: p.alloc_seq())
            both(lambda p: p.map_shared(seq, toks))
            if both(lambda p: p.ensure(seq, len(toks) + 1)):
                both(lambda p: p.record_tokens(seq, toks))
                live[seq] = list(toks)
            else:                              # exhausted: roll back
                both(lambda p: p.free_seq(seq))
        elif op <= 5 and live:                 # grow + record one token
            seq = sorted(live)[arg % len(live)]
            if len(live[seq]) < 16 and both(lambda p: p.ensure(seq, len(live[seq]) + 1)):
                tok = 300 + (arg * 7 + len(live[seq])) % 5   # forks streams
                both(lambda p: p.record_token(seq, tok))
                live[seq].append(tok)
        elif op <= 7 and live:                 # divergent write -> COW
            seq = sorted(live)[arg % len(live)]
            both(lambda p: p.cow_for_write(seq, max(len(live[seq]) - 1, 0)))
        elif live:                             # retire
            seq = sorted(live)[arg % len(live)]
            both(lambda p: p.free_seq(seq))
            del live[seq]
        assert _pool_state(pools[0]) == _pool_state(pools[1])
        owned = Counter(b for s in pool._seq_blocks.values() for b in s)
        assert dict(owned) == pool._refcount   # counts mirror ownership
        assert all(c >= 1 for c in pool._refcount.values())
        assert 0 not in owned                  # the garbage block is never owned
        heap, cached = set(pool._free_blocks), set(pool._cached)
        assert not (heap & set(owned)) and not (cached & set(owned))
        assert not (heap & cached)
        assert len(set(owned)) + len(heap) + len(cached) == pool.num_blocks - 1
    for seq in list(live):
        pool.free_seq(seq)
    assert not pool._refcount and _conserved(pool)
    pool.flush_prefix_cache()                  # full drain: the initial state
    assert len(pool._free_blocks) == pool.num_blocks - 1
    assert pool.num_free == pool.num_seqs and not pool._node_of


def test_eviction_lru_leaf_first():
    """Allocation under pressure evicts refcount-0 trie blocks, least
    recently used first and leaves first; owned blocks never leave."""
    pool = PagedCachePool(_FakeKV(), 3, max_len=16, block_size=4, num_blocks=7,
                          device="cpu")
    tok_a, tok_b = list(range(8)), list(range(100, 108))
    for toks in (tok_a, tok_b):                # chain A cached, then chain B
        seq = pool.alloc_seq()
        assert pool.ensure(seq, 8)
        pool.record_tokens(seq, toks)
        pool.free_seq(seq)
    assert pool.prefix_cached_blocks == 4 and len(pool._free_blocks) == 2
    sc = pool.alloc_seq()
    assert pool.ensure(sc, 12)                 # 3 blocks: 2 free + 1 evicted
    assert pool.prefix_evictions == 1
    # the victim is chain A's leaf: A's root survives for a shorter match
    assert len(pool._match_nodes(tok_a)) == 1
    assert len(pool._match_nodes(tok_b)) == 2
    pool.free_seq(sc)
    assert _conserved(pool)


def test_flush_prefix_cache_empties_trie():
    pool = PagedCachePool(_FakeKV(), 2, max_len=16, block_size=4, num_blocks=7,
                          device="cpu")
    s0 = pool.alloc_seq()
    assert pool.ensure(s0, 8)
    pool.record_tokens(s0, list(range(8)))
    pool.free_seq(s0)
    assert pool.prefix_cached_blocks == 2
    pool.flush_prefix_cache()
    assert pool.prefix_cached_blocks == 0
    assert not pool._root.children and not pool._node_of
    assert len(pool._free_blocks) == pool.num_blocks - 1
    assert pool.map_shared(pool.alloc_seq(), list(range(8))) == 0  # a miss now


@pytest.mark.parametrize("kv_bits", [None, 8, 4], ids=["fp", "int8", "int4"])
def test_cow_copies_blocks_bitwise_in_place(port, kv_bits):
    """An aligned full hit copies the last shared block at admission:
    every paged leaf (codes, nibble-packed int4 bytes, f32 scales) of the
    copy equals its source bitwise, no other block changes, and every leaf
    keeps its address (a captured step stays bound to it)."""
    tm, _ = port
    pool = PagedCachePool(tm, 2, max_len=8, block_size=4, num_blocks=4, device="cpu",
                          kv_bits=kv_bits)
    s0 = pool.alloc_seq()
    assert pool.ensure(s0, 8)
    toks = list(range(8))
    pool.record_tokens(s0, toks)               # publish both blocks
    gen = torch.Generator().manual_seed(0)
    for key in pool.paged_keys:                # k, v (+ k_scale, v_scale)
        leaf = pool.cache[key]
        pat = torch.randint(1, 100, leaf.shape, generator=gen)
        leaf.copy_(pat.to(leaf.dtype))
    before = {k: (v.data_ptr(), v.clone()) for k, v in pool.cache.items()}
    s1 = pool.alloc_seq()
    old = list(pool._seq_blocks[s0])
    assert pool.map_shared(s1, toks) == 7 and pool.cow_copies == 1
    new = pool._seq_blocks[s1]
    assert new[0] == old[0] and new[1] != old[1]
    for key in pool.paged_keys:
        ptr, was = before[key]
        leaf = pool.cache[key]
        assert leaf.data_ptr() == ptr, key
        assert torch.equal(leaf[:, new[1]].view(torch.uint8), leaf[:, old[1]].view(torch.uint8))
        keep = [b for b in range(pool.num_blocks) if b != new[1]]
        assert torch.equal(leaf[:, keep], was[:, keep]), key
    assert pool._refcount[old[1]] == 1 and pool._refcount[new[1]] == 1


# ------------------------------------------------- the engine vs the reference
@pytest.fixture(scope="module")
def reference():
    jm, tm = models()
    jsp = jax_qfs(jm, jm.init(jax.random.PRNGKey(0)), jax_policy_for(jm, 4))
    return jm, tm, jsp, to_port(jsp)


TENANTS = dict(tenants=2, requests=4, prompt_len=16, block_size=4, prefill_chunk=4)
HOST = dict(sample_device=False, pipeline=False)


@pytest.fixture(scope="module")
def tenants_reference(reference):
    """The reference engine op by op on the ``--tenants 2`` workload."""
    jm, _, jsp, _ = reference
    args = _args(**TENANTS)
    work = launcher.synthetic_workload(args, jm.cfg.vocab_size)
    ref = JaxEngine(jm, jsp, prefix_cache=True, prefill_fn=jm.prefill_chunk,
                    decode_fn=jm.decode_step, **HOST, **_engine_kw(args))
    launcher.drive(ref, work, args.arrival_every, SamplingParams())
    return args, work, ref


PREFIX_KEYS = ("prefix_hits", "prefix_lookups", "prefill_launches")
PREFIX_CACHE_KEYS = ("enabled", "lookups", "hits", "hit_tokens", "cow_copies", "evictions",
                     "cached_blocks")


@pytest.mark.parametrize("kw", [HOST, {}], ids=["host-sampling", "defaults"])
def test_tenants_workload_equals_reference(reference, tenants_reference, kw):
    _, tm, _, tsp = reference
    args, work, ref = tenants_reference
    eng = ServeEngine(tm, tsp, device="cpu", **kw, **_engine_kw(args))
    launcher.drive(eng, work, args.arrival_every, SamplingParams())
    assert [eng.output(r) for r in range(len(work))] == \
        [ref.output(r) for r in range(len(work))]
    m, rm = eng.metrics(), ref.metrics()
    assert m["prefix_hits"] > 0 and m["prefix_cache"]["enabled"]
    if kw == HOST:
        assert {k: m[k] for k in PREFIX_KEYS} == {k: rm[k] for k in PREFIX_KEYS}
        assert {k: m["prefix_cache"][k] for k in PREFIX_CACHE_KEYS} == \
            {k: rm["prefix_cache"][k] for k in PREFIX_CACHE_KEYS}
        assert m["prefix_hit_rate"] == rm["prefix_hit_rate"]
        assert m["blocks_shared"] == rm["blocks_shared"]
    else:
        assert m["pipeline"]["lookahead_steps"] > 0
        assert m["prefix_cache"]["hit_tokens"] == rm["prefix_cache"]["hit_tokens"]


def test_copy_on_write_keeps_the_captured_step(port, monkeypatch):
    """A decode step "captured" once (a stand-in for the card's graph
    that overwrites its outputs at every replay) serves block-aligned
    repeated prompts, whose hits copy their last shared block at
    admission, with admissions between replays: the eager step's
    streams, one capture, no re-capture."""
    from repro_torch.train import serve as tserve

    monkeypatch.setattr(tserve, "_Graph", _ReplayedEagerly)
    tm, sp = port
    P, Q = _prompt(tm, 8, seed=12), _prompt(tm, 12, seed=13)
    work = [(P, 9), (P, 7), (Q, 8), (P, 10), (Q, 6)]
    outs = {}
    for name in ("eager", "graphed"):
        step = tserve.GraphedDecodeStep(tm) if name == "graphed" else None
        eng = ServeEngine(tm, sp, device="cpu", decode_fn=step, num_slots=3, max_len=24,
                          block_size=4, prefill_chunk=4)
        launcher.drive(eng, work, 2, SamplingParams())
        outs[name] = [eng.output(r) for r in range(len(work))]
        m = eng.metrics()
        assert m["prefix_cache"]["cow_copies"] > 0 and m["recompiles"] == 0
    assert (step.captures, step.recaptures) == (1, 0)
    assert outs["graphed"] == outs["eager"]


# ------------------------------------------------------ warm == cold, the port
@pytest.mark.parametrize("kv_bits", [None, 8, 4], ids=["fp", "int8", "int4"])
def test_warm_identical_to_cold(port, kv_bits):
    tm, sp = port
    P = _prompt(tm, 10, seed=1)
    warm, weng, _ = _serve(tm, sp, [P, P, P], [5, 5, 5], kv_bits=kv_bits)
    cold, _, _ = _serve(tm, sp, [P], [5], kv_bits=kv_bits, prefix_cache=False)
    assert warm == [cold[0]] * 3
    assert weng.pool.prefix_cache and weng.pool.prefix_hit_tokens > 0
    assert weng.metrics()["prefix_hit_rate"] > 0


@pytest.mark.parametrize("kv_bits", [None, 4], ids=["fp", "int4"])
def test_warm_identical_to_cold_under_preemption(port, kv_bits):
    """Scarce blocks and shared prompts: preemption fires with shared
    blocks live, the replays reuse the trie, and the streams equal an
    ample run without sharing; the drained pool conserves its blocks."""
    tm, sp = port
    P = _prompt(tm, 8, seed=3)
    want, _, _ = _serve(tm, sp, [P] * 3, [12] * 3, max_len=20, prefix_cache=False,
                        kv_bits=kv_bits)
    got, eng, _ = _serve(tm, sp, [P] * 3, [12] * 3, max_len=20, num_blocks=11,
                         kv_bits=kv_bits)
    assert got == want
    assert eng.scheduler.preemptions > 0
    assert _conserved(eng.pool) and not eng.pool._refcount


def test_divergence_after_shared_prefix(port):
    """B extends A's prompt and C repeats A (an aligned full hit: the
    admission copy): each equals its cold run."""
    tm, sp = port
    A = _prompt(tm, 8, seed=4)
    B = np.concatenate([A, _prompt(tm, 6, seed=5)])
    warm, eng, _ = _serve(tm, sp, [A, B, A], [5, 5, 5])
    for i, p in enumerate([A, B, A]):
        cold, _, _ = _serve(tm, sp, [p], [5], prefix_cache=False)
        assert warm[i] == cold[0], f"stream {i} diverged"
    assert eng.pool.cow_copies >= 1 and eng.pool.prefix_hit_tokens > 0


def test_decoded_blocks_publish_and_hit(port):
    """Blocks completed during decode publish too: B replays A's prompt
    and its first emitted tokens, and hits past A's prompt."""
    tm, sp = port
    A = _prompt(tm, 8, seed=6)
    eng = ServeEngine(tm, sp, device="cpu", num_slots=3, max_len=24, block_size=4,
                      prefill_chunk=4)
    eng.submit(A, max_new_tokens=6)
    eng.run_until_drained()
    B = np.concatenate([A, np.asarray(eng.output(0)[:5])])  # 12 tokens fed by A
    before = eng.pool.prefix_hit_tokens
    eng.submit(B, max_new_tokens=3)
    eng.run_until_drained()
    assert eng.pool.prefix_hit_tokens - before >= 12
    cold, _, _ = _serve(tm, sp, [B], [3], prefix_cache=False)
    assert eng.output(1) == cold[0]


def test_admission_gate_counts_new_blocks_only(port):
    """7 usable blocks: A holds 4, so B cold needs 4 + 1 watermark > 3
    free, but trie-shared only 2 + 1: with sharing A and B run together,
    without it B waits."""
    tm, sp = port
    P = _prompt(tm, 12, seed=8)
    kw = dict(num_slots=2, max_len=16, num_blocks=8)
    warm, weng, peak_shared = _serve(tm, sp, [P, P], [4, 3], **kw)
    cold, _, peak_cold = _serve(tm, sp, [P, P], [4, 3], prefix_cache=False, **kw)
    assert warm == cold
    assert (peak_shared, peak_cold) == (2, 1)
    assert weng.scheduler.preemptions == 0
