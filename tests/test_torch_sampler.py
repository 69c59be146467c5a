"""The port's device sampler (``repro_torch.serve.sampler``) against the
reference's (``repro.serve.sampler``), on the CPU.

- The threefry stream: key words and the f32 uniform bit for bit against
  ``jax.random.uniform(_stream_key(...))`` under ``jit(vmap)``, over a
  seeded sweep with seeds >= 2^31, request id 2^31 - 1 and positions
  0..4096.
- ``_sort_key`` bitwise (±0, ±inf, subnormals, NaN-free), and the top-k
  and top-p thresholds of ``_bisect_threshold`` bitwise on the same keys.
- Greedy bitwise against ``Request.select_token`` on rows with
  manufactured ties.
- Sampled tokens against the reference's ``sample_rows`` over a grid of
  (temperature, top_k, top_p), 3072 draws: equal, except a draw whose
  ``u * total`` lies within 4·V ulps of a CDF boundary (torch and XLA
  sum in other orders).  Such draws are flagged, counted and printed,
  and may not exceed 1 %.
- Chi-square against the host-warped distribution; position keying;
  invariance to batch composition; ``row_arrays`` equal to the
  reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import sampler as jsampler
from repro.serve.request import Request as JaxRequest
from repro.serve.request import SamplingParams as JaxSamplingParams
from repro.serve.request import warp_probs
from repro_torch.serve import sampler as tsampler
from repro_torch.serve.request import Request, SamplingParams
from test_torch_gpu import boundary_flagged

torch.set_num_threads(1)

GRID = [(temp, top_k, top_p) for temp in (0.5, 0.9, 1.0, 1.7)
        for top_k in (0, 1, 5, 50) for top_p in (1.0, 0.9, 0.5)]


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)


def _stream_inputs(seed):
    """4101 (seed, rid, position) triples: random seeds and rids, the
    edge cases first, then every position 0..4096."""
    n = 4 + 4097
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    rids = rng.integers(0, 2 ** 31, n).astype(np.int32)
    seeds[:4] = [0, 2 ** 31, 2 ** 32 - 1, 2 ** 31 + 7]
    rids[:4] = [2 ** 31 - 1, 0, 2 ** 31 - 1, 1]
    pos = np.concatenate([[0, 4096, 4096, 1], np.arange(4097)]).astype(np.int32)
    return seeds, rids, pos


def _jax_keys(seeds, rids, pos):
    f = jax.jit(jax.vmap(lambda s, r, p: jax.random.key_data(
        jsampler._stream_key(s, r, p))))
    return np.asarray(f(*map(jnp.asarray, (seeds, rids, pos))))


def test_stream_key_words_bitwise():
    seeds, rids, pos = _stream_inputs(0)
    want = _jax_keys(seeds, rids, pos)
    k0, k1 = tsampler._stream_key(_t(seeds), _t(rids), _t(pos))
    assert np.array_equal(k0.numpy(), want[:, 0].astype(np.int64))
    assert np.array_equal(k1.numpy(), want[:, 1].astype(np.int64))


def test_uniform_bitwise():
    seeds, rids, pos = _stream_inputs(1)
    f = jax.jit(jax.vmap(lambda s, r, p: jax.random.uniform(
        jsampler._stream_key(s, r, p), dtype=jnp.float32)))
    want = np.asarray(f(*map(jnp.asarray, (seeds, rids, pos))))
    got = tsampler.uniform(_t(seeds), _t(rids), _t(pos)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got >= 0).all() and (got < 1).all()


def test_sort_key_bitwise():
    tiny = np.finfo(np.float32).tiny
    specials = np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, tiny, -tiny,
                         tiny / 2, -tiny / 2, 1e-45, -1e-45,
                         np.finfo(np.float32).max, np.finfo(np.float32).min],
                        np.float32)
    rng = np.random.default_rng(2)
    x = np.concatenate([specials, (rng.normal(size=4000) * 10.0 ** rng.integers(
        -40, 38, 4000)).astype(np.float32)])
    want = np.asarray(jsampler._sort_key(jnp.asarray(x))).astype(np.int64)
    got = tsampler._sort_key(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    order = np.argsort(got, kind="stable")      # the key orders like the float
    assert (np.diff(x[order].astype(np.float64)) >= 0).all()


@pytest.mark.parametrize("kind", ["top_k", "top_p"])
def test_bisect_threshold_bitwise(kind):
    rng = np.random.default_rng(3)
    B, V = 16, 301
    vals = (rng.normal(size=(B, V)) * 2).astype(np.float32)
    vals[0, :5] = vals[0].max()                 # a tie at the top
    if kind == "top_k":
        x = vals
        k = rng.integers(1, V + 1, B).astype(np.int32)

        def jgood(m, kk):
            return m.sum() >= kk

        def tgood(m):
            return m.sum(-1) >= torch.from_numpy(k)
        extra = k
    else:
        p = np.exp(vals - vals.max(-1, keepdims=True))
        x = (p / p.sum(-1, keepdims=True)).astype(np.float32)
        top_p = rng.uniform(0.05, 0.99, B).astype(np.float32)
        target = top_p * x.sum(-1, dtype=np.float32)
        xt = torch.from_numpy(x)

        def jgood_p(m, row, tgt):
            return jnp.where(m, row, 0.0).sum() >= tgt

        def tgood(m):
            return torch.where(m, xt, 0.0).sum(-1) >= torch.from_numpy(target)
    keys = jsampler._sort_key(jnp.asarray(x))
    if kind == "top_k":
        want = jax.vmap(lambda kr, kk: jsampler._bisect_threshold(
            kr, lambda m: jgood(m, kk)))(keys, jnp.asarray(extra))
    else:
        want = jax.vmap(lambda kr, row, tgt: jsampler._bisect_threshold(
            kr, lambda m: jgood_p(m, row, tgt)))(keys, jnp.asarray(x), jnp.asarray(target))
    got = tsampler._bisect_threshold(tsampler._sort_key(torch.from_numpy(x)), tgood)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_greedy_bitwise_equals_host_oracle_with_ties():
    rng = np.random.default_rng(0)
    B, V = 20, 97
    rows = rng.normal(size=(B, V)).astype(np.float32)
    for i in range(0, B, 3):                    # manufacture ties at the max
        rows[i, rng.integers(0, V, size=3)] = rows[i].max()
    reqs = [JaxRequest(i, [1], 8, JaxSamplingParams()) for i in range(B)]
    want = [req.select_token(rows[i]) for i, req in enumerate(reqs)]
    arrs = tsampler.row_arrays(B, [(i, Request(i, [1], 8, SamplingParams()))
                                   for i in range(B)])
    got = tsampler.sample_rows(torch.from_numpy(rows), *map(_t, arrs),
                               torch.zeros(B, dtype=torch.int32))
    assert got.dtype == torch.int32 and got.tolist() == want
    assert tsampler.greedy_rows(torch.from_numpy(rows)).tolist() == want


def test_sampled_tokens_match_reference_draw_for_draw():
    rng = np.random.default_rng(4)
    B, V = 64, 257
    draws = flagged = 0
    for temp, top_k, top_p in GRID:
        logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
        sp = SamplingParams(temperature=temp, top_k=top_k, top_p=top_p)
        reqs = [(i, Request(int(rng.integers(0, 2 ** 31)), [1], 8,
                            SamplingParams(temp, top_k, top_p,
                                           int(rng.integers(0, 2 ** 32)))))
                for i in range(B)]
        arrs = tsampler.row_arrays(B, reqs)
        pos = rng.integers(0, 4096, B).astype(np.int32)
        want = np.asarray(jsampler.sample_rows(*map(jnp.asarray, (logits, *arrs, pos))))
        got = tsampler.sample_rows(*map(_t, (logits, *arrs, pos))).numpy()
        u = tsampler.uniform(_t(arrs[3]), _t(arrs[4]), _t(pos)).numpy()
        for i in np.nonzero(got != want)[0]:
            assert boundary_flagged(logits[i], sp, u[i]), (
                f"(temp {temp}, top_k {top_k}, top_p {top_p}) row {i}: port drew "
                f"{got[i]}, reference {want[i]}, away from any CDF boundary")
            flagged += 1
        draws += B
    print(f"sampled draws: {draws}, differing at a flagged CDF boundary: {flagged}")
    assert draws >= 2000
    assert flagged <= 0.01 * draws


def test_sampling_chi_square_exact():
    """temperature 1, top-p 0.8: 4000 draws over positions match the
    host-warped distribution by chi-square (as the reference's gate)."""
    sp = SamplingParams(temperature=1.0, top_k=0, top_p=0.8, seed=11)
    rng = np.random.default_rng(7)
    row = (rng.normal(size=(12,)) * 1.5).astype(np.float32)
    p = warp_probs(row, sp)
    N = 4000
    req = Request(3, [1], 8, sp)
    arrs = tsampler.row_arrays(N, [(i, req) for i in range(N)])
    draws = tsampler.sample_rows(
        torch.from_numpy(np.broadcast_to(row, (N, row.size)).copy()),
        *map(_t, arrs), torch.arange(N, dtype=torch.int32)).numpy()
    counts = np.bincount(draws, minlength=row.size)
    live = p > 1e-12
    assert counts[~live].sum() == 0, "drew a nucleus-masked token"
    exp = p[live] * N
    chi2 = float(((counts[live] - exp) ** 2 / exp).sum())
    assert chi2 < 31.3, (chi2, counts, p)     # p = 0.001 critical value, df <= 11


def _draw(row, sp, request_id, position, slot=0, companions=()):
    """The token drawn for one request at ``slot`` among ``companions``
    ((request, logits, position) in the other slots)."""
    n = 1 + len(companions)
    logits = np.zeros((n, row.size), np.float32)
    positions = np.zeros(n, np.int32)
    others = [s for s in range(n) if s != slot]
    pairs = [(slot, Request(request_id, [1], 8, sp))]
    logits[slot], positions[slot] = row, position
    for s, (req, lg, ps) in zip(others, companions):
        pairs.append((s, req))
        logits[s], positions[s] = lg, ps
    arrs = tsampler.row_arrays(n, pairs)
    return int(tsampler.sample_rows(*map(_t, (logits, *arrs, positions)))[slot])


def test_sampling_deterministic_and_position_keyed():
    sp = SamplingParams(temperature=0.9, top_k=6, seed=5)
    row = np.random.default_rng(1).normal(size=(33,)).astype(np.float32)
    assert _draw(row, sp, 2, 4) == _draw(row, sp, 2, 4)
    alts = {_draw(row, sp, r, pos) for r in range(4) for pos in range(16)}
    assert len(alts) > 1


@pytest.mark.parametrize("seed", range(8))
def test_sampling_invariant_to_batch_composition(seed):
    rng = np.random.default_rng(seed)
    V = 29
    sp = SamplingParams(temperature=0.7 + seed * 0.1, top_k=seed % 7, top_p=0.9,
                        seed=seed * 131)
    row = rng.normal(size=(V,)).astype(np.float32)
    position = int(rng.integers(0, 41))
    alone = _draw(row, sp, 1000 + seed, position)
    nrows = 1 + seed % 5
    comps = [(Request(2000 + i, [1], 8, SamplingParams(temperature=1.0, seed=i)),
              rng.normal(size=(V,)).astype(np.float32), int(rng.integers(0, 50)))
             for i in range(nrows)]
    assert _draw(row, sp, 1000 + seed, position, slot=seed % (nrows + 1),
                 companions=comps) == alone


def test_row_arrays_equal_reference():
    pairs_t, pairs_j = [], []
    for slot, (t, k, p, s) in enumerate([(0.0, 0, 1.0, 0), (0.9, 5, 0.9, 2 ** 32 + 3),
                                         (1.3, 0, 0.5, 2 ** 31)]):
        pairs_t.append((slot * 2, Request(slot + 7, [1], 8, SamplingParams(t, k, p, s))))
        pairs_j.append((slot * 2, JaxRequest(slot + 7, [1], 8,
                                             JaxSamplingParams(t, k, p, s))))
    got = tsampler.row_arrays(6, pairs_t)
    want = jsampler.row_arrays(6, pairs_j)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
