"""The slot pool, the full-prompt prefill and ``--mode static`` in the
port against the JAX package.

- ``SlotCachePool``'s bookkeeping against the reference's pool driven in
  lockstep: lowest-id allocation, the length-gated ``can_admit`` (no bound
  for a ring), ``write``'s key and shape checks, ``cache_bytes``; a write
  splices in place (the leaves keep their addresses).
- ``TransformerLM.prefill`` of a full-attention model (glm4-9b smoke):
  logits within the model's bounds and the cache equal to the
  reference's.
- ``ServeEngine(cache="slot")`` on the launcher's smoke workload, for
  glm4-9b and h2o-danube (a ring of 8 behind prompts of 16), against the
  reference's slot engine run op by op: greedy streams equal.
- ``launch.serve --mode static`` (the port's ``static`` on the reference's
  weights, prompts from ``--seed``) against the reference's static loop on
  the same prompts: equal greedy tokens, both archs.
- The launcher runs ``--cache slot`` and ``--mode static`` end to end on
  the CPU; ``--ckpt-dir`` serves a saved checkpoint's params (the static
  loop's tokens bitwise those of the same params); the engine refuses quantized
  KV and spec on the slot pool, as the reference's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant.qat import policy_for as jax_policy_for
from repro.serve import ServeEngine as JaxEngine
from repro.serve.cache import SlotCachePool as JaxSlotPool
from repro.train.serve import quantize_for_serving as jax_qfs
from repro_torch.launch import serve as launcher
from repro_torch.quant.qat import policy_for
from repro_torch.serve import SamplingParams, ServeEngine, SlotCachePool
from repro_torch.spec import SpecConfig
from torch_parity import models, to_port

ARCHS = ("glm4-9b", "h2o-danube-3-4b")
LOGIT_BOUND = 2e-2          # relative logit bound at bf16 (test_torch_model.py)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    jm, tm = models(request.param)
    jsp = jax_qfs(jm, jm.init(jax.random.PRNGKey(0)), jax_policy_for(jm, 4))
    return jm, tm, jsp, to_port(jsp)


def _args(*extra):
    return launcher.parse_args(["--device", "cpu", "--requests", "4", "--gen", "8", *extra])


# --------------------------------------------------------------- the pool
@pytest.mark.parametrize("arch", ARCHS)
def test_slot_pool_bookkeeping_matches_reference(arch):
    jm, tm = models(arch)
    mine = SlotCachePool(tm, 3, 20, device="cpu")
    theirs = JaxSlotPool(jm, 3, 20)
    assert mine.length_bound == theirs.length_bound
    assert mine.length_bound == (None if tm.cfg.sliding_window else 20)
    assert mine.cache_bytes() == theirs.cache_bytes()
    for n in (5, 20, 21, 400):
        assert mine.can_admit(n) == theirs.can_admit(n)
    order = [mine.alloc_seq() for _ in range(3)]
    assert order == [theirs.alloc_seq() for _ in range(3)] == [0, 1, 2]
    assert not mine.can_admit(4) and not theirs.can_admit(4)
    with pytest.raises(RuntimeError):
        mine.alloc()
    mine.free(1), theirs.free(1)
    mine.free(0), theirs.free(0)
    assert mine.alloc() == theirs.alloc() == 0
    with pytest.raises(ValueError):
        mine.free(1)
    assert mine.ensure(0, 10**6) and mine.occupancy() == pytest.approx(2 / 3)


def test_slot_pool_write_splices_in_place_and_checks():
    _, tm = models("h2o-danube-3-4b")
    pool = SlotCachePool(tm, 2, 12, device="cpu")
    slot = pool.alloc()
    addr = {k: v.data_ptr() for k, v in pool.cache.items() if k != "length"}
    one = tm.init_cache(1, 12, device="cpu")
    for key in ("k", "v"):
        one[key].normal_()
    one["length"].fill_(7)
    pool.write(slot, one)
    assert {k: v.data_ptr() for k, v in pool.cache.items() if k != "length"} == addr
    for key in ("k", "v"):
        torch.testing.assert_close(pool.cache[key][:, slot], one[key][:, 0], rtol=0, atol=0)
        assert not pool.cache[key][:, 1 - slot].any()
    assert pool.cache["length"].tolist() == [7, 0]
    with pytest.raises(ValueError, match="keys"):
        pool.write(slot, {"k": one["k"], "v": one["v"]})
    with pytest.raises(ValueError, match="shape"):
        pool.write(slot, {**one, "k": one["k"][:, :, :4]})
    with pytest.raises(ValueError, match="not allocated"):
        pool.write(1 - slot, one)


# ----------------------------------------------------------- full prefill
def test_prefill_matches_reference():
    jm, tm = models("glm4-9b")
    jsp = jax_qfs(jm, jm.init(jax.random.PRNGKey(3)), jax_policy_for(jm, 4))
    tokens = np.random.default_rng(3).integers(0, jm.cfg.vocab_size, (2, 11)).astype(np.int32)
    want_logits, want = jm.prefill(jsp, tokens=jnp.asarray(tokens), max_len=20)
    got_logits, got = tm.prefill(to_port(jsp), tokens=torch.from_numpy(tokens), max_len=20)
    assert got_logits.shape == (2, 1, jm.cfg.vocab_size)
    scale = float(np.abs(np.asarray(want_logits)).max())
    assert float(np.abs(got_logits.numpy() - np.asarray(want_logits)).max()) <= LOGIT_BOUND * scale
    for key in ("k", "v"):
        assert got[key].shape == (jm.cfg.num_layers, 2, 20, jm.cfg.num_kv_heads, jm.cfg.hd)
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(want[key], np.float32), err_msg=key)
    assert got["length"].tolist() == [11, 11]


# ------------------------------------------------------------ slot engine
def test_slot_engine_streams_equal_reference(served):
    jm, tm, jsp, tsp = served
    args = _args("--cache", "slot")
    work = launcher.synthetic_workload(args, jm.cfg.vocab_size)
    kw = dict(num_slots=args.num_slots, max_len=args.prompt_len + args.gen + 1, cache="slot")
    ref = JaxEngine(jm, jsp, sample_device=False, pipeline=False,
                    prefill_fn=lambda sp, t, n: jm.prefill(sp, tokens=t, max_len=n),
                    decode_fn=jm.decode_step, **kw)
    launcher.drive(ref, work, args.arrival_every, SamplingParams())
    eng = ServeEngine(tm, tsp, device="cpu", **kw)
    launcher.drive(eng, work, args.arrival_every, SamplingParams())
    for rid in ref.requests:
        assert eng.output(rid) == ref.output(rid), rid
        assert len(eng.output(rid)) == work[rid][1]
    m, rm = eng.metrics(), ref.metrics()
    assert sorted(m) == sorted(rm) and m["cache"] == "slot"
    assert m["recompiles"] == 0 and m["tokens_total"] == sum(n for _, n in work)
    assert m["pipeline"]["lookahead_steps"] > 0


# ------------------------------------------------------------ static mode
def test_static_mode_equals_reference(served):
    jm, tm, jsp, tsp = served
    args = _args("--mode", "static", "--batch", "3", "--seed", "4")
    res = launcher.static(args, tm.cfg, tm, tsp, policy_for(tm, 4))
    prompts = launcher.static_prompts(args, jm.cfg.vocab_size)
    assert prompts.shape == (3, args.prompt_len)
    logits, cache = jm.prefill(jsp, tokens=jnp.asarray(prompts),
                               max_len=args.prompt_len + args.gen + 1)
    tok = jnp.argmax(logits[:, -1], -1)[:, None]
    want = [tok]
    for _ in range(args.gen):
        logits, cache = jm.decode_step(jsp, cache, tok)
        tok = jnp.argmax(logits[:, -1], -1)[:, None]
        want.append(tok)
    np.testing.assert_array_equal(res["tokens"], np.asarray(jnp.concatenate(want, 1)))
    assert res["ms_per_step"] > 0 and res["prefill_s"] > 0


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("extra", [("--cache", "slot"), ("--mode", "static")],
                         ids=["slot", "static"])
def test_launcher_runs_slot_and_static(extra, capsys):
    out = launcher.main(["--device", "cpu", "--arch", "h2o-danube-3-4b", "--requests", "3",
                         "--gen", "6", "--prompt-len", "12", *extra])
    text = capsys.readouterr().out
    assert "first sequence:" in text
    if extra[0] == "--cache":
        assert "served 3 requests on 4 slot rows" in text and out.metrics()["cache"] == "slot"
        assert all(len(out.output(r)) > 0 for r in range(3))
    else:
        assert out["tokens"].shape == (4, 7) and "ms/token-step" in text


def test_launcher_still_refuses_ckpt_dir(tmp_path):
    """``--ckpt-dir`` (refused until item 10's serving part was ported)
    parses, refuses a directory with no checkpoint, and serves the static
    loop from one the port's checkpoint writer made of seed-0 params: the
    tokens of serving those params without it."""
    from repro_torch import ckpt as ckpt_lib

    args = launcher.parse_args(["--device", "cpu", "--ckpt-dir", "/nonexistent"])
    with pytest.raises(FileNotFoundError):
        launcher.build(args)
    _, tm = models("glm4-9b")
    ckpt_lib.save(str(tmp_path), 7, {"params": tm.init(seed=0, device="cpu"), "opt": {}})
    flags = ["--device", "cpu", "--mode", "static", "--batch", "2", "--gen", "4",
             "--prompt-len", "8"]
    restored = launcher.main(flags + ["--ckpt-dir", str(tmp_path)])
    assert np.array_equal(restored["tokens"], launcher.main(flags)["tokens"])


def test_slot_engine_refuses_quantized_kv_and_spec():
    _, tm = models("glm4-9b")
    from repro_torch.train.serve import quantize_for_serving

    sp = quantize_for_serving(tm, tm.init(seed=0, device="cpu"), policy_for(tm, 4),
                              device="cpu")
    with pytest.raises(ValueError, match="slot pool stores fp KV"):
        ServeEngine(tm, sp, device="cpu", cache="slot", kv_bits=8)
    with pytest.raises(ValueError, match="requires cache='paged'"):
        ServeEngine(tm, sp, device="cpu", cache="slot", spec=SpecConfig(k=2, draft_bits=2))
    with pytest.raises(ValueError, match="want 'paged' or 'slot'"):
        ServeEngine(tm, sp, device="cpu", cache="ring")
