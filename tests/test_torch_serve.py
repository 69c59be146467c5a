"""The port's ServeEngine against the JAX reference engine.

- On the launcher's default synthetic workload (``repro_torch.launch.
  serve.synthetic_workload``: staggered arrivals, heterogeneous lengths),
  trimmed to 4 requests and gen 8, the port's greedy token streams equal
  the reference's (``prefix_cache=False, sample_device=False,
  pipeline=False``), with the reference's weights carried over.  Against
  the reference engine running its model calls op by op the streams must
  be equal: both packages then round every bf16 op alike.  Against the
  jit'd reference engine (XLA fuses ops and rounds bf16 elsewhere, which
  breaks this random smoke model's exact logit ties differently) a
  stream may diverge only where the reference's own top-2 logit margin
  at the first divergence is below LOGIT_BOUND times the logit scale
  (the bf16 bound of test_torch_model.py); the test prints that margin.
- Inside the port, a pool too small for the workload preempts and
  replays, and gives the same tokens as an unpressured run.
- Metric keys are byte-compatible with the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.quant.qat import policy_for as jax_policy_for
from repro.serve import ServeEngine as JaxEngine
from repro.serve.cache import PagedCachePool as JaxPool
from repro.train.serve import quantize_for_serving as jax_qfs
from repro_torch.launch import serve as launcher
from repro_torch.serve import SamplingParams, ServeEngine
from torch_parity import models, to_port

LOGIT_BOUND = 2e-2  # relative logit bound at bf16 (test_torch_model.py)


def _args(**over):
    return launcher.parse_args(["--device", "cpu", "--requests", "4", "--gen", "8",
                                *sum(([f"--{k.replace('_', '-')}", str(v)]
                                      for k, v in over.items()), [])])


def _engine_kw(args):
    return dict(num_slots=args.num_slots, max_len=args.prompt_len + args.gen + 1,
                block_size=args.block_size, num_blocks=args.num_blocks,
                prefill_chunk=args.prefill_chunk)


@pytest.fixture(scope="module", params=["op_by_op", "jit"])
def served(request):
    """One reference run of the trimmed default workload per mode
    (module-scoped: each JAX engine compiles once).  ``op_by_op`` hands the
    engine the model's unjitted methods as its prefill/decode functions."""
    jm, tm = models()
    jsp = jax_qfs(jm, jm.init(jax.random.PRNGKey(0)), jax_policy_for(jm, 4))
    args = _args()
    work = launcher.synthetic_workload(args, jm.cfg.vocab_size)
    fns = ({"prefill_fn": jm.prefill_chunk, "decode_fn": jm.decode_step}
           if request.param == "op_by_op" else {})
    ref = JaxEngine(jm, jsp, prefix_cache=False, sample_device=False,
                    pipeline=False, **fns, **_engine_kw(args))
    launcher.drive(ref, work, args.arrival_every, SamplingParams())
    return request.param, jm, tm, jsp, args, work, ref


def _ref_margin(jm, jsp, prompt, emitted):
    """The reference's top-2 logit margin after ``prompt + emitted``."""
    replay = np.concatenate([prompt, np.asarray(emitted, np.int64)]).astype(np.int32)
    pool = JaxPool(jm, 1, len(replay) + 1, block_size=16, prefix_cache=False)
    seq = pool.alloc_seq()
    pool.ensure(seq, len(replay) + 1)
    logits, _ = jm.prefill_chunk(jsp, pool.step_cache(), jnp.asarray(replay[None]),
                                 seq, 0, len(replay))
    top = np.sort(np.asarray(logits[0, 0]))[-2:]
    return float(top[1] - top[0]), float(np.abs(np.asarray(logits)).max())


def test_greedy_streams_equal_reference(served):
    mode, jm, tm, jsp, args, work, ref = served
    eng = ServeEngine(tm, to_port(jsp), device="cpu", **_engine_kw(args))
    launcher.drive(eng, work, args.arrival_every, SamplingParams())
    assert len(eng.requests) == len(ref.requests) == 4
    for rid in ref.requests:
        want, got = ref.output(rid), eng.output(rid)
        assert len(got) == len(want) == work[rid][1]
        if got == want:
            continue
        assert mode == "jit", f"request {rid}: {got} != {want} op by op"
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        margin, scale = _ref_margin(jm, jsp, work[rid][0], want[:i])
        print(f"request {rid}: first divergence at token {i}, reference "
              f"top-2 margin {margin:.4g} (bound {LOGIT_BOUND * scale:.4g})")
        assert margin < LOGIT_BOUND * scale, (
            f"request {rid} diverged at token {i} where the reference's top-2 "
            f"margin {margin:.4g} exceeds the bf16 logit bound "
            f"{LOGIT_BOUND * scale:.4g}")
    m = eng.metrics()
    assert m["recompiles"] == 0 and m["preemptions"] == 0
    assert m["tokens_total"] == sum(n for _, n in work)


def test_metric_keys_match_reference(served):
    *_, args, work, ref = served
    jm, tm = models()
    eng = ServeEngine(tm, to_port(jax_qfs(jm, jm.init(jax.random.PRNGKey(1)),
                                          jax_policy_for(jm, 4))),
                      device="cpu", **_engine_kw(args))
    launcher.drive(eng, work[:2], args.arrival_every, SamplingParams())
    mine, theirs = eng.metrics(), ref.metrics()
    assert sorted(mine) == sorted(theirs)
    for key in ("sampler", "pipeline", "prefix_cache"):
        assert sorted(mine[key]) == sorted(theirs[key])
    assert sorted(mine["requests"][0]) == sorted(theirs["requests"][0])


def test_preemption_replays_to_the_same_tokens():
    _, tm = models()
    from repro_torch.quant.qat import policy_for
    from repro_torch.train.serve import quantize_for_serving

    sp = quantize_for_serving(tm, tm.init(seed=3, device="cpu"), policy_for(tm, 4),
                              device="cpu")
    args = _args(gen=16, prompt_len=8, block_size=4, arrival_every=0)
    work = launcher.synthetic_workload(args, tm.cfg.vocab_size)
    outs = {}
    for num_blocks in (None, 9):   # 8 usable blocks: 4 rows need up to 24
        eng = ServeEngine(tm, sp, device="cpu",
                          **{**_engine_kw(args), "num_blocks": num_blocks})
        launcher.drive(eng, work, 0, SamplingParams())
        outs[num_blocks] = ([eng.output(r) for r in range(len(work))],
                            eng.metrics()["preemptions"])
    assert outs[None][1] == 0 and outs[9][1] > 0
    assert outs[9][0] == outs[None][0]
