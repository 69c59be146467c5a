"""``launch.op_costs``, ``launch.specs`` and the op-count latency evaluator
against the JAX package's ``launch.hlo_analysis``, on the CPU.

- The twins of ``tests/test_hlo_analysis.py``'s contracts: a 128³ matmul
  counts ``2·128³`` flops (as the reference's ``analyze_hlo`` of the same
  product), a Python loop of 10 counts 10 times, 5 × 10 nested loops 50
  times; the roofline terms and the bottleneck at H100 rates.
- The byte rules the counter states: views and allocations 0, a gather
  its rows, an indexed write its window.
- The glm4-9b smoke ``decode_step`` (B 1, ``max_len`` 16), built on meta
  stand-ins: the reference's ``analyze_hlo`` flops, 163,200, unpacked and
  packed at 2 and 8 bits; packed, each matrix charged its planes.
- The smoke loss forward and backward within 5 % of the reference's
  ``jax.grad`` count, the gap named term by term.
- glm4-9b at full widths and depth, 4 bits, 4 rows over a paged pool:
  the planes it reads are the 4.70 GB weight floor (``PERF.md`` §2),
  each kernel charges exactly its contract, and the whole step counts
  within 6 % of the floor (the eager ops around the kernels: 5.9 %).
- ``OpCountLatencyEvaluator``: the 8-bit reference is the all-8 count,
  fewer bits cost strictly less, a repeat is a memo hit (the reference's
  ``test_hlo_latency_evaluator_bits_monotone`` fails under jax 0.9.0:
  XLA charges the same bytes at 2 and 8 bits).
- ``launch/autotune.py --hw hlo`` runs two episodes at smoke size.
- ``launch.specs``' stand-ins and parameter counts equal the reference's;
  the QAT fake-quant ops on meta charge their kernels' contracts.
- ``count_costs``' memory count on a known function: arguments, an
  argument updated in place (alias), a new output, a freed transient
  (temp) and the peak; a tensor-parallel train step's collectives, read
  off the dispatcher on rank 0 of a fake group of 8, equal ``dist.tp.stats``'
  bytes and calls kind by kind.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.launch.op_costs import (H100, OpCosts, count_costs,
                                         roofline_from_costs)
from repro_torch.launch.specs import cache_struct, params_struct, sds, serving_params_struct

sys.path.insert(0, str(Path(__file__).parent))
import torch_parity as tp  # noqa: E402

RNG = np.random.default_rng(0)
W = RNG.standard_normal((128, 128)).astype(np.float32)
MM = 2 * 128 ** 3


def _compiled_flops(f, *args) -> float:
    return analyze_hlo(jax.jit(f).lower(*args).compile().as_text()).flops


# ------------------------------------------------- tests/test_hlo_analysis.py twins
def test_plain_matmul():
    w = torch.from_numpy(W)
    assert count_costs(torch.matmul, w, w).flops == MM
    assert _compiled_flops(lambda x, y: x @ y, jnp.asarray(W), jnp.asarray(W)) == MM


def test_loop_multiplies_body():
    w = torch.from_numpy(W)

    def f(x):
        for _ in range(10):
            x = x @ w
        return x

    assert count_costs(f, w).flops == 10 * MM


def test_nested_loops():
    w = torch.from_numpy(W)

    def f(x):
        for _ in range(5):
            for _ in range(10):
                x = x @ w
        return x

    assert count_costs(f, w).flops == 50 * MM


def test_roofline_terms_and_bottleneck():
    costs = OpCosts(flops=H100["peak_flops"], traffic_bytes=H100["hbm_bw"] / 2)
    rl = roofline_from_costs(costs, chips=1, model_flops=H100["peak_flops"] / 2)
    assert rl.bottleneck == "compute"
    assert rl.t_compute == 1.0 and rl.t_memory == 0.5 and rl.t_collective == 0.0
    assert rl.roofline_fraction == 0.5
    assert rl.useful_ratio == 0.5
    mem = roofline_from_costs(OpCosts(flops=1.0, traffic_bytes=H100["hbm_bw"]), chips=2,
                              model_flops=4.0)
    assert mem.bottleneck == "memory" and mem.t_total == 1.0 and mem.model_flops == 2.0


def test_byte_rules():
    """Views and allocations move nothing; a gather charges the rows it
    returns (read and written) and its indices; an indexed write charges
    its values, its window and its indices, not the buffer."""
    table = torch.from_numpy(RNG.standard_normal((1000, 64)).astype(np.float32))
    idx = torch.tensor([3, 7, 11], dtype=torch.int64)
    assert count_costs(lambda t: t.t().reshape(64, 1000)[:4], table).traffic_bytes == 0
    assert count_costs(torch.empty, (1000, 64)).traffic_bytes == 0
    gather = 2 * 3 * 64 * 4 + 3 * 8
    assert count_costs(lambda t: t[idx], table).traffic_bytes == gather
    assert count_costs(torch.nn.functional.embedding, idx, table).traffic_bytes == gather
    rows = torch.zeros((3, 64))

    def write(t):
        t[idx] = rows

    assert count_costs(write, table.clone()).traffic_bytes == 2 * 3 * 64 * 4 + 3 * 8
    # an elementwise op: each operand read once, the output written once
    assert count_costs(torch.add, table, table).traffic_bytes == 3 * table.numel() * 4


# ---------------------------------------------------------- the smoke decode step
@pytest.fixture(scope="module")
def glm():
    jm, tm = tp.models()
    return jm, tm


def _ref_decode_flops(jm, bits) -> float:
    from repro.launch.specs import cache_struct as jcache
    from repro.launch.specs import params_struct as jparams
    from repro.launch.specs import sds as jsds
    from repro.launch.specs import serving_params_struct as jserving

    params = jparams(jm) if bits is None else jserving(jm, _policy(jm, bits))
    return _compiled_flops(jm.decode_step, params, jcache(jm, 1, 16), jsds((1, 1), jnp.int32))


def _policy(model, bits):
    """All groups at ``bits`` but the frozen ones, as the reference's or the
    port's ``QuantPolicy`` for its model."""
    if type(model).__module__.startswith("repro_torch"):
        from repro_torch.quant.policy import QuantPolicy
    else:
        from repro.quant.policy import QuantPolicy
    names = [g.name for g in model.quant_groups()]
    frozen = model.frozen_bits()
    return QuantPolicy.from_array(names, [frozen.get(n, bits) for n in names])


@pytest.mark.parametrize("bits", [None, 2, 8], ids=["unpacked", "packed2", "packed8"])
def test_smoke_decode_step_flops_match_reference(glm, bits):
    jm, tm = glm
    params = params_struct(tm) if bits is None else serving_params_struct(tm, _policy(tm, bits))
    costs = count_costs(tm.decode_step, params, cache_struct(tm, 1, 16), sds((1, 1), torch.int32))
    assert costs.flops == _ref_decode_flops(jm, bits) == 163_200
    if bits is not None:
        # every projection and the 8-bit lm_head through qmm's contract:
        # planes bits·K·N/8 bytes, f32 scale, bf16 x, f32 y
        cfg = tm.cfg
        D, F, V, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.hd
        mats = [(D, cfg.num_heads * hd), (D, cfg.num_kv_heads * hd), (D, cfg.num_kv_heads * hd),
                (cfg.num_heads * hd, D), (D, F), (D, F), (F, D)] * cfg.num_layers
        want = sum(bits * K * N // 8 + 4 * N + 2 * K + 4 * N for K, N in mats)
        want += 8 * D * V // 8 + 4 * V + 2 * D + 4 * V
        assert costs.kernels == {"qmm_bitserial": [len(mats) + 1, 155_008.0, float(want)]}


def test_smoke_loss_grad_flops_within_5pct_of_reference(glm):
    """Forward and backward of the smoke loss at (2, 32): within 5 % of
    the reference's ``jax.grad`` count, and equal to it once the two
    named differences are taken out: the port's checkpointed
    ``chunked_ce`` computes the lm_head readout again in the backward
    (one more 2·T·D·V), which the reference's compiled program counts
    once; and the port's ``blocked_attention`` skips the (q, kv) chunk
    pair above the causal diagonal (3 of 4 pairs at 32 tokens in chunks
    of 16), where the reference computes all four, masked: its forward
    q·k and p·v, the backward's four products and the recomputed q·k."""
    jm, tm = glm
    jp = jm.init(jax.random.PRNGKey(0))
    toks = RNG.integers(0, tm.cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = RNG.integers(0, tm.cfg.vocab_size, (2, 32)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    ref = _compiled_flops(jax.grad(lambda p: jm.loss(p, jb)[0]), jp)
    params = tp.to_port(jp)
    from repro_torch.optim.adamw import tree_leaves

    leaves = [t.requires_grad_(True) for t in tree_leaves(params)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}

    def fwd_bwd():
        loss, _ = tm.loss(params, batch)
        torch.autograd.grad(loss, leaves, allow_unused=True)

    got = count_costs(fwd_bwd).flops
    cfg = tm.cfg
    B, S, H, hd = 2, 32, cfg.num_heads, cfg.hd
    readout_again = 2 * B * S * cfg.d_model * cfg.vocab_size
    pair = 2 * B * H * 16 * 16 * hd                 # one q·k (or p·v) of one chunk pair
    skipped = cfg.num_layers * pair * (2 + 4 + 1)   # fwd q·k, p·v; bwd 4; recomputed q·k
    assert got == ref + readout_again - skipped
    assert abs(got - ref) / ref < 0.05


# ------------------------------------------------------------ full width on meta
def _qmm_contract(mats, bits, M):
    """qmm's contract bytes over ``mats`` ((K, N) pairs) at ``bits`` and M
    rows: planes bits·K·N/8, the f32 scale, bf16 x read, f32 y written."""
    return sum(bits * K * N // 8 + 4 * N + 2 * M * K + 4 * M * N for K, N in mats)


def test_glm4_full_width_decode_bytes_near_weight_floor():
    """glm4-9b (40 × 4096, vocab 151552) at 4 bits with its 8-bit lm_head,
    4 rows of 96 tokens over a meta paged pool (block 16, fp KV).  The
    planes the step reads are ``PERF.md`` §2's 4.70 GB weight floor; the
    281 qmm calls charge exactly their contract and the 40 paged
    attentions every K/V slot their tables address.  The eager torch ops
    around the kernels (dtype casts, norms, RoPE, SwiGLU, residual adds)
    move 209 MB more at 4 rows, so the whole step counts 5.9 % over the
    floor: it is held to 6 %, where 5 % was hoped for."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.quant.qat import policy_for
    from repro_torch.serve.cache import PagedCachePool

    model = build_model(get_config("glm4-9b"))
    cfg = model.cfg
    sparams = serving_params_struct(model, policy_for(model, 4))
    pool = PagedCachePool(model, 4, 96, block_size=16, device="meta")
    for _ in range(4):
        pool.ensure(pool.alloc_seq(), 96)
    costs = count_costs(model.decode_step, sparams, pool.step_cache(), sds((4, 1), torch.int32))
    D, F, V, hd, KV = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.hd, cfg.num_kv_heads
    H = cfg.num_heads
    mats = [(D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D), (D, F), (D, F),
            (F, D)] * cfg.num_layers
    planes = sum(4 * K * N // 8 for K, N in mats) + D * V
    assert round(planes / 1e9, 2) == 4.70
    assert costs.kernels["qmm_bitserial"][:2] == [281, 2 * 4 * (sum(K * N for K, N in mats)
                                                                + D * V)]
    assert costs.kernels["qmm_bitserial"][2] == (_qmm_contract(mats, 4, 4)
                                                 + _qmm_contract([(D, V)], 8, 4))
    nb = pool.block_tables.shape[1]
    kv_rows = 2 * 4 * nb * 16 * KV * hd * 2                    # every addressed slot, bf16
    q_out_tables = 4 * H * hd * (2 + 4) + 4 * nb * 4 + 4 * 4
    assert costs.kernels["paged_attention"][0] == cfg.num_layers
    assert costs.kernels["paged_attention"][2] == cfg.num_layers * (kv_rows + q_out_tables)
    assert abs(costs.traffic_bytes - 4.70e9) / 4.70e9 < 0.06


# ------------------------------------------------------------- the evaluator
def test_op_count_latency_evaluator_bits_monotone(glm):
    """The packed decode step's op count rooflined: the all-8-bit
    candidate is the reference, fewer bits strictly lower, a repeat served
    from the memo."""
    from repro_torch.autotune import OpCountLatencyEvaluator

    _, tm = glm
    ev = OpCountLatencyEvaluator(tm, max_len=16)
    low, ref = ev({n: ev.frozen.get(n, 2) for n in ev.group_names})
    high, ref2 = ev({n: ev.frozen.get(n, 8) for n in ev.group_names})
    assert ref == ref2 == high
    assert 0 < low < high
    misses = ev.cache.stats()["misses"]
    assert ev({n: ev.frozen.get(n, 2) for n in ev.group_names}) == (low, ref)
    assert ev.cache.stats()["misses"] == misses


def test_autotune_launcher_hw_hlo(tmp_path):
    from repro_torch.launch import autotune

    out = autotune.main(["--device", "cpu", "--hw", "hlo", "--episodes", "2",
                         "--pretrain-steps", "2", "--workers", "2", "--batch-episodes", "1",
                         "--archive", str(tmp_path / "archive.json")])
    res, arch = out["result"], out["archive"]
    assert len(res.episodes) == 2 and len(arch) >= 1
    assert all(e.latency is not None and e.latency > 0 for e in arch.entries())


@pytest.mark.parametrize("arch", ["glm4-9b", "moonshot-v1-16b-a3b", "qwen2-vl-7b",
                                  "musicgen-large", "hymba-1.5b", "rwkv6-1.6b"])
def test_specs_match_reference(arch):
    """The stand-ins' shapes and dtypes and the parameter counts equal the
    reference's ``launch.specs`` for the smoke configs, on meta; a GELU
    model's less the ``mlp/wu`` the reference draws and never uses."""
    from repro.configs import SHAPES as JSHAPES
    from repro.launch import specs as jspecs
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs

    jm, tm = tp.models(arch)
    for train in (True, False):
        got = specs.batch_struct(tm.cfg, SHAPES["train_4k"], train=train)
        want = jspecs.batch_struct(jm.cfg, JSHAPES["train_4k"], train=train)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
    cfg = tm.cfg
    unused_wu = cfg.num_layers * cfg.d_model * cfg.d_ff if cfg.act == "gelu" else 0
    assert specs.count_params(tm) == jspecs.count_params(jm) - unused_wu
    assert specs.active_params(cfg, tm) == jspecs.active_params(jm.cfg, jm) - unused_wu
    from repro_torch.train.serve import _leaves

    sp, cache, tokens = specs.decode_structs(tm, SHAPES["decode_32k"], _policy(tm, 4))
    _, jcache, jtokens = jspecs.decode_structs(jm, JSHAPES["decode_32k"], _policy(jm, 4))
    assert tuple(tokens.shape) == tuple(jtokens.shape)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    assert all(t.device.type == "meta" for t in (*_leaves(sp), *cache.values()))


def test_qat_step_on_meta_charges_the_fake_quant_pair(glm):
    """A QAT loss's forward and backward on meta stand-ins (the smoke
    glm4, 4 bits): one per-column fake-quant each way, charged its
    contract -- every leaf read and written, its scales -- and the step's
    matmuls through the registry, with no plain fake-quant inside."""
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    from repro_torch.quant.qat import bits_assignment, bits_to_device, quantize_params

    _, tm = glm
    params = params_struct(tm)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    groups = tm.quant_groups()
    bits = bits_to_device(bits_assignment(groups, _policy(tm, 4)), "meta")
    batch = {"tokens": sds((2, 32), torch.int32), "labels": sds((2, 32), torch.int32)}

    def step():
        qp = quantize_params(tree_unflatten(params, leaves), bits, groups)
        loss, _ = tm.loss(qp, batch)
        torch.autograd.grad(loss, leaves, allow_unused=True)

    costs = count_costs(step)
    fwd, bwd = costs.kernels["fake_quant_group_col"], costs.kernels["fake_quant_group_col_bwd"]
    assert fwd[0] == bwd[0] == 1 and fwd[1] == bwd[1] == 0
    quantized = sum(g.n_weights for g in groups) * 2          # bf16 leaves
    assert quantized < fwd[2] < 3 * quantized and quantized < bwd[2] < 4 * quantized
    assert costs.flops > 0 and "fake_quant" not in costs.kernels


def test_grouped_fake_quant_on_meta_charges_its_contract():
    """The CNN QAT path's grouped fake-quant and its STE on meta tensors:
    one charge each way, at each tensor read and written once (its scale
    and bits beside), the STE reading w and g and writing the gradient."""
    from repro_torch.quant.wrpn import fake_quant_ste_group

    ws = [sds((16, 3, 3, 3), torch.float32).requires_grad_(True),
          sds((10, 16), torch.float32).requires_grad_(True)]
    nbytes = sum(w.numel() * 4 for w in ws)

    def step():
        outs = fake_quant_ste_group(ws, [4, 8])
        torch.autograd.grad([o.sum() for o in outs], ws)

    costs = count_costs(step)
    assert costs.kernels["fake_quant_group"] == [1, 0.0, 2 * nbytes + 8 * len(ws)]
    assert costs.kernels["fake_quant_group_bwd"] == [1, 0.0, 3 * nbytes + 4 * len(ws)]


# ------------------------------------------------------------ collectives and memory
def test_memory_count_of_a_known_function():
    """The memory count on meta: an in-place update of an argument is an
    alias, a new product is an output, a transient freed before the end is
    temp; the peak is arguments + temp + the outputs made."""
    a, b = sds((64, 64), "float32"), sds((64, 32), "float32")
    n = 64 * 4

    def f(x, y):
        t = x * 2.0                      # 64 x 64 transient, freed before the end
        z = t @ y                        # 64 x 32 output
        del t
        x.add_(1.0)                      # the argument, updated in place
        return x, z

    m = count_costs(f, a, b).memory
    assert m == {"argument_bytes": 64 * n + 32 * n, "output_bytes": 64 * n + 32 * n,
                 "alias_bytes": 64 * n, "temp_bytes": 64 * n,
                 "peak_bytes": 64 * n + 32 * n + 64 * n + 32 * n}


def test_tp_step_collectives_equal_tp_stats():
    """A counted tensor-parallel train step (glm4 and moonshot smoke, rank
    0 of a fake group on a (2, 4) mesh, meta shards): the collectives
    ``count_costs`` reads off the dispatcher equal ``dist.tp.stats``'
    bytes and calls for the same step, kind by kind."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import tp as tpm
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_process_group

    names = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "all_to_all": "all-to-all", "reduce_scatter": "reduce-scatter"}
    with fake_process_group(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        for arch in ("glm4-9b", "moonshot-v1-16b-a3b"):
            cfg = get_config(arch, smoke=True)
            with dryrun.shard_profile("tp"):
                step, args, _, _ = dryrun.cell_step(mesh, cfg, ShapeConfig("t", "train", 16, 4))
                tpm.stats.reset()
                costs = count_costs(step, *args)
            want = {names[k]: v for k, v in tpm.stats.bytes.items()}
            calls = {names[k]: v for k, v in tpm.stats.calls.items()}
            assert costs.coll_bytes_by_kind == want and costs.coll_count_by_kind == calls, arch
            assert costs.coll_bytes > 0
