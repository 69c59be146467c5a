"""The dry run (``repro_torch.launch.dryrun``) and the production meshes
(``launch/mesh.py``) against ``repro.launch.dryrun`` and
``repro.launch.mesh`` on the CPU.

A JAX subprocess with 512 fake host devices (``XLA_FLAGS`` as the
reference's dry run sets it) reads the reference's production meshes, the
shard shape of every train-state leaf of glm4-9b and moonshot smoke under
``tp``, ``tp_sp`` and ``fsdp`` on a (2, 4) mesh (``NamedSharding.
shard_shape`` of ``state_specs``), and ``analyze_hlo``'s flops of the
reference's compiled GSPMD prefill (sequence-sharded) and decode steps at
smoke size on that mesh.  Meanwhile the port runs rank 0 of a fake
process group of 8 ranks:

- each leaf's shard bytes equal the reference's under all three profiles,
  and the train record's ``argument_bytes`` is their sum (``tp``) plus the
  batch's and the bits' shards;
- the prefill and decode records' per-rank flops: decode exactly the
  reference's; prefill within 2 % once the one term that differs is named
  and added back -- the attention tiles the causal mask kills, which the
  reference's flash scan computes and the port's skips (4.3 % of glm4's
  smoke prefill, 2.8 % of moonshot's), after which the rest is within
  0.5 %;
- the ``--dp-collectives`` record equals the reference's committed one;
- every one of ``--all``'s 80 cells (and ``--profile tp``'s) is a
  countable cell or a skip whose reason is the reference's or names its
  ROADMAP item, 26 countable (36 under ``tp``), and ``run_all`` writes the
  skips without spawning;
- glm4-9b ``decode_32k`` at the 256-rank pod mesh, at full width, counts
  without allocating: the process's max RSS rises by less than 2 GB while
  the rank's cache alone is 10.7 GB;
- ``make_production_mesh``'s shapes and names equal the reference's, and it
  refuses a group of another size.
"""
import json
import math
import os
import resource
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import SHAPES, all_archs, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_group, make_production_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GLM, MOON = "glm4-9b", "moonshot-v1-16b-a3b"
ARCHS = (GLM, MOON)
PROFILES = ("tp", "tp_sp", "fsdp")
TRAIN = ShapeConfig("train_smoke", "train", 16, 4)
PREFILL = ShapeConfig("prefill_smoke", "prefill", 64, 4)
DECODE = ShapeConfig("decode_smoke", "decode", 64, 8)

_REF = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, math, sys
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.dist import sharding as shd
from repro.launch import specs as S
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_production_mesh
from repro.models import build_model
from repro.optim import AdamW
from repro.quant.qat import policy_for

archs, (pS, pB, dS, dB) = sys.argv[1].split(","), map(int, sys.argv[2:6])
out = {"meshes": {}, "bytes": {}, "flops": {}}
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    out["meshes"][str(mp)] = [list(m.axis_names), list(m.devices.shape)]
mesh = jax.make_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8],
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
P = jax.sharding.PartitionSpec
for arch in archs:
    model = build_model(get_config(arch, smoke=True))
    pstruct = S.params_struct(model)
    state = {"params": pstruct, "opt": jax.eval_shape(AdamW().init, pstruct)}
    for profile in ("tp", "tp_sp", "fsdp"):
        os.environ["REPRO_SHARD_PROFILE"] = profile
        specs = jax.tree.leaves(shd.state_specs(state, mesh), is_leaf=lambda x: isinstance(x, P))
        out["bytes"][f"{arch}/{profile}"] = [
            math.prod(jax.sharding.NamedSharding(mesh, sp).shard_shape(l.shape))
            * l.dtype.itemsize for l, sp in zip(jax.tree.leaves(state), specs)]
    os.environ["REPRO_SHARD_PROFILE"] = "tp"
    with jax.set_mesh(mesh):
        batch = S.batch_struct(model.cfg, ShapeConfig("p", "prefill", pS, pB), train=False)

        def pstep(params, batch):
            logits, _ = model.forward(params, tokens=batch.get("tokens"), remat="full")
            return logits.astype(jnp.bfloat16)

        in_sh = (shd.to_named(shd.param_specs(pstruct, mesh), mesh),
                 shd.to_named(shd.batch_specs(batch, mesh, seq_shard=True), mesh))
        c = jax.jit(pstep, in_shardings=in_sh).lower(pstruct, batch).compile()
        out["flops"][f"{arch}/prefill"] = analyze_hlo(c.as_text()).flops
        sparams, cache, tokens = S.decode_structs(model, ShapeConfig("d", "decode", dS, dB),
                                                  policy_for(model, default_bits=4))

        def dstep(sp, c, t):
            logits, c2 = model.decode_step(sp, c, t)
            return logits.astype(jnp.bfloat16), c2

        # the reference's run_cell hands batch_specs the bare token struct,
        # which it cannot take: the struct goes in a dict here
        cache_sh = shd.to_named(shd.cache_specs(cache, mesh), mesh)
        in_sh = (shd.to_named(shd.param_specs(sparams, mesh), mesh), cache_sh,
                 shd.to_named(shd.batch_specs({"tokens": tokens}, mesh)["tokens"], mesh))
        c = jax.jit(dstep, in_shardings=in_sh, out_shardings=(None, cache_sh),
                    donate_argnums=(1,)).lower(sparams, cache, tokens).compile()
        out["flops"][f"{arch}/decode"] = analyze_hlo(c.as_text()).flops
print(json.dumps(out))
"""

torch.set_num_threads(1)


def _reference():
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("REPRO_SHARD_PROFILE", None)
    args = [",".join(ARCHS), PREFILL.seq_len, PREFILL.global_batch, DECODE.seq_len,
            DECODE.global_batch]
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REF), *map(str, args)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _dead_tile_flops(cfg, shape, tp) -> float:
    """The flops a rank's ``blocked_attention`` leaves out of a prefill of
    ``shape``: the tiles whose every (query, key) pair the causal mask
    kills (``models.common._tile_dead``), each ``QKᵀ`` and ``PV`` over the
    rank's rows and q heads."""
    from repro_torch.models.common import _tile_dead

    S = shape.seq_len
    cq, ck = min(cfg.q_chunk, S), min(cfg.kv_chunk, S)
    dead = sum(_tile_dead(qi, ki, cq, ck, True, cfg.sliding_window)
               for qi in range(-(-S // cq)) for ki in range(-(-S // ck)))
    rows, heads = shape.global_batch // tp.d, cfg.num_heads // tp.m
    return float(dead * 2 * 2 * rows * heads * cq * ck * cfg.hd * cfg.num_layers)


@pytest.fixture(scope="module")
def runs():
    """(the reference's results, the port's at (2, 4) on a fake group of 8)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import tp as tpm
    from repro_torch.dist.sharding import named_leaves, state_specs
    from repro_torch.launch import specs as S
    from repro_torch.launch.op_costs import _bytes
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW

    proc = _reference()
    port = {"bytes": {}, "records": {}, "dead": {}}
    try:
        with fake_process_group(8):
            mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
            for arch in ARCHS:
                cfg = get_config(arch, smoke=True)
                model = build_model(cfg)
                pstruct = S.params_struct(model)
                state = {"params": pstruct, "opt": AdamW().init(pstruct)}
                for profile in PROFILES:
                    with dryrun.shard_profile(profile):
                        placed = dryrun.place_meta(state, state_specs(state, mesh), mesh)
                    port["bytes"][f"{arch}/{profile}"] = [
                        _bytes(t) if isinstance(t, torch.Tensor) else names[-1]
                        for names, t in named_leaves(placed)]
                for shape, ss in ((TRAIN, False), (PREFILL, True), (DECODE, None)):
                    rec, costs = dryrun.count_cell(mesh, cfg, shape, profile="tp", seq_shard=ss)
                    port["records"][f"{arch}/{shape.kind}"] = (rec, costs)
                with dryrun.shard_profile("tp"):
                    port["dead"][arch] = _dead_tile_flops(cfg, PREFILL,
                                                          tpm.TensorParallel(cfg, mesh))
    finally:
        stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1]), port


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("profile", PROFILES)
def test_leaf_shard_bytes_equal_the_reference(runs, arch, profile):
    """Every train-state leaf's rank-0 shard on the (2, 4) mesh, in leaf
    order: the reference's ``NamedSharding.shard_shape`` bytes.  AdamW's
    step counter is a host int in the port (a 0-d int32 leaf of 4 bytes,
    replicated, in the reference)."""
    ref, port = runs
    got, want = port["bytes"][f"{arch}/{profile}"], ref["bytes"][f"{arch}/{profile}"]
    assert len(got) == len(want) > 0
    assert [(g, w) for g, w in zip(got, want) if not isinstance(g, int)] == [("step", 4)]
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if isinstance(g, int) and g != w]
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCHS)
def test_train_record_arguments_are_the_shards(runs, arch):
    """The train record under ``tp``: ``argument_bytes`` is the state's shard
    bytes (the reference's) plus the batch's rows (tokens and labels, int32,
    B / 2 rows a rank) and the int32 bits map; the moments are updated in
    place (``alias_bytes``: the fp32 m and v shards)."""
    ref, port = runs
    rec, _ = port["records"][f"{arch}/train"]
    want = ref["bytes"][f"{arch}/tp"]
    model_bits = 4 * sum(math.prod(v.shape) for v in _bits(arch).values())
    batch = 2 * 4 * (TRAIN.global_batch // 2) * TRAIN.seq_len
    assert rec["status"] == "ok"
    assert rec["memory"]["argument_bytes"] == sum(want) - 4 + batch + model_bits
    n = (len(want) - 1) // 3        # opt's m, its step, its v, then the params
    assert rec["memory"]["alias_bytes"] == sum(want[:2 * n + 1]) - 4
    m = rec["memory"]
    assert m["peak_bytes"] == (m["argument_bytes"] + m["temp_bytes"]
                               + m["output_bytes"] - m["alias_bytes"])
    assert set(rec) >= {"chips", "status", "params", "active_params", "profile", "remat",
                        "serve_bits", "count_s", "memory", "roofline", "fits_hbm"}


def _bits(arch):
    from repro_torch.models import build_model
    from repro_torch.quant.qat import bits_assignment, policy_for

    model = build_model(get_config(arch, smoke=True))
    return bits_assignment(model.quant_groups(), policy_for(model, 8))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_per_rank_flops_match_the_reference(runs, arch, kind):
    """Per-rank flops on (2, 4) against ``analyze_hlo`` of the reference's
    compiled GSPMD step: within 2 %.  The decode step's are equal.  The one
    term that differs, named: the prefill's causally dead attention tiles,
    which the reference computes under its mask and the port skips; with
    them added back the rest is within 0.5 %."""
    ref, port = runs
    rec, costs = port["records"][f"{arch}/{kind}"]
    want = ref["flops"][f"{arch}/{kind}"]
    named = port["dead"][arch] if kind == "prefill" else 0.0
    gap = (want - costs.flops) / want
    print(f"{arch} {kind}: port {costs.flops:.0f}, reference {want:.0f} ({gap:+.2%}); "
          f"dead attention tiles {named:.0f} ({named / want:.2%})")
    assert rec["roofline"]["flops"] == costs.flops
    assert abs(costs.flops + named - want) <= 0.005 * want, (costs.flops, named, want)
    if kind == "decode":
        assert costs.flops == want
    else:
        assert named > 0.005 * want     # the named term is what differs by more than 0.5 %
    assert abs(costs.flops + named - want) <= 0.02 * want


def test_counted_collectives_are_the_tp_stats(runs):
    """The train record's collectives are the step's own: the counted
    payloads of the last smoke count by kind, at least one of each of
    all-gather, all-reduce and reduce-scatter (kv columns gathered at m =
    4), and a moonshot train step's all-to-all."""
    _, port = runs
    for arch in ARCHS:
        _, costs = port["records"][f"{arch}/train"]
        kinds = set(costs.coll_bytes_by_kind)
        assert {"all-gather", "all-reduce", "reduce-scatter"} <= kinds, kinds
    assert "all-to-all" in port["records"][f"{MOON}/train"][1].coll_bytes_by_kind


# the reference's committed record: benchmarks/results/dryrun/dp_collectives_glm4-9b.json
DP_RECORD = {"grad_elements": 93888,
             "exact": {"all-reduce": 375564},
             "compressed": {"all-reduce": 12, "all-to-all": 187776, "all-gather": 189312},
             "send": {"exact": 657237, "compressed": 329973}, "send_reduction_x": 1.992}


def test_dp_collectives_equal_the_reference_record():
    """``--dp-collectives``: glm4-9b smoke, 8 ranks, planes 2, batch 8 x 64,
    built in f32, the reference's "exact fp32 pmean" baseline (its
    record's bf16 gradients reach f32 by XLA:CPU's promotion of a bf16
    all-reduce).  The exact route all-reduces every gradient in f32 (4
    bytes an element) and the three metrics; the compressed route's two phases move each
    leaf's 2 planes in an all-to-all and an all-gather (no leaf pads: each
    size divides 8) and two (8, 2) f32 scale gathers a leaf.  Equal to
    the reference's record, payload by payload."""
    rec = dryrun.run_dp_collectives()
    assert rec["grad_elements"] == DP_RECORD["grad_elements"]
    for route in ("exact", "compressed"):
        assert rec["wire"][route]["by_kind"] == DP_RECORD[route], (route, rec["wire"][route])
        assert rec["wire"][route]["send_bytes"] == DP_RECORD["send"][route]
    assert rec["send_reduction_x"] == DP_RECORD["send_reduction_x"]


def test_dp_exact_route_keeps_the_gradients_dtype():
    """The data-parallel step's exact route (``launch/train.py --mesh D,1``)
    all-reduces each gradient in its own dtype: glm4-9b smoke in bf16 on 8
    ranks puts its params' bytes on the wire (2 bytes an element of a bf16
    matrix, 4 of an f32 norm scale), and the three f32 metrics; no f32
    copy of a bf16 gradient."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.op_costs import count_costs
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.quant.qat import bits_assignment, bits_to_device, policy_for
    from repro_torch.train.train_step import init_dp_state, make_dp_train_step

    cfg = get_config(GLM, smoke=True)
    assert cfg.dtype == "bfloat16"
    model, opt = build_model(cfg), AdamW(lr=1e-3)
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 8)), "cpu")
    with dryrun.shard_profile("dp"), fake_process_group(8):
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
        state = init_dp_state(model, opt, 0, mesh)
        batch = SyntheticLMData(seed=0, global_batch=8, seq_len=64, vocab=cfg.vocab_size).next()
        costs = count_costs(make_dp_train_step(model, opt, mesh, planes=0), state, batch, bm)
    params = tree_leaves(model.init(0, device="cpu"))
    assert sum(p.numel() for p in params) == DP_RECORD["grad_elements"]
    want = sum(p.numel() * p.element_size() for p in params) + 12
    assert costs.coll_bytes_by_kind == {"all-reduce": want}, costs.coll_bytes_by_kind
    assert want < 0.51 * DP_RECORD["exact"]["all-reduce"]


def test_every_cell_is_a_record_or_a_reasoned_skip(tmp_path):
    """``--all``'s 80 cells (10 archs x 4 shapes x 2 meshes): 26 countable
    at the default profiles (the dense and moe archs' prefill and decode,
    h2o-danube's long_500k), 36 under ``--profile tp`` (the train cells of
    the five below 60e9 parameters); every skip gives the reference's
    reason or names ROADMAP item 11b-iv.  ``run_all`` writes a skip record
    a refused cell, and keeps a record that exists, spawning nothing."""
    from repro_torch.configs import cell_is_runnable

    counted = {}
    for profile in (None, "tp"):
        for arch in all_archs():
            for shape in SHAPES:
                for mesh in ("pod", "multipod"):
                    ok, reason = dryrun.plan_cell(arch, shape, mesh, profile)
                    if ok:
                        counted.setdefault(profile, []).append((arch, shape, mesh))
                    else:
                        ref_ok, ref_reason = cell_is_runnable(arch, shape)
                        assert reason == ref_reason or "item 11b-iv" in reason, reason
    assert len(counted[None]) == 26 and len(counted["tp"]) == 36
    dense_moe = {"phi3-mini-3.8b", GLM, "internlm2-20b", "h2o-danube-3-4b", MOON,
                 "llama4-maverick-400b-a17b"}
    assert {a for a, s, _ in counted[None]} == dense_moe
    assert {a for a, s, _ in counted["tp"] if s == "train_4k"} == dense_moe - {
        "llama4-maverick-400b-a17b"}
    out = str(tmp_path)
    with open(os.path.join(out, f"{GLM}_decode_32k_pod.json"), "w") as f:
        json.dump({"status": "ok"}, f)
    res = dryrun.run_all(meshes=("pod",), out_dir=out, archs=["rwkv6-1.6b", GLM],
                         shapes=["train_4k", "decode_32k"])
    assert [r["status"] for r in res] == ["skipped", "skipped", "skipped", "cached"]
    for name in ("rwkv6-1.6b_train_4k_pod", "rwkv6-1.6b_decode_32k_pod", f"{GLM}_train_4k_pod"):
        with open(os.path.join(out, name + ".json")) as f:
            rec = json.load(f)
        assert rec["status"] == "skipped" and "item 11b-iv" in rec["reason"], rec


def test_full_width_decode_cell_allocates_nothing():
    """glm4-9b ``decode_32k`` on the 256-rank pod mesh at full width and
    depth: the rank's cache is 8 rows x 32,768 tokens x 2 KV heads x 128
    x 40 layers of K and V in bf16 (10.7 GB, updated in place: its
    ``alias_bytes``), and the process's max RSS rises by less than 2 GB."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    rec = dryrun.run_cell(GLM, "decode_32k", "pod")
    rise = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - before
    cache = 2 * 40 * 8 * 32768 * 2 * 128 * 2
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["memory"]["alias_bytes"] == cache and cache > 10.7e9
    assert rec["memory"]["argument_bytes"] > cache and rec["fits_hbm"]
    assert rise < 2e9, rise


def test_production_mesh_shapes_and_names_equal_the_reference(runs):
    ref, _ = runs
    for multi_pod, n in ((False, 256), (True, 512)):
        with fake_process_group(n):
            m = make_production_mesh(multi_pod=multi_pod)
            assert [list(m.mesh_dim_names), list(m.shape)] == ref["meshes"][str(multi_pod)]


def test_production_mesh_refuses_another_group_size():
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with fake_process_group(8):
        for multi_pod in (False, True):
            with pytest.raises(ValueError, match="not 8"):
                make_production_mesh(multi_pod=multi_pod)
    with fake_process_group(256), pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
