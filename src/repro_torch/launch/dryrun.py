"""Per-rank dry run of every (arch × shape × mesh) cell: what one chip of a
production mesh holds and moves, without the chips (torch twin of
``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 fake XLA host devices
and reads the compiled program's memory and op counts.  The port has no
compiler: for each cell the dry run

  1. starts a ``"fake"`` process group of the production size in its own
     process, as rank 0 (``launch/mesh.py::fake_process_group``), and
     builds ``make_production_mesh`` on it (16 × 16, or 2 × 16 × 16);
  2. places every leaf as the reference's ``dist.sharding`` specs place it
     (``state_specs``, ``param_specs``, ``batch_specs``, ``cache_specs``):
     rank 0's shard of each, a stand-in on the meta device (no storage);
  3. runs the port's own step on those shards under the cell's profile --
     the tensor-parallel QAT train step (``make_tp_train_step``), the
     forward over a sequence-sharded prefill batch, or ``decode_step``
     over a cache of the rank's rows -- counted by ``launch/op_costs.py``:
     flops, HBM traffic, each collective's payload (the fake group answers
     them without a peer), and the storages it holds (arguments, results,
     aliases, peak);
  4. writes the reference's record, its roofline at one H100's data-sheet
     rates (``op_costs.roofline_from_costs``).

A cell the port cannot count faithfully is written ``status: skipped``
with the reason the port's refusal gives, which names its ROADMAP item;
no number is made up for it.  Every kernel entry point on meta charges
its kernel's contract (``kernels.ops.charging``); nothing runs on a
device.

Run one cell:   python -m repro_torch.launch.dryrun --arch glm4-9b --shape decode_32k --mesh pod
Run everything: python -m repro_torch.launch.dryrun --all   (a subprocess a cell)

Records go to ``--out`` (``run_all``: ``dryrun_out/`` at the repo's root,
which git ignores).  The fake group exists only in the process that runs
a cell.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
                           "dryrun_out")
DEFAULT_PROFILE = {"train": "fsdp", "prefill": "tp", "decode": "tp"}
META = torch.device("meta")


def _log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def shard_profile(profile: str):
    """``REPRO_SHARD_PROFILE`` set to ``profile`` for the block."""
    prev = os.environ.get("REPRO_SHARD_PROFILE")
    os.environ["REPRO_SHARD_PROFILE"] = profile
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("REPRO_SHARD_PROFILE", None)
        else:
            os.environ["REPRO_SHARD_PROFILE"] = prev


def local_shape(shape, spec, sizes: dict) -> tuple:
    """The shape of rank 0's shard of a leaf of ``shape`` placed by
    ``spec`` on a mesh of ``sizes`` (the specs' divisibility guard makes
    every split even)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n = math.prod(sizes[a] for a in ((entry,) if isinstance(entry, str) else entry))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split {n} ways ({spec})")
        out[d] //= n
    return tuple(out)


def place_meta(tree, specs, mesh, *, dtensor: bool = True):
    """``tree`` (meta stand-ins at their global shapes) with every tensor
    leaf replaced by a new meta stand-in of rank 0's shard under
    ``specs``: a DTensor over ``mesh`` (``dtensor``), else the plain
    local tensor.  Host ints pass."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import map_tree, mesh_sizes, placements_of

    sizes = mesh_sizes(mesh)

    def put(_, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        local = torch.empty(local_shape(leaf.shape, spec, sizes), dtype=leaf.dtype, device=META)
        if not dtensor:
            return local
        return DTensor.from_local(local, mesh, placements_of(spec, mesh), run_check=False,
                                  shape=leaf.shape, stride=torch.empty(leaf.shape,
                                                                       device=META).stride())

    return map_tree(put, tree, specs)


def compute_tree(tp, placed):
    """Every placed leaf as the tensor this rank computes with
    (``TensorParallel.compute_leaf``: its shard, or gathered whole)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import map_tree

    return map_tree(lambda names, t: tp.compute_leaf(names, t) if isinstance(t, DTensor)
                    else t, placed)


def cell_step(mesh, cfg, shape, *, serve_bits: int = 4, remat: str = "full",
              seq_shard: bool | None = None):
    """(step function, its arguments, model flops of the whole step, info)
    of one cell on ``mesh`` under the sharding profile already set
    (:func:`shard_profile`), the arguments rank 0's meta shards.  Raises
    ``NotImplementedError`` (the port's refusal, naming its ROADMAP item)
    where the port has no path."""
    from repro_torch.dist import tp as tpm
    from repro_torch.dist.sharding import batch_specs, cache_specs, param_specs, state_specs
    from repro_torch.launch import specs as S
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.quant.qat import bits_assignment, bits_to_device, policy_for
    from repro_torch.train.train_step import make_tp_train_step

    model = build_model(cfg)
    n_params = S.count_params(model)
    n_active = S.active_params(cfg, model)
    B, T = shape.global_batch, shape.seq_len
    info = {"params": n_params, "active_params": n_active}
    if seq_shard is None:
        seq_shard = T >= 32_768
    if shape.kind == "train":
        opt = AdamW(lr=3e-4, weight_decay=0.1,
                    moments="int8" if n_params > 60e9 else "fp32")
        step = make_tp_train_step(model, opt, mesh, remat=remat)
        groups = model.quant_groups(seq_len=T)
        bits = bits_to_device(bits_assignment(groups, policy_for(model, 8)), META)
        pstruct = S.params_struct(model)
        state = {"params": pstruct, "opt": opt.init(pstruct)}
        batch = S.batch_struct(cfg, shape, train=True)
        args = (place_meta(state, state_specs(state, mesh), mesh),
                place_meta(batch, batch_specs(batch, mesh, seq_shard=False), mesh), bits)
        return step, args, 6.0 * n_active * B * T, info

    if shape.kind == "prefill":
        batch = S.batch_struct(cfg, shape, train=False)
        bspecs = batch_specs(batch, mesh, seq_shard=seq_shard)
        # the batch arrives split over "model" where its spec puts the sequence there
        seq = bspecs["embeds" if "embeds" in bspecs else "tokens"][1]
        tp = tpm.TensorParallel(cfg, mesh, seq_shard=seq is not None)
        pstruct = S.params_struct(model)

        def step(params, batch):
            comp = compute_tree(tp, params)
            local = {k: v.to_local() for k, v in batch.items()}
            with tpm.active(tp), torch.no_grad():
                logits, _ = model.forward(comp, tokens=local.get("tokens"),
                                          embeds=local.get("embeds"),
                                          positions=local.get("positions"), remat="full")
            return logits.to(torch.bfloat16)

        args = (place_meta(pstruct, param_specs(pstruct, mesh), mesh),
                place_meta(batch, bspecs, mesh))
        return step, args, 2.0 * n_active * B * T, info

    tp = tpm.TensorParallel(cfg, mesh)
    policy = policy_for(model, default_bits=serve_bits)
    sparams, cache, tokens = S.decode_structs(model, shape, policy)

    def step(params, cache, tokens):
        comp = compute_tree(tp, params)
        with tpm.active(tp), torch.no_grad():
            logits, new = model.decode_step(comp, cache, tokens)
        return logits.to(torch.bfloat16), new

    args = (place_meta(sparams, param_specs(sparams, mesh), mesh),
            place_meta(cache, cache_specs(cache, mesh), mesh, dtensor=False),
            place_meta({"tokens": tokens}, batch_specs({"tokens": tokens}, mesh), mesh,
                       dtensor=False)["tokens"])
    return step, args, 2.0 * n_active * B * serve_bits / 8.0, info


def count_cell(mesh, cfg, shape, *, profile: str | None = None, serve_bits: int = 4,
               remat: str = "full", seq_shard: bool | None = None, label: str = ""):
    """The dry run of one cell on ``mesh`` (a ``DeviceMesh`` over a
    process group, fake or real, whose rank 0 this process plays) ->
    (record, ``OpCosts``).  The record has the reference's fields, with
    ``count_s`` (the counting run's wall time) for ``lower_s`` and
    ``compile_s`` and ``fits_hbm`` (the peak against one H100's memory)
    for ``fits_16g``, and adds each collective kind's payload bytes and
    count and, for a train cell, the bytes of the param and moment shards
    the rank holds (``state_bytes``); a cell the port refuses is
    ``status: skipped`` with the refusal's reason, and no costs."""
    from repro_torch.core.costmodel import H100_HBM_BYTES
    from repro_torch.dist.sharding import mesh_sizes
    from repro_torch.launch.op_costs import _bytes, count_costs, roofline_from_costs

    profile = profile or DEFAULT_PROFILE[shape.kind]
    chips = math.prod(mesh_sizes(mesh).values())
    with shard_profile(profile):
        try:
            step, args, model_flops, info = cell_step(
                mesh, cfg, shape, serve_bits=serve_bits, remat=remat, seq_shard=seq_shard)
        except NotImplementedError as e:
            _log(f"[dryrun] SKIP {label or cfg.name} × {shape.name} ({profile}): {e}")
            return {"status": "skipped", "reason": str(e), "profile": profile}, None
        t0 = time.perf_counter()
        costs = count_costs(step, *args)
        count_s = time.perf_counter() - t0
    rl = roofline_from_costs(costs, chips=chips, model_flops=model_flops)
    mem = costs.memory
    rec = {"chips": chips, "status": "ok", **info, "profile": profile, "remat": remat,
           "serve_bits": serve_bits, "count_s": round(count_s, 1), "memory": mem,
           "roofline": rl.row(), "fits_hbm": mem["peak_bytes"] < H100_HBM_BYTES,
           "coll_bytes_by_kind": costs.coll_bytes_by_kind,
           "coll_count_by_kind": costs.coll_count_by_kind}
    if shape.kind == "train":
        rec["state_bytes"] = {part: _bytes(args[0][part]) for part in ("params", "opt")}
    _log(f"[dryrun] {label or cfg.name} × {shape.name} ({profile}): "
         f"peak/rank={mem['peak_bytes'] / 1e9:.2f} GB flops/rank={rl.flops:.3e} "
         f"bottleneck={rl.bottleneck} roofline_frac={rl.roofline_fraction:.3f} "
         f"(count {count_s:.1f}s)")
    _log(f"  memory: {mem}")
    _log(f"  terms: compute={rl.t_compute * 1e3:.1f}ms memory={rl.t_memory * 1e3:.1f}ms "
         f"collective={rl.t_collective * 1e3:.1f}ms useful={rl.useful_ratio:.2f}")
    _log(f"  collectives: {costs.coll_summary()}")
    return rec, costs


def plan_cell(arch: str, shape_name: str, mesh_kind: str = "pod",
              profile: str | None = None) -> tuple[bool, str]:
    """(countable, reason if skipped) of a cell, without counting it: the
    reference's ``cell_is_runnable``, then the refusals the port's step
    would raise (``dist.tp.refusal``, ``train_step.tp_step_refusal``)."""
    from repro_torch.configs import SHAPES, cell_is_runnable, get_config
    from repro_torch.dist import tp as tpm
    from repro_torch.launch.mesh import PRODUCTION
    from repro_torch.launch.specs import count_params
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train.train_step import tp_step_refusal

    ok, reason = cell_is_runnable(arch, shape_name)
    if not ok:
        return ok, reason
    shape = SHAPES[shape_name]
    profile = profile or DEFAULT_PROFILE[shape.kind]
    cfg = get_config(arch)
    dims, axes = PRODUCTION[mesh_kind == "multipod"]
    err = tpm.refusal(cfg, dict(zip(axes, dims)), profile)
    if err is None and shape.kind == "train":
        n = count_params(build_model(cfg))
        err = tp_step_refusal(AdamW(moments="int8" if n > 60e9 else "fp32"), math.prod(dims))
    return (True, "") if err is None else (False, str(err))


def _write(out_dir, name: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=2)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, serve_bits: int = 4,
             remat: str = "full", out_dir: str | None = None,
             seq_shard: bool | None = None, profile: str | None = None,
             tag: str = "") -> dict:
    """One cell at its production mesh: a fake group of 256 or 512 ranks
    started (and destroyed) here, :func:`count_cell` as its rank 0."""
    from repro_torch.configs import SHAPES, cell_is_runnable, get_config
    from repro_torch.launch.mesh import PRODUCTION, fake_process_group, make_production_mesh

    shape = SHAPES[shape_name]
    profile = profile or DEFAULT_PROFILE[shape.kind]
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    ok, reason = cell_is_runnable(arch, shape_name)
    if not ok:
        return {**head, "status": "skipped", "reason": reason}
    multi_pod = mesh_kind == "multipod"
    with fake_process_group(math.prod(PRODUCTION[multi_pod][0])):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rec, _ = count_cell(mesh, get_config(arch), shape, profile=profile,
                            serve_bits=serve_bits, remat=remat, seq_shard=seq_shard,
                            label=f"{arch} × {mesh_kind}")
    rec = {**head, **rec}
    _log("[dryrun] record " + json.dumps(rec))
    if out_dir:
        _write(out_dir, f"{arch}_{shape_name}_{mesh_kind}{'_' + tag if tag else ''}.json", rec)
    return rec


def run_dp_collectives(arch: str = "glm4-9b", *, planes: int = 2, devices: int = 8,
                       seq_len: int = 64, global_batch: int = 8,
                       out_dir: str | None = None) -> dict:
    """Wire bytes of the compressed data-parallel gradient path against the
    exact fp32 mean: ``train_step.make_dp_train_step`` at ``planes`` and at
    0 on a ``devices``-wide data mesh (rank 0 of a fake group of that
    size), the smoke model on the CPU, each step's collective payloads
    counted by kind (``op_costs``), and the send bytes a rank puts on the
    wire: an all-reduce's payload × 2(n-1)/n, an all-gather's, all-to-all's
    or reduce-scatter's × (n-1)/n.  Smoke-sized: the ratio (``planes +
    4/n`` against 4 bytes an element) is size-invariant.

    The model is built in f32: the exact step all-reduces each gradient in
    its own dtype, and the reference's baseline is "the exact fp32 pmean"
    (its record's bf16 gradients reach 4 bytes an element because XLA:CPU
    promotes a bf16 all-reduce to f32).  The compressed payloads do not
    depend on the gradients' dtype."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import fake_process_group
    from repro_torch.launch.op_costs import count_costs
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.quant.qat import bits_assignment, bits_to_device, policy_for
    from repro_torch.train.train_step import init_dp_state, make_dp_train_step

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = build_model(cfg)
    opt = AdamW(lr=1e-3)
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 8)), "cpu")
    n_grad = sum(p.numel() for p in tree_leaves(model.init(0, device="cpu")))
    frac = (devices - 1) / devices
    send_mult = {"all-reduce": 2 * frac, "all-gather": frac, "all-to-all": frac,
                 "reduce-scatter": frac, "collective-permute": 1.0}
    wire = {}
    with shard_profile("dp"), fake_process_group(devices):
        mesh = init_device_mesh("cpu", (devices,), mesh_dim_names=("data",))
        state = init_dp_state(model, opt, 0, mesh)
        batch = SyntheticLMData(seed=0, global_batch=global_batch, seq_len=seq_len,
                                vocab=cfg.vocab_size).next()
        for name, p in (("compressed", planes), ("exact", 0)):
            step = make_dp_train_step(model, opt, mesh, planes=p)
            costs = count_costs(step, state, batch, bm)
            wire[name] = {
                "payload_bytes": round(costs.coll_bytes),
                "send_bytes": round(sum(send_mult.get(k, 1.0) * v
                                        for k, v in costs.coll_bytes_by_kind.items())),
                "by_kind": {k: round(v) for k, v in costs.coll_bytes_by_kind.items()},
            }
    red = wire["exact"]["send_bytes"] / max(wire["compressed"]["send_bytes"], 1.0)
    rec = {"benchmark": "dp_collectives", "arch": cfg.name, "devices": devices,
           "planes": planes, "grad_elements": n_grad, "wire": wire,
           "send_reduction_x": round(red, 3),
           "analytic_send_bytes_per_elem": {"exact": 8.0 * frac,
                                            "compressed": 2.0 * planes * frac}}
    _log(f"[dp-collectives] {cfg.name} x{devices} ranks planes={planes}: "
         f"exact send={wire['exact']['send_bytes'] / 1e6:.3f}MB "
         f"compressed send={wire['compressed']['send_bytes'] / 1e6:.3f}MB "
         f"-> {red:.3f}x wire reduction")
    _log("[dp-collectives] record " + json.dumps(rec))
    if out_dir:
        _write(out_dir, f"dp_collectives_{arch}.json", rec)
    return rec


def run_all(meshes=("pod", "multipod"), out_dir=RESULTS_DIR, archs=None, shapes=None,
            timeout: int = 3600, profile: str | None = None):
    """One subprocess a cell (each its own fake group); a cell the port
    refuses (:func:`plan_cell`) gets its skip record here, with the
    reason.  ``profile=None`` takes each cell's default (train cells
    ``fsdp``, serve cells ``tp``); a profile given that is not the cell's
    default tags its file name.  A cell whose record exists is kept."""
    from repro_torch.configs import SHAPES, all_archs

    archs = archs or all_archs()
    shapes = shapes or list(SHAPES)
    results = []
    for arch in archs:
        for shape in shapes:
            cell_profile = profile or DEFAULT_PROFILE[SHAPES[shape].kind]
            tag = "" if cell_profile == DEFAULT_PROFILE[SHAPES[shape].kind] else cell_profile
            for mesh in meshes:
                name = f"{arch}_{shape}_{mesh}{'_' + tag if tag else ''}.json"
                ok, reason = plan_cell(arch, shape, mesh, cell_profile)
                head = {"arch": arch, "shape": shape, "mesh": mesh}
                if not ok:
                    _write(out_dir, name, {**head, "status": "skipped", "reason": reason,
                                           "profile": cell_profile})
                    _log(f"[dryrun] SKIP {arch} × {shape} × {mesh}: {reason}")
                    results.append({**head, "status": "skipped"})
                    continue
                if os.path.exists(os.path.join(out_dir, name)):
                    _log(f"[dryrun] cached {arch} × {shape} × {mesh}")
                    results.append({**head, "status": "cached"})
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                       "--shape", shape, "--mesh", mesh, "--profile", cell_profile,
                       "--out", out_dir] + (["--tag", tag] if tag else [])
                t0 = time.time()
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
                _log(r.stdout.strip())
                status = "ok" if r.returncode == 0 else "fail"
                if status == "fail":
                    _log(f"[dryrun] FAIL {arch} × {shape} × {mesh} "
                         f"({time.time() - t0:.0f}s):\n{r.stderr[-3000:]}")
                results.append({**head, "status": status, "wall_s": time.time() - t0})
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--out", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--profile", default=None, choices=[None, "tp", "tp_sp", "fsdp"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--dp-collectives", action="store_true",
                    help="count compressed-vs-exact DP gradient wire bytes instead of a cell")
    ap.add_argument("--planes", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.dp_collectives:
        run_dp_collectives(args.arch or "glm4-9b", planes=args.planes,
                           out_dir=args.out or RESULTS_DIR)
        return
    if args.all:
        run_all(out_dir=args.out or RESULTS_DIR, profile=args.profile)
        return
    run_cell(args.arch, args.shape, args.mesh, serve_bits=args.bits, remat=args.remat,
             out_dir=args.out, profile=args.profile, tag=args.tag)


if __name__ == "__main__":
    main()
