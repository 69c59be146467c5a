"""Rank bodies for the port's ``torch.distributed`` tests
(``tests/test_torch_dist_*.py``).

:func:`spawn` starts ``world`` processes on gloo over a file store (no
TCP port), runs one body in each and returns what each returned.  This
module imports neither JAX nor the JAX package, so the children start on
torch alone.
"""
from __future__ import annotations

import math
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def spawn(body: str, world: int, workdir: str, **kw) -> list:
    """Run ``BODIES[body](rank, world, workdir, **kw)`` on ``world`` gloo
    ranks; -> the ranks' results, in rank order."""
    import torch.multiprocessing as mp

    mp.start_processes(_entry, args=(body, world, str(workdir), kw), nprocs=world,
                       start_method="spawn", join=True)
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"{body}_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, body, world, workdir, kw):
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/{body}.store",
                            rank=rank, world_size=world)
    try:
        out = BODIES[body](rank, world, workdir, **kw)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"{body}_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _np(t) -> np.ndarray:
    return t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


# ---- the compressed all-reduce --------------------------------------------------
class _Wire:
    """Records the uint8 payloads the collectives receive."""

    def __init__(self):
        self.received = []
        self._gather, self._a2a = dist.all_gather_into_tensor, dist.all_to_all_single

    def __enter__(self):
        from repro_torch.dist import collectives

        def gather(out, x, group=None):
            self._gather(out, x, group=group)
            if out.dtype == torch.uint8:
                n = out.numel() // x.numel()
                self.received.append(("all_gather", out.clone().numpy().reshape(n, -1)))

        def a2a(out, x, group=None):
            self._a2a(out, x, group=group)
            self.received.append(("all_to_all", out.clone().numpy()))

        collectives.dist.all_gather_into_tensor = gather
        collectives.dist.all_to_all_single = a2a
        return self

    def __exit__(self, *exc):
        from repro_torch.dist import collectives

        collectives.dist.all_gather_into_tensor = self._gather
        collectives.dist.all_to_all_single = self._a2a


def collectives(rank, world, workdir, inputs):
    """Both constructions over a group of 2 (ranks 0 and 1) and of every
    rank, on each leaf of ``inputs`` (npz: ``n{n}_{leaf}`` of shape
    ``(n, ...)``, row r for rank r); the exact mean beside them; the
    error-feedback loop of ``repro``'s own test (1 plane, 8 calls)."""
    from repro_torch.dist.collectives import compressed_allreduce

    data = np.load(inputs)
    groups = {2: dist.new_group([0, 1]), world: dist.new_group(list(range(world)))}
    out = {}
    for n, group in groups.items():
        if rank >= n:
            continue
        for key in data.files:
            if not key.startswith(f"n{n}_") or key.endswith("_ef"):
                continue
            leaf = key[len(f"n{n}_"):]
            x = torch.from_numpy(data[key][rank].copy())
            if leaf.endswith("bf16"):
                x = x.to(torch.bfloat16)
            exact = x.float().clone()
            dist.all_reduce(exact, group=group)
            out[(n, leaf, "exact")] = _np(exact / n)
            for form, size in (("ag", None), ("rs", n)):
                with _Wire() as wire:
                    o, fb = compressed_allreduce(x, group, planes=2, axis_size=size)
                out[(n, leaf, form)] = (_np(o), _np(fb), str(o.dtype), wire.received)
        # error feedback: the time average of repeated 1-plane reductions
        x = torch.from_numpy(data[f"n{n}_ef"][rank].copy())
        for form, size in (("ag", None), ("rs", n)):
            fb, outs = torch.zeros_like(x), []
            for _ in range(8):
                o, fb = compressed_allreduce(x, group, residual=fb, planes=1, axis_size=size)
                outs.append(_np(o))
            out[(n, "ef", form)] = outs
    return out


# ---- the data-parallel QAT step, the launcher, elastic restore ---------------------
DP_BATCH, DP_SEQ, DP_STEPS, DP_LR = 8, 16, 4, 1e-3


def f32_smoke(arch: str):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def dp_state(params, opt, mesh) -> dict:
    """``init_dp_state``'s state from given params (the reference's)."""
    from repro_torch.dist.elastic import place
    from repro_torch.train.train_step import add_error_feedback

    return add_error_feedback(place({"params": params, "opt": opt.init(params)}, mesh), mesh)


def dp_losses(arch: str, params_np, planes: int, mesh):
    """``DP_STEPS`` steps of ``make_dp_train_step`` from the given params at
    8 bits -> (losses, grad norms, max |ef| on this rank, ef dtypes)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.quant.qat import bits_assignment, bits_to_device, policy_for
    from repro_torch.train.train_step import make_dp_train_step

    cfg = f32_smoke(arch)
    model = build_model(cfg)
    opt = AdamW(lr=DP_LR)
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 8)), "cpu")
    state = dp_state(params_from_numpy(params_np, "cpu"), opt, mesh)
    step = make_dp_train_step(model, opt, mesh, planes=planes)
    data = SyntheticLMData(seed=0, global_batch=DP_BATCH, seq_len=DP_SEQ, vocab=cfg.vocab_size)
    losses, norms = [], []
    for _ in range(DP_STEPS):
        state, m = step(state, data.next(), bm)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    ef = [e.to_local() for e in tree_leaves(state["ef"])]
    return (losses, norms, max(float(e.abs().max()) for e in ef),
            sorted({str(e.dtype) for e in ef}))


def launcher_run(argv, cfg, steps):
    """``launch/train.py``'s ``setup`` on ``argv`` at config ``cfg``, run
    ``steps`` steps -> (losses, the run's parts)."""
    from repro_torch.launch import train

    run = train.setup(train.parse_args(argv), cfg)
    run["state"] = run["trainer"].run(run["state"], steps)
    return [h["loss"] for h in run["trainer"].history], run


def forced_steps(arch: str, states, planes: int, mesh):
    """Each of ``DP_STEPS`` steps from the reference's state before it (its
    params, moments and this rank's ``ef`` row) -> (losses, grad norms,
    max |ef| after the last)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist.elastic import local_slice
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.quant.qat import bits_assignment, bits_to_device, policy_for
    from repro_torch.train.train_step import make_dp_train_step

    cfg = f32_smoke(arch)
    model = build_model(cfg)
    opt = AdamW(lr=DP_LR)
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 8)), "cpu")
    step = make_dp_train_step(model, opt, mesh, planes=planes)
    data = SyntheticLMData(seed=0, global_batch=DP_BATCH, seq_len=DP_SEQ, vocab=cfg.vocab_size)
    rank = dist.get_rank()
    losses, norms = [], []
    for ref in states:
        state = dp_state(params_from_numpy(ref["params"], "cpu"), opt, mesh)
        for key in ("m", "v"):
            for got, want in zip(tree_leaves(state["opt"][key]), tree_leaves(ref["opt"][key])):
                got.to_local().copy_(local_slice(torch.from_numpy(np.asarray(want)), mesh,
                                                 got.placements))
        state["opt"]["step"] = int(ref["opt"]["step"])
        for got, want in zip(tree_leaves(state["ef"]), tree_leaves(ref["ef"])):
            got.to_local().copy_(torch.from_numpy(np.asarray(want)[rank:rank + 1]))
        state, m = step(state, data.next(), bm)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, max(float(e.to_local().abs().max()) for e in tree_leaves(state["ef"]))


def _wait_for(path: str, timeout: float = 600.0):
    import time

    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(path)
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def dp(rank, world, workdir, params, refs):
    """At 2 ranks: ``launch/train.py --mesh 2,1 --ckpt-dir`` for 3 steps,
    its checkpoint kept for :func:`elastic`; the DP step from the
    reference's params (glm4-9b at planes 2 and 0, moonshot at planes 2)
    for ``DP_STEPS`` steps; then each step again from the reference's state
    before it, once the reference's run (``refs``) has written it."""
    out = {}
    out["launcher"], run = launcher_run(
        ["--device", "cpu", "--arch", "glm4-9b", "--steps", "3", "--mesh", f"{world},1",
         "--ckpt-dir", os.path.join(workdir, "ckpt")], f32_smoke("glm4-9b"), 3)
    mesh = run["mesh"]
    with open(params, "rb") as f:
        trees = pickle.load(f)
    for case in refs:
        out[case] = dp_losses(case[0], trees[case[0]], case[1], mesh)
    for case, path in refs.items():
        out[("forced",) + case] = forced_steps(case[0], _wait_for(path)["states"], case[1], mesh)
    return out


def elastic(rank, world, workdir):
    """At 4 ranks: restore the 2-rank checkpoint onto meshes (4, 1) and
    (2, 2), each local shard against the saved leaf's slice, bit for bit;
    then the launcher at ``--mesh 4,1`` resumes it through ``Trainer(mesh=)``
    for 2 more steps."""
    from torch.distributed.tensor import DTensor

    from repro_torch import ckpt as ckpt_lib
    from repro_torch.dist import elastic as el
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh

    directory = os.path.join(workdir, "ckpt")
    saved, _, saved_step = ckpt_lib.restore(directory, device="cpu")
    argv = ["--device", "cpu", "--arch", "glm4-9b", "--steps", "5", "--mesh", f"{world},1",
            "--ckpt-dir", directory]
    from repro_torch.launch import train

    run = train.setup(train.parse_args(argv), f32_smoke("glm4-9b"))
    out = {"step": saved_step}
    for shape in ((world, 1), (2, world // 2)):
        if shape == (world, 1):     # the template's own placements
            mesh, like = run["mesh"], run["state"]
        else:                       # placements from the rule table
            mesh, like = make_host_mesh(shape, device="cpu"), _plain(run["state"])
        restored, _, step = el.restore_elastic(directory, like, mesh)
        bad, sharded, n = [], 0, 0
        for (names, got), (_, want) in zip(shd.named_leaves(restored), shd.named_leaves(saved)):
            if not isinstance(got, DTensor):
                if got != want:
                    bad.append("/".join(names))
                continue
            n += 1
            local = got.to_local()
            expect = el.local_slice(want, mesh, got.placements)
            sharded += local.numel() < want.numel()
            if not _same_bits(local, expect):
                bad.append("/".join(names))
        out[shape] = {"step": step, "bad": bad, "leaves": n, "sharded": sharded}
    losses, run = launcher_run(argv, f32_smoke("glm4-9b"), 5)
    out["resumed"] = losses
    return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(view), b.contiguous().view(view)))


def _plain(state):
    """A placed state's leaves as whole plain tensors (a template that
    carries no placements of its own)."""
    from repro_torch.dist import elastic as el
    from repro_torch.dist import sharding as shd

    return shd.map_tree(lambda _, x: el.whole(x), state)


# ---- the tensor- and expert-parallel step ----------------------------------------------
def tp_config(case: dict):
    """A case's smoke config: ``arch`` at ``dtype``, with ``vocab`` and
    ``cf`` (capacity factor) replaced where given."""
    import dataclasses

    from repro_torch.configs import get_config

    kw = {"dtype": case["dtype"]}
    if case.get("vocab"):
        kw["vocab_size"] = case["vocab"]
    if case.get("cf"):
        kw["capacity_factor"] = case["cf"]
    return dataclasses.replace(get_config(case["arch"], smoke=True), **kw)


def from_reference(model, tree):
    """The reference's params (numpy, every leaf f32) as the port's, each
    leaf in the dtype the port's own init gives it."""
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten

    template = model.init(0, device="cpu")
    flat = tree_leaves(tree)
    return tree_unflatten(template, [torch.from_numpy(np.array(a)).to(t.dtype)
                                     for t, a in zip(tree_leaves(template), flat)])


_MESHES: dict = {}


def tp_mesh(shape, world: int):
    """A mesh of ``shape`` in a world of ``world`` ranks: the world's own
    ``("data", "model")`` mesh, or a (1, 2) or (2, 1) case as a "model" or
    "data" row of the world's (world / 2, 2) mesh (every row runs the same
    case).  Made once a shape."""
    from repro_torch.launch.mesh import make_host_mesh

    shape = tuple(shape)
    if math.prod(shape) == world:
        key = shape
    else:
        key = (world // 2, 2)
    if key not in _MESHES:
        _MESHES[key] = make_host_mesh(key, device="cpu")
    mesh = _MESHES[key]
    if key == shape:
        return mesh
    return mesh["model"] if shape == (1, 2) else mesh["data"]


def shard_slices(mesh, placements, ndim: int) -> list:
    """The [start, stop) of each dim that this rank's shard covers."""
    from torch.distributed.tensor import Shard

    out = [None] * ndim
    for md, pl in enumerate(placements):
        if isinstance(pl, Shard) and mesh.size(md) > 1:
            n, c = mesh.size(md), mesh.get_local_rank(md)
            out[pl.dim] = (n, c) if out[pl.dim] is None else (out[pl.dim][0] * n,
                                                              out[pl.dim][1] * n + c)
    return out


def tp_case(case: dict, tree, batch, world: int) -> dict:
    """One step's loss, metrics, global norm and this rank's stored-shard
    gradients (with the part of the whole leaf each covers) of
    ``make_tp_train_step`` from the reference's params."""
    from repro_torch.dist.elastic import place
    from repro_torch.dist.sharding import named_leaves
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.quant.qat import bits_assignment, bits_to_device, policy_for
    from repro_torch.train.train_step import make_tp_train_step

    model = build_model(tp_config(case))
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 8)), "cpu")
    mesh = tp_mesh(case["shape"], world)
    params = place(from_reference(model, tree), mesh)
    step = make_tp_train_step(model, AdamW(lr=DP_LR), mesh, remat=case["remat"])
    means, grads, norm = step.grads(params, batch, bm)
    out = {k: float(v) for k, v in means.items()}
    out["norm"], out["kv_cols"] = float(norm), step.tp.kv_cols
    out["grads"] = [("/".join(names), shard_slices(mesh, t.placements, t.ndim), _np(g))
                    for (names, t), g in zip(named_leaves(params), grads)]
    return out


def tp_four(rank, world, workdir, params, cases, launch_steps):
    """At 4 ranks: every case of ``cases`` (a (1, 2) case on the world's
    two model rows, a (2, 1) case on its data columns); then
    ``launch/train.py`` at ``--mesh 2,2`` for glm4-9b (``--ckpt-dir``) and
    moonshot, and at ``--mesh 4,1`` for moonshot; the glm4 checkpoint
    restored onto (4, 1) through ``Trainer(mesh=)`` (:func:`elastic`'s
    check)."""
    with open(params, "rb") as f:
        data = pickle.load(f)
    out = {c["name"]: tp_case(c, data["params"][c["params"]], data["batch"][c.get("vocab") or 0],
                              world) for c in cases}
    ck = os.path.join(workdir, "tp_ckpt")
    runs = {"glm4 2,2": ("glm4-9b", "2,2", ["--ckpt-dir", ck]),
            "moonshot 2,2": ("moonshot-v1-16b-a3b", "2,2", []),
            "moonshot 4,1": ("moonshot-v1-16b-a3b", "4,1", [])}
    for key, (arch, mesh, extra) in runs.items():
        argv = ["--device", "cpu", "--arch", arch, "--steps", str(launch_steps), "--mesh", mesh,
                "--global-batch", "4", "--seq-len", "16", *extra]
        losses, run = launcher_run(argv, f32_smoke(arch), launch_steps)
        out[key] = {"losses": losses, "tp": hasattr(run["step_fn"], "tp")}
    out["restored"] = restore_check(ck, "glm4-9b", (world, 1))
    return out


def restore_check(directory: str, arch: str, shape) -> dict:
    """The newest checkpoint in ``directory`` restored onto a ``shape``
    mesh through ``Trainer(mesh=)``: which leaves differ from the saved
    slice, bit for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch import ckpt as ckpt_lib
    from repro_torch.dist import elastic as el
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import train

    saved, _, saved_step = ckpt_lib.restore(directory, device="cpu")
    argv = ["--device", "cpu", "--arch", arch, "--steps", str(saved_step), "--mesh",
            ",".join(map(str, shape)), "--global-batch", "4", "--seq-len", "16",
            "--ckpt-dir", directory]
    run = train.setup(train.parse_args(argv), f32_smoke(arch))
    restored, step = run["trainer"].try_restore(run["state"])
    bad, n = [], 0
    for (names, got), (_, want) in zip(shd.named_leaves(restored), shd.named_leaves(saved)):
        if isinstance(got, DTensor):
            n += 1
            if not _same_bits(got.to_local(),
                              el.local_slice(want, run["mesh"], got.placements)):
                bad.append("/".join(names))
        elif got != want:
            bad.append("/".join(names))
    return {"step": step, "saved_step": saved_step, "bad": bad, "leaves": n}


def tp_eight(rank, world, workdir, params, moe_inputs, steps, cases):
    """At 8 ranks on a (2, 4) mesh: moonshot smoke (bf16) trained ``steps``
    steps on one batch by ``make_tp_train_step`` from the reference's
    params (the twin of the reference's small-mesh train step); the
    expert-parallel MoE layer against the meshless one
    (``moe_inputs``); the split per-column QDQ of every quant-group
    leaf of glm4-9b and moonshot smoke (and a vocab-256 embed) on its
    stored shard, against the whole leaf's; and every case of ``cases``
    (:func:`tp_case`)."""
    from repro_torch.dist.elastic import place
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.quant.qat import bits_assignment, bits_to_device, policy_for
    from repro_torch.train.train_step import make_tp_train_step

    with open(params, "rb") as f:
        data = pickle.load(f)
    mesh = tp_mesh((2, 4), world)
    out = {c["name"]: tp_case(c, data["params"][c["params"]], data["batch"][c.get("vocab") or 0],
                              world) for c in cases}
    case = {"arch": "moonshot-v1-16b-a3b", "dtype": "bfloat16"}
    model = build_model(tp_config(case))
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 8)), "cpu")
    opt = AdamW(lr=1e-3)
    params_t = from_reference(model, data["params"]["moonshot-v1-16b-a3b"])
    state = place({"params": params_t, "opt": opt.init(params_t)}, mesh)
    step = make_tp_train_step(model, opt, mesh, remat="full")
    losses = []
    for _ in range(steps):
        state, m = step(state, data["batch"][0], bm)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    out["moe_ep"] = moe_ep_case(mesh, np.load(moe_inputs))
    out["qdq"] = {arch: split_qdq_case(mesh, arch, vocab)
                  for arch, vocab in (("glm4-9b", 256), ("moonshot-v1-16b-a3b", None))}
    return out


def moe_ep_case(mesh, inp) -> dict:
    """``models.moe.moe_ep`` (no drops) on this data rank's rows and this
    model rank's experts against the meshless ``moe_ffn`` on the whole
    batch: the largest difference on the rank's rows."""
    from repro_torch.dist import tp as tpm
    from repro_torch.models import moe

    x = torch.from_numpy(inp["x"])
    p = {k: torch.from_numpy(inp[k]) for k in ("router", "wg", "wu", "wd")}
    y_ref, _ = moe.moe_ffn(x, p, k=int(inp["k"]), no_drop=True)
    cfg = f32_smoke("moonshot-v1-16b-a3b")
    import dataclasses

    cfg = dataclasses.replace(cfg, num_experts=p["wg"].shape[0], d_ff=p["wg"].shape[2],
                              d_model=p["wg"].shape[1])
    tp = tpm.TensorParallel(cfg, mesh)
    rows = slice(tp.drank * x.shape[0] // tp.d, (tp.drank + 1) * x.shape[0] // tp.d)
    E_loc = p["wg"].shape[0] // tp.m
    local = {k: (v if k == "router" else v[tp.mrank * E_loc:(tp.mrank + 1) * E_loc])
             for k, v in p.items()}
    with tpm.active(tp):
        y, aux = moe.moe_ffn(x[rows], local, k=int(inp["k"]), no_drop=True)
    return {"err": float((y - y_ref[rows]).abs().max()), "aux": float(aux)}


def split_qdq_case(mesh, arch: str, vocab) -> dict:
    """Every quant-group leaf (bf16, bits 2-8 cycling over the groups) on
    its stored shard under the rule table's specs: leaves whose stored
    spec shards the contraction dim take the split QDQ (max pass, max over
    "model", QDQ pass), the rest the one call; forward and STE gradient
    against the whole leaf's, sliced, bit for bit."""
    import dataclasses

    from torch.distributed.tensor import Shard

    from repro_torch.configs import get_config
    from repro_torch.dist import tp as tpm
    from repro_torch.dist.elastic import local_slice, place
    from repro_torch.models import build_model
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.quant.qat import (_paths_index, bits_assignment, bits_to_device,
                                       get_by_path, quantize_params)

    cfg = get_config(arch, smoke=True)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    model = build_model(cfg)
    groups = model.quant_groups()
    policy = QuantPolicy.from_array(tuple(g.name for g in groups),
                                    [2 + i % 7 for i in range(len(groups))])
    bm = bits_to_device(bits_assignment(groups, policy), "cpu")
    whole = model.init(3, device="cpu")
    placed = place(whole, mesh)
    paths = _paths_index(groups)
    model_md = list(mesh.mesh_dim_names).index("model")
    split = set()
    for key in bm:
        t = get_by_path(placed, paths[key])
        pl = t.placements[model_md]
        if isinstance(pl, Shard) and pl.dim == t.ndim - 2:
            split.add(key)
    local = {key: get_by_path(placed, paths[key]).to_local().detach().requires_grad_(True)
             for key in bm}
    tp = tpm.TensorParallel(cfg, mesh)
    from repro_torch.quant.qat import set_by_path

    tree = whole
    for key, t in local.items():
        tree = set_by_path(tree, paths[key], t)
    got = quantize_params(tree, bm, groups, split, tp.max_over_model)
    gen = torch.Generator().manual_seed(7)
    bad, n_split = [], 0
    wleaves = {key: get_by_path(whole, paths[key]).detach().requires_grad_(True) for key in bm}
    wtree = whole
    for key, t in wleaves.items():
        wtree = set_by_path(wtree, paths[key], t)
    want = quantize_params(wtree, bm, groups)
    keys = list(bm)
    placements = {key: get_by_path(placed, paths[key]).placements for key in keys}
    g_whole = {key: torch.randn(wleaves[key].shape, generator=gen).to(wleaves[key].dtype)
               for key in keys}
    q = [get_by_path(got, paths[key]) for key in keys]
    qw = [get_by_path(want, paths[key]) for key in keys]
    gl = torch.autograd.grad(q, [local[key] for key in keys],
                             [local_slice(g_whole[key], mesh, placements[key]) for key in keys])
    gw = torch.autograd.grad(qw, [wleaves[key] for key in keys], [g_whole[key] for key in keys])
    for key, a, aw, g, g_w in zip(keys, q, qw, gl, gw):
        n_split += key in split
        if not (_same_bits(a.detach(), local_slice(aw.detach(), mesh, placements[key]))
                and _same_bits(g, local_slice(g_w, mesh, placements[key]))):
            bad.append(key)
    return {"bad": bad, "split": sorted(split), "leaves": len(bm), "n_split": n_split}


# ---- tensor-parallel prefill and decode, the "pod" axis, the MoE decode fallback ----
SERVE_B, SERVE_S, SERVE_PROMPT, SERVE_STEPS = 2, 16, 8, 4


def _serve_config(arch: str, **kw):
    import dataclasses

    return dataclasses.replace(f32_smoke(arch), **kw)


def _gather_vocab(logits, tp):
    """Logits whose vocab dim is split over "model" gathered whole."""
    from repro_torch.dist import tp as tpm

    return tpm.all_gather(logits.contiguous(), tp.model_group, tp.m, logits.ndim - 1) \
        if tp.vocab else logits


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def prefill_case(mesh, cfg) -> dict:
    """The forward's logits under the tensor-parallel context at ``mesh``,
    the tokens arriving with their sequence split over "model", against the
    one-rank forward on the whole batch: the largest difference relative to
    the largest logit."""
    from repro_torch.dist import tp as tpm
    from repro_torch.dist.elastic import place
    from repro_torch.launch.dryrun import compute_tree
    from repro_torch.models import build_model

    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S)).astype(np.int32))
    with torch.no_grad():
        want, _ = model.forward(params, tokens=tokens)
    tp = tpm.TensorParallel(cfg, mesh, seq_shard=True)
    w = SERVE_S // tp.m
    comp = compute_tree(tp, place(params, mesh))
    with tpm.active(tp), torch.no_grad():
        got, _ = model.forward(comp, tokens=tokens[:, tp.mrank * w:(tp.mrank + 1) * w])
    return {"err": _rel(_gather_vocab(got, tp), want), "kv": tp.kv, "kv_cols": tp.kv_cols,
            "vocab": tp.vocab, "gathers": tpm.stats.calls.get("all_gather", 0)}


def decode_case(mesh, cfg) -> dict:
    """``SERVE_STEPS`` greedy decode steps of packed 4-bit serving params
    after a full-prompt prefill, under the tensor-parallel context at
    ``mesh`` (a contiguous cache of every KV head) against the one-rank
    ``decode_step`` on the same cache: each step's logits (relative to the
    largest) and the cache's K/V after it (largest difference)."""
    from repro_torch.dist import tp as tpm
    from repro_torch.dist.elastic import place
    from repro_torch.launch.dryrun import compute_tree
    from repro_torch.models import build_model
    from repro_torch.quant.qat import policy_for
    from repro_torch.train.serve import quantize_for_serving

    model = build_model(cfg)
    sparams = quantize_for_serving(model, model.init(0, device="cpu"), policy_for(model, 4),
                                   device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)).astype(np.int32))
    with torch.no_grad():
        logits, cache = model.prefill(sparams, tokens=prompt, max_len=SERVE_PROMPT + SERVE_STEPS)
    mine = {k: v.clone() for k, v in cache.items()}
    tp = tpm.TensorParallel(cfg, mesh)
    comp = compute_tree(tp, place(sparams, mesh))
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    errs, kv = [], []
    for _ in range(SERVE_STEPS):
        with torch.no_grad():
            want, cache = model.decode_step(sparams, cache, tok)
        with tpm.active(tp), torch.no_grad():
            got, mine = model.decode_step(comp, mine, tok)
        errs.append(_rel(_gather_vocab(got, tp), want))
        kv.append(max(float((mine[k] - cache[k]).abs().max()) for k in ("k", "v")))
        assert torch.equal(mine["length"], cache["length"])
        tok = want.argmax(-1).to(torch.int32)
    return {"logits": errs, "kv": kv, "heads": tp.heads, "kv_split": tp.kv,
            "kv_cols": tp.kv_cols}


def pod_case(arch: str) -> dict:
    """One tensor-parallel step's loss, metrics and stored-shard gradients
    at a (1, 2) ("data", "model") mesh and at a (1, 1, 2) ("pod", "data",
    "model") one, from the same params and batch: the largest difference."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist.elastic import place
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.quant.qat import bits_assignment, bits_to_device, policy_for
    from repro_torch.train.train_step import make_tp_train_step

    cfg = f32_smoke(arch)
    model = build_model(cfg)
    bm = bits_to_device(bits_assignment(model.quant_groups(), policy_for(model, 8)), "cpu")
    params = model.init(0, device="cpu")
    batch = SyntheticLMData(seed=0, global_batch=4, seq_len=16, vocab=cfg.vocab_size).next()
    got = {}
    for shape, axes in (((1, 2), ("data", "model")), ((1, 1, 2), ("pod", "data", "model"))):
        mesh = make_host_mesh(shape, axes, device="cpu")
        step = make_tp_train_step(model, AdamW(lr=DP_LR), mesh)
        got[len(shape)] = step.grads(place(params, mesh), batch, bm)
    (m2, g2, n2), (m3, g3, n3) = got[2], got[3]
    return {"metrics": max(abs(float(m2[k]) - float(m3[k])) for k in m2),
            "grads": max(float((a - b).abs().max()) for a, b in zip(g2, g3)),
            "norm": abs(float(n2) - float(n3)), "leaves": len(g2)}


def fallback_case(mesh, inp) -> dict:
    """``moe_ep`` at S = 1 (its decode fallback: the tokens whole on both
    model ranks) on this rank's experts: its output and aux loss."""
    import dataclasses

    from repro_torch.dist import tp as tpm
    from repro_torch.models import moe

    x = torch.from_numpy(inp["x"])
    p = {k: torch.from_numpy(inp[k]) for k in ("router", "wg", "wu", "wd")}
    cfg = dataclasses.replace(f32_smoke("moonshot-v1-16b-a3b"), num_experts=p["wg"].shape[0],
                              d_ff=p["wg"].shape[2], d_model=p["wg"].shape[1])
    tp = tpm.TensorParallel(cfg, mesh)
    E_loc = p["wg"].shape[0] // tp.m
    local = {k: (v if k == "router" else v[tp.mrank * E_loc:(tp.mrank + 1) * E_loc])
             for k, v in p.items()}
    with tpm.active(tp), torch.no_grad():
        y, aux = moe.moe_ffn(x, local, k=int(inp["k"]), no_drop=True)
    return {"y": y.numpy(), "aux": float(aux)}


def tp_serve(rank, world, workdir, moe_inputs):
    """At 2 ranks on a (1, 2) mesh: tensor-parallel prefill (glm4 smoke in
    f32: KV heads split; one KV head, its columns split; a vocab of 256,
    split) and decode (the same, and moonshot's MoE decode fallback)
    against one rank; the step at (1, 1, 2) against (1, 2); the fallback
    on the reference's layer inputs."""
    from repro_torch.dist import tp as tpm
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh((1, 2), device="cpu")
    glm, moon = "glm4-9b", "moonshot-v1-16b-a3b"
    cases = {"glm4": _serve_config(glm), "glm4-kv1": _serve_config(glm, num_kv_heads=1),
             "glm4-v256": _serve_config(glm, vocab_size=256)}
    out = {}
    for name, cfg in cases.items():
        tpm.stats.reset()
        out[f"prefill/{name}"] = prefill_case(mesh, cfg)
    for name, cfg in {**cases, "moonshot": _serve_config(moon)}.items():
        out[f"decode/{name}"] = decode_case(mesh, cfg)
    out["pod"] = pod_case(glm)
    out["fallback"] = fallback_case(mesh, np.load(moe_inputs))
    return out


BODIES = {"collectives": collectives, "dp": dp, "elastic": elastic, "tp_four": tp_four,
          "tp_eight": tp_eight, "tp_serve": tp_serve}
