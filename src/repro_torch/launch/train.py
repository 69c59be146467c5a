"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``;
the torch twin of ``repro.launch.train``.

Runs the fault-tolerant QAT training loop (``train/trainer.py``) on the
card, or over ranks (``--mesh``): every step QDQs every quantizable weight
group at its policy bits (one grouped per-column fake-quant launch
forward, one backward; an expert bank's bits one per stacked layer), then
forward + backward + AdamW.  ``--arch`` takes every family the port serves (dense, moe, vlm,
audio, hybrid, ssm); ``--smoke`` (the default) drives the reduced
config, ``--no-smoke`` the published widths.  ``--ckpt-dir`` saves the
state every 50 steps and at the end; ``launch/serve.py --ckpt-dir``
serves its params.  Runs on ``--device cuda``
(default) and fails without a card; ``--device cpu`` takes the kernels'
plain versions.

``--mesh DATA[,MODEL]`` trains over a ``DeviceMesh`` (``launch/mesh.py``:
the ranks ``torchrun`` started, or one), the state placed with
``dist.elastic.place`` under the rule table's specs, and the ``Trainer``
restores elastically onto the mesh.  At ``MODEL > 1``, and for the moe
family at any mesh, the step is ``train_step.make_tp_train_step`` (the
reference's GSPMD step with the ``tp`` profile: tensor-parallel attention
and MLP, vocab-parallel embed and readout, expert-parallel MoE layers whose
capacity and aux loss come from each rank's tokens, as the reference's
``_moe_ep`` computes them on any mesh with a "model" axis); for the other
families at ``MODEL = 1`` it is ``make_dp_train_step(planes=0)`` (the same
step at a model axis of 1: a mean over the global batch, each rank taking
its rows of it).  Not ported (ROADMAP.md queue 1, item 11b-iv): ``MODEL >
1`` for the vlm, audio, hybrid and ssm families, the ``tp_sp`` and
``fsdp`` profiles at ``MODEL > 1``, and ``--opt8`` under the
tensor-parallel step across ranks.  On the card, ranks that outnumber the
cards share them over gloo (``launch/mesh.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --device cpu --steps 3 --mesh 2,1
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --device cpu --steps 3 --mesh 2,2
"""
from __future__ import annotations

import argparse
import math

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.dist import elastic
from repro_torch.dist.tp import refusal
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qat import bits_assignment, bits_to_device, policy_for
from repro_torch.train.train_step import (init_state, make_dp_train_step, make_tp_train_step,
                                          make_train_step, tp_step_refusal)
from repro_torch.train.trainer import Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--bits", type=int, default=8, help="uniform QAT bits")
    ap.add_argument("--policy-json", default=None,
                    help="QuantPolicy JSON from a ReLeQ search")
    ap.add_argument("--opt8", action="store_true", help="8-bit Adam moments")
    ap.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="mesh shape over the ranks, e.g. '2,2': sharded training "
                         "and elastic checkpoint restore")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh:
        args.mesh = tuple(int(x) for x in args.mesh.split(","))
    return args


def tensor_parallel(args, cfg) -> bool:
    """``--mesh`` takes the tensor-parallel step: at MODEL > 1, and for the
    moe family at any mesh."""
    return bool(args.mesh) and (len(args.mesh) > 1 and args.mesh[1] > 1 or cfg.family == "moe")


def make_mesh(args, cfg, device):
    """``--mesh``'s ``DeviceMesh`` (None without the flag); refuses what the
    tensor-parallel step does not take before any process group starts."""
    if not args.mesh:
        return None
    if tensor_parallel(args, cfg):
        err = refusal(cfg, dict(zip(("data", "model"), args.mesh))) or tp_step_refusal(
            AdamW(moments="int8" if args.opt8 else "fp32"), math.prod(args.mesh))
        if err is not None:
            raise err
    return make_host_mesh(args.mesh, ("data", "model")[:len(args.mesh)], device)


def setup(args: argparse.Namespace, cfg=None) -> dict:
    """The run's parts: config (``cfg``, else ``--arch``/``--smoke``),
    model, optimizer, policy and its bits map on the device, data, state,
    step function and trainer."""
    device = resolve_device(args.device)
    cfg = cfg or get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=20, total=args.steps),
                weight_decay=0.1, moments="int8" if args.opt8 else "fp32")
    groups = model.quant_groups(seq_len=args.seq_len)
    if args.policy_json:
        policy = QuantPolicy.from_file(args.policy_json)
    else:
        policy = policy_for(model, default_bits=args.bits)
    bits_map = bits_to_device(bits_assignment(groups, policy), device)
    data = SyntheticLMData(seed=args.seed, global_batch=args.global_batch,
                           seq_len=args.seq_len, vocab=cfg.vocab_size)
    mesh = make_mesh(args, cfg, device)
    state = init_state(model, opt, seed=args.seed, device=device)
    if mesh is None:
        step_fn = make_train_step(model, opt, remat=args.remat)
    else:
        state = elastic.place(state, mesh)
        step_fn = (make_tp_train_step(model, opt, mesh, remat=args.remat)
                   if tensor_parallel(args, cfg)
                   else make_dp_train_step(model, opt, mesh, planes=0, remat=args.remat))
    trainer = Trainer(model=model, optimizer=opt, data=data, step_fn=step_fn,
                      bits_map=bits_map, ckpt_dir=args.ckpt_dir, mesh=mesh)
    return {"cfg": cfg, "model": model, "opt": opt, "policy": policy, "data": data,
            "state": state, "step_fn": step_fn, "trainer": trainer, "mesh": mesh}


def main(argv=None) -> dict:
    """Train and print the log; returns the run's parts (``setup``) with
    the final state and the trainer's history."""
    args = parse_args(argv)
    run = setup(args)
    n = sum(x.numel() for x in tree_leaves(run["state"]["params"]))
    print(f"training {args.arch} ({n/1e6:.1f}M params, QAT "
          f"avg {run['policy'].average_bits():.1f} bits) for {args.steps} steps"
          + (f" on mesh {args.mesh}" if run["mesh"] is not None else ""))
    run["state"] = run["trainer"].run(run["state"], args.steps)
    run["history"] = run["trainer"].history
    return run


if __name__ == "__main__":
    import torch.distributed as dist

    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
