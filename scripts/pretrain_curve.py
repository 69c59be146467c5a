#!/usr/bin/env python3
"""Validation accuracy along a CNN's full-precision pretraining (the
port's ``CNNTask``), measured after every ``--every`` steps.

    PYTHONPATH=src python scripts/pretrain_curve.py --net resnet20 --device cuda
    PYTHONPATH=src python scripts/pretrain_curve.py --net resnet20 --device cpu --batch 32

It shows at which step a network leaves chance level: ``chip_smoke.py``
sizes ResNet-20's pretraining and its accuracy floor from it.  On the
card it runs as ``chip_smoke.py``'s search phases do: f32 without TF32,
deterministic cuDNN algorithms.  On the CPU it uses torch's default
thread count.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.cnn import CNNTask


def main(argv=None) -> list[tuple[int, float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", default="resnet20")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--every", type=int, default=50)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    task = CNNTask(args.net, batch=args.batch, device=args.device)
    where = (torch.cuda.get_device_name(0) if task.device.type == "cuda"
             else f"cpu, {torch.get_num_threads()} threads")
    params, mom = task.params, task.mom
    curve = []
    t0 = time.perf_counter()
    for step in range(args.every, args.steps + 1, args.every):
        params, mom = task.train(args.every, None, params, mom)
        acc = task.accuracy(params)
        curve.append((step, acc))
        print(f"{args.net} on {where}, batch {args.batch}: step {step} accuracy {acc:.4f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return curve


if __name__ == "__main__":
    main()
