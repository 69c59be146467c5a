"""How far a model's f32 QAT-free loss gradients lie from the same port
evaluated in float64, on the CPU: the rounding that any f32 evaluation
carries, which bounds how closely two f32 implementations that sum in
other orders can agree.

    PYTHONPATH=src python scripts/grad_conditioning.py [--arch rwkv6-1.6b]

Smoke config, params from ``init(seed 0)``, one batch of 2 x 32 tokens
from the numpy data pipeline; prints max over leaves of
max|g32 - g64| / max|g64|.  The f64 run casts every ``.float()`` and f32
constant of the model to f64 for its duration (this script's own patch;
nothing in the package changes).
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.optim.adamw import tree_leaves, tree_unflatten


def grads(model, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = model.loss(tree_unflatten(params, leaves), batch)
    return torch.autograd.grad(loss, leaves)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_config(args.arch, smoke=True), dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLMData(seed=0, global_batch=2, seq_len=32, vocab=cfg.vocab_size)
             .next().items()}
    g32 = grads(model, params, batch)
    f32, to_float = torch.float32, torch.Tensor.float
    torch.Tensor.float, torch.float32 = torch.Tensor.double, torch.float64
    try:
        m64 = build_model(dataclasses.replace(cfg, dtype="float64"))
        g64 = grads(m64, tree_unflatten(params, [p.double() for p in tree_leaves(params)]),
                    batch)
    finally:
        torch.Tensor.float, torch.float32 = to_float, f32
    err = max(float((a.double() - b).abs().max() / b.abs().max().clamp(min=1e-300))
              for a, b in zip(g32, g64))
    print(f"{args.arch}: f32 gradients within {err:.3e} of f64 (max over leaves, relative "
          f"to each leaf's largest)")
    return err


if __name__ == "__main__":
    np.set_printoptions(precision=4)
    main()
