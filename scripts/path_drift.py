"""How far a served row's logits move between the two ways the engine
computes them, by depth: the prompt prefilled in chunks and the last
tokens fed through the decode step one at a time (a plain decode run),
against every token prefilled in chunks (how a spec verify scores a
window).  Narrow widths, random weights from seed 0, on the CPU:

    PYTHONPATH=src python scripts/path_drift.py [--layers 2 6 12 24]

Prints max|decode path - chunk path| / max|logit| per family, dtype and
depth.  A difference that grows with depth is rounding amplified layer by
layer, not a wrong path (at two layers both paths agree to the bf16
logit bound; ``tests/test_torch_gpu.py`` holds that on the card at the
published widths)."""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

NARROW = {"rwkv6-1.6b": dict(d_model=256, num_heads=4, num_kv_heads=4, d_ff=896),
          "hymba-1.5b": dict(d_model=320, num_heads=5, num_kv_heads=1, d_ff=1088,
                             sliding_window=64)}


def main(argv=None):
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.quant.qat import policy_for
    from repro_torch.train.serve import quantize_for_serving

    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 6, 12, 24])
    ap.add_argument("--decoded", type=int, default=8, help="tokens fed through the decode step")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    toks = np.random.default_rng(0).integers(0, 2000, 50)
    for arch, over in NARROW.items():
        for dtype in ("float32", "bfloat16"):
            for L in args.layers:
                cfg = dataclasses.replace(get_config(arch), num_layers=L, vocab_size=2000,
                                          dtype=dtype, **over)
                model = build_model(cfg)
                sp = quantize_for_serving(model, model.init(seed=0, device="cpu"),
                                          policy_for(model, 4), device="cpu")
                a = chip_smoke.fresh_logits(torch, model, sp, toks, device="cpu",
                                            decoded=args.decoded)
                b = chip_smoke.fresh_logits(torch, model, sp, toks, device="cpu")
                print(f"{arch} {dtype} {L:2d} layers: max|decode - chunk| / max|logit| = "
                      f"{float((a - b).abs().max() / b.abs().max()):.3g}", flush=True)


if __name__ == "__main__":
    main()
