#!/usr/bin/env python3
"""One MoE layer's expert FFN at moonshot-v1-16b-a3b's widths (64 experts
top-6, d_model 2048, d_ff 1408 an expert, 4-bit packed banks, bf16
activations, drop-free as served), timed on the card for the port found
under ``--src``: the decode step's shape (4 rows of 1 token) replayed in a
captured CUDA graph, as the graphed decode step runs it, and a 64-token
prefill chunk's shape run eagerly, as the chunk path runs it.

    python3 scripts/moe_layer_time.py [--src DIR] [--label NAME] [--reps 200]

``--src`` (default: this checkout's ``src``) lets one call time two
checkouts of the port, a parent commit unpacked beside the change, with
the same measuring code.  Weights are random from a seed (the work does
not depend on their values).  Times are CUDA-event medians over
``--reps`` runs after warm-up.  Prints the card's name and power limit,
then one JSON line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
E, K_TOP, D, F = 64, 6, 2048, 1408


def _median_ms(torch, fn, reps):
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(Path(args.src).resolve())]
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.quant.pack import Packed, pack_weight

    if not torch.cuda.is_available():
        sys.exit("moe_layer_time: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; port from {args.src}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = {"router": torch.randn((D, E), generator=gen, device="cuda") * D ** -0.5}
    for name, (din, dout) in (("wg", (D, F)), ("wu", (D, F)), ("wd", (F, D))):
        pairs = [pack_weight(torch.randn((din, dout), generator=gen, device="cuda") * din ** -0.5, 4)
                 for _ in range(E)]
        p[name] = Packed(torch.stack([a for a, _ in pairs]), torch.stack([s for _, s in pairs]), 4)
    out = {"label": args.label, "src": args.src, "card": smi}
    for shape, (B, S), graphed in (("decode", (4, 1), True), ("chunk", (1, 64), False)):
        x = (torch.randn((B, S, D), generator=gen, device="cuda")).to(torch.bfloat16)

        def run():
            return moe.moe_ffn(x, p, k=K_TOP, no_drop=True)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                run()
        torch.cuda.current_stream().wait_stream(side)
        ops.reset_counts()
        run()
        torch.cuda.synchronize()
        launches = {k: n for k, n in ops.counts.items() if n}
        if graphed:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                run()
            fn = graph.replay
        else:
            fn = run
        for _ in range(10):
            fn()
        out[shape] = {"rows": B, "tokens": S, "graphed": graphed, "launches": launches,
                      "ms": _median_ms(torch, fn, args.reps)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
