"""Quickstart: ReLeQ end to end on the paper's LeNet; the torch twin of
the reference's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cuda

1. pretrain LeNet (synthetic-learnable MNIST stand-in) in full precision,
2. run the PPO agent over per-layer bitwidths (paper Fig 4 loop), every
   QAT forward quantizing its weights through the fake-quant kernel,
3. long-retrain at the found policy and report accuracy loss + the
   hardware speedups the paper's cost models predict.

The default steps are the reference quickstart's (pretrain 300, 30
episodes with 2 retrain steps each, long retrain 150); the step flags
run it small.  Runs on ``--device cuda`` (default) and fails
without a card; ``--device cpu`` takes the kernels' plain versions.  The
reference's last line, its serving roofline's speedup, prints the same
formula at one NVIDIA H100 SXM's data-sheet rates
(``costmodel.weight_stream_decode_time``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.cnn import CNNTask
from repro_torch.core import costmodel as cm
from repro_torch.core.search import ReLeQSearch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--pretrain-steps", type=int, default=300)
    ap.add_argument("--episodes", type=int, default=30)
    ap.add_argument("--long-retrain-steps", type=int, default=150)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the quickstart and print its report; returns what it printed
    (plus the search record and the wall time of each stage)."""
    args = parse_args(argv)
    wall = {}
    print("== pretraining LeNet (fp32) ==")
    t0 = time.perf_counter()
    task = CNNTask("lenet", seed=0, device=args.device)
    fp_acc = task.pretrain(args.pretrain_steps)
    wall["pretrain_s"] = time.perf_counter() - t0
    print(f"full-precision accuracy: {fp_acc:.3f}")

    print("\n== ReLeQ search (PPO + LSTM agent, per-layer bitwidths) ==")
    t0 = time.perf_counter()
    search = ReLeQSearch(task.make_env_factory(retrain_steps=2), seed=0, device=args.device)
    result = search.run(episodes=args.episodes, log_every=10)
    wall["search_s"] = time.perf_counter() - t0
    bits = result.best_bits
    names = task.names
    avg_bits = float(np.mean([bits[n] for n in names]))
    print("bitwidths:", {n: bits[n] for n in names})
    print(f"average bits: {avg_bits:.2f}")

    print("\n== long retrain at the found policy (paper's final step) ==")
    t0 = time.perf_counter()
    rel = task.long_retrain(bits, steps=args.long_retrain_steps)
    wall["long_retrain_s"] = time.perf_counter() - t0
    print(f"relative accuracy after retrain: {rel:.4f} "
          f"(acc loss {max(0.0, (1 - rel) * 100):.2f}%)")

    vec = [bits[n] for n in names]
    report = {
        "stripes_speedup": cm.speedup_vs_8bit(cm.stripes_time, vec, task.groups),
        "energy_reduction": cm.energy_reduction_vs_8bit(vec, task.groups),
        "tvm_cpu_speedup": cm.speedup_vs_8bit(cm.tvm_cpu_time, vec, task.groups),
        "h100_decode_speedup": cm.speedup_vs_8bit(cm.weight_stream_decode_time, vec,
                                                  task.groups),
    }
    print("\n== hardware benefit (paper cost models) ==")
    print(f"Stripes speedup vs 8-bit : {report['stripes_speedup']:.2f}x")
    print(f"Stripes energy reduction : {report['energy_reduction']:.2f}x")
    print(f"TVM-CPU speedup vs 8-bit : {report['tvm_cpu_speedup']:.2f}x")
    print(f"H100 decode speedup      : {report['h100_decode_speedup']:.2f}x")
    return {"task": task, "fp_acc": fp_acc, "result": result, "bits": bits,
            "avg_bits": avg_bits, "rel_acc": rel, "wall": wall, **report}


if __name__ == "__main__":
    main()
