#!/usr/bin/env python3
"""Compare ``chip_smoke.py`` runs from their ``chiprun_out/chip_smoke.json``
files: per serving cell the end-to-end metrics (tokens/s, decode step
p50, time to first token), the traced decode step's device time and idle
share, and the main path's time per kernel.

    python3 scripts/compare_smoke.py parent=a.json change=b.json ...

Each argument is ``label=path``; runs with the same label are listed side
by side in the order given.  Reads files only: no card needed.
"""
from __future__ import annotations

import json
import statistics
import sys


def summary(run: dict) -> dict[str, dict[str, float]]:
    out = {}
    for cell, s in run["serve"].items():
        ttft = [r["ttft_s"] for r in s["requests"]]
        out[cell] = {
            "tokens/s": s["metrics"]["tokens_per_s"],
            "decode step p50 ms": s["metrics"]["decode_step_p50_ms"],
            "TTFT p50 s": statistics.median(ttft),
            "TTFT mean s": statistics.fmean(ttft),
            "TTFT max s": max(ttft),
            "wall s": s["wall_s"],
        }
        br = run["decode_breakdown"].get(cell) or {}
        # runs since the one-token hotpath profile two paths per cell; the
        # default (pipeline) path reads as the older runs' single path
        paths = br if "pipeline" in br else {"pipeline": br}
        for path, b in paths.items():
            tag = "" if path == "pipeline" else f" ({path})"
            out[cell][f"traced step host ms{tag}"] = b.get("step_ms") or float("nan")
            out[cell][f"traced step device ms{tag}"] = b.get("device_ms") or float("nan")
            out[cell][f"traced idle share{tag}"] = b.get("idle_share") or float("nan")
    out["kernels (ms on the main path)"] = {k["name"]: k["ms"] for k in run["per_step"]}
    out["run"] = {"total s": run["total_s"]}
    return out


def main(argv: list[str]) -> None:
    runs = []
    for arg in argv:
        label, path = arg.split("=", 1)
        with open(path) as f:
            runs.append((label, summary(json.load(f))))
    if not runs:
        sys.exit(__doc__)
    print("card:", json.load(open(argv[0].split("=", 1)[1]))["card"])
    labels = [label for label, _ in runs]
    for section in dict.fromkeys(sec for _, r in runs for sec in r):
        print(f"\n{section}")
        print(f"  {'':44s}" + "".join(f"{label:>12s}" for label in labels))
        metrics = dict.fromkeys(m for _, r in runs for m in r.get(section, {}))
        for metric in metrics:
            vals = [r.get(section, {}).get(metric, float("nan")) for _, r in runs]
            print(f"  {metric:44s}" + "".join(f"{v:12.4f}" for v in vals))


if __name__ == "__main__":
    main(sys.argv[1:])
