#!/usr/bin/env python3
"""Phase 2's rows of the paged kernels (rows 2, 3 and 4 of ``PERF.md``
§6) for the port found under ``--src``, so that one call can time two
checkouts of the port on one card with the same measuring code:

    python3 scripts/kernel_rows.py [--src DIR] [--label NAME] [--hd16]
    python3 scripts/kernel_rows.py --compare NAME=FILE NAME=FILE ...

The rows are ``chip_smoke.py``'s (this checkout's): the fp and quantized
paged attention at glm4-9b's shape (KV 2, G 16, hd 128), at hd 120 and G
5 over ring tables, at G 1 / G 7, and the fused decode at glm4-9b's and
moonshot's shapes; ``--hd16`` adds the head-dim-16 rows (a port that has
them).  Each kernel is checked against its plain version as phase 2
checks it.  Prints the card's name and power limit, one line per row,
then one JSON line (also written to ``chiprun_out/kernel_rows_NAME.json``).
``--compare`` reads such files and prints each row's kernel ms side by
side, in the order given (parent, change, change, parent in one call).
Needs a CUDA card, except ``--compare``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def key(row: dict) -> str:
    return f"{row['kernel']} {row.get('container', 'bf16')} {row['shape']}"


def compare(pairs: list[str]) -> None:
    runs = []
    for arg in pairs:
        label, path = arg.split("=", 1)
        runs.append((label, json.loads(Path(path).read_text())))
    print("card:", runs[0][1]["card"])
    print(f"{'row':58s}" + "".join(f"{label:>12s}" for label, _ in runs))
    rows = dict.fromkeys(key(r) for _, run in runs for r in run["rows"])
    for name in rows:
        vals = []
        for _, run in runs:
            ms = [r["ms"] for r in run["rows"] if key(r) == name]
            vals.append(f"{ms[0]:12.4f}" if ms else f"{'-':>12s}")
        print(f"{name:58s}" + "".join(vals))


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--hd16", action="store_true")
    ap.add_argument("--compare", nargs="+", metavar="NAME=FILE")
    args = ap.parse_args(argv)
    if args.compare:
        compare(args.compare)
        return None
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        sys.exit("kernel_rows: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; port from {args.src}")
    build.build_all()
    _, peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    timer = cs.Timer(torch)
    rows: list[dict] = []
    cs.check_paged_attention(torch, timer, peaks, rows)
    cs.check_paged_attention_quant(torch, timer, peaks, rows)
    cs.check_ring_attention(torch, timer, peaks, rows)
    cs.check_ring_attention(torch, timer, peaks, rows, cs.HYMBA_RING, cs.HYMBA_RING_LENGTHS,
                            seed=22)
    cs.check_fused_decode(torch, timer, peaks, rows)
    for tag, heads in cs.MVA_HEADS.items():
        cs.check_ring_attention(torch, timer, peaks, rows, heads,
                                ((f"{tag} lengths", [1, 17, 100, 112]),
                                 (f"{tag} decode", [41, 58, 73, 96])), seed=31)
    cs.check_fused_decode(torch, timer, peaks, rows, shape=(4, 16, 1, 128, 16, 2048),
                          theta=5e4, prefix="g1 ", seed=23)
    if args.hd16:
        cs.check_hd16_kernels(torch, timer, peaks, rows)
    out = {"card": smi, "src": args.src, "label": args.label,
           "rows": [{k: r[k] for k in ("kernel", "shape", "ms", "plain_ms", "library_ms",
                                       "bound_ms", "max_abs_err") if k in r}
                    | {"container": r.get("container", "bf16")} for r in rows]}
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / f"kernel_rows_{args.label}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
