#!/usr/bin/env python3
"""Phase 2's rows of the paged kernels (rows 2, 3 and 4 of ``PERF.md``
§6), of qmm at rwkv6-1.6b's shapes (rows 1 and 1' rwkv) and of the
fake-quant kernels (rows 5', 5'' and 5'' banks) for the port found under
``--src``, so that one call can time two checkouts of the port on one
card with the same measuring code:

    python3 scripts/kernel_rows.py [--src DIR] [--label NAME] [--hd16] [--rwkv-qmm]
                                   [--no-paged] [--rwkv-e2e] [--fq]
    python3 scripts/kernel_rows.py --compare NAME=FILE NAME=FILE ...

The rows are ``chip_smoke.py``'s (this checkout's): the fp and quantized
paged attention at glm4-9b's shape (KV 2, G 16, hd 128), at hd 120 and G
5 over ring tables, at G 1 / G 7, and the fused decode at glm4-9b's and
moonshot's shapes; ``--hd16`` adds the head-dim-16 rows (a port that has
them); ``--rwkv-qmm`` adds both qmm bodies at every rwkv6-1.6b shape
(decode M 4, a 256-token chunk; f32 activations where RWKV feeds them),
and ``--no-paged`` leaves the paged rows out; ``--fq`` adds the flat
fake-quant at every ResNet-20 / LeNet shape (row 5': its sum over one
ResNet-20 forward, beside the empty-kernel launch floor where the port
has one) and the per-column pair at the 4-layer glm4-9b cell and at
moonshot's three expert banks (rows 5'' and 5'' banks, forward and
STE).  Each kernel is checked
against its plain version as phase 2 checks it.  ``--rwkv-e2e`` adds
RWKV end to end as ``chip_smoke.py`` reads it: phase 3o's two mixes
(after one warm-up serve of the first), phase 5o's graphed decode step
and one eager 256-token prefill chunk.  Prints the card's name and power
limit, one line per row, then one JSON line (also written to
``chiprun_out/kernel_rows_NAME.json``).  ``--compare`` reads such files
and prints each row's kernel ms and each end-to-end number side by side,
in the order given (parent, change, change, parent in one call).
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
    if "M" in row:                                  # a qmm row
        return f"{row['kernel']} {row['x_dtype']} {row['shape']} M={row['M']}"
    if "dims" in row:                               # a flat fake-quant row
        return f"{row['kernel']} {row['dtype']} {row['shape']} {tuple(row['dims'])}"
    return f"{row['kernel']} {row.get('container', 'bf16')} {row['shape']}"


def fq_rows(cs, rows) -> dict:
    """Rows 5', 5'' and 5'' banks as PERF.md gives them: 5' summed over
    one ResNet-20 forward (its 20 f32 layers), the per-column pair per QAT
    forward and backward."""
    out = {}
    flat = cs.per_step(rows, "fake_quant", lambda r: r["calls_per_forward"])
    for k in ("ms", "library_ms", "bound_ms"):
        out[f"5' per forward {k}"] = flat[k]
    for r in rows:
        if r["kernel"] == "empty_launch":
            out["5' empty floor, 20 back to back ms"] = r["ms"]
            out["5' empty floor, one launch ms"] = r["one_ms"]
        if r["kernel"].startswith("fake_quant_group_col"):
            tag = ("5'' banks" if "moonshot" in r["shape"] else "5''") + (
                " STE" if r["kernel"].endswith("bwd") else " forward")
            for k in ("ms", "library_ms", "bound_ms"):
                out[f"{tag} {k}"] = r[k]
    return out


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
    e2e = dict.fromkeys(k for _, run in runs for k in run.get("e2e", {}))
    for name in e2e:
        vals = [run.get("e2e", {}).get(name) for _, run in runs]
        print(f"{name:58s}" + "".join(f"{v:12.4f}" if isinstance(v, (int, float)) else
                                      f"{'-':>12s}" for v in vals))


def compat_plans(cs) -> None:
    """A port from before this checkout's plans is timed with the same
    rows: a port from before f32 dequant plans (f32 x on its SIMT body, no
    plan) has its plan read without ``f32``; one from before the
    per-column row blocks has its plan described as a K split over a
    cluster, read twice, and one with no empty kernel its launch floor
    written as not measured (NaN)."""
    import inspect

    from repro_torch.kernels import build
    from repro_torch.kernels import fake_quant as fq
    from repro_torch.kernels import qmm

    if "splits" not in fq.ColPlan._fields:
        cs.col_tiles = lambda plan: f"K split over a cluster of {plan.split}, read twice"
    if not hasattr(build.library("fake_quant"), "fake_quant_empty_launch"):
        nan = float("nan")
        cs.empty_launch_floor = lambda torch, timer, launches: {
            "kernel": "empty_launch", "shape": f"{launches} back to back", "dims": [36, 256],
            "dtype": "-", "launches": launches, "ms": nan, "one_ms": nan}
    if "f32" in inspect.signature(qmm.dequant_plan).parameters:
        return

    def plan(path, M, K, N, bits, f32):
        if path == "bitserial":
            return qmm.bitserial_plan(M, K, N, bits)
        return None if f32 else qmm.dequant_plan(M, K, N, bits)

    cs.qmm_plan = plan


def rwkv_e2e(torch, cs) -> dict:
    """rwkv6-1.6b at its published widths, 4-bit weights: phase 3o's two
    mixes served once each after a warm-up serve of the first, 5o's
    profiled graphed decode step and one eager 256-token chunk."""
    need, flags = ("qmm_bitserial", "qmm_dequant"), ["--bits", "4"]
    warm = cs.serve_path(torch, "rwkv warm-up", flags, need, arch=cs.RWKV_ARCH, forbid=cs.PAGED)
    built = tuple(warm[k] for k in ("cfg", "model", "sparams", "policy"))
    del warm
    short = cs.serve_path(torch, "rwkv short", flags, need, built, arch=cs.RWKV_ARCH,
                          forbid=cs.PAGED)
    long = cs.serve_path(torch, "rwkv long", flags, need, built, base=cs.DANUBE,
                         arch=cs.RWKV_ARCH, forbid=cs.PAGED)
    step = cs.profile_decode(torch, short["engine"], short["work"])
    chunk = cs.recurrent_chunk_ms(torch, long, reps=5)
    print(f"  [rwkv] {chunk['chunk']}-token prefill chunk: {chunk['host_ms']:.2f} ms host"
          + (f", {chunk['busy_ms']:.2f} ms busy, qmm {chunk['qmm_ms']:.2f}"
             if chunk["busy_ms"] else ""))
    out = {}
    for mix, r in (("3o", short), ("3o long", long)):
        summary = cs.cell_summary(r)
        for k in ("tokens_per_s", "decode_step_p50_ms", "ttft_p50_s"):
            out[f"{mix} {k}"] = summary[k]
    out |= {"5o step_ms": step["step_ms"], "5o busy_ms": step.get("device_ms"),
            "5o qmm_ms": step.get("families_ms", {}).get("qmm"),
            "chunk host_ms": chunk["host_ms"], "chunk busy_ms": chunk["busy_ms"],
            "chunk qmm_ms": chunk["qmm_ms"]}
    return out


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--hd16", action="store_true")
    ap.add_argument("--rwkv-qmm", action="store_true")
    ap.add_argument("--no-paged", action="store_true")
    ap.add_argument("--rwkv-e2e", action="store_true")
    ap.add_argument("--fq", action="store_true")
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
    if args.no_paged and not (args.hd16 or args.rwkv_qmm or args.rwkv_e2e):
        build.library("fake_quant")              # the fake-quant rows alone
    else:
        build.build_all()
    compat_plans(cs)
    _, peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    timer = cs.Timer(torch)
    rows: list[dict] = []
    if not args.no_paged:
        cs.check_paged_attention(torch, timer, peaks, rows)
        cs.check_paged_attention_quant(torch, timer, peaks, rows)
        cs.check_ring_attention(torch, timer, peaks, rows)
        cs.check_ring_attention(torch, timer, peaks, rows, cs.HYMBA_RING,
                                cs.HYMBA_RING_LENGTHS, seed=22)
        cs.check_fused_decode(torch, timer, peaks, rows)
        for tag, heads in cs.MVA_HEADS.items():
            cs.check_ring_attention(torch, timer, peaks, rows, heads,
                                    ((f"{tag} lengths", [1, 17, 100, 112]),
                                     (f"{tag} decode", [41, 58, 73, 96])), seed=31)
        cs.check_fused_decode(torch, timer, peaks, rows, shape=(4, 16, 1, 128, 16, 2048),
                              theta=5e4, prefix="g1 ", seed=23)
    if args.hd16:
        cs.check_hd16_kernels(torch, timer, peaks, rows)
    if args.rwkv_qmm:
        cs.check_qmm(torch, timer, peaks, rows, cs.RWKV_QMM, cs.RECURRENT_MS, seed=4)
    if args.fq:
        cs.check_fake_quant(torch, timer, peaks, rows)
        cs.check_fake_quant_col(torch, timer, peaks, rows)
        cs.check_fake_quant_col_banks(torch, timer, peaks, rows)
    out = {"card": smi, "src": args.src, "label": args.label,
           "rows": [{k: r[k] for k in ("kernel", "shape", "M", "x_dtype", "dims", "dtype", "ms",
                                       "plain_ms", "library_ms", "bound_ms", "bound_3term_ms",
                                       "bound_simt_ms", "max_abs_err") if k in r}
                    | {"container": r.get("container", "bf16")} for r in rows], "e2e": {}}
    if args.fq:
        out["e2e"] |= fq_rows(cs, rows)
    if args.rwkv_e2e:
        out["e2e"] |= rwkv_e2e(torch, cs)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / f"kernel_rows_{args.label}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
