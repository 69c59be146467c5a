"""Print the dry run's records (``python -m repro_torch.launch.dryrun
--all``, ``--all --profile tp``) as a markdown table, one row an (arch,
shape, profile) with its ``pod`` and ``multipod`` records side by side
("pod / multipod"): a rank's peak GB, ``fits_hbm``, the three roofline
terms in ms (compute / memory / collective), the bottleneck, each
collective kind's count and MB; then the skipped cells, grouped by
reason.  Counts at one H100's data-sheet rates, not measurements.

    python scripts/dryrun_table.py [DIR]      # DIR: dryrun_out/ by default
"""
import collections
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("pod", "multipod")


def _coll(rec) -> dict:
    """{kind: (count, MB)} of a record's collectives."""
    return {k: (rec["coll_count_by_kind"][k], f"{b / 1e6:.0f}")
            for k, b in sorted(rec["coll_bytes_by_kind"].items())}


def main() -> None:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "dryrun_out")
    cells, skipped = collections.defaultdict(dict), collections.defaultdict(set)
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if "shape" not in rec:
            continue
        if rec["status"] != "ok":
            skipped[rec["reason"]].add(f"{rec['arch']} {rec['shape']}")
            continue
        cells[(rec["arch"], rec["shape"], rec["profile"])][rec["mesh"]] = rec
    print("| Arch | Shape (profile) | Peak GB a rank | fits_hbm | Compute / memory / collective ms "
          "| Bottleneck | Collectives: count, MB |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for (arch, shape, profile), by in sorted(cells.items()):
        recs = [by[m] for m in MESHES if m in by]
        peak = " / ".join(f"{r['memory']['peak_bytes'] / 1e9:.2f}" for r in recs)
        fits = " / ".join(str(r["fits_hbm"]) for r in recs)
        terms = " · ".join(" / ".join(f"{r['roofline'][t] * 1e3:.1f}" for t in
                                      ("t_compute", "t_memory", "t_collective")) for r in recs)
        neck = " / ".join(sorted({r["roofline"]["bottleneck"] for r in recs}))
        colls = [_coll(r) for r in recs]
        kinds = ", ".join(f"{k} {colls[0][k][0]}x " + " / ".join(c[k][1] for c in colls if k in c)
                          for k in colls[0])
        print(f"| {arch} | {shape} ({profile}) | {peak} | {fits} | {terms} | {neck} | {kinds} |")
    for reason, names in skipped.items():
        print(f"\nskipped ({len(names)} arch x shape, both meshes): {reason}: "
              f"{', '.join(sorted(names))}")
    n = sum(len(by) for by in cells.values())
    print(f"\n{n} records")


if __name__ == "__main__":
    main()
