#!/usr/bin/env python3
"""Where a ResNet-20 QAT train step's time goes on the card, for the port
found under ``--src``: the host-clock step time, the device time and
launches per kernel family, and the runtime calls per step that can
block the host (stream and device syncs, memcpys).

    python3 scripts/qat_step_profile.py [--src DIR] [--label NAME]

``--src`` (default: this checkout's ``src``) lets one call profile two
checkouts of the port, a parent commit unpacked beside the change, with
the same measuring code: ``chip_smoke.profile_qat_step`` of this
checkout (phase 5e), at its mixed policy, batch 128, from randomly
initialised weights (a step's work does not depend on their values).
Runs as phase 5e does: f32 without TF32, deterministic cuDNN.  Prints the
card's name and power limit, then one JSON line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.cnn import CNNTask

    if not torch.cuda.is_available():
        sys.exit("qat_step_profile: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; port from {args.src}")
    task = CNNTask("resnet20", seed=0, device="cuda")
    out = {"label": args.label, "src": args.src, "card": smi,
           **chip_smoke.profile_qat_step(torch, task)}
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
