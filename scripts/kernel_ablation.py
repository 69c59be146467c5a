#!/usr/bin/env python3
"""Where the time of the two redesigned kernels goes, on the card.

    python3 scripts/kernel_ablation.py

1. qmm dequant (bf16 x, M = 64, 4-bit, glm4-9b's wq and wg shapes): the
   kernel as built, and copies of ``csrc/qmm.cu`` with parts of its K loop
   taken out -- the loads of later K steps (``noload``), the decode of the
   plane bytes (``nodecode``: constant A fragments) and the wgmma (``nomma``)
   -- alone and in pairs.  What is left of a call with only one part in
   its loop says how long that part takes without the others.
2. The same kernel over launch plans other than ``dequant_plan``'s:
   warpgroups per CTA and K splits (``qmm_launch`` takes them as data).
3. fp paged attention (B=4, KV=2, G=16, hd=128, bs=16, lengths {41, 58,
   73, 96}): the kernel, and copies without the split combine
   (``nocombine``), without the score and P.V loop (``nocompute``), both,
   and one that returns at once (``empty``: launch and scheduling).

Times: CUDA events per call (L2 flushed, ``chip_smoke.Timer``) and the
kernels' device time from ``torch.profiler``.  The copies are built with
the package's nvcc flags into ``src/repro_torch/_build/ablation``.  The
card's name and power limit are printed first.  Needs an sm_90 card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.paged_attention import arrival_counters  # noqa: E402
from repro_torch.kernels.qmm import dequant_plan, dequant_smem  # noqa: E402
from repro_torch.quant.pack import pack_weight  # noqa: E402

OUT = ROOT / "src" / "repro_torch" / "_build" / "ablation"

QMM_CUTS = {
    "NOLOAD": ("    if (nx < n) tc_load<NT, BITS>(ring + (nx % TC_STAGES) * S::SLOT, g, c0 + nx * kg, r128);",
               ""),
    "NODECODE": ("    for (int kk = 0; kk < 4; ++kk) tc_frag<BITS>(a[kk], slot + S::X_BYTES, kk, col, sh);",
                 "    for (int kk = 0; kk < 4; ++kk)\n        for (int q = 0; q < 4; ++q) "
                 "a[kk][q] = 0x3F803F80u + i;"),
    "NOMMA": ("    for (int kk = 0; kk < 4; ++kk) wg::Wgmma<NT>::run(acc, a[kk], desc + 2 * kk);",
              "    for (int kk = 0; kk < 4; ++kk)\n        acc[kk] += __uint_as_float(a[kk][0] ^ a[kk][1]"
              " ^ a[kk][2] ^ a[kk][3]) + (float)desc;"),
}
QMM_VARIANTS = {"full": (), "noload": ("NOLOAD",), "nodecode": ("NODECODE",),
                "nomma": ("NOMMA",), "only loads": ("NODECODE", "NOMMA"),
                "only decode": ("NOLOAD", "NOMMA"), "only wgmma": ("NOLOAD", "NODECODE")}
PA_CUTS = {
    "EMPTY": ("    const size_t bk = (size_t)b * KV + kvh;\n",
              "    const size_t bk = (size_t)b * KV + kvh;\n    if (b >= 0) return;\n"),
    "NOCOMBINE": ("    if (S > 1 && splitkv::arrive_last(arrived + bk, S))", "    if (false)"),
    "NOCOMPUTE": ("    for (int it = 0; it < ntiles; ++it) {",
                  "    wg::cp_async_wait<0>();\n    __syncthreads();\n"
                  "    for (int it = 0; it < 0; ++it) {"),
}
PA_VARIANTS = {"full": (), "nocombine": ("NOCOMBINE",), "nocompute": ("NOCOMPUTE",),
               "nocompute+nocombine": ("NOCOMPUTE", "NOCOMBINE"), "empty": ("EMPTY",)}


def patched(source: str, cuts: dict, names, tag: str) -> Path:
    text = (build.CSRC / source).read_text()
    for name in names:
        old, new = cuts[name]
        if old not in text:
            sys.exit(f"kernel_ablation: csrc/{source} no longer holds the line cut by {name}")
        text = text.replace(old, new)
    text = text.replace('#include "', f'#include "{build.CSRC}/')
    path = OUT / f"{tag}.cu"
    path.write_text(text)
    return path


def build_all(jobs: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {tag: subprocess.Popen([build._nvcc(), *flags, "-o", str(OUT / f"lib{tag}.so"), str(src)])
             for tag, src in jobs.items()}
    for tag, proc in procs.items():
        if proc.wait() != 0:
            sys.exit(f"kernel_ablation: nvcc failed for {tag}")
    return {tag: ctypes.CDLL(str(OUT / f"lib{tag}.so")) for tag in jobs}


def device_ms(timer, fn, key: str) -> float:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages() if key in e.key) / 10 / 1e3


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("kernel_ablation: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {f"qmm_{v}": patched("qmm.cu", QMM_CUTS, cuts, f"qmm_{v.replace(' ', '_')}")
            for v, cuts in QMM_VARIANTS.items()}
    jobs.update({f"pa_{v}": patched("paged_attention.cu", PA_CUTS, cuts,
                                    f"pa_{v.replace('+', '_')}")
                 for v, cuts in PA_VARIANTS.items()})
    libs = build_all(jobs)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    timer = cs.Timer(torch)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)

    print("qmm dequant, M=64, 4-bit: events ms / device ms per call")
    shapes = {}
    for name, K, N in (("wq", 4096, 4096), ("wg", 4096, 13696)):
        planes, scale = pack_weight(torch.randn((K, N), generator=gen, device="cuda"), 4)
        x = torch.randn((64, K), generator=gen, device="cuda").to(torch.bfloat16)
        shapes[name] = (x, planes, scale, K, N)

    def qmm_call(lib, x, planes, scale, K, N, kgroups, splits):
        y = torch.empty((64, N), device="cuda")
        ws = torch.empty((splits, 64, N), device="cuda")
        return lambda: lib.qmm_launch(x.data_ptr(), 1, planes.data_ptr(), scale.data_ptr(),
                                      y.data_ptr(), ws.data_ptr(), 64, K, N, 4, 1, 64, kgroups,
                                      splits, stream)

    for variant in QMM_VARIANTS:
        lib = libs[f"qmm_{variant}"]
        lib.qmm_launch.argtypes = [P, I, P, P, P, P] + [I] * 8 + [P]
        cells = []
        for name, (x, planes, scale, K, N) in shapes.items():
            plan = dequant_plan(64, K, N)
            fn = qmm_call(lib, x, planes, scale, K, N, plan.kgroups, plan.splits)
            cells.append(f"{name} {timer(fn):.4f} / {device_ms(timer, fn, 'qmm'):.4f}")
        print(f"  {variant:12s} " + "   ".join(cells), flush=True)

    print("qmm dequant, M=64, 4-bit, launch plans (warpgroups kg, K splits s): events ms")
    lib = libs["qmm_full"]
    for name, (x, planes, scale, K, N) in shapes.items():
        plan = dequant_plan(64, K, N)
        cells = []
        for kg in (1, 2, 4):
            if dequant_smem(64, 4, kg) > 232448:
                continue
            tiles = -(-N // 64)
            for target in (132, 264, 528):
                splits = max(1, min(plan.chunks, -(-target // tiles)))
                fn = qmm_call(lib, x, planes, scale, K, N, kg, splits)
                mark = "*" if (kg, splits) == (plan.kgroups, plan.splits) else ""
                cells.append(f"kg{kg}/s{splits}{mark} {timer(fn):.4f}")
        print(f"  {name}: " + "  ".join(cells), flush=True)

    print("fp paged attention, main lengths {41, 58, 73, 96}: events ms / device ms per call")
    B, KV, G, hd, bs, nb = 4, 2, 16, 128, 16, 6
    NB = B * nb + 1
    q = torch.randn((B, KV, G, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn((NB, bs, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn((NB, bs, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
    bt = (torch.randperm(NB - 1, generator=torch.Generator().manual_seed(0))[:B * nb] + 1)
    bt = bt.reshape(B, nb).to("cuda", torch.int32)
    ln = torch.tensor([41, 58, 73, 96], dtype=torch.int32, device="cuda")
    out = torch.empty((B, KV, G, hd), device="cuda")
    ws = torch.empty(B * KV * 16 * G * (hd + 2), device="cuda")
    arrived = arrival_counters(torch.device("cuda", torch.cuda.current_device()), B * KV)
    for variant in PA_VARIANTS:
        lib = libs[f"pa_{variant}"]
        lib.paged_attention_launch.argtypes = [P] * 8 + [I] * 8 + [F, P]
        cells = []
        for pps in (1, 2, nb):
            fn = (lambda pps=pps: lib.paged_attention_launch(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(), ln.data_ptr(),
                out.data_ptr(), ws.data_ptr(), arrived.data_ptr(), 1, B, KV, G, hd, bs, nb, pps,
                hd ** -0.5, stream))
            cells.append(f"{-(-nb // pps)} splits {timer(fn):.4f} / "
                         f"{device_ms(timer, fn, 'paged'):.4f}")
        print(f"  {variant:20s} " + "   ".join(cells), flush=True)


if __name__ == "__main__":
    main()
