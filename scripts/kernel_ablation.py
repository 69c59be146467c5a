#!/usr/bin/env python3
"""Where the time of the redesigned kernels goes, on the card.

    python3 scripts/kernel_ablation.py [bitserial] [qmm] [pa] [paq] [fused] [fq] [f32] [col]

(the sections named, all eight by default)

0. qmm bit-serial (``bitserial``; bf16 x, M = 4, glm4-9b's decode shapes:
   wq, wk, wg and wd at 4 bits, the lm_head at 8): the kernel as built, and
   copies of ``csrc/bitserial.cuh`` with parts taken out -- the loads of
   later K steps (``noload``: only the first three steps are staged), the
   code build (``nocode``: constant A fragments, so no plane fragment
   loads and no bit gather either), the mma (``nomma``) and the split
   cluster combine (``nocombine``) -- as "loads only" (nocode + nomma),
   "code build only" (noload + nomma), "products only" (noload + nocode)
   and "no combine"; copies with a deeper ring (6 or 8 slots), 256-K
   steps, or the plane loads without their L2 prefetch hint (whole and
   loads only); then the kernel over other launch plans: warps per CTA
   (column tiles of 16 * warps) x K splits (``qmm_launch`` takes them as
   data).
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
4. Quantized paged attention (``paq``; same shapes, int8 and packed int4):
   the same cuts of ``csrc/paged_attention_quant.cu`` and of the sweep in
   ``csrc/kv_attention.cuh``.
5. The fused decode (``fused``; glm4-9b's 4-bit q|k|v, D = 4096, packed
   int4 pool, lengths {41, 58, 73, 96}): launch (A), the split-K
   projection, at 1, 2, 4 and 8 K splits; launch (B), the attend launch
   on finished projections, whole and with the same cuts; both launches
   at several K and page splits, and at the plan with (B) launched as a
   programmatic dependent of (A) and as an ordinary launch (``nopdl``),
   alternated three times, eagerly and each captured in a CUDA graph.
6. The grouped fake-quant of the QAT path (``fq``; the ResNet-20 group in
   f32 and bf16 and the LeNet group in f32, bits cycling through the
   mixed policy of chip_smoke's phase 5e): the forward as built at
   clusters of 1, 2, 4 and 8 CTAs per tensor (below the plan's cluster
   the larger layers are read twice), a copy without the cluster's max
   exchange (``noexchange``: each CTA scales by its own max), one that
   computes every code's value instead of reading the CTA's table
   (``notable``), copies whose QDQ multiplies where it divides
   (``nodiv``, no table) or is left out (``noqdq``:
   loads, max and stores), one of 512 threads holding 4 vectors each
   (``512 threads``), and one that returns at once (``empty``: the launch
   and the clusters' scheduling);
   beside it the flat path it replaced (per layer ``tensor_scale`` and
   the flat kernel), the flat kernel alone at given scales and the
   library's same work (per layer ``abs().amax()`` and
   ``fake_quantize_per_tensor_affine``); then the STE backward as built
   (1 vector a thread), at 2 and 4, empty, and its plain version (per
   layer abs, compare, cast, mul).
   Device times here sum every kernel of a call (10 calls, L2 warm).
7. qmm on f32 x (``f32``; rwkv6-1.6b's f32 projections at 4 bits, 2048 x
   2048 and 2048 x 7168): the bit-serial body at M = 4 over warps per
   CTA x K splits, and the dequant body at M = 256 over warpgroups per
   CTA x K splits (its split pass included), beside ``torch.matmul``.
8. The per-column fake-quant pair and the flat kernel (``col``; the
   4-layer glm4-9b cell's nine bf16 leaves at chip_smoke's mixed policy,
   and moonshot's three expert banks with (L,) bits): the forward as
   built (row blocks of ``COL_ROWS`` = 256 rows), with the max pass's
   device time beside; copies with row blocks of 64, 128 and 512 rows,
   with 4 rows in each thread's cp.async ring, with no ring (16-byte
   loads into registers, 2 or 4 rows in flight), with registers capped
   for 3 or 5 CTAs an SM, with a multiply for the division (``nodiv``)
   and with write-back stores for the QDQ pass's streaming ones; each
   leaf alone; the STE as built (2 vectors a thread in flight), at 1 and
   4 and with streaming stores; the flat kernel per ResNet-20 forward
   (20 launches at given scales, one call) as built, on 64-thread
   blocks, without its q / n table and with w loaded after bits and
   scale, beside 20 empty launches.

Times: CUDA events per call (L2 flushed, ``chip_smoke.Timer``) and the
kernels' device time from ``torch.profiler``.  The copies are built with
the package's nvcc flags into ``src/repro_torch/_build/ablation``.  The
card's name and power limit are printed first.  Needs an sm_90 card.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fused_decode import attend_plan, project_plan  # noqa: E402
from repro_torch.kernels.paged_attention import arrival_counters, split_plan  # noqa: E402
from repro_torch.kernels.qmm import bitserial_plan, dequant_plan, dequant_smem  # noqa: E402
from repro_torch.models.common import rope_cos_sin  # noqa: E402
from repro_torch.quant.pack import kv_pack_int4, kv_quantize, pack_weight  # noqa: E402

OUT = ROOT / "src" / "repro_torch" / "_build" / "ablation"

BS_CUTS = {
    "NOLOAD": ("        if (nx < n)\n            load_step<NT, BITS, F32>(",
               "        if (false)\n            load_step<NT, BITS, F32>("),
    "NOCODE": ("            codes_to_a<BITS>(af, c, s);",
               "            af[0] = af[1] = af[2] = af[3] = 0x3F803F80u + s + h;"),
    "NOMMA": ("                    mma_bf16(acc[j], af, x_pair(xb[j][0], s), x_pair(xb[j][1], s));",
              "                    acc[j][0] += __uint_as_float(af[0] ^ af[1] ^ af[2] ^ af[3] ^ "
              "x_pair(xb[j][0], s) ^ x_pair(xb[j][1], s));"),
    "NOCOMBINE": ("    if (a.cluster) {\n        // qmm: split 0", "    if (false) {\n        // qmm: split 0"),
    "STAGES6": ("constexpr int STAGES = 4;", "constexpr int STAGES = 6;"),
    "STAGES8": ("constexpr int STAGES = 4;", "constexpr int STAGES = 8;"),
    "STEP256": ("constexpr int STEP = 128; ", "constexpr int STEP = 256; "),
    "NOL2PF": ("cp.async.cg.shared.global.L2::256B [%0]", "cp.async.cg.shared.global [%0]"),
}
BS_VARIANTS = {"full": (), "loads only": ("NOCODE", "NOMMA"),
               "code build only": ("NOLOAD", "NOMMA"), "products only": ("NOLOAD", "NOCODE"),
               "no combine": ("NOCOMBINE",), "6 stages": ("STAGES6",), "8 stages": ("STAGES8",),
               "256-K steps": ("STEP256",), "no L2 prefetch hint": ("NOL2PF",),
               "loads only, no L2 hint": ("NOCODE", "NOMMA", "NOL2PF")}
BS_SHAPES = [("wq", 4096, 4096, 4), ("wk", 4096, 256, 4), ("wg", 4096, 13696, 4),
             ("wd", 13696, 4096, 4), ("lm_head", 4096, 151552, 8)]

QMM_CUTS = {
    "NOLOAD": ("    if (nx < n)\n        tc_load<NT, BITS, TERMS>(ring + (nx % S::STAGES) * S::SLOT, g, "
               "c0 + nx * kg, r128);", ""),
    "NODECODE": ("    for (int kk = 0; kk < 4; ++kk) tc_frag<BITS>(a[kk], slot + S::PLANES, kk, col, sh);",
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
# the quantized sweep (kv_attention.cuh) without its tile loop
SWEEP_NOCOMPUTE = ("    for (int it = 0; it < ntiles; ++it) {",
                   "    wg::cp_async_wait<0>();\n    __syncthreads();\n"
                   "    for (int it = 0; it < 0; ++it) {")
PAQ_CUTS = {
    "EMPTY": PA_CUTS["EMPTY"],
    "NOCOMBINE": PA_CUTS["NOCOMBINE"],
    "NOCOMPUTE": SWEEP_NOCOMPUTE,
}
ATTEND_CUTS = {
    "EMPTY": PA_CUTS["EMPTY"],
    "NOCOMBINE": ("    if (splitkv::arrive_last(a.arrived + bk, S + 1))", "    if (false)"),
    "NOCOMPUTE": SWEEP_NOCOMPUTE,
    "NOPDL": ("    cfg.numAttrs = pdl ? 1 : 0;", "    cfg.numAttrs = 0;"),
}


FQ_CUTS = {
    "EMPTY": ("    cluster_arrive_relaxed();         // this CTA runs: the others may write its "
              "slots\n", "    if (a.count > 0) return;\n"),
    "BWD_EMPTY": ("    int lo = 0, hi = a.count - 1;",
                  "    if (a.count > 0) return;\n    int lo = 0, hi = a.count - 1;"),
    "NOARRIVE": ("    cluster_arrive_relaxed();         // this CTA runs: the others may write its "
                 "slots\n", ""),
    "NOEXCHANGE": ("    cluster_wait();                   // every CTA of the cluster has started\n"
                   "    if (tid < C) {                    // thread q writes this CTA's max into "
                   "rank q's slot\n        float c = warp_max[0];\n#pragma unroll\n        for (int i "
                   "= 1; i < THREADS / 32; ++i) c = max_nan(c, warp_max[i]);\n        *cluster."
                   "map_shared_rank(&cta_max[rank], tid) = c;\n    }\n    cluster_arrive();      "
                   "           // release: this CTA's writes are visible\n    cluster_wait();      "
                   "             // acquire: every rank's max is in cta_max\n    float s = "
                   "cta_max[0];\n#pragma unroll\n    for (int q = 1; q < MAX_CLUSTER; ++q)\n        "
                   "if (q < C) s = max_nan(s, cta_max[q]);\n",
                   "    float s = warp_max[0];\n    for (int i = 1; i < THREADS / 32; ++i) "
                   "s = max_nan(s, warp_max[i]);\n"),
    "NODIV": ("    float wc = __fdiv_rn(w, p.scale);", "    float wc = w * p.scale;"),
    "NODIV2": ("    return __fmul_rn(__fdiv_rn(q, p.n), p.scale);", "    return q * p.n * p.scale;"),
    "NOQDQ": ("const float* levels, int n) {\n    if (p.fp) return;",
              "const float* levels, int n) {\n    if (n >= 0) return;"),
    "NOTABLE": ("    if (!p.fp && n <= TABLE_N) {", "    if (false) {"),
    "T512": ("constexpr int THREADS = 256;", "constexpr int THREADS = 512;"),
    "BV2": ("constexpr int BWD_VECS = 1;", "constexpr int BWD_VECS = 2;"),
    "BV4": ("constexpr int BWD_VECS = 1;", "constexpr int BWD_VECS = 4;"),
    "V4": ("constexpr int MAX_VECS = 8; ", "constexpr int MAX_VECS = 4; "),
}
FQ_VARIANTS = {"full": (), "noexchange": ("NOARRIVE", "NOEXCHANGE"),
               "notable": ("NOTABLE",), "nodiv": ("NODIV", "NODIV2", "NOTABLE"),
               "noqdq": ("NOQDQ",),
               "512 threads": ("T512", "V4"), "empty": ("EMPTY", "BWD_EMPTY"),
               "bwd 2 vectors": ("BV2",), "bwd 4 vectors": ("BV4",)}
FQ_FWD_VARIANTS = ("full", "noexchange", "notable", "nodiv", "noqdq", "512 threads", "empty")
COL_CUTS = {
    **{f"ROWS{r}": ("constexpr int COL_ROWS = 256;", f"constexpr int COL_ROWS = {r};")
       for r in (64, 128, 512)},
    "RING4": ("constexpr int COL_RING = 8;", "constexpr int COL_RING = 4;"),
    "NORING": ("    if (aligned) ring_rows(", "    if (false) ring_rows("),
    "VECLOADS": ("            if (r < rows) load_cols(w + r * N, col, N, v[u]);",
                 "            if (r < rows && col < N) v[u] = *reinterpret_cast<const Vec<T>*>("
                 "w + r * N + col);"),
    "UNROLL1": ("constexpr int COL_UNROLL = 4;", "constexpr int COL_UNROLL = 1;"),
    "UNROLL2": ("constexpr int COL_UNROLL = 4;", "constexpr int COL_UNROLL = 2;"),
    "CTAS3": ("constexpr int COL_MIN_CTAS = 4;", "constexpr int COL_MIN_CTAS = 3;"),
    "CTAS5": ("constexpr int COL_MIN_CTAS = 4;", "constexpr int COL_MIN_CTAS = 5;"),
    "NODIV": FQ_CUTS["NODIV"],
    "STWB": ("        __stcs(reinterpret_cast<int4*>(row + c), *reinterpret_cast<const int4*>(&r));",
             "        *reinterpret_cast<Vec<T>*>(row + c) = r;"),
    "STCS_STE": ("            reinterpret_cast<Vec<T>*>(grad)[v] = gr[u];",
                 "            __stcs(reinterpret_cast<int4*>(grad) + v, "
                 "*reinterpret_cast<const int4*>(&gr[u]));"),
    "STE1": ("constexpr int STE_VECS = 2;", "constexpr int STE_VECS = 1;"),
    "STE4": ("constexpr int STE_VECS = 2;", "constexpr int STE_VECS = 4;"),
    "FLAT64": ("    const int64_t per_block = (int64_t)THREADS * (vectorized ? Vec<T>::N : 1);",
               "    const int64_t per_block = (int64_t)64 * (vectorized ? Vec<T>::N : 1);"),
    "FLAT64B": ("    fake_quant_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(",
                "    fake_quant_kernel<T><<<(unsigned)blocks, 64, 0, st>>>("),
    "NOTABLE": ("    const bool tabled = n <= TABLE_N && !p.fp;",
                "    const bool tabled = false && !p.fp;"),
    "LATELOAD": ("    if (tid < nvec) r = wv[tid];", "    if (false) r = wv[tid];"),
    "LATELOAD2": ("        if (i != tid) r = wv[i];", "        r = wv[i];"),
}
COL_VARIANTS = {"full": (), "rows 64": ("ROWS64",), "rows 128": ("ROWS128",),
                "rows 512": ("ROWS512",), "ring 4": ("RING4",),
                "registers, 2 rows": ("NORING", "VECLOADS", "UNROLL2"),
                "registers, 4 rows": ("NORING", "VECLOADS"),
                "3 CTAs an SM": ("CTAS3",), "5 CTAs an SM": ("CTAS5",), "nodiv": ("NODIV",),
                "write-back stores": ("STWB",), "ste streaming stores": ("STCS_STE",),
                "ste 1": ("STE1",), "ste 4": ("STE4",), "flat 64 threads": ("FLAT64", "FLAT64B"),
                "flat notable": ("NOTABLE",), "flat lateload": ("LATELOAD", "LATELOAD2")}


def bs_tag(variant: str) -> str:
    """A file-name-safe tag of a bit-serial variant."""
    return "bs_" + re.sub(r"[^A-Za-z0-9]+", "_", variant)


def patched(source: str, cuts: dict, names, tag: str) -> Path:
    """A copy of csrc/{source} and the shared headers in a directory of its
    own, each cut applied to the source if it holds the cut's line, else
    to the one header that does."""
    files = {f.name: f.read_text() for f in [build.CSRC / source, *build.CSRC.glob("*.cuh")]}
    for name in names:
        old, new = cuts[name]
        holders = [f for f, text in files.items() if old in text]
        if source in holders:
            holders = [source]
        if len(holders) != 1:
            sys.exit(f"kernel_ablation: {len(holders)} files of csrc hold the line cut by {name}")
        files[holders[0]] = files[holders[0]].replace(old, new)
    out = OUT / tag
    out.mkdir(parents=True, exist_ok=True)
    for f, text in files.items():
        (out / f).write_text(text)
    return out / source


def build_all(jobs: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]

    def lib(tag):                  # nvcc splits its arguments at commas
        return OUT / f"lib{re.sub(r'[^A-Za-z0-9_]+', '_', tag)}.so"
    procs = {tag: subprocess.Popen([build._nvcc(), *flags, "-o", str(lib(tag)), str(src)])
             for tag, src in jobs.items()}
    for tag, proc in procs.items():
        if proc.wait() != 0:
            sys.exit(f"kernel_ablation: nvcc failed for {tag}")
    return {tag: ctypes.CDLL(str(lib(tag))) for tag in jobs}


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
    sections = set(sys.argv[1:]) or {"bitserial", "qmm", "pa", "paq", "fused", "fq", "f32",
                                     "col"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    if "bitserial" in sections:
        jobs.update({bs_tag(v): patched("qmm.cu", BS_CUTS, cuts, bs_tag(v))
                     for v, cuts in BS_VARIANTS.items()})
    if "qmm" in sections:
        jobs.update({f"qmm_{v}": patched("qmm.cu", QMM_CUTS, cuts, f"qmm_{v.replace(' ', '_')}")
                     for v, cuts in QMM_VARIANTS.items()})
    if "pa" in sections:
        jobs.update({f"pa_{v}": patched("paged_attention.cu", PA_CUTS, cuts,
                                        f"pa_{v.replace('+', '_')}")
                     for v, cuts in PA_VARIANTS.items()})
    if "paq" in sections:
        jobs.update({f"paq_{v}": patched("paged_attention_quant.cu", PAQ_CUTS, cuts,
                                         f"paq_{v.replace('+', '_')}")
                     for v, cuts in PA_VARIANTS.items()})
    if "fused" in sections:
        jobs.update({f"fd_{v}": patched("fused_decode.cu", ATTEND_CUTS, cuts,
                                        f"fd_{v.replace('+', '_')}")
                     for v, cuts in PA_VARIANTS.items()})
        jobs["fd_nopdl"] = patched("fused_decode.cu", ATTEND_CUTS, ("NOPDL",), "fd_nopdl")
    if "fq" in sections:
        jobs.update({f"fq_{v}": patched("fake_quant.cu", FQ_CUTS, cuts,
                                        f"fq_{v.replace(' ', '_')}")
                     for v, cuts in FQ_VARIANTS.items()})
    if "col" in sections:
        jobs.update({f"col_{v}": patched("fake_quant.cu", COL_CUTS, cuts,
                                         "col_" + re.sub(r"[^A-Za-z0-9]+", "_", v))
                     for v, cuts in COL_VARIANTS.items()})
    libs = build_all(jobs)
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "bitserial" in sections:
        bitserial_section(libs, timer, gen)
    if "qmm" in sections:
        qmm_section(libs, timer, gen)
    if "pa" in sections:
        pa_section(libs, timer, gen)
    if "paq" in sections:
        paq_section(libs, timer, gen)
    if "fused" in sections:
        fused_section(libs, timer, gen)
    if "fq" in sections:
        fq_section(libs, timer, gen)
    if "f32" in sections:
        f32_section(timer, gen)
    if "col" in sections:
        col_section(libs, timer, gen)


def f32_section(timer, gen) -> None:
    """The f32 bodies (the package's own build) over launch plans."""
    stream = torch.cuda.current_stream().cuda_stream
    lib = build.library("qmm")
    for name, K, N in (("2048 x 2048", 2048, 2048), ("2048 x 7168", 2048, 7168)):
        planes, scale = pack_weight(torch.randn((K, N), generator=gen, device="cuda")
                                    * K ** -0.5, 4)
        for path, M in (("bitserial", 4), ("dequant", 256)):
            x = torch.randn((M, K), generator=gen, device="cuda")
            y = torch.empty((M, N), device="cuda")
            xs = torch.empty((3, M, K), dtype=torch.bfloat16, device="cuda")
            dense = torch.randn((K, N), generator=gen, device="cuda")
            cells = [f"matmul {timer(lambda: torch.matmul(x, dense)):.4f}"]
            if path == "bitserial":
                plan = bitserial_plan(M, K, N, 4)
                grid = [(w, s) for w in (1, 2, 4, 8) for s in (1, 2, 4, 8, 16)
                        if s <= plan.steps and -(-N // (16 * w)) * s >= 132]
                mark = (plan.warps, plan.splits)
            else:
                plan = dequant_plan(M, K, N, 4, f32=True)
                grid = [(kg, s) for kg in (1, 2) for s in (1, 2, 3, 4, 6)]
                mark = (plan.kgroups, plan.splits)
            for a, sp in grid:
                ws = torch.empty((sp, M, N), device="cuda")

                def fn(a=a, sp=sp, ws=ws):
                    err = lib.qmm_launch(x.data_ptr(), 0, planes.data_ptr(), scale.data_ptr(),
                                         y.data_ptr(), ws.data_ptr(), xs.data_ptr(), M, K, N,
                                         4, 0 if path == "bitserial" else 1,
                                         0 if path == "bitserial" else 64, a, sp, stream)
                    build.check(err, "qmm f32")
                tag = ("w" if path == "bitserial" else "kg") + f"{a}/s{sp}"
                cells.append(f"{tag}{'*' if (a, sp) == mark else ''} {timer(fn):.4f}")
            print(f"qmm {path} f32, M={M}, {name}, 4-bit (events ms; * the plan's): "
                  + "  ".join(cells), flush=True)


def bitserial_section(libs, timer, gen) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    M = 4
    print(f"qmm bit-serial, M={M}: events ms / device ms per call")
    shapes = {}
    for name, K, N, bits in BS_SHAPES:
        planes, scale = pack_weight(torch.randn((K, N), generator=gen, device="cuda")
                                    * K ** -0.5, bits)
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        shapes[name] = (x, planes, scale, K, N, bits)

    def call(lib, x, planes, scale, K, N, bits, warps, splits):
        y = torch.empty((M, N), device="cuda")
        return lambda: lib.qmm_launch(x.data_ptr(), 1, planes.data_ptr(), scale.data_ptr(),
                                      y.data_ptr(), None, None, M, K, N, bits, 0, 0, warps,
                                      splits, stream)

    for variant in BS_VARIANTS:
        lib = libs[bs_tag(variant)]
        build._declare("qmm", lib)
        cells = []
        for name, (x, planes, scale, K, N, bits) in shapes.items():
            plan = bitserial_plan(M, K, N, bits)
            fn = call(lib, x, planes, scale, K, N, bits, plan.warps, plan.splits)
            cells.append(f"{name} {timer(fn):.4f} / {device_ms(timer, fn, 'qmm'):.4f}")
        print(f"  {variant:21s} " + "   ".join(cells), flush=True)

    print(f"qmm bit-serial, M={M}, launch plans (warps w, K splits s; * the plan's): events ms")
    lib = libs[bs_tag("full")]
    for name, (x, planes, scale, K, N, bits) in shapes.items():
        plan = bitserial_plan(M, K, N, bits)
        cells = []
        for warps in (1, 2, 4, 8):
            tiles = -(-N // (16 * warps))
            if tiles > 4 * 132 and warps < plan.warps:
                continue
            seen = set()
            for target in (132, 264, 396, 528, 792):
                splits = max(1, min(plan.steps // 2, -(-target // tiles), 16))
                if splits in seen:
                    continue
                seen.add(splits)
                fn = call(lib, x, planes, scale, K, N, bits, warps, splits)
                mark = "*" if (warps, splits) == (plan.warps, plan.splits) else ""
                cells.append(f"w{warps}/s{splits}{mark} {timer(fn):.4f}")
        print(f"  {name}: " + "  ".join(cells), flush=True)


def qmm_section(libs, timer, gen) -> None:
    stream = torch.cuda.current_stream().cuda_stream

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
                                      y.data_ptr(), ws.data_ptr(), None, 64, K, N, 4, 1, 64,
                                      kgroups, splits, stream)

    for variant in QMM_VARIANTS:
        lib = libs[f"qmm_{variant}"]
        build._declare("qmm", lib)
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


def pa_section(libs, timer, gen) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = torch.cuda.current_stream().cuda_stream
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



MAIN = [41, 58, 73, 96]


def quant_inputs(gen, B, KV, hd, bs, nb, kv_bits):
    """A quantized pool pair over shuffled pages, as chip_smoke.py's."""
    qmax = float(2 ** (kv_bits - 1) - 1)
    NB, bt = cs.block_tables(torch, B, nb, nb)
    pools = []
    for _ in range(2):
        codes, scale = kv_quantize(torch.randn((NB, bs, KV, hd), generator=gen, device="cuda"),
                                   qmax)
        pools.append((kv_pack_int4(codes) if kv_bits == 4 else codes, scale))
    (kc, ks), (vc, vs) = pools
    return kc, vc, ks, vs, bt, qmax


def paq_section(libs, timer, gen) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    B, KV, G, hd, bs = 4, 2, 16, 128, 16
    nb = -(-max(MAIN) // bs)
    pps, splits = split_plan(nb)
    ln = torch.tensor(MAIN, dtype=torch.int32, device="cuda")
    q = torch.randn((B, KV, G, hd), generator=gen, device="cuda").to(torch.bfloat16)
    out = torch.empty((B, KV, G, hd), device="cuda")
    ws = torch.empty(B * KV * 16 * G * (hd + 2), device="cuda")
    arrived = arrival_counters(torch.device("cuda", torch.cuda.current_device()), B * KV)
    print(f"quantized paged attention, main lengths {MAIN}, {splits} splits: "
          "events ms / device ms per call")
    pools = {c: quant_inputs(gen, B, KV, hd, bs, nb, bits) for c, bits in (("int8", 8), ("int4", 4))}
    for variant in PA_VARIANTS:
        lib = libs[f"paq_{variant}"]
        build._declare("paged_attention_quant", lib)
        for container, (kc, vc, ks, vs, bt, _) in pools.items():
            cells = []
            for p in (1, 2, nb):
                fn = (lambda kc=kc, vc=vc, ks=ks, vs=vs, bt=bt, p=p, p4=int(container == "int4"):
                      lib.paged_attention_quant_launch(
                          q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ks.data_ptr(),
                          vs.data_ptr(), bt.data_ptr(), ln.data_ptr(), out.data_ptr(),
                          ws.data_ptr(), arrived.data_ptr(), 1, p4, B, KV, G, hd, bs, nb, p,
                          hd ** -0.5, stream))
                mark = "*" if p == pps else ""
                cells.append(f"{-(-nb // p)} splits{mark} {timer(fn):.4f} / "
                             f"{device_ms(timer, fn, 'paged'):.4f}")
            print(f"  {variant:20s} {container} " + "   ".join(cells), flush=True)


def fused_section(libs, timer, gen) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    B, KV, G, hd, bs, D = 4, 2, 16, 128, 16, 4096
    H = KV * G
    widths = (H * hd, KV * hd, KV * hd)
    ntot = sum(widths)
    nb = -(-(max(MAIN) + 1) // bs)
    pps, splits = attend_plan(nb)
    plan = project_plan(B, D, widths)
    mats = [pack_weight(torch.randn((D, n), generator=gen, device="cuda") * D ** -0.5, 4)
            for n in widths]
    x = torch.randn((B, D), generator=gen, device="cuda").to(torch.bfloat16)
    w_args = [a for planes, scale in mats for a in (planes.data_ptr(), scale.data_ptr(), 4)]
    proj = torch.empty((plan.chunks, B, ntot), device="cuda")
    lib = libs["fd_full"]
    build._declare("fused_decode", lib)
    print(f"fused decode (A), the split-K projection, B={B}: events ms / device ms per call "
          f"(plan: {plan.splits} splits, {plan.ctas} CTAs)")
    cells = []
    for s in (1, 2, 4, plan.splits, 8, 16):
        fn = (lambda s=s: lib.fused_project_launch(
            x.data_ptr(), 1, *w_args, proj.data_ptr(), B, D, widths[0], widths[1], s, stream))
        cells.append(f"{s} splits {timer(fn):.4f} / {device_ms(timer, fn, 'fused_project'):.4f}")
    print("  " + "   ".join(cells), flush=True)

    kc, vc, ks, vs, bt, qmax = quant_inputs(gen, B, KV, hd, bs, nb, 4)
    ln = torch.tensor(MAIN, dtype=torch.int32, device="cuda")
    cos, sin = rope_cos_sin(ln, hd, 1e4)
    qm = torch.tensor(qmax, device="cuda")
    fin = torch.randn((B, ntot), generator=gen, device="cuda")
    outs = [torch.empty((B, KV, G, hd), device="cuda"),
            torch.empty((B, KV, hd // 2), dtype=torch.uint8, device="cuda"),
            torch.empty((B, KV, hd // 2), dtype=torch.uint8, device="cuda"),
            torch.empty((B, KV), device="cuda"), torch.empty((B, KV), device="cuda")]
    ws = torch.empty(B * KV * 16 * G * (hd + 2), device="cuda")
    arrived = arrival_counters(torch.device("cuda", torch.cuda.current_device()), B * KV)
    print(f"fused decode (B), the attend launch on finished projections, int4 pool, "
          f"page splits + the new token (plan: {splits}): events ms / device ms per call")
    for variant in PA_VARIANTS:
        lib = libs[f"fd_{variant}"]
        build._declare("fused_decode", lib)
        cells = []
        for p in (1, 2, nb):
            fn = (lambda lib=lib, p=p: lib.fused_attend_launch(
                fin.data_ptr(), 1, kc.data_ptr(), vc.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                bt.data_ptr(), ln.data_ptr(), cos.data_ptr(), sin.data_ptr(), qm.data_ptr(),
                *(t.data_ptr() for t in outs), ws.data_ptr(), arrived.data_ptr(), 1, B, KV, G,
                hd, bs, nb, p, hd ** -0.5, stream))
            mark = "*" if p == pps else ""
            cells.append(f"{-(-nb // p)} splits{mark} {timer(fn):.4f} / "
                         f"{device_ms(timer, fn, 'fused_attend'):.4f}")
        print(f"  {variant:20s} " + "   ".join(cells), flush=True)

    print(f"fused decode, both launches (A) + (B), int4 pool: events ms / device ms per call "
          f"(plan: {plan.splits} K splits, {splits} page splits)")

    def whole(lib, p, s):
        return lambda: lib.fused_decode_launch(
            x.data_ptr(), 1, *w_args, proj.data_ptr(), s, kc.data_ptr(), vc.data_ptr(),
            ks.data_ptr(), vs.data_ptr(), bt.data_ptr(), ln.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), qm.data_ptr(), *(t.data_ptr() for t in outs), ws.data_ptr(),
            arrived.data_ptr(), 1, B, D, KV, G, hd, bs, nb, p, hd ** -0.5,
            torch.cuda.current_stream().cuda_stream)   # the capture stream in a graph

    lib = libs["fd_full"]
    build._declare("fused_decode", lib)
    for p in (1, 2):
        cells = []
        for s in (2, 4, plan.splits, 8):
            fn = whole(lib, p, s)
            mark = "*" if (p, s) == (pps, plan.splits) else ""
            cells.append(f"{s} K splits{mark} {timer(fn):.4f} / "
                         f"{device_ms(timer, fn, 'fused'):.4f}")
        print(f"  {-(-nb // p)} page splits: " + "   ".join(cells), flush=True)

    print("fused decode, both launches at the plan, (B) a programmatic dependent of (A) "
          "(pdl) or not (nopdl): events ms per call, alternated")
    build._declare("fused_decode", libs["fd_nopdl"])
    for rep in range(3):
        cells = [f"{tag} {timer(whole(libs[lib], pps, plan.splits)):.4f}"
                 for tag, lib in (("pdl", "fd_full"), ("nopdl", "fd_nopdl"))]
        print(f"  round {rep + 1}: " + "   ".join(cells), flush=True)

    print("the same, each captured in a CUDA graph (pdl: a programmatic graph edge from "
          "(A) to (B)): events ms per replay, alternated")
    graphs = {}
    for tag, lib in (("pdl", "fd_full"), ("nopdl", "fd_nopdl")):
        fn = whole(libs[lib], pps, plan.splits)
        build.check(fn(), f"fused decode ({tag})")
        torch.cuda.synchronize()
        graphs[tag] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[tag]):
            build.check(fn(), f"fused decode ({tag}) under capture")
    for rep in range(3):
        cells = [f"{tag} {timer(g.replay):.4f}" for tag, g in graphs.items()]
        print(f"  round {rep + 1}: " + "   ".join(cells), flush=True)



def all_device_ms(fn, calls: int = 10) -> float:
    """Device time of every kernel ``fn`` launches, per call (L2 warm)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0) / calls / 1e3


def fq_section(libs, timer, gen) -> None:
    from repro_torch.kernels import fake_quant as fq
    from repro_torch.kernels.ref import fake_quant_group_bwd_ref
    from repro_torch.quant.wrpn import tensor_scale

    stream = torch.cuda.current_stream().cuda_stream
    for net, dtype in (("resnet20", torch.float32), ("resnet20", torch.bfloat16),
                       ("lenet", torch.float32)):
        ws = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
              for _, shape in cs.weight_shapes(net)]
        gs = [torch.randn(w.shape, generator=gen, device="cuda").to(dtype) for w in ws]
        G = len(ws)
        bits = torch.tensor([cs.QAT_BITS[i % len(cs.QAT_BITS)] for i in range(G)],
                            dtype=torch.int32, device="cuda")
        plan = fq.fake_quant_group_plan([w.numel() for w in ws], dtype)
        outs, scales = [torch.empty_like(w) for w in ws], torch.empty(G, device="cuda")
        grads = [torch.empty_like(g) for g in gs]
        args = (fq._pointers(ws), fq._pointers(outs), fq._numels(ws), G, bits.data_ptr(),
                scales.data_ptr(), fq._eps(dtype), fq._DTYPES[dtype])
        bwd_args = (fq._pointers(ws), fq._pointers(gs), fq._pointers(grads), fq._numels(ws),
                    G, scales.data_ptr(), fq._DTYPES[dtype], stream)
        label = f"{net} {str(dtype)[6:]}, {G} tensors, {sum(w.numel() for w in ws)} weights"
        print(f"grouped fake-quant forward, {label} (plan: clusters of {plan.cluster}, "
              f"{plan.vecs} vectors a thread): events ms / device ms per QAT forward")
        for variant in FQ_FWD_VARIANTS:
            lib = libs[f"fq_{variant}"]
            build._declare("fake_quant", lib)
            cells = []
            for c in (1, 2, 4, 8):
                fn = (lambda lib=lib, c=c: lib.fake_quant_group_launch(*args, c, stream))
                mark = "*" if c == plan.cluster else ""
                cells.append(f"C={c}{mark} {timer(fn):.4f} / "
                             f"{device_ms(timer, fn, 'fake_quant_group_kernel'):.4f}")
            print(f"  {variant:12s} " + "   ".join(cells), flush=True)
        n4 = 7
        zp = torch.zeros((), dtype=torch.int32, device="cuda")
        given = [tensor_scale(w) for w in ws]

        def library():
            for w in ws:
                torch.fake_quantize_per_tensor_affine(w, w.abs().amax().float() / n4, zp,
                                                       -n4, n4)

        def flat_path():
            for i, w in enumerate(ws):
                fq.fake_quant_cuda(w, bits[i], tensor_scale(w))

        def flat_given():
            for i, w in enumerate(ws):
                fq.fake_quant_cuda(w, bits[i], given[i])

        build._declare("fake_quant", libs["fq_full"])
        group = (lambda: libs["fq_full"].fake_quant_group_launch(*args, plan.cluster, stream))
        cells = [f"{name} {timer(fn):.4f} / {all_device_ms(fn):.4f}"
                 for name, fn in (("group", group), ("flat path (scale + kernel)", flat_path),
                                  ("flat at given scales", flat_given),
                                  ("library (amax + fake_quantize)", library))]
        print("  per QAT forward, events ms / device ms (all kernels): " + "   ".join(cells),
              flush=True)
        print(f"grouped STE backward, {label} ({plan.bwd_ctas[0]} CTAs): events ms / device ms "
              f"per QAT backward")
        cells = []
        for variant in ("full", "bwd 2 vectors", "bwd 4 vectors", "empty"):
            lib = libs[f"fq_{variant}"]
            build._declare("fake_quant", lib)
            fn = (lambda lib=lib: lib.fake_quant_group_bwd_launch(*bwd_args))
            cells.append(f"{variant} {timer(fn):.4f} / "
                         f"{device_ms(timer, fn, 'fake_quant_group_bwd'):.4f}")
        plain = (lambda: fake_quant_group_bwd_ref(ws, gs, scales))
        cells.append(f"plain (abs, <=, to, mul per layer) {timer(plain):.4f} / "
                     f"{all_device_ms(plain):.4f}")
        print("  " + "   ".join(cells), flush=True)



def col_section(libs, timer, gen) -> None:
    from repro_torch.kernels import fake_quant as fq
    from repro_torch.models import build_model
    from repro_torch.quant.qat import bits_assignment, bits_to_device
    from repro_torch.quant.wrpn import tensor_scale

    stream = torch.cuda.current_stream().cuda_stream
    model = build_model(cs.lm_cell())
    bmap = bits_assignment(model.quant_groups(), cs.lm_mixed_policy(model))
    cells = [("glm4-9b 4L", [s for _, s in cs.lm_leaves()],
              list(bits_to_device(bmap, "cuda").values())),
             ("moonshot banks", cs.BANK_SHAPES, cs.bank_bits(torch, cs.BANK_SHAPES, 0))]
    for cell, shapes, bits in cells:
        ws = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in shapes]
        gs = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in shapes]
        outs = [torch.empty_like(w) for w in ws]
        scales = fq.col_scales(ws, torch.bfloat16, ws[0].device)
        grads = [torch.empty_like(g) for g in gs]
        cbits, runs = fq._col_bits(bits, [fq.col_dims(s) for s in shapes], ws[0].device)
        eps = fq._eps(torch.bfloat16)
        print(f"per-column forward, {cell} (bf16, {len(ws)} leaves): events ms / device ms per "
              f"QAT forward [the max pass alone, device ms]", flush=True)
        # a variant's grid follows its own COL_ROWS (the C entry plans the
        # row blocks); the plan gives the launches' leaf ranges alone
        plan = fq.fake_quant_col_plan(shapes, torch.bfloat16)
        for variant in ("full", "rows 64", "rows 128", "rows 512", "ring 4",
                        "registers, 2 rows", "registers, 4 rows", "3 CTAs an SM",
                        "5 CTAs an SM", "nodiv", "write-back stores"):
            lib = libs[f"col_{variant}"]
            build._declare("fake_quant", lib)

            def fn(lib=lib):
                for sc in scales:
                    sc.fill_(eps)
                fq.col_launches(lib, plan, ws, outs, scales, cbits, runs, stream)
            print(f"  {variant:18s} {timer(fn, iters=5):.4f} / "
                  f"{device_ms(timer, fn, 'fake_quant_col'):.4f} "
                  f"[{device_ms(timer, fn, 'fake_quant_col_max'):.4f}]", flush=True)
        lib = libs["col_full"]
        build._declare("fake_quant", lib)
        out = []
        for i, shape in enumerate(shapes):
            plan = fq.fake_quant_col_plan([shape], torch.bfloat16)

            def fn(plan=plan, i=i):
                scales[i].fill_(eps)
                fq.col_launches(lib, plan, ws[i:i + 1], outs[i:i + 1], scales[i:i + 1],
                                cbits[i:i + 1], runs[i:i + 1], stream)
            ms = timer(fn, iters=5)
            out.append(f"{tuple(shape)} {ms:.4f} ({ws[i].numel() * 6 / ms / 1e6:.0f})")
        print("  each leaf alone, ms (GB/s of two reads and a write): " + "  ".join(out),
              flush=True)
        for sc in scales:
            sc.fill_(eps)
        plan = fq.fake_quant_col_plan(shapes, torch.bfloat16)
        fq.col_launches(lib, plan, ws, outs, scales, cbits, runs, stream)
        out = []
        for variant in ("full", "ste 1", "ste 4", "ste streaming stores"):
            lib = libs[f"col_{variant}"]
            build._declare("fake_quant", lib)

            def fn(lib=lib):
                for a, b in plan.launches:
                    lib.fake_quant_col_bwd_launch(
                        fq._pointers(ws[a:b]), fq._pointers(gs[a:b]), fq._pointers(grads[a:b]),
                        fq._pointers(scales[a:b]), fq._dims(plan.dims[a:b]), b - a, 1, stream)
            out.append(f"{variant} {timer(fn, iters=5):.4f} / "
                       f"{device_ms(timer, fn, 'fake_quant_col_bwd_kernel'):.4f}")
        print("  STE per QAT backward: " + "   ".join(out), flush=True)
        del ws, gs, outs, scales, grads
        torch.cuda.empty_cache()
    ws = [torch.randn(s, generator=gen, device="cuda") for _, s in cs.weight_shapes("resnet20")]
    given = [tensor_scale(w) for w in ws]
    bits = torch.tensor([cs.QAT_BITS[i % len(cs.QAT_BITS)] for i in range(len(ws))],
                        dtype=torch.int32, device="cuda")
    outs = [torch.empty_like(w) for w in ws]
    out = []
    for variant in ("full", "flat 64 threads", "flat notable", "flat lateload"):
        lib = libs[f"col_{variant}"]
        build._declare("fake_quant", lib)

        def fn(lib=lib):
            for i, w in enumerate(ws):
                lib.fake_quant_launch(w.data_ptr(), outs[i].data_ptr(), bits[i:].data_ptr(),
                                      given[i].data_ptr(), w.numel(), 0, 1, stream)
        out.append(f"{variant} {timer(fn):.4f} / {device_ms(timer, fn, 'fake_quant_kernel'):.4f}")
    empty = libs["col_full"].fake_quant_empty_launch
    out.append(f"20 empty launches {timer(lambda: empty(20, 36, 256, stream)):.4f}")
    print("flat kernel per ResNet-20 forward (f32, 20 launches at given scales, one call): "
          "events ms / device ms: " + "   ".join(out), flush=True)


if __name__ == "__main__":
    main()
