"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  Libraries go to
``src/repro_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source rebuilds and an unchanged one is reused.  Nothing is built at import: :func:`library` builds on first
use, and :func:`build_all` starts every ``nvcc`` at once (set-up time for
``chip_smoke.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# --split-compile=0: nvcc runs a source's optimization passes on every
# core (the five sources, qmm.cu's 77 instances of the tensor-core bodies
# among them, build in about half the time)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
              "--split-compile=0")
SOURCES = ("qmm", "paged_attention", "paged_attention_quant", "fused_decode",
           "fake_quant")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report per source, from the last build
ptxas_info: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/{name}.cu`` is (or will be) built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one nvcc (or return None if the library is already built)."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    ptxas_info[name] = log
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every kernel source in parallel (one nvcc per source)."""
    with _lock:
        jobs = {name: _start(name) for name in SOURCES if name not in _libs}
        for name, job in jobs.items():
            _finish(name, job)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(library_path(name)))
            _declare(name, lib)
            _libs[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "qmm":
        # x, x_dtype, planes, scale, y, ws, xs, M, K, N, bits, path,
        # token_tile, groups, splits, stream
        lib.qmm_launch.argtypes = [P, I, P, P, P, P, P] + [I] * 8 + [P]
        lib.qmm_launch.restype = I
    elif name == "paged_attention":
        # q, k_pool, v_pool, block_tables, lengths, out, ws, arrived, dtype,
        # B, KV, G, hd, bs, nb, pages_per_split, scale, stream
        lib.paged_attention_launch.argtypes = [P] * 8 + [I] * 8 + [F, P]
        lib.paged_attention_launch.restype = I
    elif name == "paged_attention_quant":
        # q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, out, ws,
        # arrived, dtype, packed4, B, KV, G, hd, bs, nb, pages_per_split,
        # scale, stream
        lib.paged_attention_quant_launch.argtypes = [P] * 10 + [I] * 9 + [F, P]
        lib.paged_attention_quant_launch.restype = I
    elif name == "fused_decode":
        # proj, act_dtype, k_pool, v_pool, k_scale, v_scale, block_tables,
        # lengths, cos, sin, qmax, out, kc, vc, ksc, vsc, ws, arrived,
        # packed4, B, KV, G, hd, bs, nb, pages_per_split, scale, stream
        lib.fused_attend_launch.argtypes = [P, I] + [P] * 16 + [I] * 8 + [F, P]
        lib.fused_attend_launch.restype = I
        # x, act_dtype, (planes, scale, bits) x 3, proj, B, D, Nq, Nkv,
        # splits, stream
        lib.fused_project_launch.argtypes = [P, I] + [P, P, I] * 3 + [P] + [I] * 5 + [P]
        lib.fused_project_launch.restype = I
        # x, act_dtype, (planes, scale, bits) x 3, proj, splits, k_pool,
        # v_pool, k_scale, v_scale, block_tables, lengths, cos, sin, qmax,
        # out, kc, vc, ksc, vsc, ws, arrived, packed4, B, D, KV, G, hd, bs,
        # nb, pages_per_split, scale, stream
        lib.fused_decode_launch.argtypes = ([P, I] + [P, P, I] * 3 + [P, I] + [P] * 16
                                            + [I] * 9 + [F, P])
        lib.fused_decode_launch.restype = I
    elif name == "fake_quant":
        # w, out, bits, scale, numel, dtype, vectorized, stream
        lib.fake_quant_launch.argtypes = [P, P, P, P, ctypes.c_int64, I, I, P]
        lib.fake_quant_launch.restype = I
        # ws, outs, numels (host arrays), count, bits, scale, eps, dtype,
        # cluster, stream
        lib.fake_quant_group_launch.argtypes = [P, P, P, I, P, P, F, I, I, P]
        lib.fake_quant_group_launch.restype = I
        # ws, gs, grads, numels (host arrays), count, scale, dtype, stream
        lib.fake_quant_group_bwd_launch.argtypes = [P, P, P, P, I, P, I, P]
        lib.fake_quant_group_bwd_launch.restype = I
        lib.fake_quant_group_limits.argtypes = [P]
        lib.fake_quant_group_limits.restype = None
        # ws, outs, scales, bits, dims, bits_runs (host arrays), count,
        # dtype, stream
        lib.fake_quant_col_launch.argtypes = [P] * 6 + [I, I, P]
        lib.fake_quant_col_launch.restype = I
        # its two passes alone: ws, scales, dims, count, dtype, stream; and
        # the same arguments as fake_quant_col_launch
        lib.fake_quant_col_max_launch.argtypes = [P, P, P, I, I, P]
        lib.fake_quant_col_max_launch.restype = I
        lib.fake_quant_col_qdq_launch.argtypes = [P] * 6 + [I, I, P]
        lib.fake_quant_col_qdq_launch.restype = I
        # ws, gs, grads, scales, dims (host arrays), count, dtype, stream
        lib.fake_quant_col_bwd_launch.argtypes = [P] * 5 + [I, I, P]
        lib.fake_quant_col_bwd_launch.restype = I
        lib.fake_quant_col_limits.argtypes = [P]
        lib.fake_quant_col_limits.restype = None
        # launches, blocks, threads, stream
        lib.fake_quant_empty_launch.argtypes = [I, I, I, P]
        lib.fake_quant_empty_launch.restype = I


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        import torch

        try:
            msg = torch.cuda.cudart().cudaGetErrorString(err)
        except (AttributeError, RuntimeError, TypeError):
            msg = "see cudaError_t"
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def require_sm90(device) -> None:
    """Raise unless ``device`` is a Hopper (sm_90) card."""
    import torch

    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the repro_torch kernels are built for sm_90a; {device} is "
            f"sm_{cap[0]}{cap[1]} ({torch.cuda.get_device_name(device)})")
