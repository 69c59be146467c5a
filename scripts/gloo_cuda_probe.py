"""Which ``torch.distributed`` collectives a gloo group takes on CUDA tensors,
with two ranks on one card, and how long each takes.

    python3 scripts/gloo_cuda_probe.py [--ranks 2] [--mib 64]

Two processes (a TCP store on localhost) each hold the one card, allocate
``--mib`` MiB there, and run every collective of the list on CUDA tensors
over one gloo group: the result is checked against what the collective
must give, and its wall time (host clock around the call and a
``torch.cuda.synchronize()``) is the median of 3 after one warm-up.  Prints
one JSON line per rank 0: ``{"card": ..., "ok": {name: bool}, "error":
{name: message}, "ms": {name: ms}, "mib": ...}``.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cases(dist, torch, rank, n, mib, dev):
    """(name, fn() -> bool) of every collective probed."""
    elems = mib * (1 << 20) // 4
    x = torch.full((elems,), float(rank + 1), device=dev)
    want_sum = float(n * (n + 1) // 2)

    def all_reduce(op, dtype, want):
        def run():
            t = torch.full((elems,), float(rank + 1), device=dev, dtype=dtype)
            dist.all_reduce(t, op=op)
            return bool((t == want).all())
        return run

    def broadcast():
        t = x.clone()
        dist.broadcast(t, src=0)
        return bool((t == 1.0).all())

    def all_gather_into_tensor():
        out = torch.empty((n * elems,), device=dev)
        dist.all_gather_into_tensor(out, x)
        return all(bool((out[r * elems:(r + 1) * elems] == r + 1).all()) for r in range(n))

    def all_gather():
        outs = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(outs, x)
        return all(bool((o == r + 1).all()) for r, o in enumerate(outs))

    def reduce_scatter_tensor():
        inp = torch.full((n * elems,), float(rank + 1), device=dev)
        out = torch.empty((elems,), device=dev)
        dist.reduce_scatter_tensor(out, inp)
        return bool((out == want_sum).all())

    def all_to_all_single():
        inp = torch.arange(n, device=dev, dtype=torch.float32).repeat_interleave(elems // n)
        inp = inp + 100 * rank
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp)
        per = elems // n
        return all(bool((out[r * per:(r + 1) * per] == 100 * r + rank).all()) for r in range(n))

    def all_to_all():
        per = elems // n
        inp = [torch.full((per,), float(100 * rank + j), device=dev) for j in range(n)]
        out = [torch.empty((per,), device=dev) for _ in range(n)]
        dist.all_to_all(out, inp)
        return all(bool((o == 100 * r + rank).all()) for r, o in enumerate(out))

    R = dist.ReduceOp
    return [
        ("all_reduce_sum_f32", all_reduce(R.SUM, torch.float32, want_sum)),
        ("all_reduce_sum_bf16", all_reduce(R.SUM, torch.bfloat16, want_sum)),
        ("all_reduce_max_f32", all_reduce(R.MAX, torch.float32, float(n))),
        ("broadcast", broadcast),
        ("all_gather_into_tensor", all_gather_into_tensor),
        ("all_gather", all_gather),
        ("reduce_scatter_tensor", reduce_scatter_tensor),
        ("all_to_all_single", all_to_all_single),
        ("all_to_all", all_to_all),
    ]


def _rank(rank: int, n: int, port: int, mib: int) -> None:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=n)
    ok, err, ms = {}, {}, {}
    for name, fn in _cases(dist, torch, rank, n, mib, dev):
        try:
            ok[name] = fn()
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[name] = statistics.median(times)
        except Exception as e:          # the answer is which collectives raise
            ok[name], err[name] = False, f"{type(e).__name__}: {str(e)[:200]}"
        dist.barrier()
    if rank == 0:
        print(json.dumps({"card": torch.cuda.get_device_name(0), "ranks": n, "mib": mib,
                          "ok": ok, "error": err, "ms": ms}))
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank(args.rank, args.ranks, args.port, args.mib)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ranks",
                               str(args.ranks), "--mib", str(args.mib), "--rank", str(r),
                               "--port", str(port)]) for r in range(args.ranks)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return max(abs(rc) for rc in rcs)


if __name__ == "__main__":
    sys.exit(main())
