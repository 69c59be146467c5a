#!/usr/bin/env python3
"""Op counts of the port's decode steps on meta tensors (``launch.op_costs``),
on the CPU, with nothing allocated:

    PYTHONPATH=src python3 scripts/op_counts.py

Prints, for the glm4-9b smoke decode step (B 1, ``max_len`` 16; the
reference evaluator's shape) unpacked and packed at 2 and 8 bits, its
flops and bytes and the qmm calls' share; then glm4-9b at its published
widths and depth, 4 bits, 4 rows over a 96-token paged pool (block 16,
fp KV): the bytes each kernel charges, the eager torch ops' bytes, the
total and its excess over the weight planes.  CPU counts, not device
metrics.
"""
from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.launch.op_costs import count_costs
from repro_torch.launch.specs import cache_struct, params_struct, sds, serving_params_struct
from repro_torch.models import build_model
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qat import policy_for
from repro_torch.serve.cache import PagedCachePool


def policy(model, bits: int) -> QuantPolicy:
    names = [g.name for g in model.quant_groups()]
    frozen = model.frozen_bits()
    return QuantPolicy.from_array(names, [frozen.get(n, bits) for n in names])


def main() -> None:
    model = build_model(get_config("glm4-9b", smoke=True))
    for bits in (None, 2, 8):
        params = (params_struct(model) if bits is None
                  else serving_params_struct(model, policy(model, bits)))
        c = count_costs(model.decode_step, params, cache_struct(model, 1, 16),
                        sds((1, 1), torch.int32))
        qmm = c.kernels.get("qmm_bitserial", [0, 0.0, 0.0])
        print(f"glm4-9b smoke decode step, {'unpacked' if bits is None else f'{bits} bits'}: "
              f"{c.flops:.0f} flops, {c.traffic_bytes:.0f} bytes; qmm {qmm[0]} calls, "
              f"{qmm[2]:.0f} bytes")
    model = build_model(get_config("glm4-9b"))
    cfg = model.cfg
    sparams = serving_params_struct(model, policy_for(model, 4))
    pool = PagedCachePool(model, 4, 96, block_size=16, device="meta")
    for _ in range(4):
        pool.ensure(pool.alloc_seq(), 96)
    c = count_costs(model.decode_step, sparams, pool.step_cache(), sds((4, 1), torch.int32))
    D, F, V, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.hd
    H, KV = cfg.num_heads, cfg.num_kv_heads
    mats = [(D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D), (D, F), (D, F), (F, D)]
    planes = cfg.num_layers * sum(4 * K * N // 8 for K, N in mats) + D * V
    kernels = sum(v[2] for v in c.kernels.values())
    print(f"glm4-9b full width, 4 bits, 4 rows, 96-token paged pool: {c.flops:.0f} flops, "
          f"{c.traffic_bytes:.0f} bytes ({c.traffic_bytes / planes - 1:+.2%} over the "
          f"{planes} bytes of planes)")
    for name, (calls, flops, nbytes) in c.kernels.items():
        print(f"  {name}: {calls} calls, {nbytes:.0f} bytes")
    print(f"  kernels beyond the planes: {kernels - planes:.0f} bytes; eager torch ops: "
          f"{c.traffic_bytes - kernels:.0f} bytes")
    for nbytes, name in c.breakdown(8):
        print(f"  {name}: {nbytes:.0f} bytes")


if __name__ == "__main__":
    main()
