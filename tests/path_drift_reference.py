"""The decode-path / chunk-path drift of ``scripts/path_drift.py``, measured
on the same weights in the port and in the JAX package: the reference's
params (from each ``--seeds`` seed, packed at 4 bits) carried over by
``repro_torch.convert``, 50 tokens of which the last ``--decoded`` go
through the decode step in the decode path, every one through chunked
prefill in the chunk path.
The reference runs as its engine runs it (jit'd) and op by op
(``jax.disable_jit``, the rounding points the port follows).  CPU only:

    PYTHONPATH=src python tests/path_drift_reference.py [--layers 24] [--dtype bfloat16] [--seeds 0 1 2]

Prints max|decode path - chunk path| / max|logit| for each, and the port's
chunk-path logits against the reference's."""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.quant.qat import policy_for as jax_policy_for  # noqa: E402
from repro.serve.cache import PagedCachePool as JaxPool  # noqa: E402
from repro.train.serve import make_chunked_prefill, make_decode_step  # noqa: E402
from repro.train.serve import quantize_for_serving as jax_qfs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from torch_parity import to_port  # noqa: E402

NARROW = {"rwkv6-1.6b": dict(d_model=256, num_heads=4, num_kv_heads=4, d_ff=896),
          "hymba-1.5b": dict(d_model=320, num_heads=5, num_kv_heads=1, d_ff=1088,
                             sliding_window=64)}


def reference_logits(jm, jsp, tokens, chunk=64, decoded=0, jit=True):
    """``chip_smoke.fresh_logits`` in the JAX package: a fresh one-row pool,
    the tokens but the last ``decoded`` prefilled in ``chunk``-token
    chunks, the rest decoded one at a time; f32 logits after the last."""
    tokens = np.asarray(tokens, np.int32)
    pool = JaxPool(jm, 1, len(tokens) + 1, block_size=16, prefix_cache=False)
    seq = pool.alloc_seq()
    pool.ensure(seq, len(tokens) + 1)
    pre = make_chunked_prefill(jm, donate=False) if jit else jm.prefill_chunk
    dec = make_decode_step(jm, donate=False) if jit else jm.decode_step
    n = len(tokens) - decoded
    with contextlib.nullcontext() if jit else jax.disable_jit():
        for lo in range(0, n, chunk):
            valid = min(chunk, n - lo)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :valid] = tokens[lo:lo + valid]
            logits, cache = pre(jsp, pool.step_cache(), jnp.asarray(buf), seq, lo, valid)
            pool.accept(cache)
        for tok in tokens[n:]:
            logits, cache = dec(jsp, pool.step_cache(), jnp.asarray([[int(tok)]], jnp.int32))
            pool.accept(cache)
    return np.asarray(logits[0, 0], np.float32)


def drifts(arch, dtype, layers, decoded=8, seed=0):
    """{name: max|decode path - chunk path| / max|logit|} for the port and
    the reference (jit'd and op by op) on the same weights, plus the
    port's chunk path against the reference's op-by-op one."""
    import chip_smoke

    over = dict(num_layers=layers, vocab_size=2000, dtype=dtype, **NARROW[arch])
    jm = jax_build_model(dataclasses.replace(jax_get_config(arch), **over))
    tm = build_model(dataclasses.replace(get_config(arch), **over))
    jsp = jax_qfs(jm, jm.init(jax.random.PRNGKey(seed)), jax_policy_for(jm, 4))
    tsp = to_port(jsp)
    toks = np.random.default_rng(seed).integers(0, 2000, 50)
    out = {}
    port = [chip_smoke.fresh_logits(torch, tm, tsp, toks, device="cpu", decoded=d).numpy()
            for d in (decoded, 0)]
    out["port"] = float(np.abs(port[0] - port[1]).max() / np.abs(port[1]).max())
    ref = {}
    for name, jit in (("reference jit", True), ("reference op by op", False)):
        ref[name] = [reference_logits(jm, jsp, toks, decoded=d, jit=jit) for d in (decoded, 0)]
        out[name] = float(np.abs(ref[name][0] - ref[name][1]).max() / np.abs(ref[name][1]).max())
    want = ref["reference op by op"][1]
    out["port chunk vs reference op by op"] = float(np.abs(port[1] - want).max()
                                                    / np.abs(want).max())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=list(NARROW))
    ap.add_argument("--dtype", nargs="+", default=["bfloat16"])
    ap.add_argument("--layers", type=int, nargs="+", default=[24])
    ap.add_argument("--decoded", type=int, default=8)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0],
                    help="each seeds the params (PRNGKey) and the tokens (numpy)")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    for arch in args.arch:
        for dtype in args.dtype:
            for L in args.layers:
                for seed in args.seeds:
                    d = drifts(arch, dtype, L, args.decoded, seed)
                    print(f"{arch} {dtype} {L:2d} layers, seed {seed}: max|decode - chunk| / "
                          "max|logit|: " + ", ".join(f"{k} {v:.3g}" for k, v in d.items()),
                          flush=True)


if __name__ == "__main__":
    main()
