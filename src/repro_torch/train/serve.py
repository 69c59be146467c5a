"""Serving transform (torch port of ``repro.train.serve``): pack ReLeQ's
bitwidths into bitplane weights.

``quantize_for_serving`` turns training-layout params + a QuantPolicy into
the serving layout:

- a per-layer LIST under ``params["blocks"][0]`` (each layer's packed
  buffers keep their own bitwidth),
- every packable matrix replaced by ``Packed(planes (bits, K//8, N)
  uint8, scale (1, N) f32, bits)``; ``bits >= 16`` stays dense,
- the embedding kept dense but wrapped as ``QDQ(w, bits, value)``.  The
  reference re-quantizes the whole ``(V, D)`` table on every lookup;
  here ``value = fake_quant(w, bits, axis=0)`` is computed once, with
  bitwise the same result,
- norms untouched.

Packing runs layer by layer on ``device`` (the card unless
``device="cpu"``), so a full-width model never holds more than one f32
copy of one matrix beside its masters.

:func:`make_decode_step` is the counterpart of the reference's
``jax.jit`` decode step: it captures the fixed-shape decode step
in a CUDA graph on the card (:class:`GraphedDecodeStep`) and is the
eager ``model.decode_step`` on the CPU; the chunked prefill stays the
eager ``model.prefill_chunk`` (it runs once per admission).
:class:`GraphedFn` captures a function of tensors once per shape; the
device sampler (``serve.sampler``) is two of them.

A captured graph is replayed on the current stream and writes the same
output buffers at every replay: a caller reads (or copies out) what it
needs in stream order before the next replay.  Capture and replay
failures raise; nothing falls back to the eager step on the card.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.quant.pack import QDQ, Packed, pack_weight
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qat import get_by_path, set_by_path
from repro_torch.quant.wrpn import FP_BITS, fake_quant


def _pack_matrix(w, bits: int, device):
    if bits >= 16:  # not worth packing; serve dense
        return w.to(device)
    planes, scale = pack_weight(w.to(device).float(), bits)
    return Packed(planes, scale, bits)


def _layer(tree, l: int, device):
    """Layer ``l`` of a stacked subtree, on ``device``."""
    if isinstance(tree, dict):
        return {k: _layer(v, l, device) for k, v in tree.items()}
    return tree[l].to(device)


def quantize_for_serving(model, params, policy: QuantPolicy, device=None) -> dict:
    device = resolve_device(device)
    stacked = params["blocks"][0]
    layers = [_layer(stacked, l, device) for l in range(model.cfg.num_layers)]
    out = {key: val for key, val in params.items() if key != "blocks"}
    out["final_norm"] = params["final_norm"].to(device)
    for g in model.quant_groups():
        bits = policy.get(g.name)
        if g.path[0] == "blocks":
            rest = g.path[2:]
            w = get_by_path(stacked, rest)[g.layer]
            layers[g.layer] = set_by_path(layers[g.layer], rest,
                                          _pack_matrix(w, bits, device))
        elif g.path == ("embed",):
            emb = params["embed"].to(device)
            out["embed"] = (QDQ(emb, bits, fake_quant(emb, bits, axis=0))
                            if bits < FP_BITS else emb)
        elif g.path == ("lm_head",):
            out["lm_head"] = _pack_matrix(params["lm_head"], bits, device)
        else:  # pragma: no cover - future group kinds
            raise ValueError(f"no serving transform for group {g.name}")
    out["blocks"] = [layers]
    return out


# ---------------------------------------------------------------------------
# captured steps (the counterparts of the reference's jit wrappers)
# ---------------------------------------------------------------------------


def _leaves(tree):
    """The tensors of a params tree (dicts, lists, Packed/QDQ leaves)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


class _Graph:
    """``fn(*inputs)`` captured once on CUDA over the static ``inputs``.

    One eager call on a side stream comes first (lazy module and library
    loads, ``cudaFuncSetAttribute``, the split-KV counters' allocation);
    its launches are real and counted.  The kernel counts that capture
    ticked (it launches nothing) are taken back and added again at every
    replay."""

    def __init__(self, fn, inputs):
        t0 = time.perf_counter()
        self.inputs = inputs
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*inputs)
        torch.cuda.current_stream().wait_stream(side)
        before = dict(kops.counts)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*inputs)
        self.launches = {k: n - before[k] for k, n in kops.counts.items() if n != before[k]}
        kops.add_counts(self.launches, -1)
        self.seconds = time.perf_counter() - t0   # warm-up and capture, host clock

    def replay(self):
        self.graph.replay()
        kops.add_counts(self.launches)
        return self.outputs


class GraphedFn:
    """``fn(*tensors) -> tensor`` run plain on CPU tensors and, on CUDA
    tensors, as one captured graph per (device, shapes, dtypes): every
    argument is copied into the graph's static input before a replay, so
    nothing is bound and a graph is never captured again.  The result on
    CUDA is the graph's output buffer, overwritten by the next replay."""

    def __init__(self, fn):
        self.fn = fn
        self.captures = 0
        self.capture_seconds = 0.0
        self._graphs: dict[tuple, _Graph] = {}

    def __call__(self, *args):
        if args[0].device.type != "cuda":
            return self.fn(*args)
        key = tuple((a.device, tuple(a.shape), a.dtype) for a in args)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = _Graph(self.fn, [a.clone() for a in args])
            self.captures += 1
            self.capture_seconds += g.seconds
        for buf, a in zip(g.inputs, args):
            buf.copy_(a)
        return g.replay()


class GraphedDecodeStep:
    """``model.decode_step`` captured in a CUDA graph at its first call and
    replayed afterwards.

    It owns static buffers for the per-step inputs (tokens (B, 1),
    ``length`` (B,), ``block_tables`` (B, nb)) and copies the caller's
    values into them before each replay; every other cache leaf and every
    serving-param tensor is bound by address, and the graph is keyed on
    those addresses (as the jit cache keys on shapes; the params tree is
    walked once per params object, its leaves' addresses read per call).
    A changed key
    captures again and counts in ``recaptures`` (the engine's
    ``serve.recompiles``); the pool and the params keep their tensors, so
    steady-state serving shows none.  Returns ``(logits, cache)``: the
    graph's logits buffer and the caller's cache with ``length`` the
    graph's output buffer, as the eager step returns a new ``length``."""

    COPIED = ("length", "block_tables")

    def __init__(self, model):
        self.model = model
        self.captures = 0
        self.recaptures = 0
        self.capture_seconds = 0.0
        self._graph: _Graph | None = None
        self._key = None
        self._params = None
        self._param_leaves: list[torch.Tensor] = []

    def _bound_key(self, params, cache, tokens):
        if params is not self._params:
            self._params, self._param_leaves = params, list(_leaves(params))
        bound = tuple((k, v.data_ptr(), tuple(v.shape), v.dtype)
                      for k, v in cache.items() if k not in self.COPIED)
        copied = tuple((tuple(cache[k].shape), cache[k].dtype) for k in self.COPIED)
        return (tokens.device, tuple(tokens.shape), copied, bound,
                tuple(map(torch.Tensor.data_ptr, self._param_leaves)))

    def __call__(self, params, cache, tokens):
        key = self._bound_key(params, cache, tokens)
        if key != self._key:
            self._capture(params, cache, tokens)
            self._key = key
        tok, length, bt = self._graph.inputs
        tok.copy_(tokens)
        length.copy_(cache["length"])
        bt.copy_(cache["block_tables"])
        logits, new_length = self._graph.replay()
        return logits, {**cache, "length": new_length}

    def _capture(self, params, cache, tokens):
        if self._graph is not None:
            self.recaptures += 1
        self._graph = None   # its private pool goes with it
        bound = {k: v for k, v in cache.items() if k not in self.COPIED}
        decode = self.model.decode_step

        def step(tok, length, bt):
            logits, out = decode(params, {**bound, "length": length, "block_tables": bt}, tok)
            moved = [k for k in bound if out[k] is not bound[k]]
            if moved:
                raise RuntimeError(f"decode_step replaced cache leaves {moved}; a "
                                   "captured step needs them written in place")
            return logits, out["length"]

        self._graph = _Graph(step, [tokens.clone(), cache["length"].clone(),
                                    cache["block_tables"].clone()])
        self.captures += 1
        self.capture_seconds += self._graph.seconds


def make_decode_step(model, device=None):
    """The engine's decode step on ``device`` (the card unless
    ``device="cpu"``): the eager ``model.decode_step`` on the CPU, a
    :class:`GraphedDecodeStep` on CUDA."""
    if resolve_device(device).type == "cpu":
        return model.decode_step
    return GraphedDecodeStep(model)
