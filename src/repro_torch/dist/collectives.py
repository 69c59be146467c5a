"""Compressed all-reduce: fp8 planes with error feedback (torch port of
``repro.dist.collectives``).

The data-parallel gradient all-reduce moves 4 bytes an element a step
(2 in bf16); this module moves fp8 *planes* instead: each rank compresses
its local array into ``planes`` successive e4m3 payloads (the value, then
the residual of that rounding, ...), each at its own scalar scale, the
ranks exchange planes and scales, and each reduces the dequantized sum.

Error feedback: what even the last plane could not represent is returned
as the local residual ``fb``, for the caller to fold into the *next*
step's input (``residual=fb``), the standard construction that keeps
compressed SGD unbiased over time.

Payloads cross the wire as ``uint8`` (``torch.float8_e4m3fn`` viewed as
bytes), so the backend's collectives never see an fp8 dtype.  ``group``
is a process group (None: the default group) or ``(DeviceMesh, axis
name)``.  Every rank of the group must call.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_leaves, tree_unflatten

_E4M3_MAX = 448.0
# XLA folds the reference's ``/ 448`` into a product with 1/448 rounded to f32
_INV_E4M3_MAX = float(torch.tensor(1.0 / _E4M3_MAX, dtype=torch.float32))
_F8 = torch.float8_e4m3fn


def process_group(group):
    """A process group from a group, None (the default group) or
    ``(DeviceMesh, axis name)``."""
    if isinstance(group, tuple):
        mesh, axis = group
        return mesh.get_group(axis)
    return group if group is not None else dist.group.WORLD


_CHUNK = 1 << 26     # elements an elementwise pass holds in temporaries at a time


def _chunks(n: int):
    for i in range(0, n, _CHUNK):
        yield slice(i, min(i + _CHUNK, n))


def _fp8_planes(x: torch.Tensor, planes: int, *, inplace: bool = False):
    """x (f32) -> (planes ``(planes, ...)`` uint8, scales ``(planes,)`` f32,
    residual f32).

    Plane 0 carries the value, plane i the rounding residual of planes <i,
    each at its own scalar scale mapping max|.| to e4m3's max.  Bit for bit
    the reference as it runs compiled: the scale is the maximum times
    f32(1/448), and the residual ``r - q·s`` is rounded once (XLA contracts
    it into a fused multiply-add): ``q·s`` is exact in f64 (4 significant
    bits times 24), and so is the difference, since ``q·s`` is 0 or within
    a factor of two of ``r``.  Elementwise work runs in chunks of
    ``_CHUNK`` elements; ``inplace=True`` writes the residual over ``x``."""
    r = x.float()
    if r is x and not inplace:
        r = r.clone()
    flat = r.view(-1)
    q = torch.empty((planes,) + tuple(r.shape), dtype=_F8, device=r.device)
    qf = q.view(planes, -1)
    ss = []
    for p in range(planes):
        s = torch.clamp(torch.linalg.vector_norm(flat, float("inf")), min=1e-30) * _INV_E4M3_MAX
        s64 = s.double()
        for c in _chunks(flat.numel()):
            qc = (flat[c] / s).to(_F8)
            qf[p, c] = qc
            flat[c] = (flat[c].double() - qc.double() * s64).float()
        ss.append(s)
    return q.view(torch.uint8), torch.stack(ss), r


def _dequant_sum(codes: torch.Tensor, scales: torch.Tensor, out=None) -> torch.Tensor:
    """The f32 sum over the leading two axes of ``codes (a, b, ...)`` as fp8
    times ``scales (a, b)``, added in row-major order one term at a time,
    in chunks; written to ``out`` (rounded to its dtype) when given."""
    a, b = codes.shape[:2]
    flat = codes.reshape(a, b, -1)
    if out is None:
        out = torch.empty(codes.shape[2:], dtype=torch.float32, device=codes.device)
    dst = out.view(-1)
    for c in _chunks(flat.shape[2]):
        acc = None
        for i in range(a):
            for j in range(b):
                term = flat[i, j, c].view(_F8).float() * scales[i, j]
                acc = term if acc is None else acc.add_(term)
        dst[c] = acc
    return out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """-> ``(n, *x.shape)``: every rank's ``x``, stacked in rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(), group=group)
    return out.view((n,) + tuple(x.shape))


def compressed_allreduce(x: torch.Tensor, group=None, *, residual=None, planes: int = 2,
                         mean: bool = True, axis_size: int | None = None):
    """All-reduce ``x`` over ``group`` through an fp8 wire format.

    Returns ``(reduced, fb)``: the (mean by default) reduction of every
    rank's *dequantized* planes, and this rank's error-feedback residual,
    both in ``x``'s dtype.  Pass ``fb`` back as ``residual`` next call.

    Two constructions:

    - ``axis_size=None``: all-gather every rank's planes and reduce
      locally; each rank *receives* ``n·planes`` bytes an element.
    - ``axis_size=n`` (the group's size): the two-phase reduce-scatter /
      all-gather analogue.  Compress, all-to-all chunk exchange,
      decompress and reduce the own chunk, re-compress, all-gather:
      ``≈ 2·planes·(n-1)/n`` bytes an element sent.  The stage-2
      quantization error is folded into this rank's slice of ``fb``.
    """
    group = process_group(group)
    xf = x.float() if residual is None else x.float() + residual.float()
    if xf is x:
        xf = xf.clone()
    if axis_size is not None:
        return _compressed_rs_ag(x, xf, group, planes, mean, axis_size)
    q_u8, scales, fb = _fp8_planes(xf, planes, inplace=True)
    gq = _all_gather(q_u8, group)          # (n, planes, ...)
    del q_u8
    gs = _all_gather(scales, group)        # (n, planes)
    out = _dequant_sum(gq, gs)
    if mean:
        out.div_(dist.get_world_size(group))
    return out.to(x.dtype), fb.to(x.dtype)


def _compressed_rs_ag(x, xf, group, planes: int, mean: bool, n: int):
    """Two-phase compressed all-reduce (see :func:`compressed_allreduce`);
    ``xf`` is this call's own f32 buffer, overwritten by the residual."""
    if n != dist.get_world_size(group):
        raise ValueError(f"axis_size {n} != the group's size {dist.get_world_size(group)}")
    shape, size = x.shape, x.numel()
    c = -(-size // n)
    flatp = xf.reshape(-1)
    if n * c != size:
        flatp = torch.nn.functional.pad(flatp, (0, n * c - size))
    del xf
    q_u8, scales, fb1 = _fp8_planes(flatp.view(n, c), planes, inplace=True)  # (planes, n, c)
    # phase 1: chunk j of every rank travels to rank j, compressed
    recv = torch.empty((n, planes, c), dtype=torch.uint8, device=x.device)
    dist.all_to_all_single(recv, q_u8.transpose(0, 1).contiguous(), group=group)
    del q_u8
    gs = _all_gather(scales, group)             # (n, planes)
    mine = _dequant_sum(recv.transpose(0, 1), gs.T)    # (c,): planes, then peers
    del recv
    if mean:
        mine.div_(n)
    # phase 2: re-compress the reduced chunk, all-gather every chunk
    q2, s2, fb2 = _fp8_planes(mine, planes, inplace=True)
    gq2 = _all_gather(q2, group)                # (n, planes, c)
    gs2 = _all_gather(s2, group)                # (n, planes)
    del q2
    flat_out = torch.empty(n * c, dtype=x.dtype, device=x.device)
    for j in range(n):   # each peer's chunk: its planes summed, rounded once to x's dtype
        _dequant_sum(gq2[j:j + 1], gs2[j:j + 1], out=flat_out[j * c:(j + 1) * c])
    del gq2
    out = flat_out[:size].view(shape)
    # error feedback: the stage-1 residual everywhere + this rank's stage-2
    # residual at its own chunk (scaled back up if the wire carried means)
    me = dist.get_rank(group)
    fb1[me] += fb2 * (n if mean else 1)
    del fb2
    fb = fb1.reshape(-1)[:size].view(shape)
    return out, fb.to(x.dtype)


def compressed_allreduce_tree(tree, group=None, *, residuals=None, planes: int = 2,
                              mean: bool = True, axis_size: int | None = None):
    """Per-leaf :func:`compressed_allreduce` over a gradient tree (nested
    dicts and lists of tensors, leaves in ``jax.tree`` order).

    ``residuals`` is the matching error-feedback tree from the previous
    step (or None on step 0).  Returns ``(reduced_tree, residual_tree)``;
    ``train.train_step.make_dp_train_step`` carries the residuals as
    ``state["ef"]``.  ``axis_size`` selects the two-phase construction."""
    leaves = tree_leaves(tree)
    res = tree_leaves(residuals) if residuals is not None else [None] * len(leaves)
    outs, fbs = [], []
    for leaf, r in zip(leaves, res):
        o, f = compressed_allreduce(leaf, group, residual=r, planes=planes, mean=mean,
                                    axis_size=axis_size)
        outs.append(o)
        fbs.append(f)
    return tree_unflatten(tree, outs), tree_unflatten(tree, fbs)
