"""Op counts of a torch program: flops, memory traffic and collective bytes
(torch twin of ``repro.launch.hlo_analysis``).

The reference parses XLA's optimized HLO text, because XLA's own cost
analysis counts a ``while`` body once and its programs are scans.  The
port has no compiler between its Python and the card: what a program
costs is what it dispatches.  :func:`count_costs` runs a function under a
``TorchDispatchMode`` and counts every aten op it reaches -- forward and,
where the function calls ``backward`` or ``autograd.grad``, backward --
so a Python loop of N layers counts N times without any trip-count
recovery.  Run on meta tensors (``launch.specs``) it allocates nothing,
and each ``kernels.ops`` entry point called there charges its hand
kernel's contract cost instead of running a plain version.

Counting rules:

- **flops**: ``torch.utils.flop_counter``'s registry (mm, bmm, addmm,
  convolutions, SDPA: 2 x output x contraction), the reference's
  dot/convolution rule; elementwise work counts no flops in either.
  A kernel entry point charges its own products (qmm: 2·M·K·N).
- **traffic_bytes**: each aten op's operand bytes plus its output bytes
  -- each input read once, each output written once -- the rule the
  reference's docstring gives for top-level instructions (its code
  charges twice the output, since an XLA fusion's operands are hidden
  inside it; an eager torch op's are not).  Exceptions:
  * views and allocations (``is_view`` ops, ``_unsafe_view``, ``empty``
    and its kin) move nothing and count 0;
  * a gather (``embedding``, ``index``, ``index_select``, ``gather``)
    charges the rows it returns, read and written, and its indices, not
    the whole table: XLA's operand rule would charge the table (1.24 GB
    for glm4-9b's embedding, for 4 rows of 8 KB);
  * a write into part of a buffer (``index_put_`` and ``scatter`` forms,
    ``index_copy``; ``copy_`` into a slice is already its window)
    charges the window it writes, its values and its indices, not the
    buffer -- the reference's dynamic-update-slice / scatter rule.
  * a kernel entry point on meta tensors charges its contract: the bytes
    the kernel must read and write (qmm: planes ``bits·K·N/8``, scale, x
    and its f32 y), as ``PERF.md`` §6's bounds reckon them.  The plain
    version, which dequantizes the whole weight, is never what counts.
- **coll_bytes**: every ``torch.distributed`` collective the function
  calls reaches the dispatcher as a ``c10d`` op (``dist.tp``'s and
  ``dist.collectives``' calls alike), counted by kind in the reference
  HLO's names and payload convention, the bytes of the collective's
  output: an all-reduce its tensor, an all-gather its output, an
  all-to-all its buffer, a reduce-scatter its shard.  A fake process
  group (``launch/mesh.py::fake_process_group``) answers them without a
  peer, so one process counts rank 0 of a mesh of any size.

The count also keeps the bytes the function holds (:attr:`OpCosts.memory`,
the reference's ``memory_analysis`` fields):
``argument_bytes`` (the distinct storages of the arguments; a DTensor's
local shard), ``output_bytes`` (of the results), ``alias_bytes`` (results
that are argument storages: state or cache updated in place),
``temp_bytes`` (the peak of the storages made by the call and live at
once, less the results it made) and ``peak_bytes`` = arguments + temp +
results made, the reference's ``argument + temp + max(output - alias,
0)``.  A storage is live from the op that makes it until its last
reference dies (a weak reference's callback; torch keeps a storage's
Python object while any tensor holds it), so autograd's saved tensors
count for as long as the graph holds them.

:func:`roofline_from_costs` turns a count into times at one H100's
data-sheet rates (``core.costmodel``).
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field, fields, is_dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core import costmodel
from repro_torch.kernels import ops as kops

_aten = torch.ops.aten
_FREE = {_aten._unsafe_view.default, _aten.empty.memory_format, _aten.empty_like.default,
         _aten.empty_strided.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten._local_scalar_dense.default}
_GATHERS = {_aten.embedding.default, _aten.index.Tensor, _aten.index_select.default,
            _aten.gather.default}
_WINDOW_WRITES = {_aten.index_put.default, _aten.index_put_.default,
                  _aten._index_put_impl_.default, _aten.index_copy.default,
                  _aten.index_copy_.default, _aten.scatter.src, _aten.scatter_.src,
                  _aten.scatter.value, _aten.scatter_.value}


def _collective_ops() -> dict:
    """c10d op -> the reference HLO's kind; its first argument holds the
    payload (the output, or the tensors reduced in place)."""
    kinds = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
             "allgather_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
             "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
             "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
             "broadcast_": "collective-permute"}
    out = {}
    for name, kind in kinds.items():
        try:
            out[getattr(torch.ops.c10d, name).default] = kind
        except (AttributeError, RuntimeError):   # not in this torch build
            pass
    return out


_COLLECTIVES = _collective_ops()


def _tensors(tree):
    """The tensors of a tree of lists, tuples, dicts and dataclasses
    (``Packed``, ``QDQ``, ``QTensor``); a DTensor as its local shard."""
    if isinstance(tree, torch.Tensor):
        yield getattr(tree, "_local_tensor", tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)
    elif is_dataclass(tree) and not isinstance(tree, type):
        for f in fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _storages(tree) -> dict:
    """{storage id: bytes} of the distinct storages under ``tree``."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _window_bytes(func, args, kwargs) -> int:
    """Bytes an indexed write moves: its values (or source) read, the
    window written, the indices read."""
    dest = args[0]
    if func in (_aten.index_put.default, _aten.index_put_.default,
                _aten._index_put_impl_.default):
        indices, values = args[1], args[2]
        live = [i for i in indices if i is not None]
        rows = math.prod(torch.broadcast_shapes(*(i.shape for i in live))) if live else 1
        rest = math.prod(d for k, d in enumerate(dest.shape)
                         if k >= len(indices) or indices[k] is None)
        return _bytes(values) + rows * rest * dest.element_size() + _bytes(live)
    if func in (_aten.index_copy.default, _aten.index_copy_.default):
        return 2 * _bytes(args[3]) + _bytes(args[2])
    index = args[2]                       # scatter(self, dim, index, src | value)
    src = args[3] if len(args) > 3 and isinstance(args[3], torch.Tensor) else None
    n = index.numel() * dest.element_size()
    return n + (n if src is not None else 0) + _bytes(index)


@dataclass
class OpCosts:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    coll_bytes_by_kind: dict = field(default_factory=dict)
    coll_count_by_kind: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)   # kernel -> [calls, flops, bytes]
    by_op: dict = field(default_factory=dict)     # aten op -> [calls, flops, bytes]
    memory: dict = field(default_factory=dict)    # the module docstring's byte fields

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll_bytes_by_kind.values()))

    def coll_summary(self) -> str:
        ks = sorted(self.coll_bytes_by_kind)
        return ", ".join(
            f"{k}:{self.coll_count_by_kind[k]}x/{self.coll_bytes_by_kind[k]/1e6:.0f}MB"
            for k in ks) or "none"

    def breakdown(self, top: int = 10) -> list[tuple[float, str]]:
        """The ``top`` aten ops and kernels by bytes: (bytes, name)."""
        rows = [(v[2], k) for k, v in (*self.by_op.items(), *self.kernels.items())]
        return sorted(rows, reverse=True)[:top]

    def _add(self, table: dict, name: str, flops: float, nbytes: float) -> None:
        row = table.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.flops += flops
        self.traffic_bytes += nbytes


class _Live:
    """The bytes of the storages made since it started that are still
    referenced, and their peak."""

    def __init__(self, known):
        self.known = set(known)       # the arguments' storages: not the call's own
        self.live: dict[int, int] = {}
        self.refs: dict[int, weakref.ref] = {}
        self.now = self.peak = 0

    def add(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known or key in self.live:
                continue
            self.live[key] = n = st.nbytes()
            self.refs[key] = weakref.ref(st, lambda _, key=key: self._free(key))
            self.now += n
            self.peak = max(self.peak, self.now)

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)
        self.refs.pop(key, None)


class _NoKey(Exception):
    pass


_SCALARS = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
            torch.memory_format, type(None))


def _sig(x):
    """A hashable signature of an op argument's metadata (a plain meta
    tensor's shape, strides and dtype; a scalar's value); raises
    :class:`_NoKey` for anything else."""
    t = type(x)
    if t is torch.Tensor:
        if not x.is_meta:
            raise _NoKey
        return (x.shape, x.stride(), x.dtype)
    if t is list or t is tuple:
        return (t, tuple(map(_sig, x)))
    if isinstance(x, _SCALARS):
        return (t, x)
    raise _NoKey


_PURE: dict = {}


def _pure(func) -> bool:
    """An aten op whose outputs are new tensors (no view, no write)."""
    ok = _PURE.get(func)
    if ok is None:
        schema = func._schema
        ok = _PURE[func] = (func.namespace == "aten" and not func.is_view
                            and not schema.is_mutable
                            and all(r.alias_info is None for r in schema.returns))
    return ok


def _layout(out):
    """(shape, strides, dtype) of each new meta tensor of ``out`` (a tensor
    or a tuple of them), or None."""
    outs = out if isinstance(out, tuple) else (out,)
    if not all(type(t) is torch.Tensor and t.device.type == "meta" for t in outs):
        return None
    return isinstance(out, tuple), [(tuple(t.shape), t.stride(), t.dtype) for t in outs]


class _Counter(TorchDispatchMode):
    """Counts every op and the storages it makes (module docstring).  A pure aten op on meta tensors
    is run once per signature (its arguments' shapes, strides and dtypes
    and its scalars) and its outputs' layout and its counts memoized:
    later calls get new meta tensors of that layout at once (a meta
    kernel's shape rules run in Python, ~0.5 ms an op; the layers of a
    step repeat the same signatures)."""

    def __init__(self, costs: OpCosts, live: _Live):
        super().__init__()
        self.costs, self.live = costs, live
        self.memo: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = None
        if _pure(func):
            try:
                key = (func, _sig(args), _sig(tuple(kwargs.items())))
            except _NoKey:
                pass
        hit = self.memo.get(key) if key is not None else None
        if hit is not None:
            (is_tuple, layouts), flops, nbytes = hit
            outs = tuple(torch.empty_strided(sh, st, dtype=dt, device="meta")
                         for sh, st, dt in layouts)
            out = outs if is_tuple else outs[0]
            self.live.add(out)
            if nbytes is not None:
                self.costs._add(self.costs.by_op, str(func.overloadpacket.__name__), flops,
                                nbytes)
            return out
        out = func(*args, **kwargs)
        self.live.add(out)
        kind = _COLLECTIVES.get(func)
        if kind is not None:
            c = self.costs
            c.coll_bytes_by_kind[kind] = c.coll_bytes_by_kind.get(kind, 0) + _bytes(args[0])
            c.coll_count_by_kind[kind] = c.coll_count_by_kind.get(kind, 0) + 1
            return out
        flops = nbytes = None
        if not (func.is_view or func in _FREE):
            flops = 0.0
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                flops = float(count(*args, **kwargs, out_val=out))
            if func in _GATHERS:
                nbytes = 2 * _bytes(out) + _bytes(args[1:])
            elif func in _WINDOW_WRITES:
                nbytes = _window_bytes(func, args, kwargs)
            elif func is _aten.copy_.default:
                nbytes = _bytes(args[:2])
            else:
                nbytes = _bytes((args, kwargs)) + _bytes(out)
            self.costs._add(self.costs.by_op, str(func.overloadpacket.__name__), flops, nbytes)
        if key is not None:
            layout = _layout(out)
            if layout is not None:
                self.memo[key] = (layout, flops, nbytes)
        return out


def count_costs(fn, *args, **kwargs) -> OpCosts:
    """Run ``fn(*args, **kwargs)`` and count its aten ops, kernel calls,
    collectives and the bytes it holds (module docstring).  On meta inputs
    nothing is allocated."""
    costs = OpCosts()

    def charge(kernel, flops, nbytes):
        costs._add(costs.kernels, kernel, flops, nbytes)

    held = _storages((args, kwargs))
    live = _Live(held)
    with kops.charging(charge), _Counter(costs, live):
        out = fn(*args, **kwargs)
    outs = _storages(out)
    alias = sum(n for k, n in outs.items() if k in held)
    made = sum(outs.values()) - alias
    arg = sum(held.values())
    temp = max(live.peak - made, 0)
    costs.memory = {"argument_bytes": arg, "output_bytes": sum(outs.values()),
                    "temp_bytes": temp, "alias_bytes": alias, "peak_bytes": arg + temp + made}
    return costs


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

# One NVIDIA H100 SXM (data sheet, dense bf16): the flop and HBM rates of
# core.costmodel, and NVLink's 900 GB/s to the host's other cards, 450
# GB/s each way -- the rate one card's collective payload leaves at.
H100 = {"peak_flops": costmodel.H100_PEAK_FLOPS, "hbm_bw": costmodel.H100_HBM_BW,
        "link_bw": 450e9}


@dataclass
class Roofline:
    flops: float               # per-card flops of the counted program
    hbm_bytes: float
    coll_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float = 0.0
    collectives: str = ""

    @property
    def t_total(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful model flops per card vs what the bottleneck allows."""
        if self.t_total <= 0:
            return 0.0
        return (self.model_flops / H100["peak_flops"]) / self.t_total

    def row(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "model_flops": self.model_flops, "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collectives": self.collectives,
        }


def roofline_from_costs(costs: OpCosts, *, chips: int, model_flops: float,
                        hw=H100) -> Roofline:
    t_c = costs.flops / hw["peak_flops"]
    t_m = costs.traffic_bytes / hw["hbm_bw"]
    t_x = costs.coll_bytes / hw["link_bw"]
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    return Roofline(costs.flops, costs.traffic_bytes, costs.coll_bytes,
                    t_c, t_m, t_x, bottleneck=max(terms, key=terms.get),
                    model_flops=model_flops / chips,
                    collectives=costs.coll_summary())
