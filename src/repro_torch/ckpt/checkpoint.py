"""Dependency-free fault-tolerant checkpointing (torch port of
``repro.ckpt.checkpoint``).

Layout:  <dir>/step_<N>/
            manifest.json       {step, meta, num_leaves, leaf shapes/dtypes, tree}
            leaves.npz          all array leaves, keyed leaf_<i>

The reference pickles a jax treedef; here ``manifest["tree"]`` describes
the nesting in JSON: ``{"dict": {key: node}}``, ``{"list": [node, ...]}``,
``{"qtensor": shape}`` (a ``quant.int8_opt.QTensor``: its codes and
scales are the next two leaves), ``{"int": value}`` (a host int, such as
AdamW's step) and ``{"leaf": i}``.  bfloat16 and float8 leaves are stored
exactly, as their raw uint16 / uint8 bits, with the dtype named in the
manifest.

Guarantees, as the reference's:
- **Atomic**: written to ``step_<N>.tmp`` then renamed; a crash mid-write
  never corrupts the latest checkpoint (restart uses the newest complete
  directory; a ``.tmp`` is never read).
- **Complete state**: params, optimizer moments (``QTensor`` included),
  data cursor and any meta dict ride in one tree + meta.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.quant.int8_opt import QTensor

# dtypes numpy cannot hold, stored as their bits
_RAW = {torch.bfloat16: ("bfloat16", np.uint16, torch.int16),
        torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8)}
_FROM_NAME = {name: (dt, view) for dt, (name, _, view) in _RAW.items()}


def _step_dirs(directory: str) -> list[tuple[int, str]]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            full = os.path.join(directory, name)
            if os.path.exists(os.path.join(full, "manifest.json")):
                out.append((int(name.split("_")[1]), full))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    dirs = _step_dirs(directory)
    return dirs[-1][0] if dirs else None


def step_path(directory: str, step: int | None = None) -> tuple[int, str]:
    """-> (step, its directory): the newest complete one for ``step=None``."""
    dirs = _step_dirs(directory)
    if not dirs:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    if step is None:
        return dirs[-1]
    match = [p for s, p in dirs if s == step]
    if not match:
        raise FileNotFoundError(f"step {step} not in {directory}")
    return step, match[0]


def _flatten(tree, leaves: list):
    """-> the JSON tree node; appends the tensors to ``leaves``."""
    if isinstance(tree, dict):
        return {"dict": {k: _flatten(tree[k], leaves) for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"list": [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, QTensor):
        leaves += [tree.codes, tree.scale]
        return {"qtensor": list(tree.shape)}
    if isinstance(tree, (int, np.integer)):
        return {"int": int(tree)}
    leaves.append(tree)
    return {"leaf": len(leaves) - 1}


def _rank_and_size() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _to_numpy(t) -> tuple[np.ndarray, str]:
    if not isinstance(t, torch.Tensor):
        a = np.asarray(t)
        return a, str(a.dtype)
    t = t.detach().cpu().contiguous()
    if t.dtype in _RAW:
        name, np_dt, view = _RAW[t.dtype]
        return t.view(view).numpy().view(np_dt), name
    a = t.numpy()
    return a, str(a.dtype)


def save(directory: str, step: int, tree, meta: dict | None = None, keep: int = 3) -> str:
    """Atomically write a checkpoint; prune to the newest ``keep``.

    Under a process group of more than one rank every rank calls: sharded
    ``DTensor`` leaves are gathered whole, rank 0 alone writes, and a
    barrier on each side keeps ranks from racing on the directory."""
    import torch.distributed as dist

    from repro_torch.dist.elastic import whole

    leaves: list = []
    node = _flatten(tree, leaves)
    final = os.path.join(directory, f"step_{step:08d}")
    leaves = [whole(x) for x in leaves]
    rank, size = _rank_and_size()
    if size > 1:
        dist.barrier()
    if rank == 0:
        _write(directory, final, step, node, leaves, meta, keep)
    if size > 1:
        dist.barrier()
    return final


def _write(directory, final, step, node, leaves, meta, keep):
    arrays = [_to_numpy(x) for x in leaves]
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "leaves.npz"),
             **{f"leaf_{i}": a for i, (a, _) in enumerate(arrays)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({
            "step": step,
            "meta": meta or {},
            "num_leaves": len(arrays),
            "leaves": [{"shape": list(a.shape), "dtype": dt} for a, dt in arrays],
            "tree": node,
        }, f, indent=2)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    for _, old in _step_dirs(directory)[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def _read_leaves(path: str, ids) -> dict:
    """{i: array} of the ``leaf_<i>`` members of a ``leaves.npz`` that
    :func:`save` wrote (stored, not compressed): each member read once,
    straight into a new array, and checked against the CRC in the zip's
    directory.  ``np.load`` reads a member through zipfile's stream in
    chunks and copies it twice more; this is one copy."""
    import struct
    import zipfile
    import zlib

    from numpy.lib import format as npf

    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for i in ids:
            info = zf.getinfo(f"leaf_{i}.npy")
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: leaf_{i} is compressed; save stores its members")
            f.seek(info.header_offset)
            local = f.read(30)
            if local[:4] != b"PK\x03\x04":
                raise ValueError(f"{path}: no local header for leaf_{i}")
            name_len, extra_len = struct.unpack("<HH", local[26:30])
            start = info.header_offset + 30 + name_len + extra_len
            f.seek(start)
            version = npf.read_magic(f)
            read_header = (npf.read_array_header_1_0 if version == (1, 0)
                           else npf.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            head_len = f.tell() - start
            f.seek(start)
            crc = zlib.crc32(f.read(head_len))
            a = np.empty(shape, dtype, order="F" if fortran else "C")
            buf = memoryview(a.reshape(-1, order="A")).cast("B")
            if f.readinto(buf) != a.nbytes or head_len + a.nbytes != info.file_size:
                raise ValueError(f"{path}: leaf_{i} is truncated")
            if zlib.crc32(buf, crc) != info.CRC:
                raise ValueError(f"{path}: leaf_{i} fails its CRC")
            out[i] = a
    return out


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A freshly read array (owned, writable) as a tensor on ``device``."""
    if dtype in _FROM_NAME:
        dt, view = _FROM_NAME[dtype]
        return torch.from_numpy(np.ascontiguousarray(a)).view(view).view(dt).to(device)
    return torch.from_numpy(a).to(device)


def _unflatten(node, leaves):
    if "dict" in node:
        return {k: _unflatten(v, leaves) for k, v in node["dict"].items()}
    if "list" in node:
        return [_unflatten(v, leaves) for v in node["list"]]
    if "int" in node:
        return node["int"]
    if "qtensor" in node:
        return QTensor(next(leaves), next(leaves), tuple(node["qtensor"]))
    return next(leaves)


def _leaf_ids(node) -> list[int]:
    """The npz leaf indices of a subtree of plain leaves, in order."""
    if "dict" in node:
        return [i for v in node["dict"].values() for i in _leaf_ids(v)]
    if "list" in node:
        return [i for v in node["list"] for i in _leaf_ids(v)]
    if "leaf" in node:
        return [node["leaf"]]
    raise ValueError(f"a restored subtree holds plain leaves only, not {sorted(node)}")


def restore(directory: str, step: int | None = None, device=None, subtree: str | None = None):
    """-> (tree, meta, step), tensors on ``device`` (the card unless
    ``device="cpu"``).  ``step=None`` loads the newest complete one.
    ``subtree`` names a top-level key (``"params"``): only its leaves are
    read, and it is returned as the tree."""
    device = resolve_device(device)
    step, path = step_path(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    node = manifest["tree"]
    if subtree is None:
        ids = range(manifest["num_leaves"])
    else:
        node = node["dict"][subtree]
        ids = _leaf_ids(node)
    data = _read_leaves(os.path.join(path, "leaves.npz"), ids)
    leaves = iter([_from_numpy(data.pop(i), manifest["leaves"][i]["dtype"], device)
                   for i in ids])
    return _unflatten(node, leaves), manifest["meta"], step
