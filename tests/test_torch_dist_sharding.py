"""``repro_torch.dist.sharding``, ``_fp8_planes``, placements and the host
mesh, against ``repro.dist`` on the CPU, in one process.

- Specs: the port's ``param_specs``/``state_specs`` equal the reference's
  exactly, leaf for leaf, path name for path name and in ``jax.tree``
  order, for every arch's smoke params in the training and serving
  (``Packed``/``QDQ``) layouts and with fp32 and 8-bit moments, under the
  profiles tp, tp_sp and fsdp, on meshes (2, 4), (8, 1), (1, 8) ("data",
  "model") and (2, 2, 2) ("pod", "data", "model").  The reference side is
  a ``jax.sharding.AbstractMesh``: no devices.  One known difference in
  the trees: the reference draws musicgen's ``mlp/wu``, which its GELU MLP
  never reads; the port has no such leaf (nor its moments).
- ``batch_specs`` with and without ``seq_shard``, ``cache_specs`` on each
  family's slot cache and paged pool (fp, int8 and int4 blocks).
- ``_fp8_planes``: codes, scales and residual bit for bit the reference's
  as it runs compiled (inside ``shard_map`` under ``jit``), on zeros,
  e4m3 subnormals, values at ±448·s, a leaf of one element, wide and
  ordinary values, f32 and bf16-valued.
- ``to_placements``/``spec_of`` round trips; ``make_host_mesh`` at world
  size 1 and its refusals.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import all_archs
from repro.configs import get_config as jget
from repro.dist import sharding as jshd
from repro.dist.collectives import _fp8_planes as jplanes
from repro.launch import specs as JS
from repro.models import build_model as jbuild
from repro.optim import AdamW as JAdamW
from repro.quant.qat import policy_for as jpolicy
from repro.serve.cache import PagedCachePool as JPaged
from repro_torch.configs import get_config as tget
from repro_torch.dist import sharding as tshd
from repro_torch.dist.collectives import _fp8_planes as tplanes
from repro_torch.launch import specs as TS
from repro_torch.models import build_model as tbuild
from repro_torch.optim import AdamW as TAdamW
from repro_torch.quant.qat import policy_for as tpolicy
from repro_torch.serve.cache import PagedCachePool as TPaged

torch.set_num_threads(1)

ARCHS = tuple(all_archs())
MESHES = (((2, 4), ("data", "model")), ((8, 1), ("data", "model")),
          ((1, 8), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")))
PROFILES = ("tp", "tp_sp", "fsdp")
# the reference's GELU MLP carries an ``mlp/wu`` it never reads; the port's has none
UNREAD = {"musicgen-large": "mlp/wu"}


def _jax_specs(tree, specs):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    names = ["/".join(jshd._key_name(k) for k in path) for path, _ in flat]
    leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(names) == len(leaves)
    return {n: tuple(s) for n, s in zip(names, leaves)}, names


def _port_specs(tree, specs):
    names = ["/".join(n) for n, _ in tshd.named_leaves(tree)]
    leaves = tshd.spec_leaves(specs)
    assert len(names) == len(leaves)
    return {n: tuple(s) for n, s in zip(names, leaves)}, names


def _assert_same(arch, jtree, jspecs, ttree, tspecs, what):
    want, jnames = _jax_specs(jtree, jspecs)
    got, tnames = _port_specs(ttree, tspecs)
    missing = [n for n in jnames if n not in got]
    assert all(f"/{UNREAD.get(arch)}" in n for n in missing), (what, missing)
    assert tnames == [n for n in jnames if n in got], (what, "leaf order")
    bad = {n: (got[n], want[n]) for n in tnames if got[n] != want[n]}
    assert not bad, (what, bad)


@pytest.fixture(scope="module")
def structs():
    """arch -> (reference trees, port trees): params, serving params, and
    train states with fp32 and int8 moments."""
    out = {}
    for arch in ARCHS:
        jm, tm = jbuild(jget(arch, smoke=True)), tbuild(tget(arch, smoke=True))
        jp, tp = JS.params_struct(jm), TS.params_struct(tm)
        j = {"params": jp, "serving": JS.serving_params_struct(jm, jpolicy(jm, 4))}
        t = {"params": tp, "serving": TS.serving_params_struct(tm, tpolicy(tm, 4))}
        for mom in ("fp32", "int8"):
            j[mom] = {"params": jp, "opt": jax.eval_shape(JAdamW(moments=mom).init, jp)}
            t[mom] = {"params": tp, "opt": TAdamW(moments=mom).init(tp)}
        out[arch] = (j, t)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_equal_the_reference(structs, arch, monkeypatch):
    j, t = structs[arch]
    for profile in PROFILES:
        monkeypatch.setenv("REPRO_SHARD_PROFILE", profile)
        for shape, axes in MESHES:
            jmesh, tmesh = AbstractMesh(shape, axes), tshd.AbstractMesh(shape, axes)
            for layout in ("params", "serving"):
                _assert_same(arch, j[layout], jshd.param_specs(j[layout], jmesh),
                             t[layout], tshd.param_specs(t[layout], tmesh),
                             (profile, shape, layout))
            for mom in ("fp32", "int8"):
                _assert_same(arch, j[mom], jshd.state_specs(j[mom], jmesh),
                             t[mom], tshd.state_specs(t[mom], tmesh), (profile, shape, mom))


def test_specs_shard_what_the_rules_say(structs):
    """A hand-checked sample at (2, 4) under tp: column-parallel wq on its
    output dim, row-parallel wo on its contraction dim, the 251-token
    smoke vocab too odd to split (replicated), 8-bit moment codes on their
    parameter's rule, the step counter replicated."""
    _, t = structs["glm4-9b"]
    mesh = tshd.AbstractMesh((2, 4), ("data", "model"))
    specs = tshd.state_specs(t["int8"], mesh)
    blocks = specs["params"]["blocks"][0]
    assert blocks["attn"]["wq"] == tshd.P(None, None, "model")
    assert blocks["attn"]["wo"] == tshd.P(None, "model", None)
    assert specs["params"]["embed"] == tshd.P(None, None)
    assert specs["opt"]["step"] == tshd.P()
    codes = specs["opt"]["m"]["blocks"][0]["attn"]["wq"].codes
    assert isinstance(codes, tshd.P) and codes[-1] == "model"


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, monkeypatch):
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    B, S = 8, 16
    jb = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
          "labels": jax.ShapeDtypeStruct((B, S), jnp.int32),
          "positions": jax.ShapeDtypeStruct((3, B, S), jnp.int32),
          "embeds": jax.ShapeDtypeStruct((B, S, 64), jnp.float32)}
    tb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
    caches = [(jm.init_cache(4, 32), tm.init_cache(4, 32, device="cpu"))]
    if jcfg.family != "ssm":
        for kv in (None, 8, 4):
            jp = JPaged(jm, 4, 32, block_size=4, kv_bits=kv)
            tp = TPaged(tm, 4, 32, block_size=4, kv_bits=kv, device="cpu")
            jc, tc = dict(jp.cache), dict(tp.cache)
            jc["block_tables"] = jnp.asarray(jp.block_tables)
            tc["block_tables"] = torch.as_tensor(jp.block_tables)
            caches.append((jc, tc))
    for profile in PROFILES:
        monkeypatch.setenv("REPRO_SHARD_PROFILE", profile)
        for shape, axes in MESHES:
            jmesh, tmesh = AbstractMesh(shape, axes), tshd.AbstractMesh(shape, axes)
            for seq in (False, True):
                want = {k: tuple(v) for k, v in jshd.batch_specs(jb, jmesh, seq_shard=seq).items()}
                got = {k: tuple(v) for k, v in tshd.batch_specs(tb, tmesh, seq_shard=seq).items()}
                assert got == want, (profile, shape, seq)
            for jc, tc in caches:
                assert sorted(jc) == sorted(tc)
                want = {k: tuple(v) for k, v in jshd.cache_specs(jc, jmesh).items()}
                got = {k: tuple(v) for k, v in tshd.cache_specs(tc, tmesh).items()}
                assert got == want, (profile, shape, sorted(tc))


# ---- _fp8_planes ------------------------------------------------------------------
def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.dtype.itemsize])


_rng = np.random.default_rng(0)
PLANE_CASES = {
    "normal": _rng.normal(size=(64, 33)).astype(np.float32),
    "wide": (_rng.normal(size=(20000,)) * np.exp(_rng.normal(size=20000) * 6)).astype(np.float32),
    "zeros": np.zeros((7, 3), np.float32),
    "one": np.array([3.5], np.float32),
    "subnormal": np.arange(-40, 40, dtype=np.float32) * 2.0 ** -9,
    "at_448s": np.array([448.0, -448.0, 1.0, 0.5, 1e-30, -0.0], np.float32),
}


@pytest.mark.parametrize("chunk", [None, 7], ids=["one_chunk", "chunks_of_7"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PLANE_CASES))
def test_fp8_planes_bitwise_the_compiled_reference(case, dtype, chunk, monkeypatch):
    from repro_torch.dist import collectives

    if chunk:
        monkeypatch.setattr(collectives, "_CHUNK", chunk)
    x = np.asarray(jnp.asarray(PLANE_CASES[case]).astype(dtype).astype(jnp.float32))
    for planes in (1, 2, 3):
        qj, sj, rj = jax.jit(jplanes, static_argnums=1)(jnp.asarray(x), planes)
        xt = torch.from_numpy(x.copy())
        qt, st, rt = tplanes(xt, planes)
        assert torch.equal(xt, torch.from_numpy(x))     # the input is left as it was
        assert qt.dtype == torch.uint8 and st.dtype == rt.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))
        np.testing.assert_array_equal(_bits(rt.numpy()), _bits(rj))


# ---- placements and the host mesh ----------------------------------------------------
def test_placements_round_trip():
    from torch.distributed.tensor import Replicate, Shard

    mesh = tshd.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    P = tshd.P
    assert tshd.placements_of(P(), mesh) == (Replicate(),) * 3
    assert tshd.placements_of(P(None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    assert tshd.placements_of(P(("data", "model"), None), mesh) == (Replicate(), Shard(0),
                                                                   Shard(0))
    for spec, nd in ((P(None, "model"), 2), (P(("pod", "data", "model"),), 1),
                     (P("data", None, "model"), 3)):
        assert tshd.spec_of(tshd.placements_of(spec, mesh), mesh, nd) == spec
    with pytest.raises(ValueError, match="mesh order"):
        tshd.placements_of(P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="twice"):
        tshd.placements_of(P("data", "data"), mesh)
    specs = {"a": P(None, "model"), "b": [P(), P("pod")]}
    pl = tshd.to_placements(specs, mesh)
    assert pl["b"][1] == (Shard(0), Replicate(), Replicate())


def test_host_mesh_at_world_size_one():
    import torch.distributed as dist

    from repro_torch.dist import elastic
    from repro_torch.launch.mesh import make_host_mesh

    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh((1, 1), device="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="holds 2 ranks"):
            make_host_mesh((2, 1), device="cpu")
        t = torch.arange(12.0).reshape(3, 4)
        placed = elastic.place({"w": t, "n": 3}, mesh, {"w": tshd.P(None, "model"), "n": tshd.P()})
        assert placed["n"] == 3 and torch.equal(placed["w"].to_local(), t)
        assert torch.equal(elastic.whole(placed["w"]), t)
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh((1, 1))
    assert os.environ.get("RANK") is None
