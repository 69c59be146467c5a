"""The port's boundary: ``repro_torch`` and ``chip_smoke.py`` import neither
JAX nor anything of ``repro``, and its entry points refuse to run on the
CPU unless asked to."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def test_import_pulls_in_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 25  # every submodule was imported


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_never_imports_jax_or_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: import {name}"


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import build_model
    from repro_torch.quant.qat import policy_for
    from repro_torch.serve import ServeEngine
    from repro_torch.train.serve import quantize_for_serving

    model = build_model(get_config("glm4-9b", smoke=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init()
    params = model.init(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        quantize_for_serving(model, params, policy_for(model, 4))
    sparams = quantize_for_serving(model, params, policy_for(model, 4), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, sparams)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, sparams, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--requests", "1", "--gen", "2"])
    # asked for, the CPU serves
    eng = ServeEngine(model, sparams, device="cpu", max_len=16)
    eng.submit([1, 2, 3], 2)
    assert eng.run_until_drained()["tokens_total"] == 2


def test_launcher_refuses_unported_flags():
    from repro_torch.launch import serve as launcher

    for flags in (["--spec-k", "2"], ["--cache", "slot"],
                  ["--mode", "static"], ["--prefix-cache"], ["--tenants", "2"]):
        with pytest.raises(SystemExit):
            launcher.parse_args(["--device", "cpu", *flags])
