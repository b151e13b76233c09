"""Import hygiene of the PyTorch port: no module of src/repro_torch, not
chip_smoke.py and no examples/torch_*.py imports JAX or the JAX package
(the machine with the card has no JAX), and the kernel entry points catch
nothing around a launch (no silent fallback to the plain versions)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "examples").glob("torch_*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax")


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(ROOT)) for p in MODULES])
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line}: {name}" for line, name in _imports(tree)
           if _forbidden(name)]
    assert not bad, bad


def test_the_port_has_modules_and_the_scan_sees_them():
    names = {p.relative_to(PORT).as_posix() for p in MODULES
             if p.is_relative_to(PORT)}
    for want in ("bridge.py", "kernels/ops.py", "kernels/build.py",
                 "kernels/ssd_scan.py", "models/layers.py", "models/ssm.py",
                 "serving/engine.py", "core/telemetry.py",
                 "dpu/sidecar.py", "obs/trace.py", "serving/router.py",
                 "launch/serve.py", "sim/cluster.py", "lint/wiring.py",
                 "data/pipeline.py", "configs/llama3_2_3b.py",
                 "models/moe.py", "parallel/sharding.py",
                 "launch/dryrun.py", "training/elastic.py"):
        assert want in names
    assert {p.name for p in MODULES if p.parent.name == "examples"} == {
        "torch_quickstart.py", "torch_serve_with_dpu_telemetry.py",
        "torch_train_100m.py", "torch_pathology_drilldown.py"}
    assert _forbidden("repro.core") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.core")


@pytest.mark.parametrize("module", ["ops.py", "flash_attention.py",
                                    "paged_attention.py", "ssd_scan.py"])
def test_kernel_entry_points_catch_nothing(module):
    tree = ast.parse((PORT / "kernels" / module).read_text())
    handlers = [n.lineno for n in ast.walk(tree)
                if isinstance(n, (ast.Try, ast.ExceptHandler))]
    assert not handlers, f"{module}: try/except at lines {handlers}"


def test_importing_the_port_builds_nothing(tmp_path):
    code = ("import repro_torch.serving, repro_torch.bridge, "
            "repro_torch.kernels.ops as o, repro_torch.sim, "
            "repro_torch.lint, repro_torch.data, sys; "
            "assert 'jax' not in sys.modules; "
            "assert 'triton' not in sys.modules; "
            "from repro_torch.kernels import build; "
            "assert not build.build_logs")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=tmp_path, timeout=120)
