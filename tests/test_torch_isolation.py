"""The port stands alone: nothing under ``src/repro_torch/``, nothing in
``chip_smoke.py`` and nothing the card-only tests import brings in ``jax``,
the JAX package ``repro``, or the top-level ``benchmarks`` and
``examples`` packages (which import ``repro``; the port's twins live in
``repro_torch.benchmarks``)."""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks", "examples")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_gpu.py",
        ROOT / "tools" / "b1_b4_variants.py",
        ROOT / "tools" / "b2_rounding.py",
        ROOT / "tools" / "conv_rounding.py",
        ROOT / "tools" / "migrate_agreement.py",
        ROOT / "tools" / "profile_modes.py",
        ROOT / "tools" / "train_lr_sweep.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_no_source_imports_jax_or_repro():
    files = _port_files()
    assert len(files) > 15
    bad = [f"{f.relative_to(ROOT)}:{line} imports {root}"
           for f in files for root, line in _imported_roots(f)
           if root in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = "\n".join(
        ["import importlib, sys", "import repro_torch"]
        + [f"importlib.import_module({m!r})" for m in modules]
        + ["bad = sorted(m for m in sys.modules if m.split('.')[0] in "
           f"{FORBIDDEN!r})",
           "assert not bad, bad",
           f"print(len({modules!r}))"])
    assert {"repro_torch.pshard", "repro_torch.launch.mesh",
            "repro_torch.launch.sharding", "repro_torch.launch.shapes",
            "repro_torch.models.sharded"} <= set(modules)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(modules) > 10
