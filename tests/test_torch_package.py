"""The port as a package: it imports nothing of JAX or of the JAX package,
its entry points raise rather than fall back to the CPU without a CUDA card,
and importing it builds nothing. None of this needs JAX."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.build([engine.GuestSpec(64)], engine.HostSpec(hp_ratio=8, cl=4))
    spec, st = engine.build([engine.GuestSpec(64)], engine.HostSpec(hp_ratio=8, cl=4),
                            device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.init_engine_state(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.run(spec, st, np.zeros((1, 1, 4), np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.run_series(spec, st, np.zeros((1, 1, 4), np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.run_reference(spec, st, np.zeros((1, 1, 4), np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.init_churn(spec)
    cs = engine.init_churn(spec, st, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.run_churn(spec, cs, np.zeros((1, 1, 4), np.int32))


def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_import_builds_nothing():
    """Importing every module of the port never starts nvcc."""
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = (
        "import subprocess\n"
        "def refuse(*a, **k): raise AssertionError(f'process started: {a}')\n"
        "subprocess.Popen = subprocess.run = refuse\n"
        "import importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from repro_torch.kernels import build\n"
        "assert build._LIB is None\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_synthesis_calls_no_transcendental_library_function():
    """The threefry streams and the window functions compute erf_inv, log,
    log1p and pow from exactly rounded operations: no torch (or tensor)
    transcendental, whose results differ between devices and from XLA."""
    banned = {"erfinv", "erf", "log", "log1p", "log2", "exp", "exp2", "expm1", "pow",
              "float_power", "lgamma", "special"}
    for name in ("prng.py", "traces.py"):
        tree = ast.parse((ROOT / "src" / "repro_torch" / "data" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr in banned:
                host = isinstance(node.value, ast.Name) and node.value.id in ("np", "math")
                assert host, (name, node.lineno, node.attr)
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow):
                assert isinstance(node.left, ast.Constant), (name, node.lineno)
