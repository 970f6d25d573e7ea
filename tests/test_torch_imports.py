"""Every module of the port imports with ``jax`` and ``repro`` blocked: the
port keeps its own copy of what it needs and imports torch and numpy
only.  Imports inside functions run only when called, so the port's
sources and ``chip_smoke.py`` are also read with ``ast`` at every
depth."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None           # any import of them now fails
import repro_torch
mods = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
print(len(mods))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_files = sum(1 for _ in (ROOT / "src" / "repro_torch").rglob("*.py"))
    assert int(out.stdout.split()[-1]) == n_files


def _forbidden_imports(path: Path):
    """Every import of jax, jaxlib or repro in ``path``, at any depth
    (module level, inside functions, classes or conditionals)."""
    tree = ast.parse(path.read_text())
    names = [(n.lineno, a.name) for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names]
    names += [(n.lineno, n.module) for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module
              and n.level == 0]
    return [f"{path.relative_to(ROOT)}:{line}: {m}" for line, m in names
            if m.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    """chip_smoke.py's imports name neither jax nor the JAX package."""
    assert not _forbidden_imports(ROOT / "chip_smoke.py")


def test_port_sources_import_nothing_of_jax_or_repro_at_any_depth():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert files
    bad = [b for f in files for b in _forbidden_imports(f)]
    assert not bad, bad
