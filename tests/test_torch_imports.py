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


def test_port_examples_import_nothing_of_jax_or_repro():
    """The port's example scripts name neither jax nor the JAX package."""
    files = sorted((ROOT / "examples").glob("*_torch.py"))
    assert ROOT / "examples" / "quickstart_torch.py" in files
    bad = [b for f in files for b in _forbidden_imports(f)]
    assert not bad, bad


def test_quickstart_torch_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    script = str(ROOT / "examples" / "quickstart_torch.py")
    out = subprocess.run([sys.executable, script, "--device", "cpu"],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "switch recovered from WALs" in out.stdout


def _reference_demo_count():
    """``repro.models.params.count_params`` of the reference example's
    ``CFG_100M`` (examples/lm_train.py, loaded from its file)."""
    import importlib.util

    from repro.models import lm
    from repro.models.params import count_params
    spec = importlib.util.spec_from_file_location(
        "lm_train_reference", ROOT / "examples" / "lm_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return count_params(lm.build_defs(mod.CFG_100M))


def test_lm_train_torch_runs_on_the_cpu(tmp_path):
    """The training example on the CPU at a tiny batch: it exits 0,
    writes its checkpoint under the working directory and prints the
    reference example's parameter count."""
    pytest.importorskip("jax")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    script = str(ROOT / "examples" / "lm_train_torch.py")
    out = subprocess.run([sys.executable, script, "--steps", "2", "--batch",
                          "1", "--seq", "16", "--device", "cpu"], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    n = _reference_demo_count()
    assert f"training demo-100m: {n / 1e6:.1f}M params, 2 steps" in out.stdout
    assert "step     1 loss" in out.stdout
    ckpt = tmp_path / "artifacts" / "ckpt_demo" / "step_00000002"
    assert (ckpt / ".complete").exists()


def test_lm_train_torch_defaults_to_cuda(monkeypatch, tmp_path):
    """Without --device the example asks for cuda: it raises where there
    is none and never falls back to the CPU."""
    import importlib.util
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    spec = importlib.util.spec_from_file_location(
        "lm_train_torch", ROOT / "examples" / "lm_train_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.chdir(tmp_path)
    # main() registers its config here; the test's teardown removes it
    monkeypatch.setitem(sys.modules, "repro_torch.configs.demo_100m", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--steps", "1"])
    assert not (tmp_path / "artifacts").exists()
