"""Boundaries of the PyTorch port: it never imports JAX or the reference
package, builds nothing at import, and its entry points run on the card by
default — raising, never carrying on quietly on the host, when there is
none."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_reference(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_importing_the_engine_loads_no_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "import repro_torch.query.engine, repro_torch.db\n"
        "from repro_torch.kernels import _build, dispatch\n"
        "dispatch.ensure_registered()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "assert not _build._LIBS\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_checkpoint_path_loads_no_ml_dtypes(tmp_path):
    """The launchers' checkpoints store and read bf16 by its bit patterns:
    a train launcher run that saves and resumes a bf16 state loads neither
    ml_dtypes nor JAX nor the reference."""
    code = (
        "import sys\n"
        "from repro_torch.launch import serve, train\n"
        "argv = ['--arch', 'mamba2-1.3b', '--reduced', '--seq-len', '8',\n"
        "        '--global-batch', '1', '--device', 'cpu',\n"
        f"        '--checkpoint-dir', {str(tmp_path)!r},\n"
        "        '--checkpoint-every', '1']\n"
        "train.main(argv + ['--steps', '1'])\n"
        "state = train.main(argv + ['--steps', '2'])\n"
        "assert int(state['step']) == 2\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('ml_dtypes',)!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "clean"
    assert "[restore] resumed from step 1" in out.stdout


@pytest.mark.parametrize(
    "path", [p for d in ("data", "checkpoint", "dist")
             for p in sorted((PORT / d).glob("*.py"))]
    + [PORT / "launch" / "train.py", PORT / "launch" / "serve.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_checkpoint_path_files_import_no_ml_dtypes(path):
    assert "ml_dtypes" not in imported_roots(path)


@pytest.mark.parametrize(
    "package", sorted(p.parent.name for p in PORT.glob("*/__init__.py")))
def test_each_package_imports_first(package):
    """No import cycle: every package of the port imports in a fresh
    interpreter before any other (repro_torch.store used to fail there)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c",
                          f"import repro_torch.{package}"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_device_constructors_need_cuda():
    """With no CUDA device the defaults raise; with one they land on it."""
    from repro_torch.configs import get_config
    from repro_torch.db import BitPackedColumn, Table, table_from_arrays
    from repro_torch.models import lm
    from repro_torch.query import QueryEngine
    from repro_torch.serve.engine import ServeEngine
    cpu_table = Table.synthetic("t", 10, {"a": 8}, device="cpu")
    state = {"a": (np.zeros(3, np.uint32), 8, 10, None)}
    cfg = get_config("internlm2-1.8b").reduced(num_layers=1)
    cpu_model = lm.init(cfg, device="cpu")
    calls = [lambda: Table.synthetic("t", 10, {"a": 8}),
             lambda: BitPackedColumn.from_values("a", [1, 2], 8),
             lambda: table_from_arrays(state),
             lambda: QueryEngine(cpu_table),
             lambda: lm.init(cfg),
             lambda: lm.init_caches(cfg, 1, 8),
             lambda: ServeEngine(cfg, cpu_model)]
    if torch.cuda.is_available():
        assert Table.synthetic("t", 10, {"a": 8}).device.type == "cuda"
        assert lm.init_caches(cfg, 1, 8)[0]["k"].device.type == "cuda"
        with pytest.raises(ValueError, match="lives on"):
            QueryEngine(cpu_table)
        with pytest.raises(ValueError, match="lives on"):
            ServeEngine(cfg, cpu_model)
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_build_paths_are_keyed_by_source_hash():
    from repro_torch.kernels import _build
    for name, src in _build.SOURCES.items():
        assert (_build.CSRC / src).is_file()
        p = _build.library_path(name)
        assert p.parent == _build.BUILD_DIR
        assert p.name.startswith(f"{name}-") and p.suffix == ".so"
        assert p == _build.library_path(name)
    assert _build.BUILD_DIR == ROOT / "build" / "repro_torch"
    assert all((_build.CSRC / h).is_file() for h in _build.HEADERS)


def test_cuda_sources_name_the_kernel_they_replace():
    from repro_torch.kernels import _build
    for src in _build.SOURCES.values():
        text = (_build.CSRC / src).read_text()
        assert "Replaces the TPU kernel" in text and "Bound:" in text


def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path):
    """chip_smoke.py alone in a directory, or on a machine with no card,
    exits non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [(tmp_path, alone)]
    if not torch.cuda.is_available():
        runs.append((ROOT, ROOT / "chip_smoke.py"))
    for cwd, script in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
