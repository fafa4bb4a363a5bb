"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX, nor ml_dtypes, nor anything of the JAX package ``repro``."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        .replace(".__init__", "") for p in PORT.rglob("*.py")
        if p.name != "__init__.py" or p.parent != PORT)
    code = (
        "import sys, importlib, runpy\n"
        "import repro_torch\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='smoke')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_kernel_modules_are_checked_and_importing_builds_nothing():
    """Every kernel module is among the sources checked above, and
    importing the whole port compiles and loads no kernel."""
    names = {p.name for p in SOURCES}
    for mod in ("led_matmul.py", "paged_attention.py", "chunk_attention.py"):
        assert mod in names
    code = (
        "import importlib, pathlib\n"
        "from repro_torch.kernels import _build\n"
        f"port = pathlib.Path({str(PORT)!r})\n"
        "for p in sorted(port.rglob('*.py')):\n"
        "    parts = p.relative_to(port).with_suffix('').parts\n"
        "    name = '.'.join(('repro_torch',) + parts)\n"
        "    importlib.import_module(name.replace('.__init__', ''))\n"
        "assert not _build._libs and not _build.build_seconds\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_card():
    """On a machine without CUDA the smoke exits non-zero and prints no
    result line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
