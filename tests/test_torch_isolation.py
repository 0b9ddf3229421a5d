"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package ``repro``,
nor ``msgpack``, which the GPU machine lacks (the port's checkpoint
manifest is JSON).

Two checks each: an AST scan of every import statement, and a subprocess
that blocks the modules in ``sys.modules`` before importing every module of
the port and ``chip_smoke``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
BLOCKED = ("jax", "jaxlib", "repro")
NOT_ON_THE_CARD = ("msgpack",)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_reference(path):
    assert not _imported_roots(path) & set(BLOCKED)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_what_the_card_lacks(path):
    assert not _imported_roots(path) & set(NOT_ON_THE_CARD)


def _import_everything(blocked: tuple[str, ...]) -> None:
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = "\n".join([
        "import importlib, sys",
        f"for name in {blocked!r}:",
        "    sys.modules[name] = None  # any import of it now raises ImportError",
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "import repro_torch.api",
        "print(len(sys.modules))",
    ])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(modules) > 20


def test_port_imports_with_jax_and_the_reference_blocked():
    _import_everything(BLOCKED)


def test_port_imports_with_what_the_card_lacks_blocked():
    _import_everything(NOT_ON_THE_CARD)
