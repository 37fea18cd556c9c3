"""The port's import rule: deepflows_tpu_torch and chip_smoke.py import
torch and never jax nor anything of the JAX package deepflows_tpu — the
card's machine has no JAX at all.  Nor has it transformers, safetensors,
PIL, matplotlib, torchvision or grpc: the port imports those only inside
the functions that need them, and every module imports with them
blocked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "deepflows_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "deepflows_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_relative_imports_stay_inside_the_port():
    for path in sorted(PORT.rglob("*.py")):
        depth = len(path.relative_to(PORT).parts) - 1  # packages above the file
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level - 1 <= depth, f"{path} climbs out of the port"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepflows_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'deepflows_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'deepflows_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('deepflows_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    ))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# packages the card's machine lacks: imported only inside the functions
# that use them
OPTIONAL = ("transformers", "safetensors", "PIL", "matplotlib", "matplotlib_inline",
            "torchvision", "grpc")


def _module_level_imports(tree):
    """Imports that run when the module is imported: the module body and
    class bodies, through if / try / with blocks, but not function bodies."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_optional_packages_not_imported_at_module_level(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = [n for n in _module_level_imports(tree) if n.split(".")[0] in OPTIONAL]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at module level"


def test_every_module_imports_with_the_optional_packages_blocked():
    """A finder that refuses the optional packages, as their absence would:
    ``import deepflows_tpu_torch``, ``deepflows_tpu_torch.utils``, every
    module of the port and chip_smoke.py still import."""
    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        f"BLOCKED = {OPTIONAL!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        "import deepflows_tpu_torch\n"
        "import deepflows_tpu_torch.utils as u\n"
        "assert u.Trainer and u.BPETokenizer and u.profiling.step_report\n"
        "import deepflows_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'deepflows_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in BLOCKED]\n"
        "assert not bad, bad\n"
        "try:\n"
        "    import PIL\n"
        "except ImportError:\n"
        "    print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    ))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
