"""The port stands alone: nothing under ``src/repro_torch/`` (its runtime
subpackages ``checkpoint``, ``runtime`` and ``obs`` included), nor
``chip_smoke.py`` or the port's examples, imports JAX or the JAX package, and
``triton`` is only ever imported inside the function that launches a kernel
(the CPU tests import every module and have no ``triton``)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))
RUNTIME_SUBPACKAGES = ("checkpoint", "runtime", "obs")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(tree: ast.AST):
    """(module name, node, inside a function?) for every import."""
    out = []

    def visit(node, in_fn):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                out.extend((a.name, child, in_fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                out.append((child.module or "", child, in_fn))
            visit(child, fn)

    visit(tree, False)
    return out


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("sub", RUNTIME_SUBPACKAGES)
def test_runtime_subpackages_are_checked(sub):
    """The single-process runtime's subpackages are among the files the
    import checks read, each with its ``__init__``."""
    pkg = ROOT / "src" / "repro_torch" / sub
    files = [p for p in PORT_FILES if pkg in p.parents]
    assert pkg / "__init__.py" in files and len(files) >= 3


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, node, _ in _imports(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name}:{node.lineno} imports {name}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_triton_imported_only_inside_functions(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, node, in_fn in _imports(tree):
        if name.split(".")[0] == "triton":
            assert in_fn, f"{path.name}:{node.lineno} imports triton at module level"


def test_checker_catches_violations():
    bad = ast.parse(
        "import jax.numpy as jnp\nfrom repro.core import ghost\nimport triton\n"
        "def f():\n    import triton.language as tl\n"
    )
    found = [(n, fn) for n, _, fn in _imports(bad)]
    assert ("jax.numpy", False) in found and ("repro.core", False) in found
    assert ("triton", False) in found and ("triton.language", True) in found
