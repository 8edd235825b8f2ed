"""The port's import boundary: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package (checked on the AST, so nothing is
imported to check it)."""
import ast
import os

import pytest

pytest.importorskip("torch")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_port_has_files():
    files = _port_files()
    assert len(files) > 15
    assert any(f.endswith("chip_smoke.py") for f in files)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [(line, name) for line, name in _imported(tree) if _forbidden(name)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


@pytest.mark.parametrize("src, bad", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from jaxlib import xla_client", True), ("from repro import sparse", True),
    ("import repro.core.masks", True),
    ("importlib.import_module('repro.configs.x')", True),
    ("from repro_torch import sparse", False), ("import torch", False),
    ("importlib.import_module('repro_torch.configs.x')", False),
])
def test_boundary_check_catches_imports(src, bad):
    found = [n for _, n in _imported(ast.parse(src)) if _forbidden(n)]
    assert bool(found) == bad
