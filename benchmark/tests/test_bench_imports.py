"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Modules are compared by their
whole top-level name: ``wayne_tpu_torch`` is not ``wayne_tpu``."""

import ast
import os

import pytest

from benchmark.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def _sources(under: str):
    for d, _, files in os.walk(under):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path: str) -> set[str]:
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_top_level_names_are_whole():
    assert "wayne_tpu_torch".split(".", 1)[0] != "wayne_tpu"
    src = "import wayne_tpu_torch.ops\nfrom jax import numpy\n"
    tree = ast.parse(src)
    got = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            got |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            got.add(node.module.split(".", 1)[0])
    assert got == {"wayne_tpu_torch", "jax"}


@pytest.mark.parametrize("path", sorted(_sources(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax",
                                          "wayne_tpu"}


@pytest.mark.parametrize(
    "path", sorted(_sources(os.path.join(BENCH, "reference"))),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "wayne_tpu_torch" not in top_level_imports(path)


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys
    import types

    from benchmark.harness.runner import forbidden_modules

    before = forbidden_modules()
    monkeypatch.setitem(sys.modules, "wayne_tpu_torch_fake",
                        types.ModuleType("wayne_tpu_torch_fake"))
    assert forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax.numpy" in forbidden_modules()
