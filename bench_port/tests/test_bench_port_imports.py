"""No module of the benchmark imports JAX, the JAX package (``repro``) or
the JAX package's benchmarks: top-level names are compared whole, since
``repro_torch`` begins with ``repro``."""
import ast

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted((ROOT / "bench_port").rglob("*.py"))


def top_level_imports(path):
    return imported(ast.parse(path.read_text(), str(path)))


def imported(tree):
    """Top-level names of every module ``tree`` imports, at any depth."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_forbidden_import(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_check_compares_whole_names():
    assert "repro" not in {"repro_torch"} and "repro_torch".split(".")[0] \
        not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for name in ("check.py", "traffic.py", "flops.py", "stats.py"):
        assert not top_level_imports(ROOT / "bench_port" / "lib" / name) & \
            {"repro_torch"}


ARCHS = sorted((ROOT / "bench_port" / "archs").glob("*.py"))


@pytest.mark.parametrize("path", ARCHS, ids=[p.stem for p in ARCHS])
def test_an_architecture_module_imports_the_program_only_for_its_config(
        path):
    """Of an architecture module, only ``port_config`` (which builds the
    port's ``ModelConfig``) may import the program: the reference and the
    counts import nothing of it."""
    tree = ast.parse(path.read_text(), str(path))
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "port_config":
            continue
        assert "repro_torch" not in imported(node), (path.name, node.lineno)
