"""No module of the benchmark imports JAX, the JAX package (``repro``) or
the JAX package's benchmarks: top-level names are compared whole, since
``repro_torch`` begins with ``repro``."""
import ast

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted((ROOT / "bench_port").rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
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
    for name in ("reference.py", "check.py", "traffic.py", "flops.py",
                 "stats.py"):
        assert not top_level_imports(ROOT / "bench_port" / "lib" / name) & \
            {"repro_torch"}
