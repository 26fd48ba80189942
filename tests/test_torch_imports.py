"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports JAX or the ``repro`` package, and its entry points refuse to run on
a CUDA device that is not there."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_import_of_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                f"{path}:{node.lineno} imports {n}")


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import configs
    from repro_torch.launch.serve import build_real_engine
    from repro_torch.models import registry
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.serving.real_backend import RealBackend
    cfg = configs.reduced(configs.get_config("paper-7b"))
    dcfg = configs.reduced(configs.get_draft_config("paper-7b"))
    t, d = registry.get_model(cfg), registry.get_model(dcfg)
    for call in (lambda: t.init(), lambda: t.init_paged_cache(4, 8),
                 lambda: RealBackend(t, d), lambda: build_real_engine(cfg, dcfg),
                 lambda: params_from_numpy(cfg, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
