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


NEW_FAMILY_MODULES = ["repro_torch.models.moe",
                      "repro_torch.configs.granite_moe_1b",
                      "repro_torch.configs.grok1_314b",
                      "repro_torch.configs.paligemma_3b",
                      "repro_torch.configs.gemma_7b",
                      "repro_torch.models.mamba2",
                      "repro_torch.models.hybrid",
                      "repro_torch.models.encdec",
                      "repro_torch.configs.mamba2_780m",
                      "repro_torch.configs.zamba2_1p2b",
                      "repro_torch.configs.whisper_medium",
                      "repro_torch.configs.qwen2_72b"]


@pytest.mark.parametrize("name", NEW_FAMILY_MODULES)
def test_new_family_modules_import_without_jax(name):
    """The MoE, SSM, hybrid and encoder-decoder models and their configs
    import with JAX and the reference blocked, and every config's model
    builds on meta tensors."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "importlib.import_module(sys.argv[1])\n"
        "from repro_torch import configs\n"
        "from repro_torch.models import registry\n"
        "n = sum(registry.param_count(configs.get_config(a))\n"
        "        for a in configs.list_archs())\n"
        "print(n)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, name], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 0


SIM_TIER_MODULES = ["repro_torch.serving.simulator",
                    "repro_torch.serving.router",
                    "repro_torch.serving.controlplane",
                    "repro_torch.serving.cluster",
                    "repro_torch.serving.faults",
                    "repro_torch.serving.observability",
                    "repro_torch.serving.workload",
                    "repro_torch.serving.costmodel",
                    "repro_torch.models.registry",
                    "repro_torch.launch.serve"]


@pytest.mark.parametrize("name", SIM_TIER_MODULES)
def test_sim_tier_modules_load_no_jax_or_repro(name):
    """The simulated tier's and the fleet layer's modules, and the ones
    this slice grew, load neither ``jax`` nor any ``repro`` module: after
    the import, ``sys.modules`` holds none (nothing is blocked, so an
    indirect import would show)."""
    code = (
        "import sys, importlib\n"
        "importlib.import_module(sys.argv[1])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'repro')]\n"
        "print(len(bad), bad[:5])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, name], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 []"), out.stdout


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
    from repro_torch.serving.real_backend import (DenseSlotBackend,
                                                  RealBackend)
    cfg = configs.reduced(configs.get_config("paper-7b"))
    dcfg = configs.reduced(configs.get_draft_config("paper-7b"))
    t, d = registry.get_model(cfg), registry.get_model(dcfg)
    for call in (lambda: t.init(), lambda: t.init_paged_cache(4, 8),
                 lambda: t.init_cache(2, 8), lambda: RealBackend(t, d),
                 lambda: DenseSlotBackend(t, d),
                 lambda: build_real_engine(cfg, dcfg),
                 lambda: params_from_numpy(cfg, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
