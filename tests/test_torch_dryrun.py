"""The dry run and the structural roofline on fake process groups, at
reduced size on the CPU.

``run_cell`` executes a cell's step under ``FakeTensorMode`` with DTensor
weights and inputs on a fake mesh and reads rank 0's local shards.  These
tests hold it to what it claims: the reference's result keys (less the two
that describe an XLA-CPU artifact), per-device flops counted on local
shards (times the mesh size they equal the unsharded count where nothing
is replicated, and exceed 1/8 of it where tp_seq replicates work, while a
flop counter at the DTensor level sees the global op), argument bytes
equal to the local shards' bytes, and a structural total equal to the
full-depth count.  Also the flash kernel's custom ops under fake tensors
(shapes, flop formula) and the wrapper's refusal of a DTensor."""
import ast
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_pairs, flash_attention)
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.models import registry  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN = ShapeConfig("train_4k", seq_len=64, global_batch=16, kind="train")
PREFILL = ShapeConfig("prefill_32k", seq_len=64, global_batch=8,
                      kind="prefill")
DECODE = ShapeConfig("decode_32k", seq_len=64, global_batch=8, kind="decode")
REMOVED = {"cpu_upcast_artifact_bytes", "peak_bytes_tpu_adjusted"}


def _reduced(arch, **kw):
    """The reduced config as overrides (the cell sets ``remat``)."""
    red = configs.reduced(configs.get_config(arch)).replace(**kw)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if f.name not in ("name", "remat")}


def _reference_keys():
    """The keys of the reference's ``run_cell`` result (its ``res`` dict,
    the keys it adds, and ``build_cell``'s meta), read from its source:
    importing it would set XLA's device count."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" /
                      "dryrun.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Dict):
            name = getattr(node.targets[0], "id", None)
            if name in ("res", "meta"):
                keys |= {k.value for k in node.value.keys
                         if isinstance(k, ast.Constant)}
        if isinstance(node, ast.Subscript) and getattr(
                node.value, "id", None) == "res" and isinstance(
                    node.slice, ast.Constant) and isinstance(node.ctx,
                                                             ast.Store):
            keys.add(node.slice.value)
    return keys


def _run(shape, *args, **kw):
    with dryrun.fake_world(math.prod(shape)):
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        return dryrun.run_cell(*args, mesh=mesh, verbose=False, **kw)


def _plain_flops(arch, shape, **kw):
    """Flops of the same step on plain (unsharded) fake tensors."""
    cfg = configs.get_config(arch).replace(**_reduced(arch, **kw))
    if shape.kind == "train":
        cfg = cfg.replace(remat="full")
    api = registry.get_model(cfg)
    with FakeTensorMode():
        params = _fake(registry.param_specs(cfg), shape.kind == "train")
        ins = configs.input_specs(cfg, shape, device="cpu")
        with FlopCounterMode(display=False) as fc:
            if shape.kind == "train":
                from repro_torch.training.optimizer import adamw_init
                from repro_torch.training.train_loop import make_train_step
                _, step = make_train_step(cfg)
                step(params, adamw_init(params), ins["batch"])
            elif shape.kind == "decode":
                api.decode_step(params, ins["cache"], ins["tokens"])
            else:
                api.prefill(params, ins["batch"], shape.seq_len)
    return fc.get_total_flops()


def _fake(tree, grad):
    if isinstance(tree, dict):
        return {k: _fake(v, grad) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype).requires_grad_(grad)


CELLS = [("deepseek-7b", TRAIN, (4, 2)),
         ("granite-moe-1b-a400m", DECODE, (4, 2)),
         ("mamba2-780m", PREFILL, (4, 2)), ("whisper-medium", DECODE, (4, 2)),
         ("deepseek-7b", TRAIN, (16, 16)),
         ("granite-moe-1b-a400m", DECODE, (16, 16))]


@pytest.mark.parametrize("arch,cell,shape", CELLS)
def test_run_cell_returns_the_reference_keys(arch, cell, shape):
    res = _run(shape, arch, cell, cfg_override=_reduced(arch))
    want = _reference_keys() - REMOVED
    assert len(want) >= 20
    assert want <= set(res), want - set(res)
    assert not REMOVED & set(res)
    assert res["chips"] == math.prod(shape)
    assert res["device"] == "cpu"            # a local shard's, not a label
    assert res["mesh"] == "x".join(map(str, shape))
    assert res["flops_per_device"] > 0 and res["bytes_per_device"] > 0
    assert res["peak_bytes_per_device"] >= res["argument_bytes_per_device"]
    assert res["bottleneck"] in ("compute", "memory", "collective")
    json.dumps(res)


def test_fsdp_train_flops_are_counted_on_local_shards():
    """An fsdp train step over 8 data ranks (ZeRO-3: each rank's products
    see its own rows) counts 1/8 of the unsharded flops per device; at
    the DTensor level the count would be the whole step's."""
    res = _run((8, 1), "deepseek-7b", TRAIN,
               cfg_override=_reduced("deepseek-7b"), accum_override=1)
    assert res["weight_mode"] == "fsdp"
    plain = _plain_flops("deepseek-7b", TRAIN)
    assert abs(8 * res["flops_per_device"] - plain) <= 0.01 * plain, (
        8 * res["flops_per_device"], plain)


def test_fsdp_train_flops_on_data_and_model_axes():
    """On (4, 2) the products split over both axes, except the work
    DTensor's rules leave whole (one (tokens x d x d) product of each
    layer's backward, ROADMAP A12): 8 x the per-device count lies within
    10 % above the unsharded one."""
    res = _run((4, 2), "deepseek-7b", TRAIN,
               cfg_override=_reduced("deepseek-7b"), accum_override=1)
    plain = _plain_flops("deepseek-7b", TRAIN)
    assert plain <= 8 * res["flops_per_device"] <= 1.1 * plain, (
        8 * res["flops_per_device"], plain)


def test_tp_seq_decode_counts_replicated_work():
    """tp_seq replicates q / k / v and the attention's heads over model:
    per-device flops exceed 1/8 of the unsharded count."""
    res = _run((4, 2), "deepseek-7b", DECODE,
               cfg_override=_reduced("deepseek-7b"))
    assert res["weight_mode"] == "tp_seq"
    plain = _plain_flops("deepseek-7b", DECODE)
    assert res["flops_per_device"] > plain / 8, (res["flops_per_device"],
                                                 plain)
    assert res["flops_per_device"] < plain


def test_a_dtensor_level_flop_counter_sees_the_global_op():
    """The trap the per-device count avoids: (64, 8192) @ (8192, 8192)
    with the weight sharded 2-D on a fake 256-rank mesh reads the whole
    product at the DTensor level, 1/256 of it on rank 0's shards."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with dryrun.fake_world(256):
        mesh = init_device_mesh("cpu", (32, 8),
                                mesh_dim_names=("data", "model"))
        fake = FakeTensorMode()
        fake.__enter__()
        x = distribute_tensor(torch.empty(64, 8192), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(8192, 8192), mesh,
                              [Shard(0), Shard(1)])
        with dryrun._dtensor_bookkeeping_aside():
            with FlopCounterMode(display=False) as fc:
                x @ w
            counter = dryrun.LocalCounter(mesh)
            with counter:
                x @ w
        fake.__exit__(None, None, None)
    assert fc.get_total_flops() == 2 * 64 * 8192 * 8192
    assert counter.flops == 2 * 64 * 8192 * 8192 // 256
    assert counter.coll_counts["all-gather"] >= 1


def test_argument_bytes_equal_the_local_shards():
    arch = "deepseek-7b"
    red = _reduced(arch)
    res = _run((4, 2), arch, TRAIN, cfg_override=red, accum_override=1)
    cfg = configs.get_config(arch).replace(**red)
    sizes = {"data": 4, "model": 2}
    meta = registry.param_specs(cfg)
    p = dryrun._local_size(meta, shd.param_specs(cfg, meta, sizes), sizes)
    # bf16 weights, fp32 m and v alike, the step counter, the batch
    n_local = p // 2
    batch = configs.input_specs(cfg, TRAIN)["batch"]
    b = dryrun._local_size(batch, shd.data_specs(cfg, batch, sizes), sizes)
    assert res["argument_bytes_per_device"] == p + 2 * 4 * n_local + 4 + b


def test_structural_total_equals_the_full_depth_count():
    """Eager counting sees every layer: the two-depth extrapolation of a
    uniform stack lands on the full-depth count."""
    arch, red = "deepseek-7b", _reduced("deepseek-7b", num_layers=6)
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        st = roofline.structural_cell(arch, PREFILL, mesh, verbose=False,
                                      cfg_override=red)
        full = dryrun.run_cell(arch, PREFILL, mesh, verbose=False,
                               cfg_override=red)
    assert st["depth"] == 6 and (st["L1"], st["L2"]) == (2, 4)
    for term in roofline.TERMS:
        assert st[term] == pytest.approx(full[term], rel=1e-9), term
    assert st["flops_per_device_per_layer"] > 0


def test_flash_custom_ops_under_fake_tensors():
    """The flash kernel's custom ops on fake CUDA tensors: the kernels'
    shapes, no launch, and the flop formula over the visited pairs."""
    n = flash_attention.launches
    with FakeTensorMode():
        q = torch.empty((2, 300, 8, 64), device="cuda", dtype=torch.bfloat16)
        k = torch.empty((2, 300, 2, 64), device="cuda", dtype=torch.bfloat16)
        with FlopCounterMode(display=False) as fc:
            out = flash_attention(q, k, k, causal=True)
        o2, lse = torch.ops.repro_torch.flash_attention_lse(q, k, k, True, 5)
    assert out.shape == q.shape and out.device.type == "cuda"
    assert lse.shape == (2, 8, 300) and lse.dtype == torch.float32
    assert flash_attention.launches == n
    assert fc.get_total_flops() == 4 * 2 * 8 * 64 * (300 * 301 // 2)
    assert attention_pairs(300, 300, True, 0) == 300 * 301 // 2
    assert attention_pairs(4, 4, True, 2) == 2 + 2 + 3 + 4
    assert attention_pairs(16, 1500, False, 0) == 16 * 1500


@pytest.mark.parametrize("causal,prefix_len", [(True, 0), (True, 40),
                                               (False, 0)])
def test_flash_backward_flop_formula_is_five_halves_of_the_forward(
        causal, prefix_len):
    """The backward op's flop formula, as FlopCounterMode calls it on fake
    CUDA tensors (a train cell's route on the card): five products over
    the visited pairs where the forward has two."""
    with FakeTensorMode():
        q = torch.empty((2, 300, 8, 64), device="cuda", dtype=torch.bfloat16)
        k = torch.empty((2, 300, 2, 64), device="cuda", dtype=torch.bfloat16)
        with FlopCounterMode(display=False) as fwd:
            o, lse = torch.ops.repro_torch.flash_attention_lse(
                q, k, k, causal, prefix_len)
        with FlopCounterMode(display=False) as bwd:
            dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
                q, k, k, o, lse, o, causal, prefix_len)
    pairs = attention_pairs(300, 300, causal, prefix_len)
    assert fwd.get_total_flops() == 4 * 2 * 8 * 64 * pairs
    assert bwd.get_total_flops() == 5 * fwd.get_total_flops() // 2
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)


def test_flash_wrapper_refuses_a_dtensor():
    from torch.distributed.tensor import Replicate, distribute_tensor
    with dryrun.fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        q = distribute_tensor(torch.zeros((1, 8, 2, 32)), mesh,
                              [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="not DTensors"):
            flash_attention(q, q, q, causal=True)


def test_dryrun_cli_on_a_fake_256_rank_group(tmp_path):
    out = tmp_path / "cell.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-72b", "--shape", "decode_32k", "--device", "cpu", "--json",
         str(out)], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(out.read_text())
    assert res["failures"] == []
    (cell,) = res["results"]
    assert cell["chips"] == 256 and cell["mesh"] == "32x8"
    assert cell["weight_mode"] == "tp_seq" and cell["fits_hbm"]
    # the 80-layer cache and the weights, sharded 256 ways
    assert 20e9 < cell["argument_bytes_per_device"] < 30e9
