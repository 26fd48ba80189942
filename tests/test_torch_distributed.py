"""Distributed correctness of the port on 8 CPU ranks (gloo), the
counterpart of ``tests/test_distributed.py``'s 8 XLA CPU devices.

The reference's weights (JAX, reduced configs, fp32) are bridged through
numpy; 8 spawned processes form a (4, 2) ("data", "model") mesh and run
the port with DTensor weights and inputs through the sharding hooks:

* reduced deepseek-7b at 2 layers: the sharded loss equals the unsharded
  port loss and the reference's within 1e-4, and so do the gradients;
* context-parallel decode (the cache's sequence over ``model``): logits
  within 1e-4 of the unsharded port and the reference;
* a MoE (granite, the dispatch groups aligned with the data shards) and an
  SSM (mamba2) sharded loss, within 1e-4;
* every assigned architecture's placements are constructible on the
  mesh.

Tighter than the reference's own 1e-3."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as rconfigs  # noqa: E402
from repro.models import registry as rregistry  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 8
CASES = {"deepseek-7b": {}, "granite-moe-1b-a400m": {"moe_groups": 4},
         "mamba2-780m": {}}
TOL = 1e-4

_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, port, data = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=8)
from torch.distributed.tensor.experimental import implicit_replication
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch.dryrun import _sharded
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import registry
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.common import leaves

mesh = make_debug_mesh(4, 2, device_type="cpu")
cases = json.loads(sys.argv[4])
arrs = np.load(data)
out = {}


def tree(prefix):
    t = {}
    for key in arrs.files:
        if key.startswith(prefix + "/"):
            node, parts = t, key.split("/")[1:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arrs[key]
    return t


def sharded(fn):
    with implicit_replication(), shd.activation_sharding(("data",), "model"):
        return fn()


for arch, extra in cases.items():
    cfg = configs.reduced(configs.get_config(arch)).replace(
        dtype="float32", num_layers=2, **extra)
    api = registry.get_model(cfg)
    params = params_from_numpy(cfg, tree(arch), device="cpu")
    tok = torch.as_tensor(arrs[arch + ":tokens"]).long()
    batch = {"tokens": tok, "labels": tok}
    trainable = [p.requires_grad_(True) for p in leaves(params)]
    loss = api.loss(params, batch)[0]
    grads = torch.autograd.grad(loss, trainable)
    dp = shd.distribute_tree(params, shd.param_specs(cfg, params, mesh),
                             mesh)
    dleaves = [p.detach().requires_grad_(True) for p in leaves(dp)]
    it = iter(dleaves)

    def rebuild(t):
        return {k: rebuild(v) for k, v in t.items()} if isinstance(t, dict) \
            else next(it)
    dp = rebuild(dp)
    db = shd.distribute_tree(batch, shd.data_specs(cfg, batch, mesh), mesh)
    dloss, dgrads = sharded(lambda: (lambda l: (l, torch.autograd.grad(
        l, dleaves)))(api.loss(dp, db)[0]))
    res = {"loss": loss.item(), "sharded": dloss.full_tensor().item(),
           "grad_err": max((g.full_tensor() - w).abs().max().item()
                           for g, w in zip(dgrads, grads))}
    if arch == "deepseek-7b":
        with torch.no_grad():
            _, cache = api.prefill(params, {"tokens": tok}, 64)
            dc = shd.distribute_tree(cache, shd.cache_specs(cfg, cache, mesh),
                                     mesh)
            lg, _ = api.decode_step(params, cache, tok[:, :1])
            dt = shd.distribute_tree(tok[:, :1], shd.token_specs(
                tok[:, :1], mesh), mesh)
            dlg, dcache = sharded(lambda: api.decode_step(dp, dc, dt))
            res["decode"] = lg.numpy().tolist()
            res["decode_err"] = (dlg.full_tensor() - lg).abs().max().item()
            res["kv_placements"] = [p.dim for p in dcache["k"].placements]
    out[arch] = res

placed = 0
with FakeTensorMode():
    for arch in configs.ASSIGNED_ARCHS:
        cfg = configs.get_config(arch)
        meta = registry.param_specs(cfg)
        _sharded(meta, shd.param_specs(cfg, meta, mesh), mesh)
        placed += 1
out["placed"] = placed
if rank == 0:
    print("RESULT:" + json.dumps(out))
dist.destroy_process_group()
"""


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree, dtype=np.float32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's losses and decode logits, and the 8 ranks' port
    results on the same bridged weights and tokens."""
    arrays, ref = {}, {}
    for i, (arch, extra) in enumerate(CASES.items()):
        rcfg = rconfigs.reduced(rconfigs.get_config(arch)).replace(
            dtype="float32", num_layers=2, **extra)
        api = rregistry.get_model(rcfg)
        params = api.init(jax.random.PRNGKey(i))
        tok = np.random.default_rng(i).integers(
            0, rcfg.vocab_size, size=(8, 32)).astype(np.int32)
        _flat(jax.tree.map(np.asarray, params), arch, arrays)
        arrays[arch + ":tokens"] = tok
        batch = {"tokens": tok, "labels": tok}
        ref[arch] = {"loss": float(api.loss(params, batch)[0])}
        if arch == "deepseek-7b":
            _, cache = api.prefill(params, {"tokens": tok}, 64)
            ref[arch]["decode"] = np.asarray(
                api.decode_step(params, cache, tok[:, :1])[0])
    data = tmp_path_factory.mktemp("dist") / "weights.npz"
    np.savez(data, **arrays)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(port), str(data),
         json.dumps(CASES)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:     # a rank that failed leaves the others waiting
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT:")]
    assert line, outs[0][0][-2000:]
    return ref, json.loads(line[0][len("RESULT:"):])


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_loss_matches_unsharded_and_reference(run, arch):
    ref, got = run
    r = got[arch]
    assert abs(r["sharded"] - r["loss"]) <= TOL, r
    assert abs(r["sharded"] - ref[arch]["loss"]) <= TOL, (r, ref[arch])
    assert abs(r["loss"] - ref[arch]["loss"]) <= TOL


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_gradients_match_unsharded(run, arch):
    assert run[1][arch]["grad_err"] <= TOL, run[1][arch]["grad_err"]


def test_context_parallel_decode_matches(run):
    ref, got = run
    r = got["deepseek-7b"]
    assert r["decode_err"] <= TOL, r["decode_err"]
    np.testing.assert_allclose(np.asarray(r["decode"]),
                               ref["deepseek-7b"]["decode"], atol=TOL,
                               rtol=0)
    # the cache's sequence stays sharded over model, its batch over data
    assert r["kv_placements"] == [1, 2]


def test_all_arch_placements_constructible(run):
    assert run[1]["placed"] == 10


_ONE_RANK = r"""
import json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{sys.argv[1]}",
                        rank=0, world_size=1)
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import registry
from repro_torch.models.common import leaves
from repro_torch.training.optimizer import tree_map
from repro_torch.training.train_loop import loss_and_grads

mesh = make_debug_mesh(1, 1, device_type="cpu")
cfg = configs.reduced(configs.get_draft_config("paper-7b")).replace(
    dtype="bfloat16")
api = registry.get_model(cfg)
params = api.init(device="cpu", seed=0)
tok = torch.randint(0, cfg.vocab_size, (2, 256),
                    generator=torch.Generator().manual_seed(0))
batch = {"tokens": tok, "labels": tok}
plain = tree_map(lambda p: p.detach().requires_grad_(True), params)
dparams = tree_map(lambda p: p.requires_grad_(True), shd.distribute_tree(
    params, shd.param_specs(cfg, params, mesh, weight_mode="fsdp"), mesh))
dbatch = shd.distribute_tree(batch, shd.data_specs(cfg, batch, mesh), mesh)
loss_p, grads_p = loss_and_grads(api, plain, batch)
with implicit_replication(), shd.activation_sharding(("data",), "model"):
    loss_s, grads_s = loss_and_grads(api, dparams, dbatch)
diff = [int((a.full_tensor() != b).sum())
        for a, b in zip(leaves(grads_s), leaves(grads_p))]
print("RESULT:" + json.dumps({
    "loss_equal": bool(torch.equal(loss_s.full_tensor(), loss_p)),
    "leaves": len(diff), "entries_differing": diff}))
dist.destroy_process_group()
"""


def test_one_rank_bf16_sharded_gradients_equal_unsharded_bits():
    """On a one-rank (1, 1) mesh the sharded path runs the unsharded
    path's local ops, so in bf16 the reduced draft's loss and every
    gradient entry equal the unsharded ones bit for bit (the DTensor
    log-sum-exp's gradient is written as ``torch.logsumexp``'s; a
    quotient form flipped bf16 roundings that grew through the layers)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-c", _ONE_RANK, str(port)],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT:")]
    r = json.loads(line[0][len("RESULT:"):])
    assert r["loss_equal"], r
    assert r["leaves"] >= 10 and r["entries_differing"] == [0] * r["leaves"]
