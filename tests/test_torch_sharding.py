"""The port's sharding rules against the reference's, leaf by leaf.

The reference's rule engine reads only ``mesh.shape`` (axis name -> size),
so both packages are handed the same stand-in meshes and need no devices:
``param_specs`` for every assigned architecture x weight mode x mesh, the
batch / cache / token specs of both packages' ``input_specs``, the input
shapes and dtypes themselves, the shape registry, and the DTensor
placements a spec becomes.  The port stacks the hybrid family's layers,
which the reference keeps as a list: there the port's spec is ``None``
for the layer axis followed by the reference's spec of one layer."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as rconfigs  # noqa: E402
from repro.configs import base as rbase  # noqa: E402
from repro.distributed import sharding as rshd  # noqa: E402
from repro.models import registry as rregistry  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import registry  # noqa: E402

MESHES = {"4x2": {"data": 4, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "32x8": {"data": 32, "model": 8},
          "2x32x8": {"pod": 2, "data": 32, "model": 8}}
MODES = ("fsdp", "tp", "tp_seq")


def _mesh(name):
    """The stand-in mesh both rule engines read (``.shape`` only)."""
    return types.SimpleNamespace(shape=dict(MESHES[name]))


def _norm(spec):
    """A spec's entries as None or a tuple of axis names."""
    return tuple(None if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)) for e in spec)


def _ref_leaves(tree, path=()):
    """{path without list indices: [reference leaf, ...]} (a list of
    per-layer trees contributes one entry per layer)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            for p, xs in _ref_leaves(v, path + (k,)).items():
                out.setdefault(p, []).extend(xs)
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for v in tree:
            for p, xs in _ref_leaves(v, path).items():
                out.setdefault(p, []).extend(xs)
    else:
        out[path] = [tree]
    return out


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, path + (k,)))
        return out
    return {path: tree}


@pytest.fixture(scope="module")
def ref_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = rregistry.param_specs(rconfigs.get_config(arch))
        return cache[arch]
    return get


def _compare(port_tree, ref_tree, ref_is_list):
    """Every port leaf's spec equals the reference's: directly, or (a
    list of layers in the reference) ``None`` then each layer's spec."""
    port, ref = _port_leaves(port_tree), _ref_leaves(ref_tree)
    assert set(port) == set(ref)
    for path, spec in port.items():
        want = {_norm(r) for r in ref[path]}
        assert len(want) == 1, (path, want)
        want = want.pop()
        if ref_is_list(path):
            want = (None,) + want
        assert _norm(spec) == want, (path, spec, want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", list(rconfigs.ASSIGNED_ARCHS))
def test_param_specs_equal_the_reference(arch, mode, mesh, ref_params):
    rcfg, cfg = rconfigs.get_config(arch), configs.get_config(arch)
    rtree = ref_params(arch)
    want = rshd.param_specs(rcfg, rtree, _mesh(mesh), weight_mode=mode)
    got = shd.param_specs(cfg, registry.param_specs(cfg), _mesh(mesh),
                          weight_mode=mode)
    listed = {k for k, v in rtree.items() if isinstance(v, list)}
    _compare(got, want, lambda path: path[0] in listed)


def _ref_inputs(arch, shape):
    cfg = rconfigs.get_config(arch)
    return rconfigs.input_specs(cfg, shape)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(rconfigs.ASSIGNED_ARCHS))
def test_data_cache_and_token_specs_equal_the_reference(arch, mesh):
    rcfg, cfg = rconfigs.get_config(arch), configs.get_config(arch)
    m = _mesh(mesh)
    for rshape, shape in zip(rbase.shapes_for(rcfg), base.shapes_for(cfg)):
        want, got = _ref_inputs(arch, rshape), configs.input_specs(cfg,
                                                                   shape)
        if "batch" in want:
            _compare(shd.data_specs(cfg, got["batch"], m),
                     rshd.data_specs(rcfg, want["batch"], m),
                     lambda p: False)
        else:
            _compare(shd.cache_specs(cfg, got["cache"], m),
                     rshd.cache_specs(rcfg, want["cache"], m),
                     lambda p: False)
            assert _norm(shd.token_specs(got["tokens"], m)) == _norm(
                rshd.token_specs(want["tokens"], m))


_JAX_TO_TORCH = {"int32": torch.int32, "bfloat16": torch.bfloat16,
                 "float32": torch.float32}


@pytest.mark.parametrize("arch", list(rconfigs.ASSIGNED_ARCHS))
def test_input_specs_shapes_and_dtypes_equal_the_reference(arch):
    rcfg, cfg = rconfigs.get_config(arch), configs.get_config(arch)
    for rshape, shape in zip(rbase.shapes_for(rcfg), base.shapes_for(cfg)):
        want = _port_leaves(_ref_inputs(arch, rshape))
        got = _port_leaves(configs.input_specs(cfg, shape))
        assert set(got) == set(want), (shape.name, set(got) ^ set(want))
        for path, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[path].shape), path
            assert t.dtype == _JAX_TO_TORCH[str(want[path].dtype)], path


def test_shape_registry_equals_the_reference():
    assert configs.ASSIGNED_ARCHS == rconfigs.ASSIGNED_ARCHS
    assert len(configs.ASSIGNED_ARCHS) == 10
    assert [vars(s) for s in base.ALL_SHAPES] == [vars(s) for s in
                                                  rbase.ALL_SHAPES]
    for arch in configs.ASSIGNED_ARCHS:
        assert [s.name for s in base.shapes_for(configs.get_config(arch))] \
            == [s.name for s in rbase.shapes_for(rconfigs.get_config(arch))]
    assert vars(base.ParallelConfig()) == vars(rbase.ParallelConfig())
    assert configs.get_shape("decode_32k").global_batch == 128
    with pytest.raises(KeyError):
        configs.get_shape("train_8k")


def test_to_placements_orders_a_pod_data_dim_as_the_mesh():
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.dryrun import fake_world
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        assert shd.to_placements((("pod", "data"), None, "model"), mesh) \
            == [Shard(0), Shard(0), Shard(2)]
        assert shd.to_placements((None, None), mesh) == [Replicate()] * 3
        with pytest.raises(ValueError, match="axis order"):
            shd.to_placements((("data", "pod"),), mesh)
        with pytest.raises(ValueError, match="shards two dims"):
            shd.to_placements(("model", "model"), mesh)


def test_hooks_are_the_identity_on_plain_tensors():
    x = torch.arange(24.0).reshape(2, 3, 4)
    with shd.activation_sharding(("data",), "model"):
        for hook in (shd.shard_activations, shd.shard_moe_slots,
                     shd.shard_decode_scores, shd.replicate_new_kv,
                     shd.shard_kv_cache, shd.gather_sequence,
                     shd.gather_weights):
            assert hook(x) is x
    assert shd.shard_activations(x) is x


def test_batch_axes_and_axis_sizes():
    assert shd.batch_axes(_mesh("2x32x8")) == ("pod", "data")
    assert shd.batch_axes(_mesh("32x8")) == ("data",)
    assert shd.axis_sizes({"data": 4}) == {"data": 4}
    assert np.prod(list(shd.axis_sizes(_mesh("2x32x8")).values())) == 512
