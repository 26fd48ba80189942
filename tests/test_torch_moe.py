"""The port's MoE layer and the configs of the MoE and VLM families against
the JAX package's: ``apply_moe`` on the same seeded inputs and weights
(fp32, 1e-5), with identical kept (token, expert) slots in calls that drop
tokens; the four new configs, their ``reduced()`` and parameter counts; the
bridge of the ``moe`` and ``image_proj`` trees."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.serving import costmodel as jcost  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import moe, registry, transformer  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serving import costmodel  # noqa: E402

NEW_ARCHS = ["granite-moe-1b-a400m", "grok-1-314b", "paligemma-3b",
             "gemma-7b"]
B, S = 2, 24          # 48 tokens a call


def _cfg_pair(mlp_type, cf, groups):
    """(JAX config, port config) of a small MoE layer: 8 experts, top-2."""
    kw = dict(d_model=64, d_ff=32, moe_num_experts=8, moe_top_k=2,
              moe_capacity_factor=cf, moe_groups=groups, mlp_type=mlp_type,
              dtype="float32")
    name = "granite-moe-1b-a400m"
    return (jconfigs.reduced(jconfigs.get_config(name)).replace(**kw),
            configs.reduced(configs.get_config(name)).replace(**kw))


def _layer(cfg, skew, seed=0):
    """Seeded numpy weights and inputs; ``skew`` pushes the router toward
    expert 0 (the inputs get a positive mean that its column reads)."""
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
    p = {"router": rng.normal(size=(d, E)) * 0.3,
         "wg": rng.normal(size=(E, d, f)) / np.sqrt(d),
         "wu": rng.normal(size=(E, d, f)) / np.sqrt(d),
         "wd": rng.normal(size=(E, f, d)) / np.sqrt(f)}
    x = rng.normal(size=(B, S, d))
    if skew:
        x += 0.5
        p["router"][:, 0] += 0.2
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


def _jax_kept(jcfg, p, x, monkeypatch):
    """The reference's kept (group, token, expert) slots, read from the
    dispatch buffer it builds: each non-empty slot of xin (G, E, C, d) is a
    copy of its token's row."""
    seen = []
    monkeypatch.setattr(jmoe, "shard_moe_slots",
                        lambda t: seen.append(np.asarray(t)) or t)
    y, aux = jmoe.apply_moe(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x))
    xin = seen[0]
    G, E, C, d = xin.shape
    xf = x.reshape(G, -1, d)
    kept = set()
    for g in range(G):
        for e in range(E):
            for c in range(C):
                row = xin[g, e, c]
                if not row.any():
                    continue
                t, = np.nonzero((xf[g] == row).all(-1))
                kept.add((g, int(t[0]), e))
    return np.asarray(y), float(aux["load_balance_loss"]), kept


def _port_kept(cfg, p, x):
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    y, aux = moe.apply_moe(cfg, tp, tx)
    G = moe.groups_for(cfg, B * S)
    r = moe.route(cfg, tp["router"], tx.reshape(G, -1, cfg.d_model),
                  cfg.moe_capacity_factor)
    k = cfg.moe_top_k
    kept = {(g, j // k, int(r.expert[g, j]))
            for g, j in zip(*np.nonzero(r.kept.numpy()))}
    return y.numpy(), float(aux["load_balance_loss"]), kept


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu"])
@pytest.mark.parametrize("cf,skew", [(8.0, False), (1.0, True)],
                         ids=["no-drop", "forced-drop"])
@pytest.mark.parametrize("groups", [1, 2, 5], ids=["G1", "G2", "G5-fallback"])
def test_apply_moe_matches_jax(groups, cf, skew, mlp_type, monkeypatch):
    """Same output (1e-5), same aux loss and the same kept (token, expert)
    slots as the reference; the skewed router at cf 1.0 drops slots, cf 8.0
    drops none.  48 tokens do not split into 5 groups: both fall back to
    one."""
    jcfg, cfg = _cfg_pair(mlp_type, cf, groups)
    p, x = _layer(cfg, skew)
    jy, jaux, jkept = _jax_kept(jcfg, p, x, monkeypatch)
    ty, taux, tkept = _port_kept(cfg, p, x)
    assert tkept == jkept
    slots = B * S * cfg.moe_top_k
    if skew:
        assert len(tkept) < slots
    else:
        assert len(tkept) == slots
    np.testing.assert_allclose(ty, jy, atol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)


@pytest.mark.parametrize("tokens,k,E,cf", [(12, 8, 32, 2.0), (15, 8, 32, 2.0),
                                           (16, 8, 32, 2.0), (16, 8, 32, 1.25),
                                           (48, 2, 8, 1.0), (1, 2, 8, 8.0)])
def test_moe_capacity_matches_jax(tokens, k, E, cf):
    """granite's decode / verify capacities (C = 8 up to 15 tokens, 16 at
    16) and its prefill's at cf 1.25."""
    assert moe.moe_capacity(tokens, E, k, cf) == jmoe.moe_capacity(
        tokens, E, k, cf)


def test_apply_moe_bf16_keeps_router_fp32():
    """A bf16 layer routes in fp32 and returns x's dtype."""
    _, cfg = _cfg_pair("swiglu", 2.0, 1)
    p, x = _layer(cfg, skew=False)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    tp["router"] = torch.from_numpy(p["router"])
    y, aux = moe.apply_moe(cfg.replace(dtype="bfloat16"), tp,
                           torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (B, S, cfg.d_model)
    assert torch.isfinite(y.float()).all()
    assert aux["load_balance_loss"].dtype == torch.float32


# ---------------------------------------------------------------------------
# configs, parameter counts and the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("draft", [False, True])
@pytest.mark.parametrize("scale", ["full", "reduced"])
def test_new_configs_and_param_counts_match_reference(arch, draft, scale):
    """The configs equal the reference's; parameter counts (meta tensors,
    every expert) and KV bytes per token equal the reference's."""
    jcfg = (jconfigs.get_draft_config if draft else jconfigs.get_config)(arch)
    cfg = (configs.get_draft_config if draft else configs.get_config)(arch)
    if scale == "reduced":
        jcfg, cfg = jconfigs.reduced(jcfg), configs.reduced(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert registry.param_count(cfg) == jregistry.param_count(jcfg)
    assert (costmodel.kv_bytes_per_token(cfg)
            == jcost.kv_bytes_per_token(jcfg))
    assert registry.get_model(cfg).supports_paged


def test_weight_bytes_count_the_router_in_fp32():
    """granite-moe-1b: all 32 experts at 2 bytes, the 24 x 1024 x 32 router
    at 4; a dense config has no fp32 leaf."""
    cm = costmodel.RooflineCostModel(costmodel.H100_SXM)
    cfg = configs.get_config("granite-moe-1b-a400m")
    router = 24 * 1024 * 32
    fp32 = [s for s in registry.leaves(transformer.param_layout(cfg))
            if s.dtype == "float32"]
    assert sum(math.prod(s.shape) for s in fp32) == router
    assert cm.weight_bytes(cfg) == 2 * registry.param_count(cfg) + 2 * router
    dense = configs.get_config("paligemma-3b")
    assert not any(s.dtype for s in registry.leaves(
        transformer.param_layout(dense)))
    assert cm.weight_bytes(dense) == 2 * registry.param_count(dense)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "paligemma-3b"])
def test_bridge_round_trips_moe_and_vlm_trees(arch):
    """A bf16 reference tree arrives leaf for leaf, the router in fp32 and
    every other leaf in bf16, the image projection included."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    jp = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_j) == len(jax.tree.leaves(tp))
    for path, want in flat_j:
        got = tp
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got.float().numpy(), want)
        fp32 = any(getattr(k, "key", None) == "router" for k in path)
        assert got.dtype == (torch.float32 if fp32 else torch.bfloat16)
    if cfg.moe_num_experts:
        assert "mlp" not in tp["layers"]
        assert tp["layers"]["moe"]["router"].dtype == torch.float32
    else:
        assert tp["image_proj"].shape == (cfg.d_model, cfg.d_model)


def test_init_params_router_fp32_in_bf16_model():
    cfg = configs.reduced(configs.get_config("granite-moe-1b-a400m"))
    p = registry.get_model(cfg).init(device="cpu", seed=0)
    assert p["layers"]["moe"]["router"].dtype == torch.float32
    assert p["layers"]["moe"]["wg"].dtype == torch.bfloat16
    assert p["layers"]["moe"]["wg"].shape == (
        cfg.num_layers, cfg.moe_num_experts, cfg.d_model, cfg.d_ff)
