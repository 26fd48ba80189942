"""The port's paged decoder against the JAX package's on bridged weights (fp32,
reduced configs): prefill, decode, verify, ragged chunks, shared prefixes,
copy-on-write forks, trash-block isolation and in-place page updates."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.serving import costmodel as jcost  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serving import costmodel  # noqa: E402
from repro_torch.serving.kv_cache import BlockManager  # noqa: E402
from repro_torch.serving.paged_runtime import (  # noqa: E402
    PagedKVRuntime, apply_copies)

ARCHS = ["paper-7b", "deepseek-7b", "qwen3-14b"]


def _pair(arch, draft=False):
    """(JAX api, port api, JAX params, port params) on the same weights."""
    jget = jconfigs.get_draft_config if draft else jconfigs.get_config
    get = configs.get_draft_config if draft else configs.get_config
    jcfg = jconfigs.reduced(jget(arch)).replace(dtype="float32")
    cfg = configs.reduced(get(arch)).replace(dtype="float32")
    japi, api = jregistry.get_model(jcfg), registry.get_model(cfg)
    jp = japi.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return japi, api, jp, tp


def _step(japi, api, jp, tp, jpages, tpages, tok, tables, start, valid=None):
    """One paged extension through both packages; returns both logits."""
    jv = None if valid is None else jnp.asarray(valid)
    jl, jpages = japi.decode_step_paged(jp, jpages, jnp.asarray(tok),
                                        jnp.asarray(tables),
                                        jnp.asarray(start), jv)
    tv = None if valid is None else torch.as_tensor(valid)
    tl, tpages = api.decode_step_paged(tp, tpages, torch.as_tensor(tok),
                                       torch.as_tensor(tables),
                                       torch.as_tensor(start), tv)
    return np.asarray(jl), tl.numpy(), jpages, tpages


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


@pytest.mark.parametrize("draft", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_verify_match_jax(arch, draft):
    japi, api, jp, tp = _pair(arch, draft)
    B, S = 2, 12
    tok = _tokens(api.cfg, (B, S + 5))
    tables = np.asarray([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], np.int32)
    jpages = japi.init_paged_cache(16, 4)
    tpages = api.init_paged_cache(16, 4, device="cpu")
    for lo, hi in ((0, S), (S, S + 1), (S + 1, S + 5)):  # prefill, T=1, T=4
        jl, tl, jpages, tpages = _step(
            japi, api, jp, tp, jpages, tpages, tok[:, lo:hi], tables,
            np.full((B,), lo, np.int32))
        np.testing.assert_allclose(tl, jl, atol=1e-4)
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tpages[key].numpy(),
                                   np.asarray(jpages[key]), atol=1e-5)


def test_ragged_chunks_match_monolithic_and_jax():
    japi, api, jp, tp = _pair("paper-7b")
    B, S = 2, 12
    tok = _tokens(api.cfg, (B, S))
    tables = np.asarray([[0, 1, 2, 3], [5, 6, 7, 8]], np.int32)
    mono, _ = api.decode_step_paged(
        tp, api.init_paged_cache(16, 4, device="cpu"), torch.as_tensor(tok),
        torch.as_tensor(tables), torch.zeros((B,), dtype=torch.int32))

    jpages = japi.init_paged_cache(16, 4)
    tpages = api.init_paged_cache(16, 4, device="cpu")
    # seq0 chunks 5+7, seq1 chunks 7+5 (padded rows exercise the trash path)
    c1 = np.stack([np.pad(tok[0, :5], (0, 2)), tok[1, :7]])
    jl, tl, jpages, tpages = _step(japi, api, jp, tp, jpages, tpages, c1,
                                   tables, np.zeros((B,), np.int32),
                                   np.asarray([5, 7], np.int32))
    c2 = np.stack([tok[0, 5:12], np.pad(tok[1, 7:12], (0, 2))])
    jl, tl, jpages, tpages = _step(japi, api, jp, tp, jpages, tpages, c2,
                                   tables, np.asarray([5, 7], np.int32),
                                   np.asarray([7, 5], np.int32))
    last = np.stack([tl[0, 6], tl[1, 4]])
    np.testing.assert_allclose(last, mono[:, -1].numpy(), atol=1e-4)
    np.testing.assert_allclose(last, np.stack([jl[0, 6], jl[1, 4]]),
                               atol=1e-4)


def test_shared_prefix_tables_match_jax():
    """Two sequences sharing physical prefix blocks (written once)."""
    japi, api, jp, tp = _pair("paper-7b")
    S, P = 8, 12                               # 8 shared + 4 private tokens
    prefix = _tokens(api.cfg, (S,), seed=1)
    sfx = _tokens(api.cfg, (2, P - S), seed=2)
    prompts = np.stack([np.concatenate([prefix, sfx[0]]),
                        np.concatenate([prefix, sfx[1]])])
    jpages = japi.init_paged_cache(16, 4)
    tpages = api.init_paged_cache(16, 4, device="cpu")
    jl0, tl0, jpages, tpages = _step(japi, api, jp, tp, jpages, tpages,
                                     prompts[:1], np.asarray([[0, 1, 2]]),
                                     np.zeros((1,), np.int32))
    jl1, tl1, jpages, tpages = _step(japi, api, jp, tp, jpages, tpages,
                                     sfx[1:2], np.asarray([[0, 1, 3]]),
                                     np.full((1,), S, np.int32))
    np.testing.assert_allclose(tl0, jl0, atol=1e-4)
    np.testing.assert_allclose(tl1, jl1, atol=1e-4)
    # the shared-prefix continuation equals an unshared prefill of prompt 1
    full, _ = api.decode_step_paged(
        tp, api.init_paged_cache(16, 4, device="cpu"),
        torch.as_tensor(prompts[1:2]), torch.as_tensor([[0, 1, 2]]),
        torch.zeros((1,), dtype=torch.int32))
    np.testing.assert_allclose(tl1[0, -1], full[0, -1].numpy(), atol=1e-4)


def test_cow_fork_copy_preserves_logits():
    """Forking a shared block through the block-migration path leaves the
    forked sequence's logits equal to an unshared run."""
    _, api, _, tp = _pair("paper-7b")
    P = 8                                      # exactly 2 full blocks
    tok = torch.as_tensor(_tokens(api.cfg, (1, P)))
    bm = BlockManager(8, 4, prefix_caching=True)
    rt = PagedKVRuntime(api, bm, device="cpu")
    bm.allocate(1, P)
    tbl1 = torch.as_tensor([bm.tables[1]], dtype=torch.int32)
    api.decode_step_paged(tp, rt.pages, tok, tbl1,
                          torch.zeros((1,), dtype=torch.int32))
    bm.register_prefix(1, tok[0].tolist(), P)
    blocks, matched = bm.match_prefix(tok[0].tolist())
    assert matched == P
    bm.share(2, blocks, P - 1)
    (src, dst), = bm.fork_for_write(2, P - 1, P)
    apply_copies([rt], *zip(*bm.drain_pending_copies()))
    tbl2 = torch.as_tensor([bm.tables[2]], dtype=torch.int32)
    start = torch.full((1,), P - 1, dtype=torch.int32)
    lg2, _ = api.decode_step_paged(tp, rt.pages, tok[:, -1:], tbl2, start)
    lg1, _ = api.decode_step_paged(tp, rt.pages, tok[:, -1:], tbl1, start)
    torch.testing.assert_close(lg2, lg1, atol=1e-5, rtol=0)
    bm.check_invariants()


def test_invalid_slots_write_only_the_trash_block():
    _, api, _, tp = _pair("paper-7b")
    pages = api.init_paged_cache(8, 4, device="cpu")
    before = {k: v.clone() for k, v in pages.items()}
    _, after = api.decode_step_paged(
        tp, pages, torch.zeros((1, 4), dtype=torch.int32),
        torch.as_tensor([[0, 1]], dtype=torch.int32),
        torch.zeros((1,), dtype=torch.int32),
        torch.zeros((1,), dtype=torch.int32))
    for key in ("k_pages", "v_pages"):
        assert torch.equal(after[key][:, :8], before[key][:, :8])
        assert (after[key][:, 8] != before[key][:, 8]).any()


def test_pages_update_in_place():
    _, api, _, tp = _pair("paper-7b")
    pages = api.init_paged_cache(8, 4, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in pages.items()}
    _, out = api.decode_step_paged(
        tp, pages, torch.as_tensor(_tokens(api.cfg, (2, 3))),
        torch.as_tensor([[0, 1], [2, 3]], dtype=torch.int32),
        torch.zeros((2,), dtype=torch.int32))
    assert {k: v.data_ptr() for k, v in out.items()} == ptrs
    assert out["k_pages"][:, :4].abs().sum() > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("draft", [False, True])
@pytest.mark.parametrize("scale", ["full", "reduced"])
def test_param_count_matches_reference(arch, draft, scale):
    jcfg = (jconfigs.get_draft_config if draft else jconfigs.get_config)(arch)
    cfg = (configs.get_draft_config if draft else configs.get_config)(arch)
    if scale == "reduced":
        jcfg, cfg = jconfigs.reduced(jcfg), configs.reduced(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert registry.param_count(cfg) == jregistry.param_count(jcfg)
    assert (costmodel.kv_bytes_per_token(cfg)
            == jcost.kv_bytes_per_token(jcfg))


def test_costmodel_cache_keyed_by_config_not_name():
    cm = costmodel.RooflineCostModel(costmodel.H100_SXM)
    full = configs.get_config("paper-7b")
    small = configs.reduced(full)
    assert small.name == full.name
    assert cm.weight_bytes(small) < cm.weight_bytes(full)
    assert cm.weight_bytes(full) == 2 * registry.param_count(full)


def test_bridge_rejects_misshapen_tree():
    japi, api, jp, _ = _pair("paper-7b")
    tree = jax.tree.map(np.asarray, jp)
    tree["embed"] = tree["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(api.cfg, tree, device="cpu")


def test_init_params_is_seeded():
    cfg = configs.reduced(configs.get_draft_config("paper-7b"))
    a = registry.get_model(cfg).init(device="cpu", seed=3)
    b = registry.get_model(cfg).init(device="cpu", seed=3)
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert a["embed"].dtype == torch.bfloat16
    assert not a["layers"]["attn"]["bq"].any()          # zero qkv biases
