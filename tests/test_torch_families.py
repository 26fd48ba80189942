"""The port's MoE and VLM decoders (and the other configs the head_dim-256
kernels open) against the JAX package's, on bridged fp32 weights at reduced
size: prefill + decode == forward and the multi-token extension for
grok-1-314b (logit softcap), paligemma-3b (image prefix), gemma-7b,
granite-moe-1b-a400m and qwen2-72b (qkv bias, reduced: 145 GB at full
width does not fit one card) (the cases of
tests/test_decode_equivalence.py); paged
== dense for granite (tests/test_paged_backend.py); and greedy engine
streams of the granite pair under AR, fixed-2 and Nightjar, equal to each
other and to the JAX RealBackend's (tests/test_spec_engine.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.bandits import make_policy as jmake_policy  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.real_backend import RealBackend as JBackend  # noqa: E402
from repro.serving.scheduler import ContinuousBatchingScheduler as JSched  # noqa: E402
from repro.serving.workload import tiny_requests as jtiny  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.bandits import make_policy  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import unembed  # noqa: E402
from repro_torch.serving import kv_cache  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.real_backend import RealBackend  # noqa: E402
from repro_torch.serving.scheduler import ContinuousBatchingScheduler  # noqa: E402
from repro_torch.serving.workload import tiny_requests  # noqa: E402

FAMS = ["grok-1-314b", "paligemma-3b", "gemma-7b", "granite-moe-1b-a400m",
        "qwen2-72b"]
B, S = 2, 16
GRANITE = "granite-moe-1b-a400m"


def _pair(arch, draft=False, key=0):
    """(JAX api, port api, JAX params, port params) on the same weights."""
    jget = jconfigs.get_draft_config if draft else jconfigs.get_config
    get = configs.get_draft_config if draft else configs.get_config
    jcfg = jconfigs.reduced(jget(arch)).replace(dtype="float32")
    cfg = configs.reduced(get(arch)).replace(dtype="float32")
    japi, api = jregistry.get_model(jcfg), registry.get_model(cfg)
    jp = japi.init(jax.random.PRNGKey(key))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return japi, api, jp, tp


def _inputs(cfg, seed=1):
    """Seeded tokens (B, S + 4) and, for a VLM, image rows (B, N, d)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(B, S + 4)).astype(np.int32)
    img = None
    if cfg.family == "vlm":
        img = rng.normal(size=(B, cfg.num_image_tokens,
                               cfg.d_model)).astype(np.float32)
    return tok, img


def _batches(tok, img):
    jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.as_tensor(tok)}
    if img is not None:
        jb["image_emb"], tb["image_emb"] = (jnp.asarray(img),
                                            torch.as_tensor(img))
    return jb, tb


@pytest.mark.parametrize("arch", FAMS)
def test_decode_matches_forward_and_jax(arch):
    """prefill of S tokens (after the image prefix), then three T=1 decode
    steps: the logits equal the port's full forward at the same positions
    and the JAX package's prefill / decode_step, and the full forward's
    hidden states equal the JAX forward's (1e-4)."""
    japi, api, jp, tp = _pair(arch)
    cfg = api.cfg
    tok, img = _inputs(cfg)
    off = cfg.num_image_tokens if img is not None else 0
    max_len = off + S + 8
    jb, tb = _batches(tok[:, :S + 3], img)
    full_h = api.forward(tp, tb)
    np.testing.assert_allclose(full_h.numpy(),
                               np.asarray(japi.forward(jp, jb)), atol=1e-4)
    full = unembed(cfg, tp, full_h).numpy()

    jb, tb = _batches(tok[:, :S], img)
    jl, jcache = japi.prefill(jp, jb, max_len)
    tl, tcache = api.prefill(tp, tb, max_len)
    assert tcache["length"].tolist() == [off + S] * B
    got, want = [tl[:, 0].numpy()], [np.asarray(jl[:, 0])]
    for t in range(S, S + 3):
        jl, jcache = japi.decode_step(jp, jcache, jnp.asarray(tok[:, t:t + 1]))
        tl, tcache = api.decode_step(tp, tcache,
                                     torch.as_tensor(tok[:, t:t + 1]))
        got.append(tl[:, 0].numpy())
        want.append(np.asarray(jl[:, 0]))
    got, want = np.stack(got, 1), np.stack(want, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, full[:, off + S - 1:off + S + 3],
                               atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5)


@pytest.mark.parametrize("arch", FAMS)
def test_multitoken_extension_matches_forward_and_jax(arch):
    """decode_step with T = 3 after the prefill (the speculative verify
    path)."""
    japi, api, jp, tp = _pair(arch)
    cfg = api.cfg
    tok, img = _inputs(cfg, seed=2)
    off = cfg.num_image_tokens if img is not None else 0
    full = unembed(cfg, tp, api.forward(tp, _batches(tok[:, :S + 3],
                                                     img)[1])).numpy()
    jb, tb = _batches(tok[:, :S], img)
    _, jcache = japi.prefill(jp, jb, off + S + 8)
    _, tcache = api.prefill(tp, tb, off + S + 8)
    jl, _ = japi.decode_step(jp, jcache, jnp.asarray(tok[:, S:S + 3]))
    tl, _ = api.decode_step(tp, tcache, torch.as_tensor(tok[:, S:S + 3]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), full[:, off + S:off + S + 3],
                               atol=1e-4)


def test_vlm_image_prefix_is_bidirectional():
    """An image row's output depends on the image rows after it (the prefix
    attends both ways) but a text row's never on the text after it."""
    _, api, _, tp = _pair("paligemma-3b")
    tok, img = _inputs(api.cfg, seed=3)
    N = api.cfg.num_image_tokens
    base = api.forward(tp, _batches(tok[:, :S], img)[1])
    img2 = img.copy()
    img2[:, -1] += 1.0
    tok2 = tok.copy()
    tok2[:, S - 1] = (tok2[:, S - 1] + 1) % api.cfg.vocab_size
    moved = api.forward(tp, _batches(tok[:, :S], img2)[1])
    assert (moved[:, 0] - base[:, 0]).abs().max() > 1e-4
    text = api.forward(tp, _batches(tok2[:, :S], img)[1])
    torch.testing.assert_close(text[:, :N + S - 1], base[:, :N + S - 1],
                               atol=0, rtol=0)


@pytest.mark.parametrize("draft", [False, True])
def test_granite_paged_matches_dense_and_jax(draft):
    """Paged prefill (start 0), T=1 decode and a T=3 verify extension give
    the dense slot cache's logits and the JAX paged decoder's (1e-4), as
    tests/test_paged_backend.py::test_paged_decode_matches_dense."""
    japi, api, jp, tp = _pair(GRANITE, draft)
    tok, _ = _inputs(api.cfg, seed=4)
    tables = np.asarray([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], np.int32)
    S0 = 12
    _, cache = api.prefill(tp, {"tokens": torch.as_tensor(tok[:, :S0])},
                           S0 + 8)
    pages = api.init_paged_cache(16, 4, device="cpu")
    jpages = japi.init_paged_cache(16, 4)
    for lo, hi in ((0, S0), (S0, S0 + 1), (S0 + 1, S0 + 4)):
        start = np.full((B,), lo, np.int32)
        lg, pages = api.decode_step_paged(
            tp, pages, torch.as_tensor(tok[:, lo:hi]),
            torch.as_tensor(tables), torch.as_tensor(start))
        jl, jpages = japi.decode_step_paged(
            jp, jpages, jnp.asarray(tok[:, lo:hi]), jnp.asarray(tables),
            jnp.asarray(start))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-4)
        if lo == 0:
            dense, _ = api.prefill(tp, {"tokens": torch.as_tensor(
                tok[:, :S0])}, S0 + 8)
            np.testing.assert_allclose(lg[:, -1].numpy(),
                                       dense[:, 0].numpy(), atol=1e-4)
        else:
            dl, cache = api.decode_step(tp, cache,
                                        torch.as_tensor(tok[:, lo:hi]))
            np.testing.assert_allclose(lg.numpy(), dl.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# whole engine runs of the granite pair
# ---------------------------------------------------------------------------


def _granite_cfgs(pkg):
    c = jconfigs if pkg == "jax" else configs
    return tuple(c.reduced(get(GRANITE)).replace(dtype="float32")
                 for get in (c.get_config, c.get_draft_config))


def _engine_run(pkg, policy, params=None):
    """tests/test_spec_engine.py::test_engine_lossless_across_policies
    through one package: 256 blocks of 8, batch <= 4, gamma <= 3, four
    requests of 10 + 8 tokens."""
    tcfg, dcfg = _granite_cfgs(pkg)
    if pkg == "jax":
        reg, BM, Be, Sched, Eng, mkpol, tiny = (
            jregistry, jkv.BlockManager, JBackend, JSched, JEngine,
            jmake_policy, jtiny)
        kw = {}
    else:
        reg, BM, Be, Sched, Eng, mkpol, tiny = (
            registry, kv_cache.BlockManager, RealBackend,
            ContinuousBatchingScheduler, ServingEngine, make_policy,
            tiny_requests)
        kw = {"device": "cpu", "params": params}
    bm = BM(256, 8)
    be = Be(reg.get_model(tcfg), reg.get_model(dcfg), max_batch=4,
            max_seq=96, seed=0, block_manager=bm, **kw)
    eng = Eng(be, Sched(bm, max_batch=4), mkpol(policy, 3, seed=0), None,
              gamma_max=3)
    reqs = tiny(4, rate_qps=1e6, prompt_len=10, output_len=8,
                vocab=tcfg.vocab_size, seed=5)
    m = eng.run(reqs, max_steps=500)
    return {r.req_id: be.output_tokens(r.req_id)[:9] for r in reqs}, m, be


def test_granite_engine_streams_lossless_and_match_jax():
    """The port's greedy streams under AR, fixed-2 and Nightjar are equal
    token for token, and equal the JAX RealBackend's Nightjar streams on the
    same (bridged) weights."""
    want, _, jbe = _engine_run("jax", "nightjar")
    tcfg, dcfg = _granite_cfgs("torch")
    params = (params_from_numpy(tcfg, jax.tree.map(np.asarray, jbe.tparams),
                                device="cpu"),
              params_from_numpy(dcfg, jax.tree.map(np.asarray, jbe.dparams),
                                device="cpu"))
    for policy in ("ar", "fixed-2", "nightjar"):
        got, _, _ = _engine_run("torch", policy, params)
        assert got == want, policy
        assert all(len(s) == 9 for s in got.values())
