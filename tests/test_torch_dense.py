"""The port's dense-cache serving path against the JAX package's (fp32,
reduced configs, bridged weights): full-sequence ``forward``, ``prefill`` and
``decode_step`` (the dense-family cases of tests/test_decode_equivalence.py),
the dense-cache speculative and AR steps, and whole ``DenseSlotBackend``
engine runs, which must emit the JAX dense backend's and the port's paged
backend's greedy streams."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.bandits import make_policy as jmake_policy  # noqa: E402
from repro.core.spec_decode import make_ar_step as jmake_ar  # noqa: E402
from repro.core.spec_decode import make_spec_step as jmake_spec  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.real_backend import DenseSlotBackend as JDense  # noqa: E402
from repro.serving.scheduler import ContinuousBatchingScheduler as JSched  # noqa: E402
from repro.serving.workload import tiny_requests as jtiny  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.bandits import make_policy  # noqa: E402
from repro_torch.core.spec_decode import make_ar_step, make_spec_step  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import unembed  # noqa: E402
from repro_torch.serving import kv_cache  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.real_backend import (DenseSlotBackend,  # noqa: E402
                                              RealBackend, make_real_backend)
from repro_torch.serving.scheduler import ContinuousBatchingScheduler  # noqa: E402
from repro_torch.serving.workload import tiny_requests  # noqa: E402

ARCHS = ["paper-7b", "deepseek-7b", "qwen3-14b"]
B, S, MAX_LEN = 2, 16, 24


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


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(
        np.int32)


@pytest.mark.parametrize("draft", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_forward_and_jax(arch, draft):
    """prefill, then decode T=1 and a T=3 extension: the logits equal the
    port's full-sequence forward at the same positions and the JAX
    package's prefill / decode_step (1e-4)."""
    japi, api, jp, tp = _pair(arch, draft)
    tok = _tokens(api.cfg.vocab_size, (B, S + 4))
    full = unembed(api.cfg, tp, api.forward(tp, {"tokens":
                                                 torch.as_tensor(tok)}))
    jh = japi.forward(jp, {"tokens": jnp.asarray(tok)})
    np.testing.assert_allclose(
        api.forward(tp, {"tokens": torch.as_tensor(tok)}).numpy(),
        np.asarray(jh), atol=1e-4)

    jl, jcache = japi.prefill(jp, {"tokens": jnp.asarray(tok[:, :S])},
                              MAX_LEN)
    tl, tcache = api.prefill(tp, {"tokens": torch.as_tensor(tok[:, :S])},
                             MAX_LEN)
    logits = [(jl, tl, S - 1)]
    for lo, hi in ((S, S + 1), (S + 1, S + 4)):
        jl, jcache = japi.decode_step(jp, jcache, jnp.asarray(tok[:, lo:hi]))
        tl, tcache = api.decode_step(tp, tcache, torch.as_tensor(
            tok[:, lo:hi]))
        logits.append((jl, tl, lo))
    for jl, tl, lo in logits:
        T = tl.shape[1]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_allclose(tl.numpy(), full[:, lo:lo + T].numpy(),
                                   atol=1e-4)
    assert tcache["length"].tolist() == [S + 4] * B
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5)


def _models(same_draft):
    """JAX and port (target, draft) pairs on the same weights; with
    ``same_draft`` the target drafts for itself."""
    t = _pair("paper-7b")
    d = t if same_draft else _pair("paper-7b", draft=True, key=1)
    return t, d


@pytest.mark.parametrize("same_draft", [False, True])
@pytest.mark.parametrize("gamma", [1, 3])
def test_spec_and_ar_steps_match_jax(gamma, same_draft):
    """Greedy dense-cache speculative steps (and AR steps) commit the JAX
    package's tokens, and both caches roll back to the same lengths."""
    (jt, tt, jtp, ttp), (jd, td, jdp, tdp) = _models(same_draft)
    prompt = _tokens(tt.cfg.vocab_size, (B, S), seed=4)
    jl, jtc = jt.prefill(jtp, {"tokens": jnp.asarray(prompt)}, 64)
    _, jdc = jd.prefill(jdp, {"tokens": jnp.asarray(prompt)}, 64)
    tl, ttc = tt.prefill(ttp, {"tokens": torch.as_tensor(prompt)}, 64)
    _, tdc = td.prefill(tdp, {"tokens": torch.as_tensor(prompt)}, 64)
    first = tl[:, -1].argmax(-1)
    np.testing.assert_array_equal(first.numpy(),
                                  np.asarray(jl[:, -1].argmax(-1)))
    jspec = jax.jit(jmake_spec(jt, jd), static_argnames=("gamma",))
    tspec = make_spec_step(tt, td)
    jlast, tlast = jnp.asarray(first.numpy(), jnp.int32), first
    for _ in range(3):
        jr = jspec(jax.random.PRNGKey(0), jtp, jdp, jtc, jdc, jlast,
                   gamma=gamma)
        tr = tspec(None, ttp, tdp, ttc, tdc, tlast, gamma)
        for name in ("tokens", "n_accepted", "last_token"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                          np.asarray(getattr(jr, name)))
        for jc, tc in ((jr.tcache, tr.tcache), (jr.dcache, tr.dcache)):
            np.testing.assert_array_equal(tc["length"].numpy(),
                                          np.asarray(jc["length"]))
        if same_draft:
            assert (tr.n_accepted == gamma).all()
        jtc, jdc, jlast = jr.tcache, jr.dcache, jr.last_token
        ttc, tdc, tlast = tr.tcache, tr.dcache, tr.last_token

    jar, tar = jax.jit(jmake_ar(jt)), make_ar_step(tt)
    for _ in range(2):
        jn, jtc = jar(jax.random.PRNGKey(0), jtp, jtc, jlast)
        tn, ttc = tar(None, ttp, ttc, tlast)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(ttc["length"].numpy(),
                                      np.asarray(jtc["length"]))
        jlast, tlast = jn, tn


# ---------------------------------------------------------------------------
# whole engine runs
# ---------------------------------------------------------------------------


def _cfgs(pkg, arch):
    c = jconfigs if pkg == "jax" else configs
    return tuple(c.reduced(get(arch)).replace(dtype="float32")
                 for get in (c.get_config, c.get_draft_config))


def _engine(pkg, kind, *, arch="deepseek-7b", policy="nightjar",
            params=None):
    """The reference's engine recipe (tests/test_paged_backend.py,
    ``_run_engine``): four requests, monolithic prefill, one package and
    one backend kind.  Returns (streams, metrics, backend)."""
    tcfg, dcfg = _cfgs(pkg, arch)
    if pkg == "jax":
        target, draft = jregistry.get_model(tcfg), jregistry.get_model(dcfg)
        bm = jkv.BlockManager(256, 8)
        be = JDense(target, draft, max_batch=4, max_seq=96, seed=0)
        sched_cls, eng_cls, mkpol, tiny = (JSched, JEngine, jmake_policy,
                                           jtiny)
    else:
        target, draft = registry.get_model(tcfg), registry.get_model(dcfg)
        bm = kv_cache.BlockManager(256, 8)
        if kind == "dense":
            be = DenseSlotBackend(target, draft, device="cpu", params=params,
                                  max_batch=4, max_seq=96, seed=0)
        else:
            be = RealBackend(target, draft, device="cpu", params=params,
                             max_batch=4, max_seq=96, seed=0,
                             block_manager=bm)
        sched_cls, eng_cls, mkpol, tiny = (ContinuousBatchingScheduler,
                                           ServingEngine, make_policy,
                                           tiny_requests)
    sched = sched_cls(bm, max_batch=4, watermark_frac=0.0)
    eng = eng_cls(be, sched, mkpol(policy, 3, seed=0), None, gamma_max=3)
    reqs = tiny(4, rate_qps=1e6, prompt_len=10, output_len=8,
                vocab=target.cfg.vocab_size, seed=5)
    m = eng.run(reqs, max_steps=3000, record_timeline=True)
    return ({r.req_id: be.output_tokens(r.req_id)[:9] for r in reqs}, m, be)


def test_dense_engine_matches_jax_dense_and_paged():
    """The port's DenseSlotBackend emits the JAX DenseSlotBackend's greedy
    streams on the same weights, under Nightjar and AR, and so does the
    port's paged RealBackend (the reference's
    test_paged_engine_matches_dense_engine)."""
    want, _, jbe = _engine("jax", "dense")
    tcfg, dcfg = _cfgs("torch", "deepseek-7b")
    params = tuple(params_from_numpy(c, jax.tree.map(np.asarray, p),
                                     device="cpu")
                   for c, p in ((tcfg, jbe.tparams), (dcfg, jbe.dparams)))
    for kind, policy in (("dense", "nightjar"), ("dense", "ar"),
                         ("paged", "nightjar")):
        got, m, _ = _engine("torch", kind, policy=policy, params=params)
        assert got == want, (kind, policy)
        assert len(m.requests) == 4
        if policy == "nightjar":
            assert m.spec["spec_steps"] >= 1, m.spec


def test_dense_engine_target_as_draft_accepts():
    """With the target as its own draft the dense backend commits accepted
    draft tokens (the rollback keeps x_N + accepted drafts) and still emits
    the AR stream."""
    from repro_torch.launch.serve import build_dense_engine
    tcfg, _ = _cfgs("torch", "paper-7b")
    tp = registry.get_model(tcfg).init(device="cpu", seed=1)
    out, acc = {}, {}
    for policy in ("nightjar", "ar"):
        eng = build_dense_engine(tcfg, tcfg, device="cpu", policy=policy,
                                 params=(tp, tp))
        assert type(eng.backend) is DenseSlotBackend
        reqs = tiny_requests(4, prompt_len=16, output_len=16, template_len=8,
                             vocab=tcfg.vocab_size, seed=0)
        m = eng.run(reqs, max_steps=3000, record_timeline=True)
        out[policy] = {r.req_id: eng.backend.output_tokens(r.req_id)[:17]
                       for r in reqs}
        acc[policy] = sum(g["accepted"] for gam, g in
                          m.spec.get("per_gamma", {}).items() if gam > 0)
    assert acc["nightjar"] > 0
    assert out["nightjar"] == out["ar"]


def test_make_real_backend_picks_paged_for_dense_pair():
    tcfg, dcfg = _cfgs("torch", "paper-7b")
    t, d = registry.get_model(tcfg), registry.get_model(dcfg)
    be = make_real_backend(t, d, device="cpu", max_batch=2, max_seq=32,
                           block_manager=kv_cache.BlockManager(16, 8))
    assert type(be) is RealBackend
