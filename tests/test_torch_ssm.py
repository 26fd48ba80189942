"""The port's mamba2 (ssm family) against the JAX package's, on bridged fp32
weights at reduced size: the chunked SSD scan, prefill + decode == forward
and the multi-token extension with its per-token state checkpoints (the
mamba2 cases of tests/test_decode_equivalence.py), the SSM checkpoint
rollback of the speculative step (speculative greedy == AR, the SSM case of
tests/test_spec_engine.py), the engine on ``DenseSlotBackend`` (the port's
counterpart of tests/test_paged_backend.py:343), and the four new configs'
full-width parameter shapes against the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import spec_decode as jspec  # noqa: E402
from repro.core.bandits import make_policy as jmake_policy  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.real_backend import DenseSlotBackend as JDense  # noqa: E402
from repro.serving.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler as JSched)
from repro.serving.workload import tiny_requests as jtiny  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import spec_decode  # noqa: E402
from repro_torch.launch.serve import build_real_engine  # noqa: E402
from repro_torch.models import mamba2, registry  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.common import tied_unembed  # noqa: E402
from repro_torch.serving.real_backend import DenseSlotBackend  # noqa: E402
from repro_torch.serving.workload import tiny_requests  # noqa: E402

ARCH = "mamba2-780m"
B, S = 2, 16


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _pair(draft=False, key=0, arch=ARCH):
    """(JAX api, port api, JAX params, port params) on the same weights."""
    jget = jconfigs.get_draft_config if draft else jconfigs.get_config
    get = configs.get_draft_config if draft else configs.get_config
    jcfg = jconfigs.reduced(jget(arch)).replace(dtype="float32")
    cfg = configs.reduced(get(arch)).replace(dtype="float32")
    japi, api = jregistry.get_model(jcfg), registry.get_model(cfg)
    jp = japi.init(jax.random.PRNGKey(key))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return japi, api, jp, tp


@pytest.fixture(scope="module")
def target():
    return _pair()


def _tokens(cfg, seed, n=S + 4):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, n)).astype(np.int32)


def _close(got, want, rel=1e-4):
    """States within 1e-4 of their largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the chunked SSD scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nc,with_init,g", [(1, False, 1), (3, True, 2),
                                            (1, True, 2), (3, False, 1)])
def test_ssd_chunked_matches_reference(nc, with_init, g):
    """ssd_chunked against the reference at 1 and 3 chunks, with and
    without an initial state, at one and two groups (two groups catch
    ``repeat`` in place of ``repeat_interleave``)."""
    rng = np.random.default_rng(nc * 10 + g)
    b, Q, h, p, n = 2, 8, 4, 8, 6
    l = nc * Q
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    Bm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    Cm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if with_init \
        else None
    wy, wst = jmamba2.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=Q,
        init_state=None if h0 is None else jnp.asarray(h0))
    gy, gst = mamba2.ssd_chunked(
        *map(torch.as_tensor, (x, dt, A, Bm, Cm)), chunk=Q,
        init_state=None if h0 is None else torch.as_tensor(h0))
    _close(gy.numpy(), wy)
    _close(gst.numpy(), wst)


def test_ssd_chunked_raises_where_reference_asserts():
    """A length above the chunk and not a multiple of it (ROADMAP C9): the
    reference asserts at 40 with chunk 32; the port pads the tail and
    gives the reference's result at a chunk that divides 40 (8).  31 (one
    short chunk) and 64 (two chunks) pass in both, with no padding."""
    rng = np.random.default_rng(0)

    def args(n):
        return [rng.normal(size=s).astype(np.float32) for s in
                ((1, n, 2, 4), (1, n, 2), (2,), (1, n, 1, 3), (1, n, 1, 3))]
    bad = args(40)
    bad[1] = np.abs(bad[1])
    bad[2] = -np.abs(bad[2])
    with pytest.raises(AssertionError):
        jmamba2.ssd_chunked(*map(jnp.asarray, bad), chunk=32)
    gy, gst = mamba2.ssd_chunked(*map(torch.as_tensor, bad), chunk=32)
    wy, wst = jmamba2.ssd_chunked(*map(jnp.asarray, bad), chunk=8)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=2e-5)
    np.testing.assert_allclose(gst.numpy(), np.asarray(wst), atol=2e-5)
    for n in (31, 64):
        good = args(n)
        jmamba2.ssd_chunked(*map(jnp.asarray, good), chunk=32)
        mamba2.ssd_chunked(*map(torch.as_tensor, good), chunk=32)


@pytest.mark.parametrize("l,divisor", [(40, 8), (70, 10)])
def test_ssd_chunked_pads_tail_to_reference(l, divisor):
    """C9 repair: at the reduced config's chunk 32, lengths 40 and 70 are
    padded to 64 and 96 with dt = 0, x = B = C = 0; y and the final state
    (from an initial state, two groups) equal the reference's scan at a
    chunk that divides the length, to the fp32 tolerance of 2e-5."""
    rng = np.random.default_rng(l)
    b, h, p, g, n = 2, 4, 8, 2, 6
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    Bm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    Cm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    wy, wst = jmamba2.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                  chunk=divisor, init_state=jnp.asarray(h0))
    gy, gst = mamba2.ssd_chunked(*map(torch.as_tensor, (x, dt, A, Bm, Cm)),
                                 chunk=32, init_state=torch.as_tensor(h0))
    assert gy.shape == (b, l, h, p)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=2e-5)
    np.testing.assert_allclose(gst.numpy(), np.asarray(wst), atol=2e-5)


def test_prefill_40_then_decode_matches_reference_forward(target):
    """A 40-token mamba2 prefill at chunk 32 (padded: the reference's
    prefill asserts there), then four decode steps: the logits equal the
    reference's forward over the 44 tokens at chunk 4, which divides
    it."""
    japi, api, jp, tp = target
    jfwd = jregistry.get_model(japi.cfg.replace(ssm_chunk=4)).forward
    rng = np.random.default_rng(40)
    tok = rng.integers(0, api.cfg.vocab_size, size=(B, 44)).astype(np.int32)
    tl, tc = api.prefill(tp, {"tokens": torch.as_tensor(tok[:, :40])})
    got = [tl[:, 0].numpy()]
    for t in range(40, 43):
        tl, tc = api.decode_step(tp, tc, torch.as_tensor(tok[:, t:t + 1]))
        got.append(tl[:, 0].numpy())
    h = jfwd(jp, {"tokens": jnp.asarray(tok)})
    full = np.asarray(jmamba2._unembed(japi.cfg, jp, h))
    np.testing.assert_allclose(np.stack(got, 1), full[:, 39:43], atol=1e-4)


# ---------------------------------------------------------------------------
# prefill + decode == forward, checkpoints
# ---------------------------------------------------------------------------


def test_decode_matches_forward_and_jax(target):
    """prefill of S tokens, then three T = 1 steps: the logits equal the
    full forward at the same positions and the JAX package's, and the
    states equal the reference's."""
    japi, api, jp, tp = target
    cfg = api.cfg
    tok = _tokens(cfg, 1)
    h = api.forward(tp, {"tokens": torch.as_tensor(tok[:, :S + 3])})
    np.testing.assert_allclose(
        h.numpy(), np.asarray(japi.forward(jp, {"tokens": jnp.asarray(
            tok[:, :S + 3])})), atol=1e-4)
    full = tied_unembed(tp, h).numpy()
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(tok[:, :S])})
    tl, tc = api.prefill(tp, {"tokens": torch.as_tensor(tok[:, :S])})
    got, want = [tl[:, 0].numpy()], [np.asarray(jl[:, 0])]
    for t in range(S, S + 3):
        jl, jc = japi.decode_step(jp, jc, jnp.asarray(tok[:, t:t + 1]))
        tl, tc = api.decode_step(tp, tc, torch.as_tensor(tok[:, t:t + 1]))
        got.append(tl[:, 0].numpy())
        want.append(np.asarray(jl[:, 0]))
    got = np.stack(got, 1)
    np.testing.assert_allclose(got, np.stack(want, 1), atol=1e-4)
    np.testing.assert_allclose(got, full[:, S - 1:S + 3], atol=1e-4)
    assert "checkpoints" not in tc
    assert tc["length"].tolist() == [S + 3] * B
    for key in ("conv", "ssm"):
        _close(tc[key].numpy(), jc[key])


def test_prefill_shorter_than_the_conv_window(target):
    """A 2-token prompt (K - 1 = 3): the conv tail is zero-padded on the
    left, as the reference pads it, and decode continues from it."""
    japi, api, jp, tp = target
    tok = _tokens(api.cfg, 4, n=4)
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(tok[:, :2])})
    tl, tc = api.prefill(tp, {"tokens": torch.as_tensor(tok[:, :2])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _close(tc["conv"].numpy(), jc["conv"])
    assert not tc["conv"][:, :, 0].any()
    jl, _ = japi.decode_step(jp, jc, jnp.asarray(tok[:, 2:4]))
    tl, _ = api.decode_step(tp, tc, torch.as_tensor(tok[:, 2:4]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_multitoken_extension_checkpoints(target):
    """decode_step with T = 3 (the speculative verify): the logits equal the
    forward and the reference's; the checkpoints equal the reference's,
    checkpoint by checkpoint, and are distinct tensors holding distinct
    states (no in-place alias); the input cache is left as it was."""
    japi, api, jp, tp = target
    cfg = api.cfg
    tok = _tokens(cfg, 2)
    full = tied_unembed(tp, api.forward(
        tp, {"tokens": torch.as_tensor(tok[:, :S + 3])})).numpy()
    _, jc = japi.prefill(jp, {"tokens": jnp.asarray(tok[:, :S])})
    _, tc = api.prefill(tp, {"tokens": torch.as_tensor(tok[:, :S])})
    before = {k: tc[k].clone() for k in ("conv", "ssm")}
    jl, jc3 = japi.decode_step(jp, jc, jnp.asarray(tok[:, S:S + 3]))
    tl, tc3 = api.decode_step(tp, tc, torch.as_tensor(tok[:, S:S + 3]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), full[:, S:S + 3], atol=1e-4)
    for key in ("conv", "ssm"):
        assert torch.equal(tc[key], before[key])
        ck = tc3["checkpoints"][key]
        assert ck.shape == (3,) + tc[key].shape
        for t in range(3):
            _close(ck[t].numpy(), jc3["checkpoints"][key][t])
        assert torch.equal(ck[-1], tc3[key])
        assert not torch.equal(ck[0], ck[1])
        assert not torch.equal(ck[1], ck[2])


# ---------------------------------------------------------------------------
# the speculative step's SSM rollback
# ---------------------------------------------------------------------------


def test_rollback_helpers_match_reference():
    """_select_ckpt / _rollback_ssm_cache on random checkpoints and a
    per-sequence n_keep equal the reference's."""
    rng = np.random.default_rng(3)
    T, L, Bn = 4, 2, 3
    ck = {"conv": rng.normal(size=(T, L, Bn, 3, 5)).astype(np.float32),
          "ssm": rng.normal(size=(T, L, Bn, 2, 4, 4)).astype(np.float32)}
    n_keep = np.array([1, 4, 2], np.int32)
    length = np.array([5, 6, 7], np.int32)
    jext = {"conv": jnp.asarray(ck["conv"][-1]),
            "ssm": jnp.asarray(ck["ssm"][-1]), "length": jnp.asarray(length),
            "checkpoints": {k: jnp.asarray(v) for k, v in ck.items()}}
    text = {"conv": torch.as_tensor(ck["conv"][-1]),
            "ssm": torch.as_tensor(ck["ssm"][-1]),
            "length": torch.as_tensor(length),
            "checkpoints": {k: torch.as_tensor(v) for k, v in ck.items()}}
    want = jspec._rollback_ssm_cache(jext, {"length": jnp.asarray(length)},
                                     jnp.asarray(n_keep))
    got = spec_decode._rollback_ssm_cache(
        text, {"length": torch.as_tensor(length)}, torch.as_tensor(n_keep))
    assert set(got) == set(want) == {"conv", "ssm", "length"}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for b, n in enumerate(n_keep):
        np.testing.assert_array_equal(got["ssm"][:, b].numpy(),
                                      ck["ssm"][n - 1][:, b])


def _disagreeing_draft(tp, scale=0.3):
    """The target's weights with the last layer's ``out_proj`` scaled: a
    draft that agrees with the target on some tokens and not others."""
    dp = {k: v for k, v in tp.items()}
    dp["layers"] = dict(tp["layers"])
    out = tp["layers"]["out_proj"].clone()
    out[-1] *= scale
    dp["layers"]["out_proj"] = out
    return dp


def test_spec_greedy_equals_ar_with_mixed_acceptance(target):
    """Speculative greedy == AR through make_spec_step, with a draft that
    accepts a different number of tokens per sequence in one step (so the
    rollback selects different checkpoints across the batch), and the AR
    tokens equal the reference's make_ar_step on the same weights."""
    japi, api, jp, tp = target
    cfg = api.cfg
    toks = _tokens(cfg, 5, n=8)
    steps, gamma = 16, 3
    # AR, the port and the reference
    lg, tc = api.prefill(tp, {"tokens": torch.as_tensor(toks)})
    last = lg[:, 0].argmax(-1)
    ar = spec_decode.make_ar_step(api)
    ar_seq = [last]
    for _ in range(steps):
        last, tc = ar(None, tp, tc, last)
        ar_seq.append(last)
    ar_seq = torch.stack(ar_seq, 1).numpy()
    jlg, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks)})
    jlast = jnp.argmax(jlg[:, 0], -1)
    jar = jspec.make_ar_step(japi)
    jseq = [np.asarray(jlast)]
    for _ in range(steps):
        jlast, jc = jar(jax.random.PRNGKey(0), jp, jc, jlast)
        jseq.append(np.asarray(jlast))
    np.testing.assert_array_equal(ar_seq, np.stack(jseq, 1))

    dp = _disagreeing_draft(tp)
    spec = spec_decode.make_spec_step(api, api)
    lg, tc = api.prefill(tp, {"tokens": torch.as_tensor(toks)})
    _, dc = api.prefill(dp, {"tokens": torch.as_tensor(toks)})
    last = lg[:, 0].argmax(-1)
    streams = [[int(t)] for t in last]
    mixed = False
    while min(len(s) for s in streams) < steps:
        res = spec(None, tp, dp, tc, dc, last, gamma)
        tc, dc, last = res.tcache, res.dcache, res.last_token
        assert "checkpoints" not in tc
        n_acc = res.n_accepted.tolist()
        mixed |= len(set(n_acc)) > 1
        assert (tc["length"] == dc["length"]).all()
        for b, row in enumerate(res.tokens.tolist()):
            streams[b].extend(t for t in row if t >= 0)
    assert mixed, "the draft never split the batch's acceptance"
    for b in range(B):
        n = min(len(streams[b]), ar_seq.shape[1])
        assert streams[b][:n] == ar_seq[b, :n].tolist(), b


def test_target_as_draft_accepts_everything(target):
    """With the target as its own draft every proposal is accepted, so the
    rollback takes the last checkpoint, and the caches equal a plain
    prefill of the committed tokens."""
    _, api, _, tp = target
    toks = _tokens(api.cfg, 6, n=8)
    spec = spec_decode.make_spec_step(api, api)
    lg, tc = api.prefill(tp, {"tokens": torch.as_tensor(toks)})
    _, dc = api.prefill(tp, {"tokens": torch.as_tensor(toks)})
    last = lg[:, 0].argmax(-1)
    res = spec(None, tp, tp, tc, dc, last, 3)
    assert res.n_accepted.tolist() == [3] * B
    # the caches hold the prompt, the last token and the three drafts
    ctx = np.concatenate([toks, last[:, None].numpy(),
                          res.tokens[:, :3].numpy()], 1)
    _, fresh = api.prefill(tp, {"tokens": torch.as_tensor(ctx)})
    for c in (res.tcache, res.dcache):
        assert c["length"].tolist() == [ctx.shape[1]] * B
        for key in ("conv", "ssm"):
            _close(c[key].numpy(), fresh[key].numpy())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _streams(engine, reqs, n):
    return {r.req_id: engine.backend.output_tokens(r.req_id)[:n]
            for r in reqs}


def test_engine_matches_jax_dense_slot_backend():
    """build_real_engine on the reduced mamba2 pair picks DenseSlotBackend
    (no paged path: tests/test_paged_backend.py:343), and its greedy
    streams under Nightjar and AR equal the JAX DenseSlotBackend's
    Nightjar stream on the same weights."""
    tcfg, dcfg = (jconfigs.reduced(g(ARCH)).replace(dtype="float32")
                  for g in (jconfigs.get_config, jconfigs.get_draft_config))
    jbe = JDense(jregistry.get_model(tcfg), jregistry.get_model(dcfg),
                 max_batch=4, max_seq=96, seed=0)
    jeng = JEngine(jbe, JSched(jkv.BlockManager(256, 8), max_batch=4),
                   jmake_policy("nightjar", 3, seed=0), None, gamma_max=3)
    jreqs = jtiny(4, rate_qps=1e6, prompt_len=10, output_len=8,
                  vocab=tcfg.vocab_size, seed=5)
    jeng.run(jreqs, max_steps=3000)
    want = {r.req_id: jbe.output_tokens(r.req_id)[:9] for r in jreqs}

    cfg, dc = (configs.reduced(g(ARCH)).replace(dtype="float32")
               for g in (configs.get_config, configs.get_draft_config))
    params = tuple(params_from_numpy(c, jax.tree.map(np.asarray, p),
                                     device="cpu")
                   for c, p in ((cfg, jbe.tparams), (dc, jbe.dparams)))
    for policy in ("nightjar", "ar"):
        eng = build_real_engine(cfg, dc, device="cpu", policy=policy,
                                params=params)
        assert type(eng.backend) is DenseSlotBackend
        assert eng.memmgr is None
        reqs = tiny_requests(4, rate_qps=1e6, prompt_len=10, output_len=8,
                             vocab=cfg.vocab_size, seed=5)
        m = eng.run(reqs, max_steps=3000, record_timeline=True)
        assert _streams(eng, reqs, 9) == want, policy
        if policy == "nightjar":
            assert m.spec["spec_steps"] >= 1, m.spec


def test_engine_target_as_draft_and_catchups():
    """Through the engine with the target as its own draft: accepted
    drafts commit (checkpoint indices above 0), the stream equals AR, and
    the backend counts its draft catch-ups."""
    cfg = configs.reduced(configs.get_config(ARCH)).replace(dtype="float32")
    tp = registry.get_model(cfg).init(device="cpu", seed=1)
    out, acc = {}, {}
    for policy in ("nightjar", "ar"):
        eng = build_real_engine(cfg, cfg, device="cpu", policy=policy,
                                params=(tp, tp))
        reqs = tiny_requests(4, prompt_len=16, output_len=16, template_len=8,
                             vocab=cfg.vocab_size, seed=0)
        m = eng.run(reqs, max_steps=3000, record_timeline=True)
        out[policy] = _streams(eng, reqs, 17)
        acc[policy] = sum(g["accepted"] for gam, g in
                          m.spec.get("per_gamma", {}).items() if gam > 0)
        cu = eng.backend.catchups
        assert cu["calls"] >= 0 and cu["tokens"] >= cu["calls"]
    assert acc["nightjar"] > 0
    assert out["nightjar"] == out["ar"]


def test_engine_refuses_chunks_and_prefix_caching():
    """The dense-slot tier prefills monolithically: a chunk budget or a
    prefix cache for a pair without a paged path is refused up front."""
    cfg, dc = (configs.reduced(g(ARCH)).replace(dtype="float32")
               for g in (configs.get_config, configs.get_draft_config))
    for kw in (dict(chunk_tokens=16), dict(prefix_caching=True)):
        with pytest.raises(ValueError, match="no paged path"):
            build_real_engine(cfg, dc, device="cpu", **kw)


def test_long_ssm_request_is_not_bounded_by_max_seq():
    """An ssm pair has no position axis, so the dense cache's max_seq bounds
    nothing (the C8 guard applies to attention caches only)."""
    cfg, dc = (configs.reduced(g(ARCH)).replace(dtype="float32")
               for g in (configs.get_config, configs.get_draft_config))
    t, d = registry.get_model(cfg), registry.get_model(dc)
    be = DenseSlotBackend(t, d, device="cpu", max_batch=2, max_seq=8)
    assert not be.positional
    from repro_torch.core.bandits import make_policy
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import BlockManager
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    eng = ServingEngine(be, ContinuousBatchingScheduler(BlockManager(64, 8),
                                                        max_batch=2),
                        make_policy("fixed-2", 3, seed=0), None, gamma_max=3)
    reqs = tiny_requests(2, prompt_len=6, output_len=12, vocab=cfg.vocab_size,
                         seed=1)
    m = eng.run(reqs, max_steps=500)
    assert len(m.requests) == 2


# ---------------------------------------------------------------------------
# full-width shapes, without storage
# ---------------------------------------------------------------------------


NEW = ["mamba2-780m", "zamba2-1.2b", "whisper-medium", "qwen2-72b"]
COUNTS = {"mamba2-780m": (780_148_992, 35_518_400),
          "zamba2-1.2b": (1_104_937_856, 22_900_864),
          "whisper-medium": (892_466_176, 43_336_704)}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("draft", [False, True], ids=["target", "draft"])
def test_full_width_param_specs_match_reference(arch, draft):
    """The port's meta-tensor parameter tree equals the reference's
    eval_shape tree leaf by leaf (shape and dtype) at full width; a
    hybrid's list of layers is compared stacked.  param_count agrees."""
    jget = jconfigs.get_draft_config if draft else jconfigs.get_config
    get = configs.get_draft_config if draft else configs.get_config
    jspecs = jregistry.param_specs(jget(arch))
    if isinstance(jspecs.get("layers"), list):
        layers = jspecs["layers"]
        jspecs = dict(jspecs, layers={
            k: jax.ShapeDtypeStruct((len(layers),) + v.shape, v.dtype)
            for k, v in layers[0].items()})
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flat(jspecs).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _flat(registry.param_specs(get(arch))).items()}
    assert got == want
    n = registry.param_count(get(arch))
    assert n == jregistry.param_count(jget(arch))
    if arch in COUNTS:
        assert n == COUNTS[arch][int(draft)]
