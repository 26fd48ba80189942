"""The port's zamba2-style hybrid against the JAX package's, on bridged fp32
weights at reduced size (4 mamba layers, the shared attention block after
layers 1 and 3): prefill + decode == forward and the multi-token extension
with checkpoints (the zamba2 cases of tests/test_decode_equivalence.py), a
hybrid target's rollback past checkpoint 0, speculative greedy == AR with
its ssm draft, the engine on ``DenseSlotBackend``, and the cost model's
per-family KV and weight bytes against the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import spec_decode as jspec  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.serving import costmodel as jcostmodel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import spec_decode  # noqa: E402
from repro_torch.launch.serve import build_real_engine  # noqa: E402
from repro_torch.models import hybrid, registry  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.common import tied_unembed  # noqa: E402
from repro_torch.serving import costmodel  # noqa: E402
from repro_torch.serving.real_backend import DenseSlotBackend  # noqa: E402
from repro_torch.serving.workload import tiny_requests  # noqa: E402

ARCH = "zamba2-1.2b"
B, S = 2, 16
MAX = S + 8


def _pair(draft=False, key=0):
    jget = jconfigs.get_draft_config if draft else jconfigs.get_config
    get = configs.get_draft_config if draft else configs.get_config
    jcfg = jconfigs.reduced(jget(ARCH)).replace(dtype="float32")
    cfg = configs.reduced(get(ARCH)).replace(dtype="float32")
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
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def test_reduced_config_has_two_attention_points(target):
    _, api, _, tp = target
    assert hybrid.attn_points(api.cfg) == (1, 3)
    assert hybrid.attn_points(configs.get_config(ARCH)) == (5, 11, 17, 23,
                                                            29, 35)
    assert tp["layers"]["in_proj"].shape[0] == api.cfg.num_layers


def test_decode_matches_forward_and_jax(target):
    """prefill, then three T = 1 steps: logits equal the forward and the
    reference's; the states and the attention caches equal the
    reference's."""
    japi, api, jp, tp = target
    tok = _tokens(api.cfg, 1)
    h = api.forward(tp, {"tokens": torch.as_tensor(tok[:, :S + 3])})
    np.testing.assert_allclose(
        h.numpy(), np.asarray(japi.forward(jp, {"tokens": jnp.asarray(
            tok[:, :S + 3])})), atol=1e-4)
    full = tied_unembed(tp, h).numpy()
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(tok[:, :S])}, MAX)
    tl, tc = api.prefill(tp, {"tokens": torch.as_tensor(tok[:, :S])}, MAX)
    got, want = [tl[:, 0].numpy()], [np.asarray(jl[:, 0])]
    for t in range(S, S + 3):
        jl, jc = japi.decode_step(jp, jc, jnp.asarray(tok[:, t:t + 1]))
        tl, tc = api.decode_step(tp, tc, torch.as_tensor(tok[:, t:t + 1]))
        got.append(tl[:, 0].numpy())
        want.append(np.asarray(jl[:, 0]))
    got = np.stack(got, 1)
    np.testing.assert_allclose(got, np.stack(want, 1), atol=1e-4)
    np.testing.assert_allclose(got, full[:, S - 1:S + 3], atol=1e-4)
    for key in ("conv", "ssm", "attn_k", "attn_v"):
        _close(tc[key].numpy(), jc[key])


def test_multitoken_extension_checkpoints(target):
    """T = 3: logits equal the forward and the reference's; the conv / SSM
    checkpoints equal the reference's one by one and are distinct
    tensors."""
    japi, api, jp, tp = target
    tok = _tokens(api.cfg, 2)
    full = tied_unembed(tp, api.forward(
        tp, {"tokens": torch.as_tensor(tok[:, :S + 3])})).numpy()
    _, jc = japi.prefill(jp, {"tokens": jnp.asarray(tok[:, :S])}, MAX)
    _, tc = api.prefill(tp, {"tokens": torch.as_tensor(tok[:, :S])}, MAX)
    jl, jc3 = japi.decode_step(jp, jc, jnp.asarray(tok[:, S:S + 3]))
    tl, tc3 = api.decode_step(tp, tc, torch.as_tensor(tok[:, S:S + 3]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), full[:, S:S + 3], atol=1e-4)
    for key in ("conv", "ssm"):
        ck = tc3["checkpoints"][key]
        for t in range(3):
            _close(ck[t].numpy(), jc3["checkpoints"][key][t])
        assert len({ck[t].data_ptr() for t in range(3)}) == 3
        assert not torch.equal(ck[0], ck[2])


def test_rollback_past_checkpoint_0(target):
    """decode_step with T = 3, then _rollback_ssm_cache with n_keep = (1, 3)
    across the batch: equal to the reference's rollback of the reference's
    extension, and to a fresh decode of only the kept tokens (random
    drafts are never accepted, so no stream test reaches index 2)."""
    japi, api, jp, tp = target
    tok = _tokens(api.cfg, 3)
    n_keep = np.array([1, 3], np.int32)
    _, jc = japi.prefill(jp, {"tokens": jnp.asarray(tok[:, :S])}, MAX)
    _, tc = api.prefill(tp, {"tokens": torch.as_tensor(tok[:, :S])}, MAX)
    _, jext = japi.decode_step(jp, jc, jnp.asarray(tok[:, S:S + 3]))
    _, text = api.decode_step(tp, {k: v.clone() for k, v in tc.items()},
                              torch.as_tensor(tok[:, S:S + 3]))
    want = jspec._rollback_ssm_cache(jext, jc, jnp.asarray(n_keep))
    got = spec_decode._rollback_ssm_cache(text, tc, torch.as_tensor(n_keep))
    assert set(got) == set(want)
    for key in ("conv", "ssm", "attn_k", "attn_v"):
        _close(got[key].numpy(), want[key])
    assert got["length"].tolist() == (S + n_keep).tolist()
    # each sequence alone: a fresh decode of its kept tokens
    for b, n in enumerate(n_keep):
        one = {k: v[b:b + 1].clone() if v.dim() == 1 else
               v[:, b:b + 1].clone() for k, v in tc.items()}
        for t in range(n):
            _, one = api.decode_step(tp, one, torch.as_tensor(
                tok[b:b + 1, S + t:S + t + 1]))
        for key in ("conv", "ssm"):
            _close(got[key][:, b:b + 1].numpy(), one[key].numpy())
        for key in ("attn_k", "attn_v"):
            _close(got[key][:, b:b + 1, :S + n].numpy(),
                   one[key][:, :, :S + n].numpy())


def test_spec_greedy_equals_ar(target):
    """A hybrid target with its ssm draft through make_spec_step: the greedy
    stream equals AR, and the AR tokens equal the reference's make_ar_step
    on the same weights."""
    japi, api, jp, tp = target
    _, dapi, _, dp = _pair(draft=True, key=1)
    toks = _tokens(api.cfg, 5, n=8)
    steps, gamma, max_len = 12, 2, 40
    lg, tc = api.prefill(tp, {"tokens": torch.as_tensor(toks)}, max_len)
    last = lg[:, 0].argmax(-1)
    ar = spec_decode.make_ar_step(api)
    ar_seq = [last]
    for _ in range(steps):
        last, tc = ar(None, tp, tc, last)
        ar_seq.append(last)
    ar_seq = torch.stack(ar_seq, 1).numpy()
    jlg, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len)
    jlast = jnp.argmax(jlg[:, 0], -1)
    jar = jspec.make_ar_step(japi)
    jseq = [np.asarray(jlast)]
    for _ in range(steps):
        jlast, jc = jar(jax.random.PRNGKey(0), jp, jc, jlast)
        jseq.append(np.asarray(jlast))
    np.testing.assert_array_equal(ar_seq, np.stack(jseq, 1))

    spec = spec_decode.make_spec_step(api, dapi)
    lg, tc = api.prefill(tp, {"tokens": torch.as_tensor(toks)}, max_len)
    _, dc = dapi.prefill(dp, {"tokens": torch.as_tensor(toks)})
    last = lg[:, 0].argmax(-1)
    streams = [[int(t)] for t in last]
    while min(len(s) for s in streams) < steps:
        res = spec(None, tp, dp, tc, dc, last, gamma)
        tc, dc, last = res.tcache, res.dcache, res.last_token
        assert "checkpoints" not in tc
        for b, row in enumerate(res.tokens.tolist()):
            streams[b].extend(t for t in row if t >= 0)
    for b in range(B):
        n = min(len(streams[b]), ar_seq.shape[1])
        assert streams[b][:n] == ar_seq[b, :n].tolist(), b


def test_hybrid_draft_is_refused(target):
    _, api, _, _ = target
    with pytest.raises(NotImplementedError, match="draft"):
        spec_decode.make_spec_step(api, api)


def test_engine_streams_on_dense_slots():
    """build_real_engine on the reduced zamba2 pair picks DenseSlotBackend;
    its greedy streams under Nightjar and fixed-2 equal AR's, and a request
    that would pass the attention caches' max_seq is refused (a hybrid has
    positions)."""
    cfg, dcfg = (configs.reduced(g(ARCH)).replace(dtype="float32")
                 for g in (configs.get_config, configs.get_draft_config))
    params = (registry.get_model(cfg).init(device="cpu", seed=1),
              registry.get_model(dcfg).init(device="cpu", seed=2))
    out = {}
    for policy in ("nightjar", "fixed-2", "ar"):
        eng = build_real_engine(cfg, dcfg, device="cpu", policy=policy,
                                params=params)
        assert type(eng.backend) is DenseSlotBackend
        assert eng.backend.positional
        reqs = tiny_requests(4, prompt_len=12, output_len=10,
                             vocab=cfg.vocab_size, seed=3)
        m = eng.run(reqs, max_steps=3000, record_timeline=True)
        out[policy] = {r.req_id: eng.backend.output_tokens(r.req_id)[:11]
                       for r in reqs}
        if policy != "ar":
            assert m.spec["spec_steps"] >= 1
    assert out["nightjar"] == out["ar"] == out["fixed-2"]


# ---------------------------------------------------------------------------
# the cost model, per family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.list_archs())
def test_kv_bytes_per_token_matches_reference(arch):
    """The reference's per-family rule on every registered config: 0 for
    ssm, the decoder's layers for encdec, the attention points for a
    hybrid (zamba2-1.2b: 6 points, 49,152 B)."""
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_draft_config, jconfigs.get_draft_config)):
        for red, jred in ((lambda c: c, lambda c: c),
                          (configs.reduced, jconfigs.reduced)):
            assert costmodel.kv_bytes_per_token(red(get(arch))) == \
                jcostmodel.kv_bytes_per_token(jred(jget(arch)))
    if arch == ARCH:
        assert costmodel.kv_bytes_per_token(configs.get_config(arch)) == \
            49_152


# fp32 bytes the reference's param_count x 2 misses (ROADMAP C7): the MoE
# router, and an ssm layer's A_log / D / dt_bias
FP32_DELTA = {"mamba2-780m": (13_824, 1_152), "zamba2-1.2b": (14_592, 768),
              "granite-moe-1b-a400m": (1_572_864, 0),
              "grok-1-314b": (6_291_456, 0)}


@pytest.mark.parametrize("arch", configs.list_archs())
def test_weight_bytes_against_reference(arch):
    """weight_bytes walks each family's own layout: equal to the
    reference's param_count x 2 where every leaf is in the model dtype, and
    above it by the fp32 leaves' extra 2 bytes each where C7 applies (the
    target, then the draft)."""
    pairs = ((configs.get_config, jconfigs.get_config),
             (configs.get_draft_config, jconfigs.get_draft_config))
    for (get, jget), delta in zip(pairs, FP32_DELTA.get(arch, (0, 0))):
        ref = jcostmodel.RooflineCostModel().weight_bytes(jget(arch))
        got = costmodel.RooflineCostModel().weight_bytes(get(arch))
        assert got - ref == delta, get
