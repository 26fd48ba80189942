"""The port's whisper-style encoder-decoder against the JAX package's, on
bridged fp32 weights at reduced size (2 + 2 layers, 12 frames): prefill +
decode == forward and the multi-token extension (the whisper cases of
tests/test_decode_equivalence.py), speculative greedy == AR at model level
with the dense draft, and the serving tier's refusal: the engine serves
token prompts, not audio, as the reference's real tier."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import spec_decode as jspec  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import spec_decode  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.common import tied_unembed  # noqa: E402
from repro_torch.serving.real_backend import (DenseSlotBackend,  # noqa: E402
                                              make_real_backend)

ARCH = "whisper-medium"
B, S, S_ENC = 2, 16, 12
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


def _inputs(cfg, seed, n=S + 4):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(B, n)).astype(np.int32)
    enc = rng.normal(size=(B, S_ENC, cfg.d_model)).astype(np.float32)
    return tok, enc


def _batches(tok, enc):
    return ({"tokens": jnp.asarray(tok), "enc_emb": jnp.asarray(enc)},
            {"tokens": torch.as_tensor(tok), "enc_emb": torch.as_tensor(enc)})


def test_learned_positions_are_served(target):
    """The port's registry no longer refuses pos_embedding == "learned";
    whisper's cross-attention has no qkv bias and its decoder layers a
    third norm."""
    _, api, _, tp = target
    assert api.cfg.pos_embedding == "learned"
    assert not api.supports_paged
    assert tp["enc_pos"].shape == (api.cfg.max_position_embeddings,
                                   api.cfg.d_model)
    assert set(tp["dec_layers"]) == {"self_attn", "cross_attn", "mlp", "ln1",
                                     "ln2", "ln3"}
    assert "bq" not in tp["dec_layers"]["cross_attn"]


def test_decode_matches_forward_and_jax(target):
    """prefill (encoder + 16 tokens), then three T = 1 steps: logits equal
    the forward and the reference's; every cache equals the
    reference's."""
    japi, api, jp, tp = target
    tok, enc = _inputs(api.cfg, 1)
    jb, tb = _batches(tok[:, :S + 3], enc)
    h = api.forward(tp, tb)
    np.testing.assert_allclose(h.numpy(), np.asarray(japi.forward(jp, jb)),
                               atol=1e-4)
    full = tied_unembed(tp, h).numpy()
    jb, tb = _batches(tok[:, :S], enc)
    jl, jc = japi.prefill(jp, jb, MAX)
    tl, tc = api.prefill(tp, tb, MAX)
    assert tc["enc_len"].tolist() == [S_ENC] * B
    got, want = [tl[:, 0].numpy()], [np.asarray(jl[:, 0])]
    for t in range(S, S + 3):
        jl, jc = japi.decode_step(jp, jc, jnp.asarray(tok[:, t:t + 1]))
        tl, tc = api.decode_step(tp, tc, torch.as_tensor(tok[:, t:t + 1]))
        got.append(tl[:, 0].numpy())
        want.append(np.asarray(jl[:, 0]))
    got = np.stack(got, 1)
    np.testing.assert_allclose(got, np.stack(want, 1), atol=1e-4)
    np.testing.assert_allclose(got, full[:, S - 1:S + 3], atol=1e-4)
    for key in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-5)


def test_multitoken_extension_matches_forward_and_jax(target):
    japi, api, jp, tp = target
    tok, enc = _inputs(api.cfg, 2)
    full = tied_unembed(tp, api.forward(
        tp, _batches(tok[:, :S + 3], enc)[1])).numpy()
    jb, tb = _batches(tok[:, :S], enc)
    _, jc = japi.prefill(jp, jb, MAX)
    _, tc = api.prefill(tp, tb, MAX)
    jl, _ = japi.decode_step(jp, jc, jnp.asarray(tok[:, S:S + 3]))
    tl, _ = api.decode_step(tp, tc, torch.as_tensor(tok[:, S:S + 3]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), full[:, S:S + 3], atol=1e-4)


def test_encoder_is_bidirectional_and_decoder_causal(target):
    """Every decoder position sees every frame (changing the last frame
    moves the first token's output), and no position sees a later
    token."""
    _, api, _, tp = target
    tok, enc = _inputs(api.cfg, 3)
    base = api.forward(tp, _batches(tok[:, :S], enc)[1])
    enc2 = enc.copy()
    # not a constant shift: the LayerNorms would remove one
    enc2[:, -1] += np.random.default_rng(0).normal(size=enc.shape[-1])
    tok2 = tok.copy()
    tok2[:, S - 1] = (tok2[:, S - 1] + 1) % api.cfg.vocab_size
    moved = api.forward(tp, _batches(tok[:, :S], enc2)[1])
    later = api.forward(tp, _batches(tok2[:, :S], enc)[1])
    assert (moved[:, 0] - base[:, 0]).abs().max() > 1e-3
    assert torch.equal(later[:, :S - 1], base[:, :S - 1])


def test_spec_greedy_equals_ar_model_level(target):
    """whisper's target (prefilled with its encoder input) and its dense
    draft through make_spec_step: the greedy stream equals AR, and the AR
    tokens equal the reference's make_ar_step on the same weights."""
    japi, api, jp, tp = target
    _, dapi, _, dp = _pair(draft=True, key=1)
    tok, enc = _inputs(api.cfg, 4, n=8)
    steps, gamma, max_len = 10, 2, 40
    jb, tb = _batches(tok, enc)
    lg, tc = api.prefill(tp, tb, max_len)
    last = lg[:, 0].argmax(-1)
    ar = spec_decode.make_ar_step(api)
    ar_seq = [last]
    for _ in range(steps):
        last, tc = ar(None, tp, tc, last)
        ar_seq.append(last)
    ar_seq = torch.stack(ar_seq, 1).numpy()
    jlg, jc = japi.prefill(jp, jb, max_len)
    jlast = jnp.argmax(jlg[:, 0], -1)
    jar = jspec.make_ar_step(japi)
    jseq = [np.asarray(jlast)]
    for _ in range(steps):
        jlast, jc = jar(jax.random.PRNGKey(0), jp, jc, jlast)
        jseq.append(np.asarray(jlast))
    np.testing.assert_array_equal(ar_seq, np.stack(jseq, 1))

    spec = spec_decode.make_spec_step(api, dapi)
    lg, tc = api.prefill(tp, tb, max_len)
    _, dc = dapi.prefill(dp, {"tokens": torch.as_tensor(tok)}, max_len)
    last = lg[:, 0].argmax(-1)
    streams = [[int(t)] for t in last]
    while min(len(s) for s in streams) < steps:
        res = spec(None, tp, dp, tc, dc, last, gamma)
        tc, dc, last = res.tcache, res.dcache, res.last_token
        assert (tc["enc_len"] == S_ENC).all()
        for b, row in enumerate(res.tokens.tolist()):
            streams[b].extend(t for t in row if t >= 0)
    for b in range(B):
        n = min(len(streams[b]), ar_seq.shape[1])
        assert streams[b][:n] == ar_seq[b, :n].tolist(), b


def test_serving_tier_refuses_an_encoder_decoder(target):
    """Requests carry token prompts, not audio: DenseSlotBackend (the only
    tier for a pair without a paged path) refuses an encdec target at
    construction instead of failing later on a missing enc_emb."""
    _, api, _, _ = target
    dcfg = configs.reduced(configs.get_draft_config(ARCH)).replace(
        dtype="float32")
    draft = registry.get_model(dcfg)
    with pytest.raises(NotImplementedError, match="enc_emb"):
        make_real_backend(api, draft, device="cpu", max_batch=2,
                          max_seq=32)
    with pytest.raises(NotImplementedError, match="enc_emb"):
        DenseSlotBackend(api, draft, device="cpu")
