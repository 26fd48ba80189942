"""The port's paged speculative step and verification against the JAX
package's (fp32, bridged weights, reduced paper-7b pair)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.spec_decode import make_paged_spec_step as jmake_spec  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.spec_decode import (make_paged_ar_step,  # noqa: E402
                                          make_paged_spec_step)
from repro_torch.core.verify import verify_greedy, verify_rejection  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

B, S, BS, NB = 2, 8, 4, 32


def _models(same_draft):
    """JAX and port (target, draft) apis and params on the same weights;
    ``same_draft`` drafts with the target itself (every proposal is
    accepted under greedy verification)."""
    out = []
    for draft in (False, True):
        use_draft = draft and not same_draft
        jget = jconfigs.get_draft_config if use_draft else jconfigs.get_config
        get = configs.get_draft_config if use_draft else configs.get_config
        jcfg = jconfigs.reduced(jget("paper-7b")).replace(dtype="float32")
        cfg = configs.reduced(get("paper-7b")).replace(dtype="float32")
        japi, api = jregistry.get_model(jcfg), registry.get_model(cfg)
        jp = japi.init(jax.random.PRNGKey(0 if same_draft else int(draft)))
        out.append((japi, api, jp, params_from_numpy(
            cfg, jax.tree.map(np.asarray, jp), device="cpu")))
    return out


def _prefilled(models, prompt):
    """Both packages' pools after a prompt prefill, and the first token."""
    tables = np.arange(NB, dtype=np.int32).reshape(B, -1)
    state = []
    for japi, api, jp, tp in models:
        _, jpages = japi.decode_step_paged(
            jp, japi.init_paged_cache(NB, BS), jnp.asarray(prompt),
            jnp.asarray(tables), jnp.zeros((B,), jnp.int32))
        tl, tpages = api.decode_step_paged(
            tp, api.init_paged_cache(NB, BS, device="cpu"),
            torch.as_tensor(prompt), torch.as_tensor(tables),
            torch.zeros((B,), dtype=torch.int32))
        state.append((jpages, tl, tpages))
    first = state[0][1][:, -1].argmax(-1)
    return tables, state, first


def _prompt(vocab):
    return np.random.default_rng(4).integers(0, vocab, size=(B, S)).astype(
        np.int32)


@pytest.mark.parametrize("same_draft", [False, True])
@pytest.mark.parametrize("gamma", [1, 2, 3])
def test_paged_spec_step_matches_jax(gamma, same_draft):
    (jt, tt, jtp, ttp), (jd, td, jdp, tdp) = models = _models(same_draft)
    tables, state, first = _prefilled(models, _prompt(tt.cfg.vocab_size))
    jtpages, _, ttpages = state[0]
    jdpages, _, tdpages = state[1]
    jspec = jax.jit(jmake_spec(jt, jd), static_argnames=("gamma",))
    tspec = make_paged_spec_step(tt, td)
    jlen = np.full((B,), S, np.int32)
    jlast = np.asarray(first.numpy(), np.int32)
    tlen, tlast = torch.as_tensor(jlen), first
    for _ in range(3):
        jr = jspec(jax.random.PRNGKey(0), jtp, jdp, jtpages, jdpages,
                   jnp.asarray(tables), jnp.asarray(jlen), jnp.asarray(jlast),
                   gamma=gamma)
        tr = tspec(None, ttp, tdp, ttpages, tdpages, torch.as_tensor(tables),
                   tlen, tlast, gamma)
        np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
        np.testing.assert_array_equal(tr.n_accepted.numpy(),
                                      np.asarray(jr.n_accepted))
        np.testing.assert_array_equal(tr.last_token.numpy(),
                                      np.asarray(jr.last_token))
        if same_draft:
            assert (tr.n_accepted == gamma).all()
        jtpages, jdpages = jr.tcache, jr.dcache
        ttpages, tdpages = tr.tcache, tr.dcache
        jlen = jlen + np.asarray(jr.n_committed, np.int32)
        jlast = np.asarray(jr.last_token, np.int32)
        tlen, tlast = tlen + tr.n_committed.int(), tr.last_token


@pytest.mark.parametrize("gamma", [1, 3])
def test_greedy_spec_stream_equals_ar_stream(gamma):
    models = _models(False)
    (_, tt, _, ttp), (_, td, _, tdp) = models
    tables, state, first = _prefilled(models, _prompt(tt.cfg.vocab_size))
    n_out = 12
    tab = torch.as_tensor(tables)

    ar = make_paged_ar_step(tt)
    pages = state[0][2]
    ar_pages = {k: v.clone() for k, v in pages.items()}
    last, length, ar_out = first, torch.full((B,), S, dtype=torch.int32), []
    for _ in range(n_out):
        last, ar_pages = ar(None, ttp, ar_pages, tab, length, last)
        ar_out.append(last)
        length = length + 1
    ar_stream = torch.stack(ar_out, 1).tolist()

    spec = make_paged_spec_step(tt, td)
    tp, dp = state[0][2], state[1][2]
    last, length = first, torch.full((B,), S, dtype=torch.int32)
    streams = [[] for _ in range(B)]
    while min(len(s) for s in streams) < n_out:
        res = spec(None, ttp, tdp, tp, dp, tab, length, last, gamma)
        tp, dp, last = res.tcache, res.dcache, res.last_token
        length = length + res.n_committed.int()
        for b in range(B):
            streams[b].extend(t for t in res.tokens[b].tolist() if t >= 0)
    for b in range(B):
        assert streams[b][:n_out] == ar_stream[b]


def _dist(rng, V, temp):
    x = rng.normal(size=V) * temp
    e = np.exp(x - x.max())
    return e / e.sum()


@pytest.mark.parametrize("seed,vocab,temp", [(0, 2, 0.5), (1, 4, 1.0),
                                             (2, 6, 2.5)])
def test_rejection_first_position_distribution_preserved(seed, vocab, temp):
    rng = np.random.default_rng(seed)
    p, q = _dist(rng, vocab, temp), _dist(rng, vocab, temp * 2)
    N, g = 20_000, 1
    gen = torch.Generator().manual_seed(seed)
    qt = torch.as_tensor(q, dtype=torch.float32)
    draft_tokens = torch.multinomial(qt.expand(N, vocab), 1, replacement=True,
                                     generator=gen)
    res = verify_rejection(gen, draft_tokens, qt.expand(N, g, vocab),
                           torch.as_tensor(p, dtype=torch.float32)
                           .expand(N, g + 1, vocab))
    emp = np.bincount(res["tokens"][:, 0].numpy(), minlength=vocab) / N
    assert np.max(np.abs(emp - p)) < 0.02, (emp, p)


@pytest.mark.parametrize("seed,vocab,g", [(0, 2, 1), (1, 4, 2), (2, 8, 4),
                                          (3, 5, 3)])
def test_rejection_committed_structure_invariants(seed, vocab, g):
    rng = np.random.default_rng(seed)
    Bn = 16
    draft_tokens = torch.as_tensor(rng.integers(0, vocab, size=(Bn, g)))
    dp = torch.as_tensor(rng.dirichlet(np.ones(vocab), size=(Bn, g)))
    tp = torch.as_tensor(rng.dirichlet(np.ones(vocab), size=(Bn, g + 1)))
    res = verify_rejection(torch.Generator().manual_seed(seed), draft_tokens,
                           dp, tp)
    n, toks = res["n_accepted"].numpy(), res["tokens"].numpy()
    assert ((0 <= n) & (n <= g)).all()
    for b in range(Bn):
        assert (toks[b, :n[b]] == draft_tokens[b, :n[b]].numpy()).all()
        assert toks[b, n[b]] == int(res["next_token"][b]) >= 0
        assert (toks[b, n[b] + 1:] == -1).all()


def test_rejection_identical_models_accept_everything():
    V, g, Bn = 16, 4, 8
    p = torch.as_tensor(np.random.default_rng(0).dirichlet(
        np.ones(V), size=(Bn, g + 1)))
    gen = torch.Generator().manual_seed(1)
    draft_tokens = torch.multinomial(p[:, :g].reshape(-1, V), 1,
                                     generator=gen).view(Bn, g)
    res = verify_rejection(gen, draft_tokens, p[:, :g], p)
    assert (res["n_accepted"] == g).all()


def test_rejection_disjoint_support_rejects_everything():
    V, g, Bn = 4, 3, 64
    q = torch.tensor([1.0, 0.0, 0.0, 0.0])
    p = torch.tensor([0.0, 0.0, 0.5, 0.5])
    res = verify_rejection(torch.Generator().manual_seed(0),
                           torch.zeros((Bn, g), dtype=torch.long),
                           q.expand(Bn, g, V), p.expand(Bn, g + 1, V))
    assert (res["n_accepted"] == 0).all()
    assert np.isin(res["next_token"].numpy(), [2, 3]).all()


@pytest.mark.parametrize("seed,g", [(0, 1), (1, 2), (2, 3)])
def test_greedy_verification_matches_jax(seed, g):
    from repro.core.verify import verify_greedy as jverify
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(8, g + 1, 6)).astype(np.float32)
    draft = rng.integers(0, 6, size=(8, g))
    draft[::2] = logits[::2, :g].argmax(-1)        # some full acceptances
    want = jverify(jnp.asarray(draft), jnp.asarray(logits))
    got = verify_greedy(torch.as_tensor(draft), torch.as_tensor(logits))
    for k in ("n_accepted", "next_token", "tokens"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_rejection_spec_step_with_target_as_draft_accepts_everything():
    """Sampled speculation: a draft identical to the target has q == p at
    every position, so every proposal is accepted; the committed tokens are
    valid ids and the step is reproducible from the generator's seed."""
    models = _models(True)
    (_, tt, _, ttp), (_, td, _, tdp) = models
    tables, state, first = _prefilled(models, _prompt(tt.cfg.vocab_size))
    spec = make_paged_spec_step(tt, td, sampling="rejection")
    ar = make_paged_ar_step(tt, sampling="rejection")
    runs = []
    for _ in range(2):
        tp = {k: v.clone() for k, v in state[0][2].items()}
        dp = {k: v.clone() for k, v in state[1][2].items()}
        gen = torch.Generator().manual_seed(7)
        res = spec(gen, ttp, tdp, tp, dp, torch.as_tensor(tables),
                   torch.full((B,), S, dtype=torch.int32), first, 3)
        assert (res.n_accepted == 3).all()
        assert ((res.tokens >= 0) & (res.tokens < tt.cfg.vocab_size)).all()
        nxt, _ = ar(gen, ttp, tp, torch.as_tensor(tables),
                    torch.full((B,), S + 4, dtype=torch.int32),
                    res.last_token)
        runs.append((res.tokens, nxt))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
