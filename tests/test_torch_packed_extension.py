"""Packed extensions of the paged decoder: a call over its rows' real
positions only (chunks of two lengths beside T=1 decode rows) gives each
row's last-position logits and the pages of the padded call, writes
nothing to the trash block and attends once per run of equal query
counts; the backend's mixed step reaches the benchmark's ``CallLog`` with
every real row and reports no padded position in its ``backend.pack``
counter, while a speculative step still reports its padded batch."""
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from repro_torch.serving.observability import TraceRecorder  # noqa: E402
from repro_torch.serving.real_backend import RealBackend  # noqa: E402
from repro_torch.serving.request import Request, Sequence  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BS, NB = 4, 32
# (start, n) of each row: chunks of 7 and 5 tokens (the two 5s one run),
# then three T=1 decode rows
ROWS = [(0, 7), (4, 5), (0, 5), (6, 1), (9, 1), (13, 1)]


def _cfg(case):
    """fp32 reduced configs.  granite's reduced capacity factor (8; 4
    experts, top 2) gives every expert room for all of a call's tokens, so
    the padded and the packed call both compute the dropless function."""
    if case == "paper-7b-draft":
        cfg = configs.reduced(configs.get_draft_config("paper-7b"))
    else:
        cfg = configs.reduced(configs.get_config(case.split("@")[0]))
    if case.endswith("@d256"):
        cfg = cfg.replace(head_dim=256)
    return cfg.replace(dtype="float32")


def _tables():
    """Four private blocks per row, none of them the trash block."""
    return torch.as_tensor([[BS * r + j for j in range(BS)]
                            for r in range(len(ROWS))], dtype=torch.int32)


def _extend(api, params, packed, ctx_api=None):
    """ROWS' extension on a fresh pool, packed or padded, after one padded
    call of ``ctx_api`` (default ``api``) wrote their contexts: (each row's
    last-position logits, the pages, the pages before the extension)."""
    rng = np.random.default_rng(5)
    stream = rng.integers(0, api.cfg.vocab_size,
                          size=(len(ROWS), max(s + n for s, n in ROWS)))
    start = np.asarray([s for s, _ in ROWS], np.int32)
    valid = np.asarray([n for _, n in ROWS], np.int32)
    pages = api.init_paged_cache(NB, BS, device="cpu")
    (ctx_api or api).decode_step_paged(
        params, pages, torch.as_tensor(stream), _tables(),
        torch.zeros(len(ROWS), dtype=torch.int32), torch.as_tensor(start))
    before = {k: v.clone() for k, v in pages.items()}
    if packed:   # the real tokens row after row, start and valid on the host
        tok = np.concatenate([stream[i, s:s + n]
                              for i, (s, n) in enumerate(ROWS)])[:, None]
    else:        # rows of 7 positions, the tails written off
        tok = np.zeros((len(ROWS), max(valid)), np.int64)
        for i, (s, n) in enumerate(ROWS):
            tok[i, :n] = stream[i, s:s + n]
    lg, out = api.decode_step_paged(params, pages, torch.as_tensor(tok),
                                    _tables(), torch.from_numpy(start),
                                    torch.from_numpy(valid))
    assert out is pages
    if packed:
        assert lg.shape == (len(ROWS), 1, api.cfg.vocab_size)
        return lg[:, 0], pages, before
    return lg[torch.arange(len(ROWS)), torch.as_tensor(valid) - 1], pages, \
        before


@pytest.mark.parametrize("case", ["paper-7b", "paper-7b-draft",
                                  "paligemma-3b@d256",
                                  "granite-moe-1b-a400m"])
def test_packed_call_matches_the_padded_call(case, monkeypatch):
    cfg = _cfg(case)
    if cfg.moe_num_experts:
        assert cfg.moe_capacity_factor * cfg.moe_top_k >= cfg.moe_num_experts
    api = registry.get_model(cfg)
    params = api.init(device="cpu", seed=3)
    want, padded, _ = _extend(api, params, False)
    # one attention call per run of equal query counts
    shapes = []
    inner = transformer.paged_attention

    def counted(q, *a):
        shapes.append(tuple(q.shape[:2]))
        return inner(q, *a)

    monkeypatch.setattr(transformer, "paged_attention", counted)
    got, packed, before = _extend(api, params, True)
    assert shapes[-3 * cfg.num_layers:] == [(1, 7), (2, 5), (3, 1)] \
        * cfg.num_layers
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    for key in ("k_pages", "v_pages"):
        # every live block as the padded call left it, the trash untouched
        torch.testing.assert_close(packed[key][:, :NB], padded[key][:, :NB],
                                   atol=1e-4, rtol=0)
        assert torch.equal(packed[key][:, NB], before[key][:, NB])
        assert not torch.equal(packed[key][:, :NB], before[key][:, :NB])


def test_a_packed_moe_call_drops_no_token():
    """A router that sends every token to the same two of eight experts, at
    the deployment's capacity factor: the padded call drops (token, expert)
    pairs past capacity; the packed call drops none and gives the logits
    and pages of a padded call with room for every token."""
    cfg = _cfg("granite-moe-1b-a400m").replace(
        moe_num_experts=8, moe_capacity_factor=1.25)
    params = registry.get_model(cfg).init(device="cpu", seed=3)
    params["layers"]["moe"]["router"].zero_()
    roomy = registry.get_model(cfg.replace(moe_capacity_factor=8.0))
    api = registry.get_model(cfg)
    want, wpages, _ = _extend(roomy, params, False)
    got, gpages, _ = _extend(api, params, True, roomy)
    dropped, _, _ = _extend(api, params, False, roomy)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    for key in ("k_pages", "v_pages"):
        torch.testing.assert_close(gpages[key][:, :NB], wpages[key][:, :NB],
                                   atol=1e-4, rtol=0)
    assert (dropped - want).abs().max() > 1e-2


def test_one_token_rows_are_the_padded_call():
    """Rows of one token each: the packed and the padded layout are one
    call (the padded one), with logits (R, 1, V)."""
    cfg = _cfg("paper-7b")
    api = registry.get_model(cfg)
    params = api.init(device="cpu", seed=3)
    tok = torch.as_tensor([[3], [5], [7]])
    tables = _tables()[:3]
    start = torch.as_tensor([0, 2, 4], dtype=torch.int32)
    ones = torch.ones(3, dtype=torch.int32)
    lg, _ = api.decode_step_paged(params, api.init_paged_cache(
        NB, BS, device="cpu"), tok, tables, start, ones)
    ref, _ = api.decode_step_paged(params, api.init_paged_cache(
        NB, BS, device="cpu"), tok, tables, start)
    assert lg.shape == (3, 1, cfg.vocab_size)
    assert torch.equal(lg, ref)


def test_a_packed_call_refuses_a_stream_that_is_not_its_rows():
    cfg = _cfg("paper-7b")
    api = registry.get_model(cfg)
    params = api.init(device="cpu", seed=3)
    with pytest.raises(ValueError, match="packed call"):
        api.decode_step_paged(params, api.init_paged_cache(NB, BS,
                                                           device="cpu"),
                              torch.zeros((6, 1), dtype=torch.int64),
                              _tables()[:2],
                              torch.zeros(2, dtype=torch.int32),
                              torch.as_tensor([3, 2], dtype=torch.int32))


# ---------------------------------------------------------------------------
# the backend's mixed step, as the benchmark and the counters see it
# ---------------------------------------------------------------------------


def _seq(rid, n, vocab):
    toks = [int(t) for t in np.random.default_rng(rid).integers(0, vocab, n)]
    return Sequence(Request(rid, 0.0, n, 16, prompt_tokens=toks))


def _backend(wrap=lambda api: api):
    cfg, dcfg = _cfg("paper-7b"), _cfg("paper-7b-draft")
    target = registry.get_model(cfg)
    draft = registry.get_model(dcfg)
    params = (target.init(device="cpu", seed=1), draft.init(device="cpu",
                                                             seed=2))
    return RealBackend(wrap(target), wrap(draft), device="cpu",
                       params=params, max_batch=8, max_seq=64), cfg, dcfg


def _mixed(be, vocab, hook=lambda: None):
    """Prefill A (6) and B (9) whole, then one mixed step: C's chunk of 7
    and D's of 5 (both final) beside A's and B's decode rows."""
    a, b, c, d = (_seq(i, n, vocab) for i, n in enumerate((6, 9, 7, 5)))
    be.hybrid_step([(a, 6), (b, 9)], [], 0, with_draft=True)
    a.prefilled, b.prefilled = 6, 9
    hook()
    be.hybrid_step([(c, 7), (d, 5)], [a, b], 0, with_draft=True)
    c.prefilled, d.prefilled = 7, 5
    return a, b, c, d


def test_call_log_sees_every_real_row_of_a_mixed_step():
    from bench_port.lib.serve import CallLog
    log = CallLog()
    be, cfg, dcfg = _backend(log.wrap)
    _mixed(be, cfg.vocab_size, hook=lambda: setattr(log, "on", True))
    assert [shape for _, shape, *_ in log.calls] == [(14, 1), (12, 1)]
    rows = log.rows()
    assert [c for c, _ in rows] == [cfg, dcfg]
    assert rows[0][1] == [(0, 7), (0, 5), (6, 1), (9, 1)]
    assert rows[1][1] == [(0, 7), (0, 5)]


def test_pack_counter_reads_no_padding_in_a_mixed_step():
    be, cfg, _ = _backend()
    a, b, c, _ = _mixed(be, cfg.vocab_size)
    rec = TraceRecorder(clock=time.perf_counter)
    be.spans = rec

    def step(fn, *args, **kw):
        rec.open("step")
        rec.open("engine.execute")
        fn(*args, **kw)
        rec.close_step("mixed")

    d = _seq(9, 6, cfg.vocab_size)
    step(be.hybrid_step, [(d, 6)], [a, b, c], 0, with_draft=True)
    step(be.draft_catchup, [a, b, c])
    starts = [be.tkv.ctx[s.req_id] for s in (a, b, c)]
    step(be.step, [a, b, c], 2)
    packs = [e["args"] for e in rec.events if e["name"] == "backend.pack"]
    assert packs == [
        # the mixed step: the target over 6 + 3 positions, the draft over
        # the chunk's 6
        {"model": "target", "positions_run": 9, "positions_valid": 9},
        {"model": "draft", "positions_run": 6, "positions_valid": 6},
        # the catch-up: A and B two tokens behind the target, C one
        {"model": "draft", "positions_run": 5, "positions_valid": 5},
        # gamma = 2 over three rows padded to four, with each row's
        # context
        {"model": "spec", "positions_run": 12, "positions_valid": 9,
         "starts": starts}]
