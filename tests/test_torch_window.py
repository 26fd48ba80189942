"""Sliding-window and full attention in one paged decoder (Mellum2's
layout), held to the benchmark's plain reference on the CPU.

At the reduced size (``configs/mellum2_12b.reduced``: one period of the
3 : 1 pattern, a window of 8 positions, shorter than the contexts, 8
experts top-2, float32, seeded random weights): the paged decoder in its
padded calls (prefill, decode, spec verify rows) and its packed calls
(chunks that straddle the window's edge beside decode rows), and the
full-sequence and dense-cache paths, against ``bench_port/archs/
swa_moe.py``'s ``logits``; the plain ``paged_attention`` with a window
against a dense masked softmax; yarn's frequencies against their closed
form; the window-0 path as today's; the backend's K / V read counters; the
architecture module's counts and refusals; and the benchmark's cell on
the CPU.  The ``cuda`` test holds the windowed kernel to its plain
version on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_window.py
"""
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, mellum2_12b, reduced  # noqa: E402
from repro_torch.configs.base import (FULL, SLIDING,  # noqa: E402
                                      WindowedConfig)
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.ref import paged_attention_ref  # noqa: E402
from repro_torch.models import common, registry, transformer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.lib import model as bench_model  # noqa: E402
from bench_port.lib import spec  # noqa: E402

ARCH = spec.load_arch("swa_moe", ROOT)
WINDOW = 8
SEED = 2**31 + 2028
# float32 on both sides, the same weights: the port and the reference
# differ only in the order of their sums (blocked vs dense attention,
# batched vs per-expert MoE products), a few float32 ulps of logits that
# spread over about +-1; a window misplaced by one position, a rope of the
# wrong kind or a wrong yarn band moves logits by 1e-2 or more
ATOL = 1e-4


def bench_group(window=WINDOW):
    """The benchmark's configuration file of Mellum2 at the reduced size of
    ``mellum2_12b.reduced``: the published keys cut, nothing else."""
    c = json.loads((ROOT / "bench_port/configs/mellum2-12b-a2.5b.json")
                   .read_text())
    c.update(hidden_size=128, num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, head_dim=32, moe_intermediate_size=64,
             num_experts=8, num_experts_per_tok=2, vocab_size=256,
             max_position_embeddings=512, torch_dtype="float32",
             sliding_window=window, layer_types=c["layer_types"][:4],
             mlp_layer_types=c["mlp_layer_types"][:4])
    c["port"]["target"]["moe_capacity_factor"] = 8.0
    return c


@pytest.fixture(scope="module")
def mellum():
    group = bench_group()
    cfg = ARCH.port_config("mellum2-12b-a2.5b", group,
                           group["port"]["target"])
    params = bench_model.make_weights(
        cfg, torch.Generator().manual_seed(SEED), "cpu")
    return SimpleNamespace(cfg=cfg, params=params, sizes=ARCH.sizes(group))


def reference(m, seqs):
    """The reference's logits of every position of each sequence."""
    return ARCH.logits(m.params, m.sizes,
                       [torch.as_tensor(s) for s in seqs], [0] * len(seqs))


def tokens(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------


def test_the_benchmarks_config_is_the_ports():
    group = json.loads((ROOT / "bench_port/configs/mellum2-12b-a2.5b.json")
                       .read_text())
    t, d = bench_model.pair(group)
    assert t == mellum2_12b.CONFIG
    assert d == mellum2_12b.DRAFT
    assert t.layer_types == (SLIDING,) * 3 + (FULL,) + (SLIDING,) * 3 \
        + (FULL,) + (SLIDING, SLIDING, SLIDING, FULL) * 5
    assert [t.layer_window(i) for i in range(4)] == [1024, 1024, 1024, 0]
    assert registry.param_count(t) == 12_149_915_904
    small = ARCH.port_config("mellum2-12b-a2.5b", bench_group(),
                             bench_group()["port"]["target"])
    assert small == mellum2_12b.reduced()


@pytest.mark.parametrize("kw,msg", [
    (dict(layer_types=(FULL,)), "1 layer types for 2 layers"),
    (dict(layer_types=(FULL, "chunked_attention")), "unknown layer types"),
    (dict(layer_types=(FULL, SLIDING)), "sliding_window of at least 1"),
])
def test_a_windowed_config_refuses_what_it_cannot_run(kw, msg):
    with pytest.raises(ValueError, match=msg):
        WindowedConfig("w", "dense", 2, 64, 4, 2, 128, 256, **kw)


def test_reference_configs_keep_one_kind_of_layer():
    cfg = get_config("paper-7b")
    assert cfg.layer_types == () and cfg.sliding_window == 0
    assert cfg.yarn_factor == 0.0
    assert {cfg.layer_window(i) for i in range(cfg.num_layers)} == {0}


# ---------------------------------------------------------------------------
# yarn
# ---------------------------------------------------------------------------


def test_yarn_frequencies_against_the_closed_form():
    """Mellum2's full layers: head_dim 128, theta 5e5, factor 16 over
    8,192 positions, beta 32 / 1.  The band runs from dim
    floor(128 ln(8192 / (2 pi 32)) / (2 ln 5e5)) = 18 to
    ceil(128 ln(8192 / (2 pi)) / (2 ln 5e5)) = 35."""
    cfg = mellum2_12b.CONFIG
    d, theta = 128, 500_000.0
    low = math.floor(d * math.log(8192 / (2 * math.pi * 32))
                     / (2 * math.log(theta)))
    high = math.ceil(d * math.log(8192 / (2 * math.pi))
                     / (2 * math.log(theta)))
    assert (low, high) == (18, 35)
    plain = theta ** (-np.arange(0, d, 2) / d)
    ramp = np.clip((np.arange(d // 2) - low) / (high - low), 0, 1)
    want = plain / 16 * ramp + plain * (1 - ramp)
    got = common.yarn_frequencies(d, theta, 16.0, 8192, 32.0, 1.0)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=2e-6)
    assert torch.equal(got[:18], common.rope_frequencies(d, theta)[:18])
    bench = ARCH.yarn_inv_freq(d, theta, ARCH.sizes(json.loads(
        (ROOT / "bench_port/configs/mellum2-12b-a2.5b.json").read_text())
    )["yarn"])
    torch.testing.assert_close(got, bench, rtol=1e-6, atol=0)
    # cos and sin scaled by the attention factor, 0.1 ln 16 + 1
    assert cfg.yarn_attention_factor == pytest.approx(0.1 * math.log(16) + 1)
    pos = torch.arange(0, 9000, 7)[None, :]
    cos, sin = common.rope_angles(pos, d, theta, yarn=cfg)
    torch.testing.assert_close(cos.square() + sin.square(),
                               torch.full_like(cos, 1.2772588722239782 ** 2),
                               rtol=1e-5, atol=0)


def test_rope_for_gives_a_table_per_kind(mellum):
    pos = torch.arange(20)[None, :]
    rope = transformer.rope_for(mellum.cfg, pos)
    assert set(rope) == {FULL, SLIDING}
    plain = common.rope_angles(pos, 32, 500_000.0)
    assert all(torch.equal(a, b) for a, b in zip(rope[SLIDING], plain))
    yarn = common.rope_angles(pos, 32, 500_000.0, yarn=mellum.cfg)
    assert all(torch.equal(a, b) for a, b in zip(rope[FULL], yarn))
    assert transformer.layer_rope(mellum.cfg, rope, 3) is rope[FULL]
    assert transformer.layer_rope(mellum.cfg, rope, 0) is rope[SLIDING]


# ---------------------------------------------------------------------------
# the plain paged attention with a window
# ---------------------------------------------------------------------------


def dense_window_attention(q, kp, vp, tables, lengths, window):
    """Each query's softmax over the positions it sees, one by one."""
    B, T, H, D = q.shape
    bs, KH = kp.shape[1], kp.shape[2]
    out = np.zeros((B, T, H, D))
    for b in range(B):
        k = kp[tables[b]].reshape(-1, KH, D)
        v = vp[tables[b]].reshape(-1, KH, D)
        for t in range(T):
            p = lengths[b] - T + t
            lo = max(0, p - window + 1) if window else 0
            for h in range(H):
                kh = h // (H // KH)
                s = k[lo:p + 1, kh] @ q[b, t, h] / math.sqrt(D)
                w = np.exp(s - s.max())
                out[b, t, h] = (w / w.sum()) @ v[lo:p + 1, kh]
    return out


@pytest.mark.parametrize("T", [1, 4, 9])
@pytest.mark.parametrize("window,lengths", [
    (3, [9, 16, 17, 33]),     # shorter than every context; block edges
    (9, [9, 31, 32, 40]),     # equal to one context, across a tile edge
    (33, [12, 33, 64, 65]),   # equal to one, longer than others
    (200, [9, 20, 64, 70]),   # longer than every context
])
def test_plain_paged_attention_with_a_window(T, window, lengths):
    rng = np.random.default_rng(T * 1000 + window)
    B, H, KH, D, bs, maxb = 4, 4, 2, 16, 4, 18
    nb = B * maxb + 1
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, KH, D)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, KH, D)).astype(np.float32)
    tables = rng.permutation(nb - 1)[:B * maxb].reshape(B, maxb).astype(
        np.int32)
    lengths = np.asarray(lengths, np.int32)
    got = paged_attention_ref(*(torch.from_numpy(a) for a in
                                (q, kp, vp, tables, lengths)), window)
    want = dense_window_attention(q, kp, vp, tables, lengths, window)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_window_zero_and_a_window_past_the_table_are_todays_mask():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 3, 4, 16)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(9, 4, 2, 16)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(9, 4, 2, 16)).astype(np.float32))
    tables = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    lengths = torch.tensor([11, 16], dtype=torch.int32)
    today = paged_attention_ref(q, kp, vp, tables, lengths)
    assert torch.equal(paged_attention_ref(q, kp, vp, tables, lengths, 0),
                       today)
    assert torch.equal(paged_attention_ref(q, kp, vp, tables, lengths, 16),
                       today)
    assert not torch.allclose(
        paged_attention_ref(q, kp, vp, tables, lengths, 5), today)


class FakeLib:
    """The kernel library's entry points, recording their arguments."""

    def __init__(self):
        self.calls = []

    def paged_attention_launch(self, *a):
        self.calls.append(("paged_attention_launch", a))
        return 0

    def paged_window_attention_launch(self, *a):
        self.calls.append(("paged_window_attention_launch", a))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper's CUDA path on meta tensors: no kernel runs, the library
    records what it is asked."""
    lib = FakeLib()
    monkeypatch.setattr(pa, "_check", lambda *a: None)
    monkeypatch.setattr(pa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(pa._build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=7))
    return lib


@pytest.mark.parametrize("T", [1, 4, 512])
def test_the_wrappers_launch_and_split_plan(fake_card, T):
    """Window 0: today's entry point and arguments, split over the whole
    table.  A window: the windowed entry point, split over the span the
    window leaves, and the window passed on."""
    B, H, KH, D, bs, maxb = 64, 32, 4, 128, 8, 1024
    q = torch.empty((B, T, H, D), device="meta", dtype=torch.bfloat16)
    kp = torch.empty((4096, bs, KH, D), device="meta", dtype=torch.bfloat16)
    tables = torch.empty((B, maxb), device="meta", dtype=torch.int32)
    lengths = torch.empty((B,), device="meta", dtype=torch.int32)
    rows = T * H // KH
    n, w = pa.paged_attention.launches, pa.paged_attention.window_launches
    pa.paged_attention(q, kp, kp, tables, lengths)
    assert (pa.paged_attention.launches,
            pa.paged_attention.window_launches) == (n + 1, w)
    pa.paged_attention(q, kp, kp, tables, lengths, window=1024)
    assert (pa.paged_attention.launches,
            pa.paged_attention.window_launches) == (n + 2, w + 1)
    (name0, a0), (name1, a1) = fake_card.calls
    n0, per0 = pa.split_plan(B, KH, rows, maxb * bs, 132)
    assert name0 == "paged_attention_launch" and len(a0) == 20
    assert a0[8:17] == (B, T, H, KH, D, bs, maxb, n0, per0)
    assert a0[17:] == (D ** -0.5, 1, 7)
    span = pa.window_span(maxb * bs, T, 1024)
    assert span == 1024 + T + pa.TILE - 2 < maxb * bs
    n1, per1 = pa.split_plan(B, KH, rows, span, 132)
    assert name1 == "paged_window_attention_launch" and len(a1) == 21
    assert a1[8:17] == (B, T, H, KH, D, bs, maxb, n1, per1)
    assert a1[17:] == (D ** -0.5, 1, 1024, 7)
    assert n1 * per1 * pa.TILE >= span and n1 * per1 <= n0 * per0
    with pytest.raises(ValueError, match="window -1"):
        pa.paged_attention(q, kp, kp, tables, lengths, window=-1)


def test_a_table_shorter_than_the_window_plans_as_today(fake_card):
    q = torch.empty((4, 1, 8, 64), device="meta")
    kp = torch.empty((40, 8, 2, 64), device="meta")
    tables = torch.empty((4, 6), device="meta", dtype=torch.int32)
    lengths = torch.empty((4,), device="meta", dtype=torch.int32)
    pa.paged_attention(q, kp, kp, tables, lengths)
    pa.paged_attention(q, kp, kp, tables, lengths, window=1024)
    (_, a0), (_, a1) = fake_card.calls
    assert a0[:17] == a1[:17] and a1[19] == 1024


def test_the_decoder_of_a_reference_config_passes_no_window(monkeypatch):
    """A gqa config's layers all attend with window 0 and share one rope
    table, as before layers had kinds."""
    cfg = reduced(get_config("paper-7b")).replace(dtype="float32")
    api = registry.get_model(cfg)
    params = api.init(device="cpu", seed=1)
    seen = []
    inner = transformer.paged_attention

    def spy(q, k, v, t, lengths, window=0):
        seen.append(window)
        return inner(q, k, v, t, lengths, window)

    monkeypatch.setattr(transformer, "paged_attention", spy)
    pos = torch.arange(5)[None, :]
    rope = transformer.rope_for(cfg, pos)
    assert isinstance(rope, tuple) and all(torch.equal(a, b) for a, b in zip(
        rope, common.rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta)))
    assert transformer.layer_rope(cfg, rope, 1) is rope
    pages = transformer.init_paged_cache(cfg, 8, 4, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 5))
    transformer.decode_step_paged(cfg, params, pages, toks,
                                  torch.tensor([[0, 1], [2, 3]]),
                                  torch.zeros(2, dtype=torch.int32))
    assert seen == [0] * cfg.num_layers


# ---------------------------------------------------------------------------
# the paged decoder against the reference
# ---------------------------------------------------------------------------


def _pool(cfg, rows, width, bs=4):
    """Pages for ``rows`` sequences of ``width`` blocks each (block
    tables of disjoint, shuffled ids; the trash block last)."""
    nb = rows * width + 3
    pages = transformer.init_paged_cache(cfg, nb, bs, device="cpu")
    ids = np.random.default_rng(rows).permutation(nb)[:rows * width]
    return pages, torch.from_numpy(ids.reshape(rows, width).astype(np.int32))


def test_padded_prefill_decode_and_verify_match_the_reference(mellum):
    """Prompts shorter than the window and longer; a padded prefill, three
    T = 1 decode steps, then spec verify rows of gamma + 1 = 4."""
    cfg, params = mellum.cfg, mellum.params
    lens = [5, 13, 21]
    seqs = [tokens(n + 7, 10 + i) for i, n in enumerate(lens)]
    ref = reference(mellum, seqs)
    pages, tables = _pool(cfg, 3, 8)
    T = max(lens)
    tok = torch.zeros((3, T), dtype=torch.long)
    for i, n in enumerate(lens):
        tok[i, :n] = torch.tensor(seqs[i][:n])
    out, _ = transformer.decode_step_paged(
        cfg, params, pages, tok, tables, torch.zeros(3, dtype=torch.int32),
        torch.tensor(lens, dtype=torch.int32))
    for i, n in enumerate(lens):
        torch.testing.assert_close(out[i, :n], ref[i][:n], atol=ATOL, rtol=0)
    for step in range(3):
        start = torch.tensor([n + step for n in lens], dtype=torch.int32)
        tok = torch.tensor([[s[n + step]] for s, n in zip(seqs, lens)])
        out, _ = transformer.decode_step_paged(cfg, params, pages, tok,
                                               tables, start)
        for i, n in enumerate(lens):
            torch.testing.assert_close(out[i, 0], ref[i][n + step],
                                       atol=ATOL, rtol=0)
    start = torch.tensor([n + 3 for n in lens], dtype=torch.int32)
    tok = torch.tensor([s[n + 3:n + 7] for s, n in zip(seqs, lens)])
    out, _ = transformer.decode_step_paged(cfg, params, pages, tok, tables,
                                           start)
    for i, n in enumerate(lens):
        torch.testing.assert_close(out[i], ref[i][n + 3:n + 7], atol=ATOL,
                                   rtol=0)


def test_packed_chunks_across_the_window_edge_match_the_reference(mellum):
    """Chunked prefill in packed calls: each call's rows are chunks whose
    queries straddle the window's edge beside T = 1 decode rows; logits
    come at each row's last position."""
    cfg, params = mellum.cfg, mellum.params
    seqs = [tokens(30, 20 + i) for i in range(4)]
    ref = reference(mellum, seqs)
    pages, tables = _pool(cfg, 4, 8)
    done = [0, 0, 0, 0]
    # (row, count) per call; a row's chunk starts where it stopped
    calls = [[(0, 6), (1, 3), (2, 1)],
             [(0, 12), (1, 9), (2, 9), (3, 2)],     # 6..17 crosses W = 8
             [(3, 14), (0, 1), (1, 1), (2, 1)],     # 2..15 crosses, decode
             [(1, 7), (3, 7), (0, 1), (2, 1)]]      # two runs of 7, two of 1
    for rows in calls:
        idx = [r for r, _ in rows]
        toks = torch.tensor([t for r, n in rows
                             for t in seqs[r][done[r]:done[r] + n]])[:, None]
        start = torch.tensor([done[r] for r, _ in rows], dtype=torch.int32)
        valid = torch.tensor([n for _, n in rows], dtype=torch.int32)
        out, _ = transformer.decode_step_paged(cfg, params, pages, toks,
                                               tables[idx], start, valid)
        assert out.shape == (len(rows), 1, cfg.vocab_size)
        for j, (r, n) in enumerate(rows):
            done[r] += n
            torch.testing.assert_close(out[j, 0], ref[r][done[r] - 1],
                                       atol=ATOL, rtol=0)


def test_full_sequence_and_dense_cache_paths_match_the_reference(mellum):
    """``forward`` (the plain windowed attention on the CPU), and
    ``prefill`` into a dense cache then ``decode_step`` of T = 1 and 3."""
    cfg, params = mellum.cfg, mellum.params
    seqs = [tokens(24, 31), tokens(24, 32)]
    ref = torch.stack(reference(mellum, seqs))
    toks = torch.tensor(seqs)
    h = transformer.forward(cfg, params, {"tokens": toks})
    torch.testing.assert_close(transformer.unembed(cfg, params, h), ref,
                               atol=ATOL, rtol=0)
    lg, cache = transformer.prefill(cfg, params, {"tokens": toks[:, :17]},
                                    32)
    torch.testing.assert_close(lg[:, 0], ref[:, 16], atol=ATOL, rtol=0)
    lg, cache = transformer.decode_step(cfg, params, cache, toks[:, 17:18])
    torch.testing.assert_close(lg[:, 0], ref[:, 17], atol=ATOL, rtol=0)
    lg, cache = transformer.decode_step(cfg, params, cache, toks[:, 18:21])
    torch.testing.assert_close(lg, ref[:, 18:21], atol=ATOL, rtol=0)


def test_the_flash_path_refuses_a_window_off_the_cpu():
    q = torch.empty((1, 8, 4, 32), device="meta")
    with pytest.raises(NotImplementedError, match="no windowed flash"):
        common.blockwise_attention(q, q, q, causal=True, window=4)


# ---------------------------------------------------------------------------
# the backend's counters, the architecture module's counts and refusals
# ---------------------------------------------------------------------------


def test_the_backend_counts_what_the_window_cuts(mellum):
    """Every target call's ``backend.pack`` span carries the K / V
    positions one full and one sliding layer read over the call's real
    rows, equal to what the rows the model received give."""
    from bench_port.lib import serve
    from repro_torch.serving.observability import TraceRecorder
    from repro_torch.serving.request import Request
    dcfg = mellum2_12b.DRAFT.replace(num_layers=1, d_model=32, num_heads=2,
                                     num_kv_heads=1, d_ff=64, vocab_size=256,
                                     dtype="float32")
    params = (mellum.params, registry.get_model(dcfg).init(device="cpu",
                                                           seed=3))
    log = serve.CallLog()
    log.on = True
    engine = serve.build_engine(
        mellum.cfg, dcfg, dict(max_batch=4, block_size=4, chunk_tokens=16,
                               num_blocks=256, prefix_caching=True,
                               memory_manager=False, policy="nightjar",
                               gamma_max=3),
        params, device="cpu", wrap=log.wrap)
    engine.attach_trace(TraceRecorder(clock=time.perf_counter))
    reqs = [Request(i, 0.0, n, 6, prompt_tokens=tokens(n, 40 + i))
            for i, n in enumerate((5, 19, 37, 11))]
    engine.run(reqs, max_steps=500)
    packs = [e["args"] for e in engine.trace.events
             if e.get("name") == "backend.pack"
             and e["args"].get("model") in ("target", "spec")]
    calls = [rows for cfg, rows in log.rows() if cfg == mellum.cfg]
    assert len(packs) == len(calls) > 5
    for a, rows in zip(packs, calls):
        assert a["kv_read_full"] == sum(s + n for s, n in rows)
        assert a["kv_read_window"] == sum(min(s + n, n + WINDOW - 1)
                                          for s, n in rows)
    assert sum(a["kv_read_window"] for a in packs) < sum(
        a["kv_read_full"] for a in packs)
    # the draft (no window) records none
    assert not any("kv_read_full" in e["args"] for e in engine.trace.events
                   if e.get("name") == "backend.pack"
                   and e["args"].get("model") == "draft")


@pytest.mark.parametrize("W", [1, 5, 8, 64])
def test_window_need_counts_each_query_and_position(W):
    cfg = mellum2_12b.reduced(window=W)
    rows = [(0, 1), (3, 1), (0, 12), (6, 9), (40, 4), (7, 1)]
    n_slide, f, b = ARCH.window_need(cfg, rows, 2)
    seen = sum(min(s + t + 1, W) for s, n in rows for t in range(n))
    read = sum(len({p for t in range(n)
                    for p in range(max(0, s + t - W + 1), s + t + 1)})
               for s, n in rows)
    H, KH, D = 4, 2, 32
    assert n_slide == 3
    assert f == 4.0 * H * D * seen
    assert b == 2 * D * (2 * KH * read + 2 * H * sum(n for _, n in rows))
    full, window = ARCH.attention_need(cfg, rows, 2)
    gf, gb = ARCH.GQA.paged_attention_need(rows, heads=H, kv_heads=KH,
                                           head_dim=D, elem_bytes=2)
    assert full == (1, gf, gb) and window == (n_slide, f, b)
    if W >= 44:   # past every row's context: the window cuts nothing
        assert (f, b) == (gf, gb)


def test_token_flops_cap_the_sliding_layers_at_the_window():
    s = ARCH.sizes(json.loads((ROOT / "bench_port/configs/"
                               "mellum2-12b-a2.5b.json").read_text()))
    gqa = ARCH.GQA.token_flops
    assert ARCH.token_flops(s, 1000) == gqa(s, 1000)
    per_pos = 4.0 * 32 * 128
    assert ARCH.token_flops(s, 3000) == gqa(s, 3000) - 21 * per_pos * (
        3000 - 1024)


@pytest.mark.parametrize("change,msg", [
    (lambda c: c["mlp_layer_types"].__setitem__(5, "dense"), "all sparse"),
    (lambda c: c["rope_parameters"]["full_attention"].__setitem__(
        "rope_type", "linear"), "takes yarn"),
    (lambda c: c["rope_parameters"]["sliding_attention"].__setitem__(
        "rope_type", "yarn"), "default rope"),
    (lambda c: c["rope_parameters"]["sliding_attention"].__setitem__(
        "rope_theta", 10000), "one rope theta"),
    (lambda c: c["rope_parameters"]["full_attention"].__setitem__(
        "mscale", 0.707), "takes yarn"),
    (lambda c: c.__setitem__("use_attention_sink", True), "no such"),
    (lambda c: c.__setitem__("layer_types", c["layer_types"][:-1]),
     "layer_types"),
    (lambda c: c.__setitem__("norm_topk_prob", False), "norm_topk_prob"),
])
def test_the_architecture_refuses_what_the_port_does_not_model(change, msg):
    c = json.loads((ROOT / "bench_port/configs/mellum2-12b-a2.5b.json")
                   .read_text())
    change(c)
    with pytest.raises(ValueError, match=msg):
        ARCH.sizes(c)


# ---------------------------------------------------------------------------
# the benchmark's cell on the CPU
# ---------------------------------------------------------------------------


def test_the_cell_runs_correct_and_reads_its_metrics(tmp_path):
    """The new cell through the harness at the reduced size (a few
    requests): correct against the reference, the float8 control refused,
    and the two new metrics read from the traced run (the profiler, which
    needs a card, replaced by a slice of the call log whose windowed
    launches take 1 ms and the full layers' 2 ms)."""
    import importlib.util
    from bench_port.lib import cellrun, device_trace, flops, serve
    sp = importlib.util.spec_from_file_location(
        "bench_port_tiny_conftest", ROOT / "bench_port/tests/conftest.py")
    conftest = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(conftest)
    root = conftest.tiny_root(tmp_path)
    group = bench_group()
    group["correct"] = {"number": "max_logit_gap", "limit": 0.01}
    group["draft"].update(hidden_size=32, intermediate_size=64,
                          num_hidden_layers=1, num_attention_heads=2,
                          num_key_value_heads=1, vocab_size=256,
                          torch_dtype="float32")
    group["deployment"].update(max_batch=8, chunk_tokens=32, num_blocks=512,
                               block_size=4)
    (root / "bench_port/configs/mellum2-12b-a2.5b.json").write_text(
        json.dumps(group))
    mix = root / "bench_port/traffic/code-long.json"
    t = json.loads(mix.read_text())
    t["prompt"].update(mu=3.3, min=12, max=64)
    t["output"].update(mu=2.5, min=4, max=32)
    mix.write_text(json.dumps(t))
    (root / "bench_port/cells/mellum2-code-long-steady.json").write_text(
        json.dumps({"rate_per_s": 6.0, "lead_in_s": 0.5}))

    class Slice:
        def __init__(self, start_at, call_log):
            self.log = call_log
            call_log.on = True

        def on_step(self, loop, now):
            pass

        def finish(self, loop):
            self.log.on = False

        def slice(self, loop):
            return device_trace.Slice(
                wall_s=1.0, busy_s=0.5, calls=self.log.rows(),
                kernels_by_step={s.index: 1 for s in loop.steps},
                kernel_s={"paged_window_attention_kernel<float>": 1e-3,
                          "paged_attention_kernel<float>": 2e-3})

    class Clock:
        """The loop's time moves 1 ms a reading, and over what it sleeps:
        the schedule follows the steps taken, not the machine's load."""
        t = 0.0

        def now(self):
            self.t += 1e-3
            return self.t

        def sleep(self, s):
            self.t += s

    clock = Clock()
    loop = serve.OpenLoop
    cell = spec.find_cell("mellum2-code-long-steady", root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve, "OpenLoop", lambda engine, reqs: loop(
            engine, reqs, clock=clock.now, sleep=clock.sleep))
        mp.setattr(device_trace, "Tracer", Slice)
        mp.setattr(device_trace, "warm_profiler", lambda: None)
        out = cellrun.run_cell(cell, seed=SEED, seconds=1.5, trace=True,
                               t_process=time.time(), device="cpu",
                               root=root, control=True)
    assert out.attempted == 9 and out.failed == 0
    assert out.correct and out.compared_tokens > 30
    assert out.control_correct is False
    got = spec.read_metrics(cell.per_layer, out.run, root)
    assert 0 < got["window_kv_read_share"]["value"] < 100
    need = 0.0
    for cfg, rows in out.run.trace.calls:
        if cfg.layer_types:
            n, f, b = ARCH.window_need(cfg, rows, 4)
            need += n * flops.least_time(f, b)
    assert need > 0
    assert got["window_attn_roofline"]["value"] == pytest.approx(
        100.0 * need / 1e-3, rel=1e-12)
    assert {"paged_attn_roofline", "mixed_position_yield",
            "dispatch_ms.decode"} <= set(got)


# ---------------------------------------------------------------------------
# on the card: the windowed kernel against its plain version
# ---------------------------------------------------------------------------

# (B, H, KH, D, bs, maxb, T, window): Mellum2's heads at decode, verify and
# a chunk straddling the window's edge, over tables long enough to split
# (4,096 positions) and short ones; window 1 (the query's own position),
# windows inside one tile, and a window past the table
CUDA_CASES = [(4, 32, 4, 128, 8, 512, 1, 1024),
              (4, 32, 4, 128, 8, 512, 4, 1024),
              (2, 32, 4, 128, 8, 512, 33, 1024),
              (3, 32, 4, 128, 8, 96, 17, 100),
              (3, 8, 2, 64, 4, 20, 5, 7),
              (2, 8, 1, 256, 16, 8, 3, 1),
              (2, 16, 8, 64, 8, 40, 1, 5000),
              (5, 4, 4, 32, 4, 64, 9, 31)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,D,bs,maxb,T,window", CUDA_CASES)
def test_cuda_paged_window_attention_matches_plain(B, H, KH, D, bs, maxb, T,
                                                   window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(B * 100 + T + window)
    nb = B * maxb + 2
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(nb, bs, KH, D)).astype(
        np.float32))
    vp = torch.from_numpy(rng.normal(size=(nb, bs, KH, D)).astype(
        np.float32))
    tables = torch.from_numpy(rng.integers(0, nb, size=(B, maxb)).astype(
        np.int32))
    # every row sees its own position; lengths ragged up to the table
    lengths = torch.from_numpy(np.asarray(
        [T + (977 * i + 13) % (maxb * bs - T + 1) for i in range(B)],
        np.int32))
    args = [a.to(dt).cuda() for a in (q, kp, vp)] + [tables.cuda(),
                                                     lengths.cuda()]
    n, w = pa.paged_attention.launches, pa.paged_attention.window_launches
    got = pa.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    assert (pa.paged_attention.launches,
            pa.paged_attention.window_launches) == (n + 1, w + 1)
    want = paged_attention_ref(*args, window)
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    full, _ = pa.split_plan(B, KH, T * (H // KH), maxb * bs,
                            torch.cuda.get_device_properties(0)
                            .multi_processor_count)
    assert pa.paged_attention.last_splits <= full
