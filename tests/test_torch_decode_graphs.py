"""Captured graphs of the pure-decode and spec steps
(``serving/step_graphs.py``), on the CPU with a stand-in graph class that
records the capture and re-runs the captured callable on replay.

Held: replayed tokens equal the eager ones (reduced paper-7b, granite and
Mellum2, gamma 0-3); one graph per (batch bucket, table width, gamma) and
no other key; an engine's backend captures every bucket and gamma before
serving, at one width, and then only replays; static inputs refilled every
step; the elastic pool's and the draft's moves drop the graphs, and a
stale address raises; the launch counters advance on a replay as on the
eager path; the ``backend.dispatch`` span says how the step ran; the CPU
backend builds no runner."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs import mellum2_12b  # noqa: E402
from repro_torch.core.bandits import make_policy  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import BlockManager  # noqa: E402
from repro_torch.serving.observability import TraceRecorder  # noqa: E402
from repro_torch.serving.paged_runtime import bucket_size  # noqa: E402
from repro_torch.serving.real_backend import RealBackend  # noqa: E402
from repro_torch.serving.request import Request, Sequence  # noqa: E402
from repro_torch.serving.scheduler import \
    ContinuousBatchingScheduler  # noqa: E402
from repro_torch.serving.step_graphs import StepGraphs, \
    graph_buckets  # noqa: E402
from repro_torch.serving.workload import tiny_requests  # noqa: E402


class RecordingGraph:
    """The runner's graph class on the CPU: ``capture`` runs the callable
    and keeps it with its outputs; ``replay`` runs it again into those
    outputs, as a graph refills its static outputs."""

    def __init__(self, shared):
        self.fn = self.outs = None

    @staticmethod
    def shared(device):
        return object()      # a pool token

    def capture(self, fn):
        self.fn, self.outs = fn, fn()
        return self.outs

    def replay(self):
        for out, new in zip(self.outs, self.fn()):
            out.copy_(new)


def _cfgs(arch):
    if arch == "mellum2":
        cfg = mellum2_12b.reduced()
        dcfg = mellum2_12b.DRAFT.replace(num_layers=1, d_model=32,
                                         num_heads=2, num_kv_heads=1,
                                         d_ff=64, vocab_size=256,
                                         dtype="float32")
        return cfg, dcfg
    return (configs.reduced(configs.get_config(arch)),
            configs.reduced(configs.get_draft_config(arch)))


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        cfg, dcfg = _cfgs(arch)
        _PARAMS[arch] = (registry.get_model(cfg).init(device="cpu", seed=1),
                         registry.get_model(dcfg).init(device="cpu", seed=2))
    return _PARAMS[arch]


def _backend(arch, *, graphs, self_draft=False, block_size=4, **kw):
    cfg, dcfg = _cfgs(arch)
    tp, dp = _params(arch)
    target = registry.get_model(cfg)
    draft = target if self_draft else registry.get_model(dcfg)
    be = RealBackend(target, draft, device="cpu",
                     params=(tp, tp if self_draft else dp), max_batch=8,
                     max_seq=160, block_size=block_size, **kw)
    if graphs:
        be._graphs = StepGraphs(RecordingGraph, "cpu", max_batch=8)
    return be


def _seqs(n, prompt=(5, 9, 3, 12, 7, 4, 10, 6), seed=0):
    rng = np.random.default_rng(seed)
    return [Sequence(Request(i, 0.0, p, 64,
                             prompt_tokens=rng.integers(0, 256, p).tolist()))
            for i, p in zip(range(n), prompt)]


def _serve(be, seqs, gammas):
    """Prefill ``seqs``, then one step per gamma; each step's committed
    counts."""
    be.prefill(seqs, with_draft=True)
    return [be.step(seqs, g).n_committed for g in gammas]


PAIRS = [("paper-7b", False), ("granite-moe-1b-a400m", False),
         ("mellum2", False), ("paper-7b", True)]


@pytest.mark.parametrize("gamma", [0, 1, 2, 3])
@pytest.mark.parametrize("arch,self_draft", PAIRS)
def test_replayed_steps_emit_the_eager_tokens(arch, self_draft, gamma):
    """A capture and replays at ``gamma`` (then at another gamma) commit
    the eager backend's tokens; the self-drafting pair accepts, so its
    contexts move by several tokens a step."""
    gammas = [gamma, gamma, gamma, gamma, (gamma + 1) % 4, gamma]
    runs = {}
    for graphs in (False, True):
        be = _backend(arch, graphs=graphs, self_draft=self_draft)
        seqs = _seqs(3)
        commits = _serve(be, seqs, gammas)
        runs[graphs] = (commits, {s.req_id: be.output_tokens(s.req_id)
                                  for s in seqs})
        if graphs:
            g = be._graphs
            # a key's first step captures (and replays), later ones
            # replay
            assert g.captures >= 2 and g.replays == len(gammas)
    assert runs[True] == runs[False]
    if self_draft and gamma:
        assert max(max(c) for c in runs[True][0]) > 1


def _modes(be, steps):
    """Each step's (mode, graph key), from the runner's capture and replay
    counts and the key whose inputs it loaded."""
    g, out, keys = be._graphs, [], []
    load = g.load
    g.load = lambda key, arrays: (keys.append(key), load(key, arrays))[1]
    for seqs, gamma in steps:
        before = (g.captures, g.replays, len(keys))
        be.step(seqs, gamma)
        mode = ("capture" if g.captures > before[0] else
                "replay" if g.replays > before[1] else "eager")
        out.append((mode, keys[-1] if len(keys) > before[2] else None))
    del g.load
    return out


def test_one_graph_per_bucket_width_and_gamma():
    """A key's first step captures and later ones replay; steps of 3 and
    4 sequences (bucket 4) at one width share a graph, a batch of 5
    (bucket 8, the largest of a backend of 8 rows) and another gamma make
    their own, and a table grown past the graph's width captures a wider
    one."""
    be = _backend("paper-7b", graphs=True, block_size=16)
    seqs = _seqs(5, prompt=(3, 4, 2, 5, 3))
    be.prefill(seqs, with_draft=True)
    g = be._graphs
    got = _modes(be, [(seqs[:b], gamma) for b, gamma in (
        (3, 0), (3, 0), (4, 0), (3, 0), (5, 0), (5, 0), (3, 2), (4, 2))])
    assert got == [("capture", (4, 1, 0)), ("replay", (4, 1, 0)),
                   ("replay", (4, 1, 0)), ("replay", (4, 1, 0)),
                   ("capture", (8, 1, 0)), ("replay", (8, 1, 0)),
                   ("capture", (4, 1, 2)), ("replay", (4, 1, 2))]
    assert list(g.entries) == [(4, 1, 0), (8, 1, 0), (4, 1, 2)]
    # grow one sequence's table past one block
    modes = []
    while be.tkv.batch_tables(seqs[:3], 4)[0].shape[1] == 1:
        modes += _modes(be, [(seqs[:3], 3)])
    modes += _modes(be, [(seqs[:3], 3)] * 3)
    assert [m for m in modes if m[0] == "capture"] == [
        ("capture", (4, 1, 3)), ("capture", (4, 2, 3))]
    assert modes[0] == ("capture", (4, 1, 3))
    assert modes[-3:] == [("replay", (4, 2, 3))] * 3
    assert len(g.entries) == 5


@pytest.mark.parametrize("arch", ["paper-7b", "mellum2"])
def test_a_narrower_table_replays_a_wider_graph(arch):
    """A step whose tables are narrower than the runner's width replays
    the graph of its bucket and gamma at that width, with its rows padded
    by the write-off block, and commits the eager backend's tokens (which
    run a smaller bucket: two rows, where the graph runs four)."""
    runs = {}
    for graphs in (False, True):
        be = _backend(arch, graphs=graphs)
        seqs = _seqs(4, prompt=(26, 3, 5, 4))
        be.prefill(seqs, with_draft=True)
        wide, narrow = seqs[:2], seqs[2:]
        width = be.tkv.batch_tables(wide, 2)[0].shape[1]
        assert width > be.tkv.batch_tables(narrow, 2)[0].shape[1]
        if graphs:
            be._graphs.width = width
        out = [be.step(b, gamma).n_committed for b, gamma in (
            (wide, 1), (wide, 1), (narrow, 1), (narrow, 1), (wide, 1))]
        runs[graphs] = (out, [be.output_tokens(s.req_id) for s in seqs])
        if graphs:
            assert be._graphs.captures == 1 and be._graphs.replays == 5
            [(Bb, w, gamma)] = be._graphs.entries
            assert w > be.tkv.batch_tables(narrow, 2)[0].shape[1]
    assert runs[True] == runs[False]


def test_static_inputs_are_refilled_every_step():
    be = _backend("granite-moe-1b-a400m", graphs=True)
    seqs = _seqs(2)
    be.prefill(seqs, with_draft=True)
    for i in range(5):
        lengths = [be.tkv.ctx[s.req_id] for s in seqs]
        last = [be.last_token[s.req_id] for s in seqs]
        replays = be._graphs.replays
        be.step(seqs, 1)
        assert be._graphs.replays == replays + 1
        # the tables as the step's reservation left them, in the first
        # two of the bucket's four rows; the rest is the write-off block
        tables = be.tkv.batch_tables(seqs, 2)[0]
        [entry] = be._graphs.entries.values()
        t, n, x, pos = (a.numpy() for a in entry.inputs)
        w = tables.shape[1]
        assert t.shape[0] == 4
        np.testing.assert_array_equal(t[:2, :w], tables)
        assert (t[:2, w:] == be.tkv.trash).all()
        assert (t[2:] == be.tkv.trash).all() and (n[2:] == 0).all()
        np.testing.assert_array_equal(n[:2], lengths)
        np.testing.assert_array_equal(x[:2], last)
        # the draft chain's starts: N and N + 1
        np.testing.assert_array_equal(pos[:, :2],
                                      [lengths, np.add(lengths, 1)])


def _captured(be, seqs):
    """A runner with a gamma = 0 and a gamma = 2 graph."""
    be.prefill(seqs, with_draft=True)
    for gamma in (0, 0, 2, 2):
        be.step(seqs, gamma)
    return sorted(k[2] for k in be._graphs.entries)


@pytest.mark.parametrize("move,kept", [("offload", [0]), ("reload", [0]),
                                       ("grow", []), ("shrink", [])])
def test_moving_tensors_drop_the_graphs(move, kept):
    be = _backend("paper-7b", graphs=True)
    seqs = _seqs(2)
    assert _captured(be, seqs) == [0, 2]
    pool = be._graphs.shared
    if move == "offload":
        be.offload_draft()
    elif move == "reload":
        be.dparams_host = be.dparams
        be.reload_draft()
    elif move == "grow":
        be.bm.expand(8)
        be.grow_pools(8)
    else:
        be.shrink_pools(be.tkv.num_blocks)
    assert sorted(k[2] for k in be._graphs.entries) == kept
    # a pool no graph holds any longer is not captured into again
    assert (be._graphs.shared is pool) == bool(kept)
    if move == "reload":
        out = be.step(seqs, 2)           # captured again over the reload
        assert out.n_committed == [1, 1]


@pytest.mark.parametrize("which", ["tkv", "dkv", "tparams"])
def test_a_stale_address_raises(which):
    be = _backend("paper-7b", graphs=True)
    seqs = _seqs(2)
    _captured(be, seqs)
    if which == "tparams":
        be.tparams = dict(be.tparams, embed=be.tparams["embed"].clone())
    else:
        kv = getattr(be, which)
        kv.pages = {k: v.clone() for k, v in kv.pages.items()}
    with pytest.raises(RuntimeError, match="moved"):
        be.step(seqs, 2)


@pytest.mark.parametrize("arch", ["paper-7b", "mellum2"])
def test_launch_counters_advance_on_replay_as_eager(arch, monkeypatch):
    """With a shim that counts as the card's wrapper does, every step
    adds the same launches, windowed launches and last split count in
    both backends: the eager ones, a capture and replays."""
    inner = transformer.paged_attention

    def counting(q, k, v, tables, lengths, window=0):
        paged_attention.launches += 1
        paged_attention.window_launches += bool(window)
        paged_attention.last_splits = tables.shape[1]
        return inner(q, k, v, tables, lengths, window)

    monkeypatch.setattr(transformer, "paged_attention", counting)
    for a in ("launches", "window_launches", "last_splits"):
        monkeypatch.setattr(paged_attention, a, 0)
    seen = {}
    for graphs in (False, True):
        be = _backend(arch, graphs=graphs)
        seqs = _seqs(3)
        be.prefill(seqs, with_draft=True)
        steps = []
        for gamma in (0, 3, 3, 0, 3, 0, 1):
            before = (paged_attention.launches,
                      paged_attention.window_launches)
            be.step(seqs, gamma)
            steps.append((paged_attention.launches - before[0],
                          paged_attention.window_launches - before[1],
                          paged_attention.last_splits))
        seen[graphs] = steps
        if graphs:
            assert be._graphs.replays >= 2
    assert seen[True] == seen[False]
    assert all(n > 0 for n, _, _ in seen[True])
    assert any(w > 0 for _, w, _ in seen[True]) == (arch == "mellum2")


def test_the_dispatch_span_says_how_the_step_ran():
    be = _backend("paper-7b", graphs=True)
    t = [0.0]

    def clock():
        t[0] += 1e-3
        return t[0]

    rec = TraceRecorder(clock=clock)
    be.spans = rec
    seqs = _seqs(2)
    rec.open("step")
    be.prefill(seqs, with_draft=True)
    for gamma in (1, 1, 1, 0):
        be.step(seqs, gamma)
    rec.close()
    def args(name):
        return [e["args"] for e in rec.events if e.get("name") == name]
    # prefill: the target's and the draft's calls; then the steps
    assert [a.get("graph") for a in args("backend.dispatch")] == \
        ["eager"] * 2 + ["capture", "replay", "replay", "capture"]
    # a step's pack span also lists each real row's context, from which a
    # reader counts what its replayed kernels read
    prompts = [s.request.prompt_len for s in seqs]
    assert [a.get("starts") for a in args("backend.pack")] == \
        [None, None] + [[p + k for p in prompts] for k in range(4)]


@pytest.mark.parametrize("kw", [{}, {"sampling": "rejection"}])
def test_the_cpu_backend_builds_no_runner(kw):
    be = _backend("paper-7b", graphs=False, **kw)
    assert be._graphs is None
    seqs = _seqs(2)
    assert len(_serve(be, seqs, [0, 2])) == 2


@pytest.mark.parametrize("max_batch,buckets", [
    (1, (1,)), (2, (1, 2)), (4, (1, 4)), (8, (1, 4, 8)), (32, (1, 4, 16, 32)),
    (64, (1, 4, 16, 64)), (100, (1, 4, 16, 64, 128))])
def test_graphs_are_made_at_powers_of_four_and_the_largest_bucket(
        max_batch, buckets):
    """A step pads its batch up to the next captured bucket: recording a
    graph costs every kernel, not every row."""
    assert graph_buckets(max_batch) == buckets
    g = StepGraphs(RecordingGraph, "cpu", max_batch=max_batch, width=8)
    assert g.buckets == buckets
    for n in range(1, max_batch + 1):
        assert g.bucket(n) == min(b for b in buckets if b >= n)
        assert g.key(n, 2, 1) == (g.bucket(n), 8, 1)
        assert g.key(n, 16, 0) == (g.bucket(n), 16, 0)


@pytest.fixture
def counting(monkeypatch):
    """``paged_attention``'s counters, advanced by a shim on the CPU path
    as the card's wrapper advances them."""
    inner = transformer.paged_attention

    def shim(q, k, v, tables, lengths, window=0):
        paged_attention.launches += 1
        paged_attention.window_launches += bool(window)
        paged_attention.last_splits = tables.shape[1]
        return inner(q, k, v, tables, lengths, window)

    monkeypatch.setattr(transformer, "paged_attention", shim)
    for a in ("launches", "window_launches", "last_splits"):
        monkeypatch.setattr(paged_attention, a, 0)
    return paged_attention


def _engine(arch, graphs, *, max_batch=4, num_blocks=96):
    """An engine over a ``max_batch`` x ``num_blocks``-block backend of
    ``arch``; with ``graphs`` its runner is the CPU stand-in at the
    backend's own width, set before the engine is built (which is when
    the backend captures its steps)."""
    cfg, dcfg = _cfgs(arch)
    tp, dp = _params(arch)
    bm = BlockManager(num_blocks, 4)
    be = RealBackend(registry.get_model(cfg), registry.get_model(dcfg),
                     device="cpu", params=(tp, dp), max_batch=max_batch,
                     block_manager=bm)
    if graphs:
        be._graphs = StepGraphs(RecordingGraph, "cpu", max_batch=max_batch,
                                width=be.graph_width())
    eng = ServingEngine(be, ContinuousBatchingScheduler(bm,
                                                        max_batch=max_batch),
                        make_policy("nightjar", 3, seed=0), None,
                        gamma_max=3)
    return eng, be


@pytest.mark.parametrize("arch", ["paper-7b", "granite-moe-1b-a400m",
                                  "mellum2"])
def test_an_engine_captures_every_step_before_serving(arch, counting):
    """Building the engine captures one graph per batch bucket (1 and 4
    for ``max_batch`` 4) and gamma up to ``gamma_max``, at the backend's
    width (a
    full batch's share of the pool: 96 blocks / 4 -> 32), without adding
    to the launch counters; serving then replays them alone, and its
    streams equal the eager engine's (the planner, which reads measured
    step times, may choose other gammas, so the steps may differ)."""
    streams = {}
    for graphs in (False, True):
        counting.launches = counting.window_launches = 0
        eng, be = _engine(arch, graphs)
        if graphs:
            g = be._graphs
            assert be.graph_width() == 32
            assert sorted(g.entries) == [(Bb, 32, gamma) for Bb in (1, 4)
                                         for gamma in range(4)]
            assert g.captures == 8 and g.replays == 0
        assert counting.launches == 0
        reqs = tiny_requests(6, rate_qps=50.0, prompt_len=10, output_len=12,
                             vocab=be.target.cfg.vocab_size, seed=3)
        gammas, step = [], be.step
        be.step = lambda seqs, gamma: (gammas.append(gamma),
                                       step(seqs, gamma))[1]
        eng.run(reqs, max_steps=2000)
        streams[graphs] = {r.req_id: be.output_tokens(r.req_id)
                           for r in reqs}
        assert counting.launches > 0
        if graphs:
            assert g.captures == 8 and g.replays == len(gammas)
            assert max(gammas) > 0
    assert streams[True] == streams[False]
    assert all(len(s) >= 12 for s in streams[True].values())


def test_an_offloaded_draft_captures_plain_decode_alone():
    be = _backend("paper-7b", graphs=False)
    be._graphs = StepGraphs(RecordingGraph, "cpu", max_batch=8,
                            width=be.graph_width())
    be.offload_draft()
    be.capture_steps(3)
    W = be.graph_width()
    assert sorted(be._graphs.entries) == [(Bb, W, 0) for Bb in (1, 4, 8)]


@pytest.mark.parametrize("max_batch,num_blocks,width", [
    (4, 96, 32), (8, 96, 16), (8, 100, 16), (64, 24576, 512),
    (64, 71680, 2048)])
def test_the_graph_width_is_a_full_batchs_share_of_the_pool(
        max_batch, num_blocks, width):
    """A power of two at least the pool's blocks over ``max_batch``: the
    chat cells' deployment (24,576 blocks, 64 rows: 3,072-token contexts)
    gives 512 blocks of 8, Mellum2's (71,680: 8,960 tokens) 2,048."""
    bm = BlockManager(num_blocks, 8)
    cfg, dcfg = _cfgs("paper-7b")
    tp, dp = _params("paper-7b")
    be = RealBackend(registry.get_model(cfg), registry.get_model(dcfg),
                     device="cpu", params=(tp, dp), max_batch=max_batch,
                     block_manager=bm)
    assert be.graph_width() == width == bucket_size(
        -(-num_blocks // max_batch))


def test_a_step_wider_than_the_graphs_captures_its_own_width():
    """A step whose tables fit the runner's width captures at that width;
    one whose tables are wider captures at its own width, which later
    steps of its bucket and gamma replay, and narrower ones still replay
    the narrower graph."""
    be = _backend("paper-7b", graphs=False, block_size=4)
    be._graphs = StepGraphs(RecordingGraph, "cpu", max_batch=8, width=4)
    seqs = _seqs(3, prompt=(5, 9, 22))
    be.prefill(seqs, with_draft=True)
    narrow, wide = seqs[:2], [seqs[0], seqs[2]]
    got = _modes(be, [(narrow, 1)] * 2)
    assert got == [("capture", (4, 4, 1)), ("replay", (4, 4, 1))]
    assert be.tkv.batch_tables(wide, 2)[0].shape[1] == 8
    got = _modes(be, [(wide, 1)] * 2 + [(narrow, 1)])
    assert got == [("capture", (4, 8, 1)), ("replay", (4, 8, 1)),
                   ("replay", (4, 4, 1))]


class _Scripted:
    """gamma 0 while three or more sequences run (speculation off, so the
    memory manager may offload the draft), 2 below."""
    name = "scripted"

    def select(self, batch, *, delta_max=0):
        return 0 if batch >= 3 else 2

    def observe(self, *args, **kw):
        pass


def test_spec_steps_after_a_reload_replay_recaptured_graphs():
    """The elastic memory manager's cycle (24 blocks of 4, four requests,
    then two more once they drained): offload and grow, contract, shrink
    and reload.  The streams equal an eager engine's; the spec steps after
    the reload capture their keys over the reloaded draft, then replay
    them."""
    from repro_torch.serving.memory_manager import ElasticMemoryManager
    streams, seen = {}, []
    for graphs in (False, True):
        cfg, dcfg = _cfgs("paper-7b")
        tp, dp = _params("paper-7b")
        bm = BlockManager(24, 4)
        be = RealBackend(registry.get_model(cfg), registry.get_model(dcfg),
                         device="cpu", params=(tp, dict(dp)), max_batch=4,
                         block_manager=bm)
        if graphs:
            be._graphs = g = StepGraphs(RecordingGraph, "cpu", max_batch=4,
                                        width=be.graph_width())
            reload, step = be.reload_draft, be.step

            def reload_draft():
                reload()
                seen.append("reload")

            def counted(seqs, gamma):
                before = (g.captures, g.replays)
                out = step(seqs, gamma)
                if seen and gamma:
                    seen.append("capture" if g.captures > before[0] else
                                "replay" if g.replays > before[1] else
                                "eager")
                return out
            be.reload_draft, be.step = reload_draft, counted
        mm = ElasticMemoryManager(
            bm, draft_blocks=4, t_persist=1, tau_low_frac=0.4,
            offload_fn=be.offload_draft, reload_fn=be.reload_draft,
            migrate_fn=be.migrate_pools, grow_fn=be.grow_pools,
            shrink_fn=be.shrink_pools)
        eng = ServingEngine(be, ContinuousBatchingScheduler(
            bm, max_batch=4, watermark_frac=0.0), _Scripted(), mm,
            gamma_max=3)
        reqs = tiny_requests(4, rate_qps=1e6, prompt_len=10, output_len=12,
                             vocab=cfg.vocab_size, seed=5)
        later = tiny_requests(2, rate_qps=1e6, prompt_len=10, output_len=12,
                              vocab=cfg.vocab_size, seed=6)
        for r in later:
            r.req_id += len(reqs)
            r.arrival += 1e4
        m = eng.run(reqs + later, max_steps=3000)
        streams[graphs] = {r.req_id: be.output_tokens(r.req_id)
                           for r in reqs + later}
        assert m.offload_events >= 1 and m.reload_events >= 1
    assert streams[True] == streams[False]
    assert seen[0] == "reload" and seen.count("reload") == 1
    assert seen[1] == "capture" and "replay" in seen[2:]
    assert "eager" not in seen
