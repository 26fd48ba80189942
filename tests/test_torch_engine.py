"""The port's serving stack against the JAX package's: the block manager's
hashing and bookkeeping, and whole engine runs (RealBackend on bridged fp32
weights, reduced paper-7b pair) that must emit the same greedy streams."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.bandits import make_policy as jmake_policy  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.memory_manager import ElasticMemoryManager as JMM  # noqa: E402
from repro.serving.real_backend import RealBackend as JBackend  # noqa: E402
from repro.serving.scheduler import ContinuousBatchingScheduler as JSched  # noqa: E402
from repro.serving.workload import tiny_requests as jtiny  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.bandits import make_policy  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serving import kv_cache  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.memory_manager import ElasticMemoryManager  # noqa: E402
from repro_torch.serving.real_backend import RealBackend  # noqa: E402
from repro_torch.serving.scheduler import ContinuousBatchingScheduler  # noqa: E402
from repro_torch.serving.workload import tiny_requests  # noqa: E402


# ---------------------------------------------------------------------------
# hashing and block bookkeeping
# ---------------------------------------------------------------------------


def test_chain_hash_and_checksums_equal_reference():
    root = kv_cache.CHAIN_ROOT
    assert root == jkv.CHAIN_ROOT
    assert kv_cache.chain_hash(root, [0]) == 0x36594F3778015CEB
    assert kv_cache.chain_hash(root, [1, 2, 3, 4]) == 0x9987D60CD5DA12D5
    rng = np.random.default_rng(0)
    for n in (1, 4, 16):
        toks = rng.integers(0, 152064, size=n).tolist()
        parent = int(rng.integers(0, 2**63))
        assert kv_cache.chain_hash(parent, toks) == jkv.chain_hash(parent,
                                                                   toks)
        data = {"t:k_pages": rng.normal(size=(2, 4, 1, 8)).astype(np.float32),
                "t:v_pages": rng.normal(size=(2, 4, 1, 8)).astype(np.float32)}
        assert (kv_cache.record_checksum(parent, toks, data)
                == jkv.record_checksum(parent, toks, data))


def _random_ops(mod, seed):
    """A seeded random sequence of block-manager operations (allocation,
    growth, prefix sharing and forks, release, elastic expand/contract);
    returns the final state and every invariant check's outcome."""
    rng = np.random.default_rng(seed)
    bm = mod.BlockManager(16, 4, prefix_caching=True)
    template = rng.integers(0, 50, size=8).tolist()
    live, prompts, next_id, checks = {}, {}, 0, []
    for _ in range(120):
        kind = int(rng.integers(0, 6))
        arg = int(rng.integers(1, 31))
        try:
            if kind == 0:                                  # admit
                toks = template[:int(rng.integers(0, 9))] + rng.integers(
                    0, 50, size=arg % 12 + 1).tolist()
                blocks, matched = bm.match_prefix(toks)
                cached = min(matched, len(toks) - 1)
                next_id += 1
                try:
                    if blocks:
                        bm.share(next_id, blocks, cached)
                        bm.fork_for_write(next_id, cached, len(toks))
                        bm.grow_to(next_id, len(toks))
                    else:
                        bm.allocate(next_id, len(toks))
                except mod.OutOfBlocks:
                    bm.release(next_id)                # roll back, as admission
                    raise
                live[next_id], prompts[next_id] = len(toks), toks
            elif kind == 1 and live:                       # decode commits
                sid = int(rng.choice(list(live)))
                end = bm.lengths[sid] + arg % 4 + 1
                bm.fork_for_write(sid, bm.lengths[sid], end)
                bm.append_tokens(sid, end - bm.lengths[sid])
            elif kind == 2 and live:                       # publish prefix
                sid = int(rng.choice(list(live)))
                bm.register_prefix(sid, prompts[sid], len(prompts[sid]))
            elif kind == 3 and live:                       # finish
                sid = int(rng.choice(list(live)))
                bm.release(sid)
                del live[sid]
            elif kind == 4 and bm.total_blocks == bm.base_blocks:
                bm.expand(4)
            elif kind == 5 and bm.total_blocks != bm.base_blocks:
                plan = bm.plan_contraction()
                if plan is not None:
                    bm.commit_contraction(plan)
        except (mod.OutOfBlocks, mod.SharedBlockWrite) as e:
            checks.append(type(e).__name__)
        bm.drain_pending_copies()
        try:
            bm.check_invariants()
            checks.append("ok")
        except AssertionError as e:
            checks.append(f"fail: {e}")
    state = (bm.tables, bm.lengths, bm.free, bm.refcount,
             list(bm.cached), bm.hash_index, bm.stats, bm.total_blocks)
    return state, checks


@pytest.mark.parametrize("seed", range(6))
def test_block_manager_random_ops_match_reference(seed):
    got, got_checks = _random_ops(kv_cache, seed)
    want, want_checks = _random_ops(jkv, seed)
    assert got == want
    assert got_checks == want_checks


# ---------------------------------------------------------------------------
# whole engine runs through both packages
# ---------------------------------------------------------------------------


def _cfgs():
    return tuple(c.reduced(get("paper-7b")).replace(dtype="float32")
                 for c, get in ((jconfigs, jconfigs.get_config),
                                (jconfigs, jconfigs.get_draft_config),
                                (configs, configs.get_config),
                                (configs, configs.get_draft_config)))


def _run(pkg, *, policy, params=None, blocks=256, block_size=8, chunk=None,
         prefix_caching=False, template=0, memmgr=False, prompt=10, out=8,
         wave2=0, repeat=False, host_store=None, watch=None):
    """The reference's engine recipe (tests/test_paged_backend.py) through
    one package; returns streams, metrics and the backend.  ``policy`` is a
    name or a policy object; ``wave2`` more requests arrive once the first
    four have drained, with the first wave's prompts in turn if ``repeat``;
    ``host_store`` is the capacity in blocks of a host KV tier;
    ``watch(backend, memory_manager)`` runs before the engine does."""
    jt, jd, tt, td = _cfgs()
    if pkg == "jax":
        target, draft = jregistry.get_model(jt), jregistry.get_model(jd)
        bm = jkv.BlockManager(blocks, block_size,
                              prefix_caching=prefix_caching,
                              host_store=jkv.HostKVStore(host_store)
                              if host_store else None)
        be = JBackend(target, draft, max_batch=4, max_seq=96, seed=0,
                      block_manager=bm)
        mk = (JSched, JMM, JEngine, jmake_policy, jtiny)
    else:
        target, draft = registry.get_model(tt), registry.get_model(td)
        bm = kv_cache.BlockManager(blocks, block_size,
                                   prefix_caching=prefix_caching,
                                   host_store=kv_cache.HostKVStore(
                                       host_store) if host_store else None)
        be = RealBackend(target, draft, device="cpu", params=params,
                         max_batch=4, max_seq=96, seed=0, block_manager=bm)
        mk = (ContinuousBatchingScheduler, ElasticMemoryManager,
              ServingEngine, make_policy, tiny_requests)
    sched_cls, mm_cls, eng_cls, mkpol, tiny = mk
    sched = sched_cls(bm, max_batch=4, chunk_tokens=chunk,
                      watermark_frac=0.0)
    mm = None
    if memmgr:
        mm = mm_cls(bm, draft_blocks=4, t_persist=1, tau_low_frac=0.4,
                    offload_fn=be.offload_draft, reload_fn=be.reload_draft,
                    migrate_fn=be.migrate_pools, grow_fn=be.grow_pools,
                    shrink_fn=be.shrink_pools)
    pol = mkpol(policy, 3, seed=0) if isinstance(policy, str) else policy
    eng = eng_cls(be, sched, pol, mm, gamma_max=3)
    reqs = tiny(4, rate_qps=1e6, prompt_len=prompt, output_len=out,
                vocab=target.cfg.vocab_size, seed=5, template_len=template)
    later = tiny(wave2, rate_qps=1e6, prompt_len=prompt, output_len=out,
                 vocab=target.cfg.vocab_size, seed=6) if wave2 else []
    for i, r in enumerate(later):
        r.req_id += len(reqs)
        r.arrival += 1e4      # long after the first wave has drained
        if repeat:
            r.prompt_tokens = list(reqs[i % len(reqs)].prompt_tokens)
    reqs += later
    if watch is not None:
        watch(be, mm)
    m = eng.run(reqs, max_steps=3000)
    streams = {r.req_id: be.output_tokens(r.req_id)[:out + 1] for r in reqs}
    return streams, m, be


def _bridged(jbe):
    _, _, tt, td = _cfgs()
    # a run that ends with the draft offloaded holds it on the host
    dparams = jbe.dparams if jbe.dparams is not None else jbe.dparams_host
    return (params_from_numpy(tt, jax.tree.map(np.asarray, jbe.tparams),
                              device="cpu"),
            params_from_numpy(td, jax.tree.map(np.asarray, dparams),
                              device="cpu"))


@pytest.mark.parametrize("scenario", ["plain", "prefix", "memmgr"])
def test_engine_streams_match_jax(scenario):
    """Greedy streams equal the JAX RealBackend's for AR, fixed-gamma and
    Nightjar scheduling; with prefix caching on (the fully-cached-prompt
    path forks blocks through the migration kernel's plain version); and
    with the elastic memory manager offloading the draft on a 24-block
    pool."""
    kw = {"plain": {},
          "prefix": dict(chunk=8, prompt=16, template=16,
                         prefix_caching=True),
          "memmgr": dict(blocks=24, block_size=4, out=12, memmgr=True)}[
        scenario]
    want, jm, jbe = _run("jax", policy="nightjar", **kw)
    params = _bridged(jbe)
    for pol in (("ar", "fixed-2", "nightjar") if scenario == "plain"
                else ("nightjar",)):
        got, m, _ = _run("torch", policy=pol, params=params, **kw)
        assert got == want, pol
        assert all(len(s) == len(want[0]) for s in got.values())
    if scenario == "prefix":
        assert m.prefix["forks"] > 0 and jm.prefix["forks"] > 0
    if scenario == "memmgr":
        assert m.offload_events >= 1


def test_target_as_draft_accepts_and_equals_ar():
    """With the target as its own draft the greedy stream commits accepted
    draft tokens (the path where verify rows t > 0 are committed) and still
    equals the AR stream; the same run as chip_smoke.py's lossless phase."""
    from repro_torch.launch.serve import build_real_engine
    cfg = configs.reduced(configs.get_config("paper-7b")).replace(
        dtype="float32")
    tp = registry.get_model(cfg).init(device="cpu", seed=1)
    out, acc = {}, {}
    for policy in ("nightjar", "ar"):
        eng = build_real_engine(cfg, cfg, device="cpu", policy=policy,
                                prefix_caching=True, chunk_tokens=16,
                                seed=0, params=(tp, tp))
        reqs = tiny_requests(4, prompt_len=16, output_len=16,
                             template_len=8, vocab=cfg.vocab_size, seed=0)
        m = eng.run(reqs, max_steps=3000, record_timeline=True)
        out[policy] = {r.req_id: eng.backend.output_tokens(r.req_id)[:17]
                       for r in reqs}
        acc[policy] = sum(g["accepted"] for gam, g in
                          m.spec.get("per_gamma", {}).items() if gam > 0)
    assert acc["nightjar"] > 0
    assert out["nightjar"] == out["ar"]



# ---------------------------------------------------------------------------
# the elastic pool's whole cycle: offload, expand, contraction, shrink, reload
# ---------------------------------------------------------------------------


class _Scripted:
    """gamma 0 while three or more sequences run (speculation off, so the
    memory manager may offload the draft), 2 below: the same choices in
    both packages, where the planner's follow measured latencies."""
    name = "scripted"

    def select(self, batch, *, delta_max=0):
        return 0 if batch >= 3 else 2

    def observe(self, *args, **kw):
        pass


# 24 blocks of 4 under four requests of 10 + 12 tokens: the draft goes, the
# pool grows to 28, and the last sequences to run hold blocks above the
# boundary; the second wave, admitted with the queue empty, then takes some
# of those blocks, so the contraction has to move them
CYCLE = dict(policy=_Scripted(), blocks=24, block_size=4, out=12,
             memmgr=True, wave2=2)
PAGE_KEYS = [f"{m}:{k}" for m in "td" for k in ("k_pages", "v_pages")]


def _pages(be):
    """Copies of the backend's four page tensors as float32 numpy arrays."""
    return {f"{m}:{k}": np.array(getattr(be, f"{m}kv").pages[k], np.float32)
            for m in "td" for k in ("k_pages", "v_pages")}


def _watch_cycle(rec, feed=None):
    """Hooks around the memory manager's migrate and shrink: record the
    plan, the pages before the moves and after the trim, and the live
    tables; with ``feed``, load those page bits into the backend before it
    migrates (the same input for both packages' moves)."""
    def watch(be, mm):
        rec["mm"] = mm
        migrate, shrink = mm.migrate_fn, mm.shrink_fn

        def migrate_fn(plan):
            rec["plan"] = (list(plan.src), list(plan.dst))
            rec["before"] = _pages(be)
            if feed is not None:
                for key in PAGE_KEYS:
                    m, k = key.split(":")
                    getattr(be, f"{m}kv").pages[k].copy_(
                        torch.from_numpy(feed[key]))
            return migrate(plan)

        def shrink_fn(n):
            shrink(n)
            rec["after"] = _pages(be)
            rec["live"] = sorted({b for t in mm.bm.tables.values()
                                  for b in t})
        mm.migrate_fn, mm.shrink_fn = migrate_fn, shrink_fn
    return watch


def test_contraction_cycle_matches_jax():
    """The memory manager completes offload -> expand -> contraction (with
    blocks to move) -> shrink -> reload in both packages: the same plan, the
    same greedy streams, and, from the JAX run's page bits before the moves,
    the port's four page tensors after the trim equal the JAX backend's
    bitwise on every block a live table references."""
    jrec, rec = {}, {}
    want, jm, jbe = _run("jax", watch=_watch_cycle(jrec), **CYCLE)
    got, m, _ = _run("torch", params=_bridged(jbe),
                     watch=_watch_cycle(rec, feed=jrec["before"]), **CYCLE)
    assert got == want
    kinds = [e.kind for e in rec["mm"].events]
    assert kinds[:4] == ["offload", "expand", "contract", "reload"], kinds
    moved = [e.detail["migrated_blocks"] for e in rec["mm"].events
             if e.kind == "contract"]
    jmoved = [e.detail["migrated_blocks"] for e in jrec["mm"].events
              if e.kind == "contract"]
    assert moved == jmoved and moved[0] >= 1, (moved, jmoved)
    assert rec["plan"] == jrec["plan"] and rec["live"] == jrec["live"]
    assert m.reload_events >= 1 and jm.reload_events >= 1
    live = rec["live"]
    src, dst = rec["plan"]
    for key in PAGE_KEYS:
        # the port's own pages before the moves agree with the JAX run's
        np.testing.assert_allclose(rec["before"][key][:, live],
                                   jrec["before"][key][:, live], atol=1e-4)
        np.testing.assert_array_equal(rec["after"][key][:, live],
                                      jrec["after"][key][:, live])
        # and each moved block carries its source's bits
        np.testing.assert_array_equal(rec["after"][key][:, dst],
                                      jrec["before"][key][:, src])


def test_backend_migrates_once_per_copy_set(monkeypatch):
    """Every CoW copy set and every contraction is one migrate_blocks call
    over the four page tensors (one kernel launch on the card)."""
    from repro_torch.kernels.block_migration import migrate_blocks
    from repro_torch.serving import paged_runtime
    calls, sets = [], []

    def recording(pools, src, dst):
        calls.append((len(pools), len(src)))
        return migrate_blocks(pools, src, dst)

    drain = kv_cache.BlockManager.drain_pending_copies

    def counted(self):
        out = drain(self)
        if out:
            sets.append(len(out))
        return out

    monkeypatch.setattr(paged_runtime, "migrate_blocks", recording)
    monkeypatch.setattr(kv_cache.BlockManager, "drain_pending_copies",
                        counted)
    _, m, _ = _run("torch", policy="nightjar", chunk=8, prompt=16,
                   template=16, prefix_caching=True)
    assert m.prefix["forks"] > 0 and sets
    rec = {}
    _run("torch", watch=_watch_cycle(rec), **CYCLE)
    sets.append(len(rec["plan"][0]))
    assert sorted(calls) == sorted((4, n) for n in sets)
