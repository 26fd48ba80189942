"""The reference's engine-level unit suites, case by case, on the port's
copies of the block manager, host KV tier, scheduler, planner and metrics.

Each suite's source is read from ``tests/``, its ``repro`` imports are bound
to ``repro_torch`` and it runs as a module of its own, so every case keeps
the reference's assertions word for word; a case is named
``<suite>__<name without test_>`` and its traceback points at the
reference's lines.  Parametrised cases stay parametrised.

Four cases name what the port has no counterpart for, and are rewritten
here against the port's API:
  * ``test_kv_cache.py::test_migration_preserves_logical_contents`` and
    ``test_host_offload.py::test_randomized_spill_restore_soak`` reach the
    reference's ``PhysicalKVPool``.  The port keeps its pages in
    ``PagedKVRuntime`` (grow, shrink, ``apply_copies``) and drains the host
    tier through ``RealBackend.apply_host_transfers``; each rewritten case
    drives the port and the reference's pool with the same seeded
    operations and holds their pages equal byte for byte.
  * ``test_verify_properties.py``'s two properties draw from a JAX key; the
    port's ``verify_rejection`` takes a ``torch.Generator``.
"""
import ast
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

from _pytest.assertion.rewrite import rewrite_asserts  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.verify import verify_rejection  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import kv_cache  # noqa: E402
from repro_torch.serving.paged_runtime import (  # noqa: E402
    PagedKVRuntime, apply_copies)
from repro_torch.serving.real_backend import RealBackend  # noqa: E402

TESTS = Path(__file__).resolve().parent
SUITES = ("test_kv_cache", "test_prefix_cache", "test_host_offload",
          "test_chunked_prefill", "test_scheduler", "test_planner",
          "test_metrics_edges", "test_kv_cache_properties",
          "test_verify_properties")
# cases rewritten below; the rest of each suite is bound from its source
REWRITTEN = {
    "test_kv_cache": {"test_migration_preserves_logical_contents"},
    "test_host_offload": {"test_randomized_spill_restore_soak"},
    "test_verify_properties": {"test_first_position_distribution_preserved",
                               "test_committed_structure_invariants"},
}
# source edits that drop what only the rewritten cases use (each must match
# exactly once, so a change to a reference suite fails here, loudly)
EDITS = {
    "test_kv_cache": [
        ("import jax.numpy as jnp\n", ""),
        ("OutOfBlocks,\n                                    PhysicalKVPool)",
         "OutOfBlocks)")],
    "test_host_offload": [("PhysicalKVPool, chain_hash", "chain_hash")],
}


def _test_names(suite):
    tree = ast.parse((TESTS / f"{suite}.py").read_text())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]


def _bind(suite):
    """The reference suite ``suite`` as a module whose ``repro`` imports
    resolve to ``repro_torch``, with pytest's assertion rewriting."""
    path = TESTS / f"{suite}.py"
    src = path.read_text()
    for old, new in EDITS.get(suite, ()):
        assert src.count(old) == 1, (suite, old)
        src = src.replace(old, new)
    src = re.sub(r"^(\s*)(from|import) repro\b", r"\1\2 repro_torch", src,
                 flags=re.M)
    tree = ast.parse(src, str(path))
    rewrite_asserts(tree, src.encode(), str(path))
    mod = types.ModuleType(f"port_{suite}")
    mod.__file__ = str(path)
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


BOUND = {s: _bind(s) for s in SUITES if s != "test_verify_properties"}
for _suite, _mod in BOUND.items():
    for _name in _test_names(_suite):
        if _name not in REWRITTEN.get(_suite, ()):
            globals()[f"{_suite}__{_name[5:]}"] = getattr(_mod, _name)


def test_every_reference_case_runs_on_the_port():
    """Each test function of the nine suites has its case here (83), and
    what the bound suites reach of the serving stack is the port's."""
    names = [f"{s}__{n[5:]}" for s in SUITES for n in _test_names(s)]
    assert len(names) == 83
    assert all(callable(globals().get(n)) for n in names), \
        [n for n in names if n not in globals()]
    for suite, mod in BOUND.items():
        for name, obj in vars(mod).items():
            home = getattr(obj, "__name__" if isinstance(obj, types.ModuleType)
                           else "__module__", "") or ""
            assert not home.split(".")[0] == "repro", (suite, name, home)


# ---------------------------------------------------------------------------
# PhysicalKVPool cases on PagedKVRuntime, held to the reference's pool
# ---------------------------------------------------------------------------


def _api(L, KH, HD):
    """A paged model of the pool geometry; the pages are all that is used."""
    cfg = configs.reduced(configs.get_config("paper-7b")).replace(
        num_layers=L, num_heads=KH, num_kv_heads=KH, head_dim=HD,
        dtype="float32")
    return registry.get_model(cfg)


def _write_tokens(rt, k, v, table, start):
    """PhysicalKVPool.write_tokens on the port's pages: (L, T, KH, hd)."""
    bs = rt.block_size
    for t in range(k.shape[1]):
        pos = start + t
        blk, off = table[pos // bs], pos % bs
        rt.pages["k_pages"][:, blk, off] = torch.from_numpy(
            np.ascontiguousarray(k[:, t]))
        rt.pages["v_pages"][:, blk, off] = torch.from_numpy(
            np.ascontiguousarray(v[:, t]))


def _gather(rt, table, length):
    idx = torch.as_tensor(list(table))
    return tuple(rt.pages[key][:, idx].reshape(
        rt.pages[key].shape[0], -1, *rt.pages[key].shape[3:])[:, :length]
        .numpy() for key in ("k_pages", "v_pages"))


def _assert_pages_equal(rt, pool, nb):
    """The port's pages (trash block aside) equal the reference pool's."""
    np.testing.assert_array_equal(rt.pages["k_pages"][:, :nb].numpy(),
                                  np.asarray(pool.k))
    np.testing.assert_array_equal(rt.pages["v_pages"][:, :nb].numpy(),
                                  np.asarray(pool.v))


def test_kv_cache__migration_preserves_logical_contents():
    """I4: expansion -> writes into high blocks -> contraction + kernel
    migration leaves every sequence's gathered KV bit-identical; the port's
    pages equal the reference pool's after the same operations."""
    import jax.numpy as jnp
    from repro.serving import kv_cache as jkv
    rng = np.random.default_rng(0)
    L, bs, kh, hd = 2, 4, 2, 8
    bm = kv_cache.BlockManager(6, block_size=bs)
    rt = PagedKVRuntime(_api(L, kh, hd), bm, device="cpu")
    jbm = jkv.BlockManager(6, block_size=bs)
    pool = jkv.PhysicalKVPool(L, 6, bs, kh, hd, dtype=jnp.float32)

    for m in (bm, jbm):
        m.allocate(1, 20)          # 5 blocks
        m.expand(4)
        m.allocate(2, 12)          # 3 blocks: 1 low + high blocks
    rt.grow(4)
    pool.grow(4)
    assert bm.tables == jbm.tables

    for sid, n in ((1, 20), (2, 12)):
        vals = rng.normal(size=(L, n, kh, hd)).astype(np.float32)
        _write_tokens(rt, vals, 2 * vals, bm.tables[sid], 0)
        pool.write_tokens(jnp.asarray(vals), jnp.asarray(2 * vals),
                          jbm.tables[sid], 0)
    _assert_pages_equal(rt, pool, bm.total_blocks)

    before = {sid: _gather(rt, bm.tables[sid], bm.lengths[sid])
              for sid in (1, 2)}
    bm.release(1)               # free low blocks so contraction has room
    jbm.release(1)
    plan = bm.plan_contraction()
    jplan = jbm.plan_contraction()
    assert plan is not None and len(plan) > 0
    assert (list(plan.src), list(plan.dst)) == (list(jplan.src),
                                                list(jplan.dst))
    apply_copies((rt,), plan.src, plan.dst)   # the migration kernel's call
    pool.migrate(jplan, use_kernel=False)
    bm.commit_contraction(plan)
    jbm.commit_contraction(jplan)
    rt.shrink(bm.base_blocks)
    pool.shrink(jbm.base_blocks)
    bm.check_invariants()

    k_after, v_after = _gather(rt, bm.tables[2], bm.lengths[2])
    np.testing.assert_array_equal(before[2][0], k_after)
    np.testing.assert_array_equal(before[2][1], v_after)
    assert all(b < bm.boundary for b in bm.tables[2])
    _assert_pages_equal(rt, pool, bm.base_blocks)


def test_host_offload__randomized_spill_restore_soak():
    """The reference's 140-step spill / restore / contraction soak, run in
    lockstep on the port (``BlockManager`` + ``HostKVStore``, the pages in a
    ``RealBackend``'s two runtimes, transfers drained by
    ``apply_host_transfers``, the contraction by ``migrate_pools`` and
    ``shrink_pools``) and on the reference (its pool and ``_flush``): the
    reference's checks on the port, and the port's target and draft pages
    equal to the reference pool byte for byte at every check."""
    import test_host_offload as ref
    from repro.serving import kv_cache as jkv
    rng = np.random.default_rng(42)
    nb = 24
    hs = kv_cache.HostKVStore(96)
    bm = kv_cache.BlockManager(nb, ref.BS, prefix_caching=True, host_store=hs)
    api = _api(ref.L, ref.KH, ref.HD)      # the reference soak's geometry
    be = RealBackend(api, api, device="cpu", params=({}, {}),
                     block_manager=bm)
    jbm = jkv.BlockManager(nb, ref.BS, prefix_caching=True,
                           host_store=jkv.HostKVStore(96))
    pool = jkv.PhysicalKVPool(ref.L, nb, ref.BS, ref.KH, ref.HD,
                              dtype=np.float32)
    prompts, live, next_seq = [], {}, 0

    def flush():
        be.apply_host_transfers()
        ref._flush(jbm, pool)

    def admit(tokens):
        nonlocal next_seq
        sid = next_seq
        next_seq += 1
        cached = ref._admit(bm, sid, tokens)
        assert ref._admit(jbm, sid, tokens) == cached
        # drain BEFORE writing, exactly like the engine step
        flush()
        if cached < len(tokens):
            k, v = ref._block_payload(tokens[cached:])
            for rt in (be.tkv, be.dkv):
                _write_tokens(rt, k, v, bm.tables[sid], cached)
            ref._write_range(pool, jbm.tables[sid], tokens, cached)
        live[sid] = tokens

    def check_bytes():
        assert not bm.pending_restores
        for b, (_, toks) in bm.block_chain.items():
            ek, ev = ref._block_payload(toks)
            for rt in (be.tkv, be.dkv):
                np.testing.assert_array_equal(
                    rt.pages["k_pages"][:, b].numpy(), ek)
                np.testing.assert_array_equal(
                    rt.pages["v_pages"][:, b].numpy(), ev)
        for rt in (be.tkv, be.dkv):
            _assert_pages_equal(rt, pool, bm.total_blocks)

    for step in range(140):
        op = rng.choice(["admit", "release", "flush", "contract_cycle"],
                        p=[0.45, 0.25, 0.2, 0.1])
        if op == "admit":
            if prompts and rng.uniform() < 0.6:
                base = prompts[int(rng.integers(len(prompts)))]
                tokens = base + ref._prompt(rng, int(rng.integers(1, 3)))
            else:
                tokens = ref._prompt(rng, int(rng.integers(1, 4)))
            need = bm.blocks_needed(len(tokens))
            assert jbm.num_allocatable == bm.num_allocatable
            if need > bm.num_allocatable:
                continue
            admit(tokens)
            if len(prompts) < 40:
                prompts.append(tokens)
        elif op == "release" and live:
            sid = list(live)[int(rng.integers(len(live)))]
            bm.release(sid)
            jbm.release(sid)
            del live[sid]
        elif op == "flush":
            flush()
        elif op == "contract_cycle":
            flush()
            bm.expand(8)
            jbm.expand(8)
            be.grow_pools(8)
            pool.grow(8)
            # park some load in the expanded region, then shrink back
            if bm.num_allocatable >= 2:
                admit(ref._prompt(rng, 2))
            plan = bm.plan_contraction()
            jplan = jbm.plan_contraction()
            assert (plan is None) == (jplan is None)
            if plan is not None:
                assert list(plan.src) == list(jplan.src)
                assert list(plan.dst) == list(jplan.dst)
                be.migrate_pools(plan)     # captures plan-time spills first
                ref._flush(jbm, pool)
                pool.migrate(jplan, use_kernel=False)
                bm.commit_contraction(plan)
                jbm.commit_contraction(jplan)
                be.shrink_pools(bm.total_blocks)
                pool.shrink(jbm.total_blocks)
        bm.check_invariants()
        ref._assert_no_leaks(bm)
        assert bm.tables == jbm.tables and bm.free == jbm.free
        if step % 10 == 0:
            flush()
            check_bytes()

    flush()
    bm.check_invariants()
    ref._assert_no_leaks(bm)
    check_bytes()
    # the soak actually exercised the tier both ways, in both packages
    assert hs.stats["spills"] > 0 and hs.stats["restores"] > 0
    # the same counters (the reference's _flush counts no spilled_blocks)
    want = {k: v for k, v in jbm.host_store.stats.items()
            if not k.endswith("_s") and k != "spilled_blocks"}
    assert {k: hs.stats[k] for k in want} == want


# ---------------------------------------------------------------------------
# test_verify_properties.py on the port's generator
# ---------------------------------------------------------------------------


def _dist(rng, V, temp):
    x = rng.normal(size=V) * temp
    e = np.exp(x - x.max())
    return e / e.sum()


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), vocab=st.integers(2, 6),
       temp=st.floats(0.3, 3.0))
def test_verify_properties__first_position_distribution_preserved(
        seed, vocab, temp):
    """Empirical distribution of the first committed token ~= target p."""
    rng = np.random.default_rng(seed)
    p = _dist(rng, vocab, temp)
    q = _dist(rng, vocab, temp * 2)

    N = 20_000
    g = 1
    gen = torch.Generator().manual_seed(seed)
    qt = torch.from_numpy(q)
    draft_tokens = torch.multinomial(qt, N, replacement=True,
                                     generator=gen)[:, None]
    draft_probs = qt.expand(N, g, vocab)
    target_probs = torch.from_numpy(p).expand(N, g + 1, vocab)

    res = verify_rejection(gen, draft_tokens, draft_probs, target_probs)
    first = res["tokens"][:, 0].numpy()
    emp = np.bincount(first, minlength=vocab) / N
    assert np.max(np.abs(emp - p)) < 0.02, (emp, p)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000), vocab=st.integers(2, 8),
       g=st.integers(1, 4))
def test_verify_properties__committed_structure_invariants(seed, vocab, g):
    """n_accepted in [0, g]; committed = accepted prefix + 1 sampled token;
    padding is -1 beyond n_accepted+1."""
    rng = np.random.default_rng(seed)
    B = 16
    gen = torch.Generator().manual_seed(seed)
    draft_tokens = torch.from_numpy(rng.integers(0, vocab, size=(B, g)))
    dp = rng.dirichlet(np.ones(vocab), size=(B, g))
    tp = rng.dirichlet(np.ones(vocab), size=(B, g + 1))
    res = verify_rejection(gen, draft_tokens, torch.from_numpy(dp),
                           torch.from_numpy(tp))
    n = res["n_accepted"].numpy()
    toks = res["tokens"].numpy()
    assert ((0 <= n) & (n <= g)).all()
    for b in range(B):
        assert (toks[b, :n[b]] == draft_tokens.numpy()[b, :n[b]]).all()
        assert toks[b, n[b]] >= 0
        assert (toks[b, n[b] + 1:] == -1).all()
        assert toks[b, n[b]] == int(res["next_token"][b])
