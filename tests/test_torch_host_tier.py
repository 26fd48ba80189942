"""The host KV tier on the real tier, the port against the JAX package: the
prefix cache spills the blocks it evicts to a ``HostKVStore`` and a later
prompt that matches them restores them (``RealBackend.apply_host_transfers``).
The reduced fp32 paper-7b pair on bridged weights, through
``tests/test_torch_engine.py``'s recipe."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import _bridged, _run  # noqa: E402

# 16 blocks of 4 under four 12-token prompts of 8 output tokens each, then
# the same four prompts again: the prefix cache evicts (and spills) the
# first wave's prompt blocks, and the second wave restores them
HOST = dict(blocks=16, block_size=4, chunk=8, prefix_caching=True,
            prompt=12, out=8, wave2=4, repeat=True)


def test_host_tier_spills_restores_and_matches_jax():
    """With a host KV tier both packages spill and restore the same blocks
    (equal ``m.host`` counters, timings aside); the streams equal the JAX
    run's and a run without the tier; every restored page holds the bits
    its spill captured."""
    want, jm, jbe = _run("jax", policy="nightjar", host_store=64, **HOST)
    params = _bridged(jbe)
    sealed, restored = {}, []

    def watch(be, mm):
        hs, bm = be.bm.host_store, be.bm
        seal, drain = hs.seal, bm.drain_pending_restores
        restore = be.dkv.restore_blocks     # the second pool restored
        pending = []

        def seal_copy(h):
            sealed[h] = {k: np.array(v) for k, v in hs.records[h].data.items()}
            return seal(h)

        def drain_restores():
            pending[:] = drain()
            return list(pending)

        def restore_blocks(ids, payloads):
            restore(ids, payloads)
            for h, b in pending:
                for m, rt in (("t", be.tkv), ("d", be.dkv)):
                    for key, arr in rt.pages.items():
                        np.testing.assert_array_equal(
                            arr[:, b].numpy(), sealed[h][f"{m}:{key}"])
                restored.append(h)
        hs.seal, bm.drain_pending_restores = seal_copy, drain_restores
        be.dkv.restore_blocks = restore_blocks

    got, m, _ = _run("torch", policy="nightjar", params=params,
                     host_store=64, watch=watch, **HOST)
    plain, _, _ = _run("torch", policy="nightjar", params=params, **HOST)
    assert got == want == plain
    assert len(m.requests) == 8
    counters = {k: v for k, v in m.host.items() if not k.endswith("_s")}
    assert counters == {k: v for k, v in jm.host.items()
                        if not k.endswith("_s")}
    assert counters["spilled_blocks"] > 0 and counters["restores"] > 0
    assert len(restored) == counters["restores"]
    assert m.prefix["restored_blocks"] == jm.prefix["restored_blocks"]
