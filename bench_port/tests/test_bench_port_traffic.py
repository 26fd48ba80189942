"""The general open-loop generator: it repeats from a seed, offers every
seed the same work, draws what the port's sharegpt preset draws, and
reads rate phases, shared prefixes and sessions from a traffic file; the
warm-up takes its shapes from the same draw."""
import json

import numpy as np
import pytest

from conftest import ROOT
from bench_port.lib import traffic

CHAT = json.loads((ROOT / "bench_port" / "traffic" / "chat.json").read_text())


def _key(reqs):
    return [(r.req_id, r.arrival, r.prompt.tolist(), r.output_len,
             r.in_window) for r in reqs]


def test_same_seed_same_requests():
    a = traffic.generate(CHAT, rate=3.0, lead_in_s=5.0, seconds=20.0,
                         seed=2**33 + 7, vocab=1000)
    b = traffic.generate(CHAT, rate=3.0, lead_in_s=5.0, seconds=20.0,
                         seed=2**33 + 7, vocab=1000)
    assert _key(a) == _key(b)


def test_every_seed_offers_the_same_schedule_with_other_ids():
    a = traffic.generate(CHAT, rate=3.0, lead_in_s=5.0, seconds=20.0,
                         seed=1, vocab=1000)
    b = traffic.generate(CHAT, rate=3.0, lead_in_s=5.0, seconds=20.0,
                         seed=2, vocab=1000)
    sched = [[(r.arrival, len(r.prompt), r.output_len, r.in_window)
              for r in x] for x in (a, b)]
    assert sched[0] == sched[1]
    assert all(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b)
               if len(x.prompt) > 4)
    assert sum(r.in_window for r in a) == 60       # round(3.0 * 20)
    assert sum(not r.in_window for r in a) == 15   # round(3.0 * 5)


def test_arrivals_fill_their_spans_in_order():
    reqs = traffic.generate(CHAT, rate=2.0, lead_in_s=4.0, seconds=10.0,
                            seed=5, vocab=50)
    t = [r.arrival for r in reqs]
    assert t == sorted(t) and t[0] == 0.0
    lead = [r.arrival for r in reqs if not r.in_window]
    win = [r.arrival for r in reqs if r.in_window]
    assert max(lead) < 4.0 and min(win) == 4.0 and max(win) < 14.0
    assert all(0 <= int(x) < 50 for r in reqs for x in r.prompt)


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 11])
def test_draw_matches_the_ports_sharegpt_draw(seed):
    from repro_torch.serving.workload import DATASETS, poisson_requests
    d = DATASETS["sharegpt"]
    assert (CHAT["prompt"]["mu"], CHAT["prompt"]["sigma"]) == \
        (d["p_mu"], d["p_sigma"])
    assert (CHAT["output"]["mu"], CHAT["output"]["sigma"]) == \
        (d["o_mu"], d["o_sigma"])
    port = poisson_requests(4.0, 200, dataset="sharegpt", seed=seed)
    gaps, prompts, outputs = traffic.draw(CHAT, 4.0, 200, seed)
    assert np.allclose(np.cumsum(gaps), [r.arrival for r in port])
    assert prompts.tolist() == [r.prompt_len for r in port]
    assert outputs.tolist() == [r.output_len for r in port]


def test_phases_scale_the_rate_piece_by_piece():
    mix = dict(CHAT, phases=[{"seconds": 10, "rate_scale": 0.5},
                             {"seconds": 10, "rate_scale": 2.0}])
    reqs = traffic.generate(mix, rate=2.0, lead_in_s=5.0, seconds=30.0,
                            seed=9, vocab=100)
    t = np.array([r.arrival for r in reqs])
    # pieces: [0,5) x0.5 (lead-in), [5,10) x0.5, [10,20) x2, [20,30) x0.5,
    # [30,35) x2
    counts = [int(((t >= a) & (t < b)).sum())
              for a, b in ((0, 5), (5, 10), (10, 20), (20, 30), (30, 35))]
    assert counts == [5, 5, 40, 10, 20]
    again = traffic.generate(mix, rate=2.0, lead_in_s=5.0, seconds=30.0,
                             seed=10, vocab=100)
    assert [(r.arrival, len(r.prompt), r.output_len) for r in reqs] == \
        [(r.arrival, len(r.prompt), r.output_len) for r in again]


def test_shared_prefixes_start_every_prompt():
    mix = dict(CHAT, prefix={"count": 3, "length": 40})
    reqs = traffic.generate(mix, rate=2.0, lead_in_s=0.0, seconds=6.0,
                            seed=4, vocab=1000)
    plain = traffic.generate(CHAT, rate=2.0, lead_in_s=0.0, seconds=6.0,
                             seed=4, vocab=1000)
    heads = {tuple(r.prompt[:40]) for r in reqs}
    assert len(heads) == 3
    assert [len(r.prompt) - 40 for r in reqs] == [len(r.prompt) for r in plain]
    assert all(np.array_equal(reqs[i].prompt[:40], reqs[i + 3].prompt[:40])
               for i in range(len(reqs) - 3))


def test_sessions_grow_each_turn_from_the_last():
    mix = dict(CHAT, sessions={"turns": 3, "gap_s": 4.0})
    reqs = traffic.generate(mix, rate=1.0, lead_in_s=0.0, seconds=6.0,
                            seed=2, vocab=1000)
    firsts = traffic.generate(CHAT, rate=1.0, lead_in_s=0.0, seconds=6.0,
                              seed=2, vocab=1000)
    assert len(firsts) == 6
    # every turn due before the end is sent: turn 1 of sessions opened
    # before 2.0, turn 2 of none (it would fall 8 s after the start)
    assert len(reqs) == 6 + sum(r.arrival < 2.0 for r in firsts)
    assert [r.arrival for r in reqs] == sorted(r.arrival for r in reqs)
    by_start = {round(r.arrival, 9): r for r in reqs}
    for f in firsts:
        if f.arrival < 2.0:
            nxt = by_start[round(f.arrival + 4.0, 9)]
            head = by_start[round(f.arrival, 9)]
            assert np.array_equal(nxt.prompt[:len(head.prompt)],
                                  head.prompt)
            assert len(nxt.prompt) > len(head.prompt) + head.output_len


def test_the_warm_up_takes_the_draws_first_shapes():
    reqs = traffic.generate(CHAT, rate=0.68, lead_in_s=10.0, seconds=51.0,
                            seed=5, vocab=1000)
    warm = traffic.warmup(CHAT, rate=0.68, lead_in_s=10.0, seconds=51.0,
                          seed=5 + 2**40, vocab=1000, count=8, output_len=8)
    assert [len(w.prompt) for w in warm] == [len(r.prompt) for r in reqs[:8]]
    assert [w.output_len for w in warm] == [min(r.output_len, 8)
                                            for r in reqs[:8]]
    assert all(w.arrival == 0.0 and not w.in_window for w in warm)
    assert not any(np.array_equal(w.prompt, r.prompt)
                   for w, r in zip(warm, reqs))
