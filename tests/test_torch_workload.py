"""The port's request generators against the reference's: every generator of
``serving/workload.py``, across seeds, gives the same requests field for
field (prompt token lists included), with the same Python and numpy
scalar types, so the simulated tier sees the same bits in both
packages."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.serving import workload as jw  # noqa: E402
from repro_torch.serving import workload as tw  # noqa: E402


def _same(got, want):
    """Field for field, types included (repr shows numpy scalar types)."""
    assert len(got) == len(want) > 0
    assert repr([dataclasses.asdict(r) for r in got]) \
        == repr([dataclasses.asdict(r) for r in want])


def _trace_fields(tr):
    return tr.times.tolist(), tr.rates.tolist(), tr.times.dtype.str


GENERATORS = {
    "poisson": lambda w, s: w.poisson_requests(
        12.0, 60, dataset="sharegpt", seed=s),
    "poisson_alpaca_slo": lambda w, s: w.poisson_requests(
        30.0, 40, dataset="alpaca", seed=s, slo=0.25),
    "dynamic_rate": lambda w, s: w.dynamic_rate_trace(
        60.0, seed=s).sample_requests(50, dataset="mixed", seed=s + 1),
    "bursty": lambda w, s: w.bursty_trace(seed=s).sample_requests(
        80, dataset="alpaca", seed=s + 1),
    "surge_trace": lambda w, s: w.surge_requests(
        70, trace=w.surge_trace(seed=s), seed=s + 1),
    "surge_rate": lambda w, s: w.surge_requests(40, rate_qps=9.0, seed=s),
    "templated": lambda w, s: w.templated_requests(
        20.0, 30, num_templates=4, seed=s),
    "mixed": lambda w, s: w.mixed_requests(15.0, 50, seed=s),
    "mixed_qa": lambda w, s: w.mixed_requests(15.0, 50, qa_frac=0.6,
                                              seed=s, slo=2.0),
    "sessions": lambda w, s: w.session_requests(6, rate_qps=0.5, seed=s),
    "tiny": lambda w, s: w.tiny_requests(8, template_len=4, seed=s),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_matches_reference(name, seed):
    _same(GENERATORS[name](tw, seed), GENERATORS[name](jw, seed))


@pytest.mark.parametrize("seed", [0, 3])
def test_traces_and_storm_match_reference(seed):
    for make in (lambda w: w.dynamic_rate_trace(90.0, seed=seed),
                 lambda w: w.bursty_trace(seed=seed),
                 lambda w: w.surge_trace(seed=seed)):
        assert _trace_fields(make(tw)) == _trace_fields(make(jw))
    reqs = jw.surge_requests(60, rate_qps=6.0, seed=seed)
    got = tw.cancellation_storm(
        tw.surge_requests(60, rate_qps=6.0, seed=seed), frac=0.3,
        start=1.0, end=6.0, seed=seed)
    want = jw.cancellation_storm(reqs, frac=0.3, start=1.0, end=6.0,
                                 seed=seed)
    assert got and repr(got) == repr(want)


def test_split_datasets_and_slo_match_reference():
    reqs = jw.poisson_requests(10, 23, seed=2)
    for n in (1, 3, 4):
        assert [[r.req_id for r in s] for s in tw.split_requests(reqs, n)] \
            == [[r.req_id for r in s] for s in jw.split_requests(reqs, n)]
    with pytest.raises(ValueError):
        tw.split_requests(reqs, 0)
    assert tw.DATASETS == jw.DATASETS
    assert tw.SURGE_CLASSES == jw.SURGE_CLASSES
    for d in sorted(jw.DATASETS):
        for slo in (None, 0.0, 0.7):
            assert tw.dataset_slo(d, slo) == jw.dataset_slo(d, slo)
