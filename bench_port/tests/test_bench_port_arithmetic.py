"""The metrics' arithmetic against hand counts on synthetic timestamps and
shapes: tails, TPOT, tokens per second, queue wait, the paged-attention
roofline's bytes and flops, and step_mfu."""
import math

import pytest

from conftest import ROOT
from bench_port.lib import device_trace, flops, spec, stats
from bench_port.lib.serve import ReqRecord, Run, StepRecord

SIZES = {"layers": 2, "d_model": 8, "heads": 2, "kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "vocab": 10, "experts": 0, "top_k": 0,
         "rope_theta": 1e4, "tied": True}


def _run(requests, steps=(), trace=None):
    return Run(seconds=10.0, window_open=5.0, window_close=15.0,
               end=20.0, setup_s=7.5, requests={r.req_id: r for r in requests},
               steps=list(steps), target_sizes=SIZES, trace=trace)


def _rec(i, due, times, *, out=None, window=True, admitted=-1.0,
         prompt=3):
    return ReqRecord(i, due, prompt, out or len(times), window,
                     admitted=admitted, token_times=list(times))


def test_p95_is_linear_between_order_statistics():
    xs = list(range(1, 21))           # 1..20
    # inclusive method: position 0.95 * 19 = 18.05 -> 19 + 0.05
    assert stats.p95(xs) == pytest.approx(19.05)
    assert stats.p95([4.0]) == 4.0 and stats.p95([]) is None


def test_tokens_per_second_counts_only_the_window():
    r1 = _rec(1, 4.0, [4.5, 5.0, 6.0, 14.9, 15.0])   # 3 inside [5, 15)
    r2 = _rec(2, 6.0, [7.0, 8.0])                     # 2 inside
    assert stats.output_tok_s(_run([r1, r2])) == pytest.approx(0.5)


def test_ttft_from_due_time_and_unserved_wait_to_the_end():
    r1 = _rec(1, 6.0, [6.25, 7.0])
    r2 = _rec(2, 8.0, [])                 # no first token: waits to 20
    r3 = _rec(3, 1.0, [3.0], window=False)  # due in the lead-in: left out
    assert sorted(stats.ttft_s(_run([r1, r2, r3]))) == [0.25, 12.0]


def test_tpot_uses_the_tokens_inside_the_window():
    r1 = _rec(1, 0.0, [4.0, 5.0, 5.5, 6.0, 16.0])  # inside: 5, 5.5, 6
    r2 = _rec(2, 0.0, [9.0])                         # one token: left out
    assert stats.tpot_s(_run([r1, r2])) == [pytest.approx(0.5)]


def test_queue_wait_runs_to_the_first_chunks_step():
    r1 = _rec(1, 6.0, [7.0], admitted=6.5)
    r2 = _rec(2, 9.0, [])                   # never admitted
    assert sorted(stats.queue_wait_s(_run([r1, r2]))) == [0.5, 11.0]


def test_decode_step_ms_averages_pure_decode_steps_in_the_window():
    steps = [StepRecord(0, 5.0, 5.04, "decode", 4, 0, 4, 0, 0),
             StepRecord(1, 5.04, 5.1, "decode", 4, 2, 4, 0, 0),
             StepRecord(2, 5.1, 5.6, "decode", 4, 0, 4, 100, 0),
             StepRecord(3, 4.0, 4.5, "decode", 4, 0, 4, 0, 0)]
    assert stats.decode_step_ms(_run([], steps)) == pytest.approx(50.0)


def test_mixed_step_ms_averages_chunk_steps_beside_decode_rows():
    steps = [StepRecord(0, 5.0, 5.04, "decode", 4, 0, 4, 0, 0),
             StepRecord(1, 5.04, 5.34, "decode", 4, 0, 4, 100, 0),
             StepRecord(2, 5.34, 5.44, "decode", 4, 0, 4, 50, 0),
             StepRecord(3, 5.44, 5.94, "decode", 0, 0, 0, 512, 0),
             StepRecord(4, 4.0, 4.9, "decode", 4, 0, 4, 9, 0)]
    assert stats.mixed_step_ms(_run([], steps)) == pytest.approx(200.0)
    read = spec.load_reader("mixed_step_ms.steady", ROOT)
    assert read(_run([], steps)) == pytest.approx(200.0)
    assert read(_run([], steps[:1])) is None


def test_itl_p99_over_every_token_gap_inside_the_window():
    # gaps inside [5, 15): r1 0.5, 0.5, 0 (two tokens of one step), r2 3.0
    r1 = _rec(1, 0.0, [4.0, 5.0, 5.5, 6.0, 6.0, 16.0])
    r2 = _rec(2, 0.0, [7.0, 10.0])
    gaps = sorted(stats.token_gaps_s(_run([r1, r2])))
    assert gaps == [0.0, 0.5, 0.5, 3.0]
    read = spec.load_reader("itl_p99_ms", ROOT)
    # inclusive: position 0.99 * 3 = 2.97 -> 0.5 + 0.97 * (3.0 - 0.5)
    assert read(_run([r1, r2])) == pytest.approx(1e3 * (0.5 + 0.97 * 2.5))
    assert read(_run([_rec(3, 0.0, [9.0])])) is None


def test_paged_attention_need_by_hand():
    # one row: 3 cached positions, 2 new queries -> they see 4 and 5
    f, b = flops.paged_attention_need([(3, 2)], heads=4, kv_heads=2,
                                      head_dim=8, elem_bytes=2)
    assert f == 4 * 4 * 8 * (4 + 5)
    # K and V of 5 positions x 2 kv heads, q and out of 2 queries x 4 heads
    assert b == 2 * 8 * (2 * 2 * 5 + 2 * 4 * 2)
    assert flops.least_time(f, b) == max(f / flops.PEAK_BF16_FLOPS,
                                         b / flops.PEAK_HBM_BYTES_S)


def test_roofline_reader_over_a_synthetic_slice():
    class Cfg:
        dtype, num_heads, num_kv_heads, resolved_head_dim = \
            "bfloat16", 28, 4, 128
        num_layers = 28
    rows = [(1000, 1)] * 64
    f, b = flops.paged_attention_need(rows, heads=28, kv_heads=4,
                                      head_dim=128, elem_bytes=2)
    need = 28 * flops.least_time(f, b)
    tr = device_trace.Slice(kernel_s={"paged_attention_kernel<bf16>": 4 * need,
                                      "gemm": 1.0},
                            calls=[(Cfg, rows)])
    read = spec.load_reader("paged_attn_roofline", ROOT)
    assert read(_run([], trace=tr)) == pytest.approx(25.0)


def test_step_mfu_by_hand():
    per_param = flops.matmul_params_per_token(SIZES)
    # attention 4 * d + 2 * (ff) ... hand count of the layout's weights
    d, hd = 8, 4
    attn = d * (2 + 2) * hd + 2 * hd * d
    assert per_param == 2 * (attn + 3 * d * 16) + 10 * d
    steps = [StepRecord(0, 5.0, 5.1, "decode", 1, 0, 1, 3, 0,
                        chunks=[(1, 0, 3)], served=[(1, 0, 1)]),
             StepRecord(1, 5.1, 5.2, "decode", 1, 0, 1, 0, 0,
                        served=[(1, 1, 1)])]
    run = _run([_rec(1, 5.0, [5.1, 5.2], prompt=3)], steps)
    ctx_terms = (1 + 2 + 3) + 4          # prompt positions 0..2, token 1
    want = 4 * 2.0 * per_param + 4.0 * 2 * 2 * hd * ctx_terms
    assert stats.useful_flops(run) == pytest.approx(want)
    read = spec.load_reader("step_mfu", ROOT)
    assert read(run) == pytest.approx(100 * want / (10 * 989e12))


def test_busy_is_the_union_of_device_intervals():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert device_trace.busy(spans) == 3.0
    assert device_trace.union(spans) == [(0.0, 2.0), (3.0, 4.0)]


def test_spread_is_interquartile_over_median():
    # exclusive quartiles of 1..5 sit at positions 1.5 and 4.5
    assert math.isclose(stats.spread([1, 2, 3, 4, 5]), (4.5 - 1.5) / 3)
