"""The ``gqa`` architecture module gives the numbers the harness gave before
the layout moved into it, bit for bit: at tiny widths on the CPU, for a
dense GQA and a top-k MoE configuration, its sizes, its ``ModelConfig``,
the reference's logits in float32 and float8, ``useful_flops`` of a fixed
run, and the attention need of a fixed call log; and every metric the
benchmark had then reads the same number from the same run.

``golden.json`` holds the values that the harness's code of the time
(``lib/model.py``'s ``sizes`` / ``port_config``, ``lib/reference.py``'s
``logits``, ``lib/flops.py``'s ``token_flops`` / ``paged_attention_need``)
gave on the CPU, integers as they are and floats as ``float.hex``; the
logits as the SHA-256 of their float32 bytes."""
import dataclasses
import hashlib
import json

import pytest
import torch

from conftest import ROOT
from bench_port.lib import device_trace, flops, model, spec, stats
from bench_port.lib.serve import ReqRecord, Run, StepRecord

GOLDEN = json.loads((ROOT / "bench_port/tests/golden.json").read_text())
GQA = spec.load_arch("gqa", ROOT)
CONFIGS = ("paper-7b", "granite-moe-1b-a400m")


def full(name):
    return json.loads((ROOT / "bench_port/configs" / f"{name}.json")
                      .read_text())


def tiny(name):
    """The configuration at tiny widths, float32 (the MoE: 4 experts,
    top-2, nothing dropped)."""
    c = full(name)
    moe = "num_local_experts" in c
    c.update(hidden_size=64, intermediate_size=32 if moe else 128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, vocab_size=64, torch_dtype="float32")
    if "attention_multiplier" in c:
        c["attention_multiplier"] = 0.25
    if moe:
        c.update(num_local_experts=4, num_experts_per_tok=2)
        c["port"]["target"]["moe_capacity_factor"] = 8.0
    c["draft"].update(hidden_size=32, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=1, vocab_size=64,
                      torch_dtype="float32")
    return c


def as_json(cfg):
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def fixed_run(sizes):
    """A run with every kind of step, chunks, served tokens and a traced
    slice whose call log holds target, draft and MoE calls."""
    reqs = {
        1: ReqRecord(1, 4.0, 40, 6, False, admitted=4.1,
                     token_times=[4.6, 5.2, 5.3, 5.9, 6.4, 7.0],
                     prefilled=40),
        2: ReqRecord(2, 5.5, 700, 5, True, admitted=5.7,
                     token_times=[6.4, 6.9, 6.9, 8.1, 9.0], prefilled=700),
        3: ReqRecord(3, 7.25, 12, 4, True, admitted=8.0,
                     token_times=[8.1, 8.2, 9.4], prefilled=12),
        4: ReqRecord(4, 13.0, 30, 3, True),
    }
    steps = [
        StepRecord(0, 4.1, 4.6, "decode", 0, 0, 1, 40, 0,
                   chunks=[(1, 0, 40)], served=[(1, 0, 1)]),
        StepRecord(1, 5.1, 5.2, "decode", 1, 0, 1, 0, 0,
                   served=[(1, 1, 1)]),
        StepRecord(2, 5.2, 5.3, "decode", 1, 3, 1, 0, 1,
                   served=[(1, 2, 1)]),
        StepRecord(3, 5.7, 6.4, "decode", 1, 0, 2, 512, 0,
                   chunks=[(2, 0, 512)], served=[(1, 4, 1)]),
        StepRecord(4, 6.4, 6.4, "decode", 1, 0, 2, 188, 0,
                   chunks=[(2, 512, 188)], served=[(2, 0, 1), (1, 4, 1)]),
        StepRecord(5, 6.5, 6.9, "decode", 2, 2, 5, 0, 0,
                   served=[(2, 1, 2)]),
        StepRecord(6, 8.0, 8.1, "decode", 1, 0, 2, 12, 1,
                   chunks=[(3, 0, 12)], served=[(2, 3, 1), (3, 0, 1)]),
        StepRecord(7, 8.1, 8.2, "decode", 2, 3, 3, 0, 1,
                   served=[(3, 1, 1)]),
        StepRecord(8, 8.9, 9.0, "decode", 2, 0, 2, 0, 1,
                   served=[(2, 4, 1)]),
        StepRecord(9, 9.3, 9.4, "decode", 1, 0, 1, 0, 1,
                   served=[(3, 2, 1)]),
        StepRecord(10, 9.5, 9.6, "idle", 0, 0, 0, 0, 1),
        StepRecord(11, 15.5, 15.6, "decode", 1, 0, 1, 0, 0),
    ]
    tcfg, dcfg = model.pair(full("paper-7b"))
    gcfg, _ = model.pair(full("granite-moe-1b-a400m"))
    tr = device_trace.Slice(
        wall_s=3.0, busy_s=0.4375,
        kernel_s={"void (anonymous namespace)::paged_attention_kernel"
                  "<__nv_bfloat16>": 0.0123,
                  "void (anonymous namespace)::paged_combine_kernel": 0.0007,
                  "nvjet_tst_256x16": 0.2},
        kernels_by_step={1: 3000, 2: 5200, 3: 4100, 5: 5000, 8: 2990,
                         9: 3010},
        calls=[(tcfg, [(1000, 1), (37, 1), (0, 512)]),
               (dcfg, [(1000, 4), (37, 4)]),
               (gcfg, [(700, 1), (12, 188)])])
    return Run(seconds=10.0, window_open=5.0, window_close=15.0, end=16.0,
               setup_s=27.5, requests=reqs, steps=steps, target_sizes=sizes,
               trace=tr, arch=GQA,
               archs={c.name: GQA for c in (tcfg, dcfg, gcfg)})


@pytest.mark.parametrize("name", CONFIGS)
def test_sizes_and_port_configs(name):
    g = GOLDEN[name]
    c = tiny(name)
    assert [a.__name__ for a in model.archs(c)] == ["bench_port_arch_gqa"] * 2
    assert GQA.sizes(c) == g["sizes"]
    assert GQA.sizes(c["draft"]) == g["draft_sizes"]
    t, d = model.pair(c)
    assert as_json(t) == g["port_config"]
    assert as_json(d) == g["draft_port_config"]
    fc = full(name)
    assert GQA.sizes(fc) == g["full_sizes"]
    assert as_json(model.pair(fc)[0]) == g["full_port_config"]


@pytest.mark.parametrize("precision", ("fp32", "fp8"))
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits(name, precision):
    g = GOLDEN[name]
    t, _ = model.pair(tiny(name))
    params = model.make_weights(t, torch.Generator().manual_seed(2**31 + 99),
                                "cpu")
    gen = torch.Generator().manual_seed(5)
    seqs = [torch.randint(0, 64, (n,), generator=gen) for n in (9, 5, 12)]
    lg = GQA.logits(params, g["sizes"], seqs, [3, 0, 11],
                    precision=precision)
    want = g[f"logits_{precision}"]
    assert [list(x.shape) for x in lg] == want["shapes"]
    assert float(sum(x.double().sum() for x in lg)).hex() == want["sum"]
    h = hashlib.sha256()
    for x in lg:
        h.update(x.contiguous().numpy().tobytes())
    assert h.hexdigest() == want["sha256"]


@pytest.mark.parametrize("name", CONFIGS)
def test_useful_flops_and_the_metrics_of_a_fixed_run(name):
    g = GOLDEN[name]
    run = fixed_run(g["full_sizes"])
    assert stats.useful_flops(run).hex() == g["useful_flops"]
    assert [GQA.token_flops(g["full_sizes"], c).hex()
            for c in (1, 77, 4096)] == g["token_flops"]
    for metric, want in g["metrics"].items():
        v = spec.load_reader(metric, ROOT)(run)
        assert (None if v is None else float(v).hex()) == want, metric


def test_the_attention_need_of_a_fixed_call_log():
    run = fixed_run({})
    got = []
    for cfg, rows in run.trace.calls:
        [(n, f, b)] = run.arch_of(cfg).attention_need(cfg, rows, 2)
        assert n == cfg.num_layers
        got.append([cfg.name, f.hex(), b.hex(),
                    (n * flops.least_time(f, b)).hex()])
    assert got == GOLDEN["attention_need"]
