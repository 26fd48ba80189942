"""The harness's whole run at tiny widths on the CPU: the open loop, the
result's line, and the comparison that decides ``correct`` — which a token
altered where it is produced turns false, and which the float8 control,
put in the program's place, fails where the served tokens pass; a
deployment with the host tier under shared prefixes and sessions; the
window's own memory peak.  The card's own runs (and the control at the
cells' sizes) are on the chip; the CLI here only refuses."""
import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, tiny_root
from bench_port.lib import cellrun, check, model, spec

SEED = 2**31 + 1234567


def _run(root, workload="paper7b-chat-steady", fault=None, seed=SEED,
         control=False):
    cell = spec.find_cell(workload, root)
    out = cellrun.run_cell(cell, seed=seed, seconds=1.5, trace=False,
                           t_process=time.time(), device="cpu", root=root,
                           fault=fault, control=control)
    return cell, out


@pytest.fixture(scope="module")
def steady(tiny):
    return _run(tiny, control=True)


def test_a_sound_run_is_correct(steady):
    cell, out = steady
    assert out.correct and out.gap <= out.limit
    assert out.compared_requests == check.SAMPLE
    assert out.compared_tokens > 50
    assert out.attempted == 30 and out.failed == 0


def test_the_result_line(steady, tiny):
    cell, out = steady
    res = cellrun.result(cell, out, trace=False, kind="cpu", root=tiny)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["device"]["platform"] == "gpu"
    assert set(res["checks"]["max_logit_gap"]) == {"value", "limit"}
    json.dumps(res)


def test_readers_without_a_trace_leave_their_metric_out(steady, tiny):
    cell, out = steady
    got = spec.read_metrics(cell.per_layer, out.run, tiny)
    assert {"mean_batch", "queue_wait_p95_ms", "decode_step_ms.steady",
            "step_mfu", "spec_step_share"} <= set(got)
    assert not {"kernels_per_decode_step", "paged_attn_roofline",
                "device_idle_share"} & set(got)


def test_the_moe_cell_runs(tiny):
    cell, out = _run(tiny, "granite-moe-chat-steady")
    assert out.correct and out.compared_tokens > 50


def _alter_tokens(engine):
    """A token altered where it is produced: after every step, the newest
    token of the first running sequence is replaced, and the replacement
    fed on as its last token."""
    be = engine.backend
    vocab = be.target.cfg.vocab_size

    def altered(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            for rid in list(be.last_token)[:1]:
                toks = be.tokens_out[rid]
                toks[-1] = (toks[-1] + 1) % vocab
                be.last_token[rid] = toks[-1]
            return out
        return call

    be.step = altered(be.step)
    be.hybrid_step = altered(be.hybrid_step)


def test_an_altered_token_is_not_correct(tiny):
    _, out = _run(tiny, fault=_alter_tokens)
    assert not out.correct and out.gap > out.limit


def test_the_control_fails_where_the_program_passes(steady):
    """The float8 control in the program's place, on the run's own sample,
    judged by the run's own decision: the served tokens pass, the
    control's fail."""
    cell, out = steady
    assert out.correct and out.readings[out.number] <= out.limit
    assert out.control_correct is False
    assert out.control[out.number] > out.limit
    assert check.decide(cell.config["correct"], out.control,
                        out.compared_tokens) is False


def test_a_host_tier_deployment_under_prefixes_and_sessions(tmp_path):
    """A deployment with ``host_tier_blocks`` on a pool that binds, under a
    traffic file of shared prefixes and two-turn sessions: evicted prefix
    blocks spill to the host and the served tokens stay correct."""
    root = tiny_root(tmp_path)
    cfg_path = root / "bench_port/configs/paper-7b.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["deployment"].update(num_blocks=96, host_tier_blocks=64)
    cfg_path.write_text(json.dumps(cfg))
    mix_path = root / "bench_port/traffic/chat.json"
    mix = json.loads(mix_path.read_text())
    mix.update(prefix={"count": 2, "length": 16},
               sessions={"turns": 2, "gap_s": 0.4})
    mix_path.write_text(json.dumps(mix))
    engines = []
    _, out = _run(root, fault=engines.append)
    hs = engines[0].scheduler.bm.host_store
    assert hs is not None and hs.stats["spilled_blocks"] > 0
    assert out.correct and out.failed == 0


class _FakeCuda:
    def __init__(self):
        self.now, self.peak = 0, 0

    def alloc(self, n):
        self.now += n
        self.peak = max(self.peak, self.now)

    def free(self, n):
        self.now -= n


def test_the_memory_peak_is_the_windows_own(monkeypatch):
    """The warm-up's and the lead-in's transients are not counted: the
    count restarts when the window opens and is read when it closes."""
    fake = _FakeCuda()

    def reset(dev=None):
        fake.peak = fake.now

    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda dev=None: fake.peak)
    w = cellrun.PeakWatch(torch.device("cuda"), 10.0, 61.0)
    fake.alloc(100)                 # weights and pool
    fake.alloc(500)                 # a warm-up transient
    fake.free(500)
    w.on_step(None, 5.0)            # lead-in
    fake.alloc(50)
    fake.free(50)
    w.on_step(None, 10.2)           # the window opens
    fake.alloc(20)
    fake.free(20)
    w.on_step(None, 61.5)           # closed: read
    fake.alloc(300)                 # the drain after the close
    assert w.read() == 120


def test_the_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines "
                    "without one")
    p = subprocess.run([sys.executable, str(ROOT / "bench_port/run.py"),
                        "--workload", "paper7b-chat-steady", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_a_traced_run_on_the_card(tmp_path):
    """A traced run at tiny widths on the card, with heads of 32 (the
    card's paged-attention kernel takes head_dim 32 / 64 / 128 / 256): the
    device trace, the program's spans and the metrics that read them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    root = tiny_root(tmp_path)
    path = root / "bench_port/configs/paper-7b.json"
    cfg = json.loads(path.read_text())
    cfg["hidden_size"], cfg["draft"]["hidden_size"] = 128, 64
    path.write_text(json.dumps(cfg))
    cell = spec.find_cell("paper7b-chat-steady", root)
    out = cellrun.run_cell(cell, seed=SEED, seconds=7.0, trace=True,
                           t_process=time.time(), device="cuda", root=root)
    res = cellrun.result(cell, out, trace=True,
                         kind=torch.cuda.get_device_name(0), root=root)
    assert res["correct"]
    assert res["device"]["busy_s"] > 0
    assert {"kernels_per_decode_step", "device_idle_share",
            "paged_attn_roofline", "dispatch_ms.decode",
            "engine_host_ms.decode", "idle_in_dispatch_share"} \
        <= set(res["metrics"])
    assert 0 < res["metrics"]["paged_attn_roofline"]["value"] <= 105
    assert out.run.trace.idle_by_phase
    names = [n for n, _ in res["breakdown"]["device_ops"]
             + res["breakdown"]["idle_gaps"]]
    assert not any("nightjar." in n for n in names)
