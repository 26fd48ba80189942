"""Fixtures of the benchmark's CPU tests: the checkout's ``src`` and root on
the path, and a copy of the benchmark at tiny widths that a CPU runs in
seconds (the same files, the same harness; only the sizes differ)."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_root(dest: Path) -> Path:
    """``dest`` holding BENCHMARK.json and bench_port/ with every
    configuration cut to a few dozen widths and the chat traffic to short
    prompts, in float32, at a rate a CPU keeps up with."""
    shutil.copytree(ROOT / "bench_port", dest / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    cdir = dest / "bench_port" / "configs"
    for f in cdir.glob("*.json"):
        c = json.loads(f.read_text())
        c.update(hidden_size=64, intermediate_size=128 if "num_local_experts"
                 not in c else 32, num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, vocab_size=256, torch_dtype="float32")
        if "attention_multiplier" in c:
            c["attention_multiplier"] = 0.25
        if "num_local_experts" in c:
            c.update(num_local_experts=4, num_experts_per_tok=2)
            c["port"]["target"]["moe_capacity_factor"] = 8.0
        c["draft"].update(hidden_size=32, intermediate_size=64,
                          num_hidden_layers=1, num_attention_heads=2,
                          num_key_value_heads=1, vocab_size=256,
                          torch_dtype="float32")
        c["deployment"].update(max_batch=8, chunk_tokens=32, num_blocks=512,
                               block_size=4)
        # float32 at these widths: sound runs read a gap of rounding
        # (under 1e-5), and logits spread over about +-0.5
        c["correct"] = {"number": "max_logit_gap", "limit": 0.01}
        f.write_text(json.dumps(c))
    for f in (dest / "bench_port" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t["prompt"].update(mu=3.0, max=64)
        t["output"].update(mu=2.5, max=32)
        f.write_text(json.dumps(t))
    for f in (dest / "bench_port" / "cells").glob("*.json"):
        c = json.loads(f.read_text())
        c.update(rate_per_s=20.0, lead_in_s=0.5)
        f.write_text(json.dumps(c))
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench_port_tiny"))
