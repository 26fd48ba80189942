#!/usr/bin/env python3
"""The knee sweep of one configuration under the chat traffic, on the card.

    python3 bench_port/sweep.py --config paper-7b --rates 0.5,1,2,3 \
        [--lead-in 8] [--seconds 20] [--seed 1]

One process: the configuration's weights and engine are made and warmed up
once, as a cell's run makes them, then each rate (ascending) is offered
open loop for a lead-in and a window, and the engine drained before the
next.  One JSON line per rate: tokens/s, tails, the queue at the window's
open and close, the mean batch and step times, and the mean lifetime of
the requests finished (due time to last token).  The knee is the highest
rate whose queue does not grow through the window and whose output tokens
per second keep up with those offered (the window's requests' output
lengths over its seconds); the sweep stops after the first rate whose
queue grows by more than ``GROWTH`` requests.  The chosen rates and
lead-ins go into ``cells/<workload>.json`` by hand.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

GROWTH = 4      # requests the queue may gain over the window at the knee
DRAIN_S = 120.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="chat")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--lead-in", type=float, default=8.0)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch
    from bench_port.lib import cellrun, model, serve, spec, stats, traffic

    if not torch.cuda.is_available():
        print("the sweep runs on an NVIDIA card", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == args.config)
    config = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((ROOT / "bench_port" / "traffic"
                      / f"{args.traffic}.json").read_text())
    tarch = model.archs(config)[0]
    tcfg, dcfg = model.pair(config)
    dep = config["deployment"]
    t0 = time.time()
    params = model.make_pair_weights(tcfg, dcfg, args.seed, "cuda")
    engine = serve.build_engine(tcfg, dcfg, dep, params)
    warm = serve.to_port_requests(traffic.warmup(
        mix, rate=min(float(r) for r in args.rates.split(",")),
        lead_in_s=args.lead_in, seconds=args.seconds,
        seed=args.seed + cellrun.WARM_SEED_OFFSET, vocab=tcfg.vocab_size,
        count=cellrun.WARM_REQUESTS, output_len=cellrun.WARM_TOKENS))
    engine.run(warm, max_steps=100_000)
    torch.cuda.synchronize()
    print(json.dumps({"config": args.config, "setup_s": time.time() - t0,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    next_id = len(warm)
    for rate in sorted(float(r) for r in args.rates.split(",")):
        reqs = traffic.generate(mix, rate=rate, lead_in_s=args.lead_in,
                                seconds=args.seconds, seed=args.seed,
                                vocab=tcfg.vocab_size)
        for r in reqs:
            r.req_id += next_id
        next_id += len(reqs)
        ol = serve.OpenLoop(engine, reqs)
        end = ol.run(lead_in_s=args.lead_in, seconds=args.seconds)
        run = serve.Run(seconds=args.seconds,
                        window_open=args.lead_in,
                        window_close=args.lead_in + args.seconds, end=end,
                        setup_s=0.0, requests=ol.recs, steps=ol.steps,
                        target_sizes=tarch.sizes(config), arch=tarch)
        ws = stats.window_steps(run)
        q_open = next((s.waiting for s in ol.steps
                       if s.t_end >= run.window_open), 0)
        q_close = next((s.waiting for s in reversed(ol.steps)
                        if s.t_end < run.window_close), 0)
        done = [r for r in ol.recs.values()
                if len(r.token_times) >= r.output_len]
        mixed = [s for s in ws if s.kind == "decode" and s.prefill_tokens]
        line = {
            "rate_per_s": rate,
            "offered_tok_s": sum(r.output_len for r in reqs
                                 if r.in_window) / args.seconds,
            "output_tok_s": stats.output_tok_s(run),
            "ttft_p95_ms": 1e3 * (stats.p95(stats.ttft_s(run)) or 0.0),
            "tpot_p95_ms": 1e3 * (stats.p95(stats.tpot_s(run)) or 0.0),
            "queue_at_open": q_open, "queue_at_close": q_close,
            "mean_batch": (sum(s.batch for s in ws) / len(ws)) if ws else 0,
            "decode_step_ms": stats.decode_step_ms(run),
            "mixed_step_ms": (1e3 * sum(s.t_end - s.t_start for s in mixed)
                              / len(mixed)) if mixed else None,
            "mixed_steps": len(mixed), "window_steps": len(ws),
            "mean_lifetime_s": (sum(r.token_times[-1] - r.due for r in done)
                                / len(done)) if done else None,
            "finished": len(done),
            "peak_bytes": torch.cuda.max_memory_allocated(),
        }
        # drain what is left before the next rate
        t_drain = time.perf_counter()
        while engine.has_work() and time.perf_counter() - t_drain < DRAIN_S:
            engine.step(now=ol.now())
        line["drain_s"] = time.perf_counter() - t_drain
        line["drained"] = not engine.has_work()
        print(json.dumps(line), flush=True)
        if q_close - q_open > GROWTH or not line["drained"]:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
