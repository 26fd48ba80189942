"""Training entry point (one device).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
      --steps 3 --batch 2 --seq 1024

``--reduced`` takes the CPU-sized config; ``--device cpu`` runs the plain
PyTorch path (the default is the card, and a run without one raises).
Prints the reference's lines: one per recorded step and the final loss.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import configs
    from ..training.data import make_batch_iter
    from ..training.train_loop import train

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    it = make_batch_iter(cfg.vocab_size, args.batch, args.seq,
                         device=args.device)
    out = train(cfg, steps=args.steps, batch_iter=it, device=args.device,
                checkpoint_dir=args.ckpt_dir)
    for h in out["history"]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f}")
    print(f"final loss {out['final_loss']:.4f} in {out['elapsed_s']:.1f}s")


if __name__ == "__main__":
    main()
