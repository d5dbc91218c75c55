"""End-to-end training example: train a ~100M-param LM for a few hundred
steps with the full substrate (microbatching, 8-bit Adam, int8 gradient
compression, checkpoint/resume, prefetched data).

Port of ``examples/train_lm.py``; runs on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 300]

Uses the mamba2-130m architecture at its full config. Resume after an
interruption is exercised by saving every 100 steps and restarting from
the latest checkpoint with ``--resume``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    argv = ["--arch", "mamba2-130m",          # full 130M config, real scale
            "--steps", str(args.steps),
            "--batch", str(args.batch),
            "--seq", str(args.seq),
            "--micro", "2",
            "--compress",                      # int8 grads + error feedback
            "--ckpt-dir", args.ckpt_dir,
            "--ckpt-every", "100"]
    if args.resume:
        argv.append("--resume")
    if args.device is not None:
        argv += ["--device", args.device]
    losses = train_main(argv)
    if args.steps >= 100:                 # warmup dominates shorter runs
        assert losses[-1] < losses[0], "loss did not improve"
        print("OK — training loss improved "
              f"({losses[0]:.3f} -> {losses[-1]:.3f})")
    else:
        print(f"OK — short sanity run ({args.steps} steps; "
              "loss-improvement check applies from 100 steps)")
    return losses


if __name__ == "__main__":
    main()
