"""End-to-end training launcher.

Port of ``repro.launch.train``; runs on the card unless ``--device cpu``.
Wires together: config -> init from a seeded generator -> prefetched data
pipeline -> train step (microbatched, 8-bit Adam, optional int8 gradient
compression) -> async checkpointing -> fleet monitor hooks (one host).

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --smoke --steps 50 --batch 8 --seq 256 [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import torch

from repro_torch.data.pipeline import Prefetcher
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.elastic import FleetMonitor
from repro_torch.models import model as M
from repro_torch.models.archs import get_arch, reduced_config
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts


def run(argv=None):
    """``main``'s run -> (losses, stats): ``step_s`` each step's seconds
    on the host clock (each ends reading the loss, which waits for the
    device), ``start`` the step it began at, ``tokens_per_step``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression + error feedback")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = M.resolve_device(args.device, "launch.train")
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    adam = opt.AdamWConfig(lr=args.lr, warmup=min(100, args.steps // 10 + 1))

    params, opt_state, residual = ts.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), adam,
        compress=args.compress, device=dev)
    n_params = sum(p.numel() for p in M.tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    step_fn = ts.build_train_step(
        cfg, adam, n_micro=args.micro, compress=args.compress,
        q_chunk=min(1024, args.seq), kv_chunk=min(1024, args.seq))

    start = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start = ckpt.restore(
            (params, opt_state), args.ckpt_dir, shardings=dev)
        print(f"resumed from step {start}")

    saver = ckpt.AsyncCheckpointer(args.ckpt_dir)
    monitor = FleetMonitor(n_hosts=1)       # one host: process 0 of 1
    losses, step_s = [], []
    with contextlib.closing(
            Prefetcher(cfg, args.batch, args.seq, start_step=start)) as pf:
        t_last = time.time()
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in pf.next().items()}
            params, opt_state, metrics, residual = step_fn(
                params, opt_state, batch, residual)
            monitor.heartbeat(0)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t0)
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.time() - t_last
                t_last = time.time()
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)")
            if step and step % args.ckpt_every == 0:
                saver.save((params, opt_state), step)
            monitor.report_step_time(0, time.time() - t_last)
        saver.save((params, opt_state), args.steps)
        saver.wait()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses, {"step_s": step_s, "start": start,
                    "tokens_per_step": args.batch * args.seq}


def main(argv=None):
    return run(argv)[0]


if __name__ == "__main__":
    main()
