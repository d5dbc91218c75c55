"""Batched serving launcher: prefill + greedy decode loop.

Port of ``repro.launch.serve``; runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --smoke --batch 4 --prompt-len 64 --gen 32 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.data.pipeline import synth_batch
from repro_torch.models import model as M
from repro_torch.models.archs import get_arch, reduced_config


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, batch: int, prompt_len: int, gen: int, greedy: bool = True,
          seed: int = 0, *, device=None):
    """Random params from ``seed``, a synthetic prompt batch, prefill, then
    ``gen - 1`` greedy decode steps. Returns (tokens (batch, gen), stats:
    prefill / decode seconds on the host clock, each ending in a device
    synchronize, and decode tokens/s)."""
    dev = M.resolve_device(device, "serve")
    gen_ = torch.Generator(device=dev).manual_seed(seed)
    params = M.init_params(cfg, gen_, device=dev)
    data = synth_batch(cfg, 0, batch, prompt_len, seed)
    data = {k: torch.as_tensor(v, device=dev) for k, v in data.items()
            if k != "labels"}
    cache_len = prompt_len + gen

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, data, cfg, cache_len=cache_len,
                              q_chunk=min(1024, prompt_len),
                              kv_chunk=min(1024, prompt_len))
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
    out_tokens = [tok.cpu().numpy()]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        step_in = ({"embeds": torch.zeros((batch, 1, cfg.d_model),
                                          dtype=torch.float32, device=dev)}
                   if cfg.frontend else {"tokens": tok})
        logits, cache = M.decode_step(params, cache, step_in,
                                      prompt_len + i, cfg)
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
        out_tokens.append(tok.cpu().numpy())
    _sync(dev)
    t_decode = time.perf_counter() - t0
    toks = np.concatenate(out_tokens, axis=1)
    return toks, {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    toks, stats = serve(cfg, args.batch, args.prompt_len, args.gen,
                        device=args.device)
    print(f"generated {toks.shape} tokens; prefill {stats['prefill_s']:.2f}s;"
          f" decode {stats['decode_s']:.2f}s"
          f" ({stats['tok_per_s']:.1f} tok/s)")
    return toks, stats


if __name__ == "__main__":
    main()
