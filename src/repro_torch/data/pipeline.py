"""Synthetic data pipeline: deterministic and host-shardable.

Port of ``repro.data.pipeline`` (numpy, word for word). Real deployments
stream tokenised shards; here the source is a seeded counter-based
generator (same philosophy as the paper's PRNG: state is a seed + step
counter, so any host can regenerate any batch — which is also what makes
checkpoint-resume and elastic re-sharding exact: the pipeline state IS the
step number).

``Prefetcher`` overlaps host batch synthesis with device compute via a
background thread and a bounded queue (the host-side half of
compute/comm overlap). The queue holds the futures of the next ``depth``
batches of a one-thread executor, so an exception raised while making a
batch is raised again by the ``next()`` that asks for it.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.models.config import ArchConfig


def synth_batch(cfg: ArchConfig, step: int, batch: int, seq: int,
                seed: int = 0):
    """Deterministic batch for (step, shape). tokens/labels int32;
    audio/vlm get synthetic frontend embeddings instead of tokens."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    out = {}
    labels = rng.integers(0, cfg.vocab, size=(batch, seq), dtype=np.int32)
    out["labels"] = labels
    if cfg.frontend:
        out["embeds"] = rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32) * 0.02
    else:
        # next-token structure: tokens are labels shifted right
        tokens = np.roll(labels, 1, axis=1)
        tokens[:, 0] = 0
        out["tokens"] = tokens
    if cfg.mrope:
        pos = np.broadcast_to(np.arange(seq)[None, :, None],
                              (batch, seq, 3)).astype(np.int32)
        out["mrope_pos"] = np.ascontiguousarray(pos)
    return out


def host_slice(global_batch: int, host_id: int, n_hosts: int):
    """[start, stop) rows of the global batch owned by this host."""
    per = global_batch // n_hosts
    return host_id * per, (host_id + 1) * per


class Prefetcher:
    """Background-thread batch prefetch with a bounded queue: batches of
    steps ``start_step``, ``start_step + 1``, ... in order."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int,
                 start_step: int = 0, seed: int = 0, depth: int = 2):
        self._make = lambda step: synth_batch(cfg, step, batch, seq, seed)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="prefetch")
        self._q: collections.deque = collections.deque()
        self._step = start_step
        self._next = start_step
        for _ in range(max(depth, 1)):
            self._submit()

    def _submit(self) -> None:
        self._q.append((self._next, self._pool.submit(self._make,
                                                      self._next)))
        self._next += 1

    def next(self):
        step, fut = self._q.popleft()
        self._submit()
        b = fut.result()            # re-raises the worker's exception
        self._step = step
        return b

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._q.clear()
