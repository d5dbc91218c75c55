"""Synthetic data pipeline: deterministic and host-shardable.

Port of ``repro.data.pipeline`` (numpy, word for word). Real deployments
stream tokenised shards; here the source is a seeded counter-based
generator (same philosophy as the paper's PRNG: state is a seed + step
counter, so any host can regenerate any batch — which is also what makes
checkpoint-resume and elastic re-sharding exact: the pipeline state IS the
step number). The reference's background ``Prefetcher`` comes with the
training part of the port, its only user.
"""

from __future__ import annotations

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
