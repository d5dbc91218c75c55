"""AdamW with block-quantised 8-bit moments + int8 gradient compression.

Port of ``repro.training.optimizer``:

  * 8-bit Adam moments (per-128-block absmax scales) cut optimizer-state
    memory by 4x against f32;
  * int8 gradient compression with error feedback: gradients are
    quantised before the data-parallel all-reduce; the quantisation
    residual is fed back into the next step so the compression is
    unbiased in the long run.

Every function is pure: it returns new trees and leaves its inputs as
they were. Trees are nested dicts of tensors (the model's params), walked
in the reference's order (``training.tree``: sorted keys), so the global
norm sums its leaves as the reference does. The arithmetic is the
reference's, op for op, in f32; ``torch.round`` rounds half to even as
``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.training import tree as T

BLOCK = 128
F32 = torch.float32


# ---------------------------------------------------------------------------
# Block-wise int8 quantisation
# ---------------------------------------------------------------------------


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 tensor -> (int8 payload (n_blocks, BLOCK), per-block f32
    scales)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale.to(F32)


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(F32) * scale[:, None]).reshape(-1)
    return flat[: int(np.prod(shape))].reshape(shape)


def _q8_sqrt(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Second-moment quantisation in sqrt-domain. Linear int8 on raw v
    zeroes small entries within a block (v spans ~squared dynamic range),
    which explodes m/sqrt(v) steps; quantising sqrt(v) halves the log-range
    so the update stays stable (the standard 8-bit-Adam trick)."""
    return _q8(torch.sqrt(torch.clamp(v, min=0.0)))


def _dq8_sqrt(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    r = _dq8(q, scale, shape)
    return r * r


# ---------------------------------------------------------------------------
# AdamW (8-bit state)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup: int = 100
    eightbit: bool = True
    grad_clip: float = 1.0


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments on each leaf's device: ``_q8`` of zeros (int8 zeros,
    scales 1e-12) when 8-bit, f32 zeros otherwise; ``count`` an int32
    scalar on the first leaf's device."""
    def zero_like(p):
        if cfg.eightbit:
            n_blocks = -(-p.numel() // BLOCK)
            return {"q": torch.zeros((n_blocks, BLOCK), dtype=torch.int8,
                                     device=p.device),
                    "s": torch.full((n_blocks,), 1e-12, dtype=F32,
                                    device=p.device)}
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    dev = T.leaves(params)[0].device
    return {
        "m": T.tree_map(zero_like, params),
        "v": T.tree_map(zero_like, params),   # stored sqrt-domain when 8bit
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _lr_at(cfg: AdamWConfig, count):
    warm = torch.clamp(count.to(F32) / max(cfg.warmup, 1), max=1.0)
    return cfg.lr * warm


def _global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in T.leaves(tree)))


def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step -> (new params, new state, {"grad_norm", "lr"})."""
    count = state["count"] + 1
    gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1c = 1.0 - cfg.b1 ** count.to(F32)
    b2c = 1.0 - cfg.b2 ** count.to(F32)
    lr = _lr_at(cfg, count)

    def upd(p, g, m, v):
        g = g.to(F32) * clip
        if cfg.eightbit:
            m_f = _dq8(m["q"], m["s"], p.shape)
            v_f = _dq8_sqrt(v["q"], v["s"], p.shape)
        else:
            m_f, v_f = m, v
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        step = (m_f / b1c) / (torch.sqrt(v_f / b2c) + cfg.eps)
        p32 = p.to(F32)
        new_p = p32 - lr * (step + cfg.weight_decay * p32)
        if cfg.eightbit:
            mq, ms = _q8(m_f)
            vq, vs = _q8_sqrt(v_f)
            return new_p.to(p.dtype), {"q": mq, "s": ms}, {"q": vq, "s": vs}
        return new_p.to(p.dtype), m_f, v_f

    flat_p = T.leaves(params)
    flat_g = T.leaves_up_to(params, grads)
    flat_m = T.leaves_up_to(params, state["m"])
    flat_v = T.leaves_up_to(params, state["v"])
    out = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = T.unflatten(params, [o[0] for o in out])
    new_m = T.unflatten(params, [o[1] for o in out])
    new_v = T.unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "count": count}, {
        "grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------


def compress_init(params):
    return T.tree_map(
        lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)


def compress_grads(grads, residual):
    """Quantise grads to int8 (+per-block scales); residual carries the
    quantisation error into the next step (error feedback)."""
    qs, new_r = [], []
    for g, r in zip(T.leaves(grads), T.leaves_up_to(grads, residual)):
        gf = g.to(F32) + r
        q, s = _q8(gf)
        qs.append({"q": q, "s": s})
        new_r.append(gf - _dq8(q, s, gf.shape))
    return T.unflatten(grads, qs), T.unflatten(grads, new_r)


def decompress_grads(comp, shapes_like):
    """``comp``'s {"q", "s"} leaves back to f32 tensors of the shapes of
    ``shapes_like``'s leaves."""
    flat_c = T.leaves_up_to(shapes_like, comp)
    out = [_dq8(c["q"], c["s"], s.shape)
           for c, s in zip(flat_c, T.leaves(shapes_like))]
    return T.unflatten(shapes_like, out)
