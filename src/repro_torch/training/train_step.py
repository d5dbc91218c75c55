"""Train-step factory: autograd + microbatch accumulation + AdamW.

Port of ``repro.training.train_step``. ``build_train_step(cfg)`` returns
    (params, opt_state, batch, residual) -> (params, opt_state, metrics,
                                             residual)
on plain tensors of one device; ``metrics`` = {"loss", "grad_norm", "lr"},
0-d f32 tensors on that device.

Gradients are ``torch.autograd.grad`` of ``models.model.train_fwd`` over
the parameter leaves in the reference's order; a leaf the loss does not
reach gets a zero gradient (``jax.value_and_grad`` gives zeros there).
Microbatching: the global batch is split into ``n_micro`` slices run one
after the other (the reference's ``lax.scan``); gradients accumulate in
f32, the loss in f32 from 0, both divided by ``n_micro`` at the end. With
int8 gradient compression the accumulated gradient is quantised (error
feedback residual carried across steps) before the optimizer.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.training import optimizer as opt
from repro_torch.training import tree as T

F32 = torch.float32


def _split_micro(batch, n_micro: int):
    def sp(x):
        b = x.shape[0]
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])
    return {k: sp(v) for k, v in batch.items()}


def loss_fn(params, batch, cfg: ArchConfig, tp: int,
            q_chunk: int, kv_chunk: int):
    return M.train_fwd(params, batch, cfg, tp=tp,
                       q_chunk=q_chunk, kv_chunk=kv_chunk)


def value_and_grad(params, batch, cfg: ArchConfig, tp: int = 1,
                   q_chunk: int = 1024, kv_chunk: int = 1024):
    """(loss, grads): the loss detached, grads a tree of ``params``'s
    structure (zeros where the loss does not reach a leaf)."""
    flat = T.leaves(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    loss = loss_fn(T.unflatten(params, leaves), batch, cfg, tp,
                   q_chunk, kv_chunk)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), T.unflatten(params, grads)


def build_train_step(cfg: ArchConfig, adam: opt.AdamWConfig | None = None,
                     tp: int = 1, n_micro: int = 1,
                     compress: bool = False,
                     q_chunk: int = 1024, kv_chunk: int = 1024):
    adam = adam or opt.AdamWConfig()

    def grad_fn(params, batch):
        return value_and_grad(params, batch, cfg, tp, q_chunk, kv_chunk)

    def step(params, opt_state, batch, residual=None):
        if n_micro > 1:
            micro = _split_micro(batch, n_micro)
            flat_p = T.leaves(params)
            g_acc = [torch.zeros(p.shape, dtype=F32, device=p.device)
                     for p in flat_p]
            loss = torch.zeros((), dtype=F32, device=flat_p[0].device)
            for i in range(n_micro):
                l, g = grad_fn(params, {k: v[i] for k, v in micro.items()})
                for a, b in zip(g_acc, T.leaves_up_to(params, g)):
                    a.add_(b.to(F32))
                loss = loss + l
                del g
            grads = T.unflatten(params, [g / n_micro for g in g_acc])
            del g_acc
            loss = loss / n_micro
        else:
            loss, grads = grad_fn(params, batch)

        if compress and residual is not None:
            comp, residual = opt.compress_grads(grads, residual)
            grads = opt.decompress_grads(comp, params)

        params, opt_state, om = opt.adamw_update(params, grads, opt_state,
                                                 adam)
        metrics = {"loss": loss, **om}
        return params, opt_state, metrics, residual

    return step


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     adam: opt.AdamWConfig | None = None, tp: int = 1,
                     compress: bool = False, *, device=None):
    """Random params from ``generator`` on ``device`` (the card when None;
    raises without CUDA), zero AdamW state, and a zero compression
    residual when ``compress``."""
    adam = adam or opt.AdamWConfig()
    params = M.init_params(cfg, generator, tp=tp, device=device)
    opt_state = opt.adamw_init(params, adam)
    residual = opt.compress_init(params) if compress else None
    return params, opt_state, residual
