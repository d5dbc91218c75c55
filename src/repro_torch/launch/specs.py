"""Shape-and-dtype input specs for every (arch x shape) dry-run cell.

Port of ``repro.launch.specs``. No allocation anywhere: params, optimizer
state, batches and caches are ``models.model.TensorSpec`` stand-ins (the
reference's ``jax.ShapeDtypeStruct``), made by running the port's own
initialisers (``init_params``, ``adamw_init``) under
``torch._subclasses.fake_tensor.FakeTensorMode`` with a CPU generator — the
counterpart of ``jax.eval_shape`` — so even the 671B-parameter deepseek
cell takes seconds on a CPU and holds no memory.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.shapes import SHAPES, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import TensorSpec
from repro_torch.training import optimizer as opt
from repro_torch.training import tree as T


def _specs(tree):
    """A tree of (fake) tensors -> the same tree of ``TensorSpec``s."""
    return T.tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), tree)


def _fake_params(cfg: ArchConfig, tp: int):
    return M.init_params(cfg, torch.Generator(), tp=tp, device="cpu")


def param_specs(cfg: ArchConfig, tp: int):
    with FakeTensorMode():
        return _specs(_fake_params(cfg, tp))


def opt_specs(cfg: ArchConfig, tp: int, adam: opt.AdamWConfig):
    with FakeTensorMode():
        return _specs(opt.adamw_init(_fake_params(cfg, tp), adam))


def batch_specs(cfg: ArchConfig, shape: ShapeConfig):
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        s_in = 1
    else:
        s_in = s
    out = {"labels": TensorSpec((b, s_in), torch.int32)}
    if cfg.frontend:
        out["embeds"] = TensorSpec((b, s_in, cfg.d_model), torch.float32)
    else:
        out["tokens"] = TensorSpec((b, s_in), torch.int32)
    if cfg.mrope:
        out["mrope_pos"] = TensorSpec((b, s_in, 3), torch.int32)
    if shape.kind == "decode":
        out.pop("labels")
    return out


def input_specs(cfg: ArchConfig, shape_name: str, tp: int,
                adam: opt.AdamWConfig | None = None):
    """Everything a cell's step needs.

    train:   (params, opt_state, batch)
    prefill: (params, batch)
    decode:  (params, cache, batch, pos)
    """
    shape = SHAPES[shape_name]
    adam = adam or opt.AdamWConfig()
    params = param_specs(cfg, tp)
    batch = batch_specs(cfg, shape)
    if shape.kind == "train":
        return {"params": params,
                "opt_state": opt_specs(cfg, tp, adam),
                "batch": batch}
    if shape.kind == "prefill":
        return {"params": params, "batch": batch}
    cache = M.cache_spec(cfg, shape.global_batch, shape.seq_len, tp)
    return {"params": params, "cache": cache, "batch": batch,
            "pos": TensorSpec((), torch.int32)}
