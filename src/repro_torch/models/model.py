"""Unified decoder-only model covering all 10 assigned architectures.

Port of ``repro.models.model``. Params are the reference's nested dict:
layers stacked along a leading L dim, the same keys, plain tensors on one
device. The layer loop is a Python loop over that dim (the reference's
``lax.scan``; its ``unroll`` mode is the same loop, so ``unroll`` is
accepted and gives the same result); each stacked leaf is unbound once a
call, so a backward stacks the layers' gradients once rather than writing
a stack-sized zero gradient per layer. Heterogeneous per-layer attention
windows (hymba's global/SWA mix) are a per-layer int.

Three entry points per architecture:
  * ``train_fwd``   — full-sequence forward -> scalar loss (chunked CE),
                      differentiable with ``torch.autograd``; ``remat``
                      recomputes each layer in the backward (the
                      reference's ``jax.checkpoint`` of the layer body).
  * ``prefill``     — full-sequence forward -> (last_logits, Cache).
  * ``decode_step`` — one token with a pre-filled cache (the serve_step).

``init_params`` draws from an explicit ``torch.Generator`` (it cannot
reproduce JAX's threefry draws); ``params_from_numpy`` carries the JAX
package's params over key for key, which is how the port is held against
the reference. Every entry point runs on the card unless the caller
passes ``device='cpu'``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig, SSMConfig
from repro_torch.models.layers import COMPUTE_DTYPE, F32

GLOBAL_WINDOW = 1 << 30       # the window of a global layer


# ---------------------------------------------------------------------------
# Cache container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cache:
    """Per-family decode state; all leaves have leading (L, B, ...) dims."""
    k: Any = None          # (L, B, S_c, n_kv, hd)
    v: Any = None
    mla_c: Any = None      # (L, B, S_c, r)
    mla_kr: Any = None     # (L, B, S_c, rd)
    ssm_state: Any = None  # (L, B, H, hd, ds)
    ssm_conv: Any = None   # (L, B, W-1, C)


FIELDS = tuple(f.name for f in dataclasses.fields(Cache))


class TensorSpec(NamedTuple):
    """Shape and dtype of a cache leaf (the reference's ShapeDtypeStruct)."""
    shape: tuple
    dtype: torch.dtype


def _rolling(cfg: ArchConfig) -> bool:
    """Uniform-SWA archs keep a circular KV buffer of width `window`."""
    return cfg.sliding_window is not None and cfg.swa_every == 1


def _eff_cache_len(cfg: ArchConfig, cache_len: int) -> int:
    return (min(cache_len, cfg.sliding_window) if _rolling(cfg)
            else cache_len)


def cache_spec(cfg: ArchConfig, batch: int, cache_len: int, tp: int,
               dtype=COMPUTE_DTYPE) -> Cache:
    """``TensorSpec``s of the decode cache (None where the family has no
    such leaf)."""
    nl = cfg.n_layers
    out = {}
    eff_len = _eff_cache_len(cfg, cache_len)
    if cfg.family in ("dense", "hybrid", "audio", "vlm", "moe"):
        if cfg.mla:
            m = cfg.mla
            out["mla_c"] = TensorSpec(
                (nl, batch, cache_len, m.kv_lora_rank), dtype)
            out["mla_kr"] = TensorSpec(
                (nl, batch, cache_len, m.rope_head_dim), dtype)
        else:
            nq, nkv = cfg.padded_heads(tp)
            out["k"] = TensorSpec((nl, batch, eff_len, nkv, cfg.hd), dtype)
            out["v"] = TensorSpec((nl, batch, eff_len, nkv, cfg.hd), dtype)
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm or SSMConfig()
        d_in = s.expand * cfg.d_model
        nh = d_in // s.head_dim
        out["ssm_state"] = TensorSpec(
            (nl, batch, nh, s.head_dim, s.d_state), F32)
        out["ssm_conv"] = TensorSpec(
            (nl, batch, s.conv_width - 1, d_in + 2 * s.d_state), dtype)
    return Cache(**{name: out.get(name) for name in FIELDS})


def zeros_cache(spec: Cache, device) -> Cache:
    """A cache of zeros on ``device`` from ``cache_spec``."""
    return Cache(**{
        name: None if sd is None else torch.zeros(sd.shape, dtype=sd.dtype,
                                                  device=device)
        for name, sd in ((n, getattr(spec, n)) for n in FIELDS)})


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _layer_windows(cfg: ArchConfig) -> np.ndarray:
    """Per-layer attention window, -1 = global."""
    w = np.full(cfg.n_layers, -1, np.int32)
    if cfg.sliding_window is not None:
        w[:] = cfg.sliding_window
        if cfg.swa_every > 1:          # every k-th layer global (hymba style)
            w[:: cfg.swa_every] = -1
    return w


def _window(win) -> int:
    """A layer's window as the layer body takes it: -1 -> global."""
    return GLOBAL_WINDOW if win < 0 else int(win)


def _init_one_layer(cfg: ArchConfig, tp: int, gen: torch.Generator):
    d = cfg.d_model
    dev = gen.device
    p = {"ln1": torch.ones((d,), dtype=F32, device=dev),
         "ln2": torch.ones((d,), dtype=F32, device=dev)}
    if cfg.family != "ssm":
        if cfg.mla:
            p["attn"] = mla_mod.init_mla(gen, d, cfg.n_heads, cfg.mla)
        else:
            nq, nkv = cfg.padded_heads(tp)
            dims = L.AttnDims(d, nq, nkv, cfg.hd, cfg.qkv_bias)
            p["attn"] = L.init_attention(gen, dims)
    if cfg.family in ("ssm", "hybrid"):
        p["ssm"] = ssm_mod.init_ssm(gen, d, cfg.ssm or SSMConfig())
    if cfg.moe:
        p["moe"] = moe_mod.init_moe(gen, d, cfg.moe, cfg.d_ff)
    elif cfg.d_ff and cfg.family != "ssm":
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff)
    return p


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over nested dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def init_params(cfg: ArchConfig, generator: torch.Generator, tp: int = 1,
                *, device=None):
    """Random params from ``generator``, on ``device`` (the card when
    None; the generator must live on that device)."""
    dev = resolve_device(device, "init_params")
    if generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"params go to {dev}")
    layers = []
    for _ in range(cfg.n_layers):
        layers.append(_init_one_layer(cfg, tp, generator))
    stacked = tree_map(lambda *xs: torch.stack(xs), *layers)
    del layers
    params = {
        "layers": stacked,
        "embed": L.init_embedding(generator, cfg.padded_vocab(tp),
                                  cfg.d_model, cfg.tie_embeddings),
        "ln_f": torch.ones((cfg.d_model,), dtype=F32, device=dev),
    }
    if cfg.mtp_heads:
        params["mtp"] = _init_one_layer(cfg, tp, generator)
    return params


def params_from_numpy(tree, *, device=None):
    """The JAX package's params as numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> the port's params, key for
    key, dtypes kept, on ``device`` (the card when None)."""
    dev = resolve_device(device, "params_from_numpy")
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


# ---------------------------------------------------------------------------
# Layer forward (shared by train / prefill; the loop body)
# ---------------------------------------------------------------------------


def _block_fwd(cfg: ArchConfig, tp: int, p, x, window: int, mrope_pos,
               q_chunk, kv_chunk, collect_cache: bool,
               unroll: bool = False):
    """One block. Returns (x_out, aux_loss, cache_pieces)."""
    d = cfg.d_model
    aux = torch.zeros((), dtype=F32, device=x.device)
    pieces = {}
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    mix = None
    if cfg.family != "ssm" and not cfg.mla:
        nq, nkv = cfg.padded_heads(tp)
        dims = L.AttnDims(d, nq, nkv, cfg.hd, cfg.qkv_bias)
        attn_out, (k, v) = L.attention_fwd(
            p["attn"], h, dims, theta=cfg.rope_theta,
            window=window, mrope_pos=mrope_pos,
            q_chunk=q_chunk, kv_chunk=kv_chunk, unroll=unroll)
        mix = attn_out
        if collect_cache:
            pieces["k"], pieces["v"] = k, v
    elif cfg.mla:
        attn_out, (c_kv, kr) = mla_mod.mla_fwd(
            p["attn"], h, cfg.n_heads, cfg.mla, theta=cfg.rope_theta,
            q_chunk=q_chunk, kv_chunk=kv_chunk, unroll=unroll)
        mix = attn_out
        if collect_cache:
            pieces["mla_c"], pieces["mla_kr"] = c_kv, kr
    if cfg.family in ("ssm", "hybrid"):
        ssm_out, (state, conv) = ssm_mod.ssm_fwd(
            p["ssm"], h, cfg.ssm or SSMConfig(), d, unroll=unroll)
        if collect_cache:
            pieces["ssm_state"], pieces["ssm_conv"] = state, conv
        mix = ssm_out if mix is None else 0.5 * (mix + ssm_out)
    x = x + mix
    if cfg.moe:
        h2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        moe_out, aux = moe_mod.moe_fwd(p["moe"], h2, cfg.moe)
        x = x + moe_out
    elif "mlp" in p:
        h2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + L.mlp_fwd(p["mlp"], h2)
    return x, aux, pieces


def _layer(params, i: int):
    return tree_map(lambda a: a[i], params["layers"])


def _layers(params, n_layers: int) -> list:
    """Each layer's params: every stacked leaf unbound once."""
    unbound = tree_map(torch.unbind, params["layers"])
    return [tree_map(lambda t: t[i], unbound) for i in range(n_layers)]


def _run_layers(cfg: ArchConfig, tp: int, params, x, mrope_pos,
                q_chunk, kv_chunk, collect_cache: bool, remat: bool,
                unroll: bool = False):
    """The layer loop. With ``remat`` and autograd on, each layer body
    runs under ``torch.utils.checkpoint``: its activations are recomputed
    in the backward instead of kept (the reference's ``jax.checkpoint``);
    the values are the same either way."""
    windows = _layer_windows(cfg)
    aux = torch.zeros((), dtype=F32, device=x.device)
    pieces_list = []
    remat = remat and torch.is_grad_enabled()
    for i, lp in enumerate(_layers(params, cfg.n_layers)):
        args = (cfg, tp, lp, x, _window(windows[i]), mrope_pos,
                q_chunk, kv_chunk, collect_cache, unroll)
        if remat:
            x, aux_i, pieces = checkpoint(_block_fwd, *args,
                                          use_reentrant=False,
                                          preserve_rng_state=False)
        else:
            x, aux_i, pieces = _block_fwd(*args)
        aux = aux + aux_i
        pieces_list.append(pieces)
    stacked = (tree_map(lambda *xs: torch.stack(xs), *pieces_list)
               if pieces_list and pieces_list[0] else {})
    return x, aux, stacked


def _chunked_ce(x, params, cfg: ArchConfig, labels, tp: int,
                s_chunk: int = 512, unroll: bool = False):
    """Cross-entropy without materialising (B, S, V): a loop over S
    chunks. Padded vocab columns are masked to -1e9."""
    b, s, d = x.shape
    vpad = cfg.padded_vocab(tp)
    s_chunk = min(s_chunk, s)
    n_chunk = s // s_chunk
    vmask = torch.arange(vpad, device=x.device) < cfg.vocab
    bias = torch.where(vmask, 0.0, -1e9)

    xc = x.reshape(b, n_chunk, s_chunk, d).transpose(0, 1)
    lc = labels.reshape(b, n_chunk, s_chunk).transpose(0, 1)
    losses = []
    for i in range(n_chunk):
        lg = L.logits(params["embed"], xc[i], cfg.tie_embeddings)
        lg = lg.to(F32) + bias
        lse = torch.logsumexp(lg, dim=-1)
        tgt = torch.gather(lg, -1, lc[i][..., None].long())[..., 0]
        losses.append((lse - tgt).sum())
    return torch.stack(losses).sum() / (b * s)


def _inputs(params, batch, cfg: ArchConfig):
    if cfg.frontend:
        return batch["embeds"].to(COMPUTE_DTYPE)
    return L.embed(params["embed"], batch["tokens"])


def train_fwd(params, batch, cfg: ArchConfig, tp: int = 1,
              q_chunk: int = 1024, kv_chunk: int = 1024,
              remat: bool = True, unroll: bool = False):
    """batch: tokens/labels (B, S) int; audio/vlm: embeds (B, S, d).
    Returns the scalar loss (CE + MoE aux [+ MTP CE])."""
    x = _inputs(params, batch, cfg)
    mrope_pos = batch.get("mrope_pos") if cfg.mrope else None
    x, aux, _ = _run_layers(cfg, tp, params, x, mrope_pos,
                            q_chunk, kv_chunk, False, remat, unroll=unroll)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    loss = _chunked_ce(x, params, cfg, batch["labels"], tp, unroll=unroll)
    if cfg.mtp_heads and "mtp" in params:
        # one-step MTP head (deepseek): extra block over shifted stream
        xm, _, _ = _block_fwd(cfg, tp, params["mtp"], x, GLOBAL_WINDOW,
                              mrope_pos, q_chunk, kv_chunk, False,
                              unroll=unroll)
        xm = L.rmsnorm(xm, params["ln_f"], cfg.norm_eps)
        mtp_labels = torch.roll(batch["labels"], -1, dims=-1)
        loss = loss + 0.3 * _chunked_ce(xm, params, cfg, mtp_labels, tp,
                                        unroll=unroll)
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def prefill(params, batch, cfg: ArchConfig, cache_len: int, tp: int = 1,
            q_chunk: int = 1024, kv_chunk: int = 1024,
            unroll: bool = False):
    """Full-sequence forward; returns (last-position logits, Cache)."""
    x = _inputs(params, batch, cfg)
    mrope_pos = batch.get("mrope_pos") if cfg.mrope else None
    x, _, pieces = _run_layers(cfg, tp, params, x, mrope_pos,
                               q_chunk, kv_chunk, True, False,
                               unroll=unroll)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    lg = L.logits(params["embed"], x[:, -1:], cfg.tie_embeddings)

    cache = Cache()
    s = x.shape[1]
    eff_len = _eff_cache_len(cfg, cache_len)
    for name in ("k", "v", "mla_c", "mla_kr"):
        if name in pieces:
            arr = pieces[name]
            pad_len = eff_len - arr.shape[2]
            if pad_len > 0:
                pad = [0, 0] * (arr.ndim - 3) + [0, pad_len]
                arr = F.pad(arr, pad)
            else:
                arr = arr[:, :, arr.shape[2] - eff_len:]
                if _rolling(cfg):
                    # align entries so slot(p) = p mod window for decode
                    arr = torch.roll(arr, s % eff_len, dims=2)
            setattr(cache, name, arr.to(COMPUTE_DTYPE))
    if "ssm_state" in pieces:
        cache.ssm_state = pieces["ssm_state"]
        cache.ssm_conv = pieces["ssm_conv"].to(COMPUTE_DTYPE)
    return lg, cache


def decode_step(params, cache: Cache, batch, pos: int, cfg: ArchConfig,
                tp: int = 1, unroll: bool = False):
    """One-token decode. batch: tokens (B, 1) or embeds (B, 1, d);
    pos: the position (an int). Returns (logits, new Cache); ``cache`` is
    left as it was."""
    x = _inputs(params, batch, cfg)
    pos = int(pos)
    windows = _layer_windows(cfg)
    d = cfg.d_model
    new = {name: [] for name in FIELDS}
    for i, lp in enumerate(_layers(params, cfg.n_layers)):
        c = {name: None if getattr(cache, name) is None
             else getattr(cache, name)[i] for name in FIELDS}
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        mix = None
        if cfg.family != "ssm" and not cfg.mla:
            nq, nkv = cfg.padded_heads(tp)
            dims = L.AttnDims(d, nq, nkv, cfg.hd, cfg.qkv_bias)
            mix, c["k"], c["v"] = L.attention_decode(
                lp["attn"], h, c["k"], c["v"], pos, dims,
                theta=cfg.rope_theta, rolling=_rolling(cfg),
                window=_window(windows[i]))
        elif cfg.mla:
            mix, c["mla_c"], c["mla_kr"] = mla_mod.mla_decode(
                lp["attn"], h, c["mla_c"], c["mla_kr"], pos, cfg.n_heads,
                cfg.mla, theta=cfg.rope_theta)
        if cfg.family in ("ssm", "hybrid"):
            ssm_out, c["ssm_state"], c["ssm_conv"] = ssm_mod.ssm_decode(
                lp["ssm"], h, c["ssm_state"], c["ssm_conv"],
                cfg.ssm or SSMConfig(), d)
            mix = ssm_out if mix is None else 0.5 * (mix + ssm_out)
        x = x + mix
        if cfg.moe:
            h2 = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
            moe_out, _ = moe_mod.moe_fwd(lp["moe"], h2, cfg.moe)
            x = x + moe_out
        elif "mlp" in lp:
            h2 = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
            x = x + L.mlp_fwd(lp["mlp"], h2)
        for name in FIELDS:
            new[name].append(c[name])
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    lg = L.logits(params["embed"], x, cfg.tie_embeddings)
    return lg, Cache(**{
        name: None if getattr(cache, name) is None
        else torch.stack(new[name]) for name in FIELDS})
