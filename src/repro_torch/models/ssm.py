"""Mamba2 SSD (state-space duality) block, chunked.

Port of ``repro.models.ssm``. Follows arXiv:2405.21060's SSD formulation:
the selective SSM with scalar per-head decay A is computed chunk-parallel
— quadratic attention-like within a chunk, linear recurrence across chunk
boundaries (a loop over chunks). Decode is the O(1) single-step recurrence
on the (B, H, hd, ds) state.

The depthwise causal conv (width 4) and gated output norm follow the
reference architecture. The dtypes are the reference's: cumulative decays
in f32, the -1e30 mask before ``exp``, f32 accumulation of every product,
and ``PERF['ssd_bf16']`` / ``PERF['ssd_chunk']`` as its switches.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import SSMConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, F32, _init, rmsnorm,
                                       silu)
from repro_torch.models.tuning import PERF, wsc


def init_ssm(gen: torch.Generator, d_model: int, cfg: SSMConfig):
    d_in = cfg.expand * d_model
    nh = d_in // cfg.head_dim
    dev = gen.device
    return {
        # fused input projection: [z (gate), x, B, C, dt]
        "w_in": _init(gen, (d_model, 2 * d_in + 2 * cfg.d_state + nh)),
        "conv": _init(gen, (cfg.conv_width, d_in + 2 * cfg.d_state),
                      scale=0.5),
        "a_log": torch.zeros((nh,), dtype=F32, device=dev),
        "d_skip": torch.ones((nh,), dtype=F32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=F32, device=dev),
        "norm_g": torch.ones((d_in,), dtype=F32, device=dev),
        "w_out": _init(gen, (d_in, d_model)),
    }


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(p, x, cfg: SSMConfig, d_model: int):
    d_in = cfg.expand * d_model
    nh = d_in // cfg.head_dim
    zxbcdt = x @ p["w_in"].to(COMPUTE_DTYPE)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in: 2 * d_in + 2 * cfg.d_state]
    dt = zxbcdt[..., 2 * d_in + 2 * cfg.d_state:]
    dt = softplus(dt.to(F32) + p["dt_bias"])              # (B,S,nh)
    return z, xbc, dt, d_in, nh


def _causal_conv(xbc, conv_w, cache=None):
    """Depthwise causal conv. xbc: (B, S, C); conv_w: (W, C).
    cache: (B, W-1, C) trailing context for decode."""
    w = conv_w.shape[0]
    if cache is None:
        pad = torch.zeros_like(xbc[:, : w - 1])
    else:
        pad = cache.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    out = 0        # Python's sum: one bf16 rounding an add, in tap order
    for i in range(w):
        out = out + xp[:, i: i + xbc.shape[1]] * conv_w[i].to(xbc.dtype)
    new_cache = xp[:, -(w - 1):]
    return silu(out), new_cache


def ssd_chunked(xh, dt, bmat, cmat, a_log, chunk: int,
                unroll: bool = False):
    """SSD scan. xh: (B,S,H,hd); dt: (B,S,H); bmat/cmat: (B,S,ds).
    Returns (B,S,H,hd) and final state (B,H,hd,ds). The cross-chunk
    recurrence is a loop over chunks (``unroll`` is accepted: the
    reference's scan and its unrolled loop give the same result)."""
    b, s, h, hd = xh.shape
    ds = bmat.shape[-1]
    if PERF["ssd_chunk"]:
        chunk = min(PERF["ssd_chunk"], chunk)
        while s % chunk:
            chunk //= 2
    nc = s // chunk
    cdt = torch.bfloat16 if PERF["ssd_bf16"] else F32
    a = -torch.exp(a_log)                                 # (H,) negative
    # discretised decay per step: da = dt * a  (log-space)
    da = dt * a                                           # (B,S,H)
    xs = (xh * dt[..., None]).to(cdt)                     # input * dt

    xc = wsc(xs.reshape(b, nc, chunk, h, hd), "data")
    dac = da.reshape(b, nc, chunk, h)
    bc = wsc(bmat.reshape(b, nc, chunk, ds).to(cdt), "data")
    cc = wsc(cmat.reshape(b, nc, chunk, ds).to(cdt), "data")

    cum = torch.cumsum(dac, dim=2)                        # (B,nc,C,H)
    seg_total = cum[:, :, -1]                             # (B,nc,H)

    # intra-chunk (quadratic): L[i,j] = exp(cum_i - cum_j) for i >= j.
    # Mask BEFORE exp (the reference's choice: -1e30 underflows to a clean
    # 0 where the unmasked exponent would overflow).
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,C,C,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    li = torch.where(mask[:, :, None], li, -1e30)
    lmat = wsc(torch.exp(li).to(cdt), "data")
    scores = torch.einsum("bnis,bnjs->bnij", cc.to(F32),
                          bc.to(F32)).to(cdt)
    intra = wsc(torch.einsum("bnij,bnijh,bnjhd->bnihd", scores.to(F32),
                             lmat.to(F32), xc.to(F32)), "data")

    # chunk-state contribution: state_n = sum_j exp(total - cum_j) B_j x_j
    decay_in = torch.exp(seg_total[:, :, None] - cum).to(cdt)
    chunk_states = torch.einsum("bnjs,bnjh,bnjhd->bnhds", bc.to(F32),
                                decay_in.to(F32), xc.to(F32))

    state = torch.zeros((b, h, hd, ds), dtype=F32, device=xh.device)
    prevs = []
    for i in range(nc):                                   # emit PREVIOUS
        prevs.append(state)
        state = (state * torch.exp(seg_total[:, i])[:, :, None, None]
                 + chunk_states[:, i])
    prev_states = torch.stack(prevs, dim=1)               # (B,nc,H,hd,ds)

    # inter-chunk: y_i += C_i exp(cum_i) state_prev
    decay_out = torch.exp(cum)                            # (B,nc,C,H)
    inter = torch.einsum("bnis,bnih,bnhds->bnihd", cc.to(F32), decay_out,
                         prev_states)
    y = (intra + inter).reshape(b, s, h, hd)
    return y, state


def ssm_fwd(p, x, cfg: SSMConfig, d_model: int, unroll: bool = False):
    """Training/prefill. x: (B,S,d). Returns (out, (state, conv_cache))."""
    cd = COMPUTE_DTYPE
    b, s, _ = x.shape
    z, xbc, dt, d_in, nh = _split_proj(p, x, cfg, d_model)
    xbc, conv_cache = _causal_conv(xbc, p["conv"])
    xh = xbc[..., :d_in].reshape(b, s, nh, cfg.head_dim)
    bmat = xbc[..., d_in: d_in + cfg.d_state]
    cmat = xbc[..., d_in + cfg.d_state:]
    chunk = min(cfg.chunk, s)
    while s % chunk:             # non-power-of-two seq: shrink to divide
        chunk //= 2
    chunk = max(chunk, 1)
    y, state = ssd_chunked(xh, dt, bmat, cmat, p["a_log"], chunk,
                           unroll=unroll)
    y = y + xh.to(F32) * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, d_in).to(cd)
    y = rmsnorm(y * silu(z), p["norm_g"], 1e-5)
    return y @ p["w_out"].to(cd), (state, conv_cache)


def ssm_decode(p, x, state, conv_cache, cfg: SSMConfig, d_model: int):
    """O(1) decode step. state: (B,H,hd,ds); conv_cache: (B,W-1,C)."""
    cd = COMPUTE_DTYPE
    b = x.shape[0]
    z, xbc, dt, d_in, nh = _split_proj(p, x, cfg, d_model)
    xbc, conv_cache = _causal_conv(xbc, p["conv"], cache=conv_cache)
    xh = xbc[..., :d_in].reshape(b, 1, nh, cfg.head_dim)
    bmat = xbc[..., d_in: d_in + cfg.d_state].to(F32)
    cmat = xbc[..., d_in + cfg.d_state:].to(F32)
    a = -torch.exp(p["a_log"])
    da = dt[:, 0] * a                                      # (B,H)
    xs = (xh[:, 0] * dt[:, 0, :, None]).to(F32)            # (B,H,hd)
    state = (state * torch.exp(da)[:, :, None, None]
             + torch.einsum("bs,bhd->bhds", bmat[:, 0], xs))
    y = torch.einsum("bs,bhds->bhd", cmat[:, 0], state)
    y = y + xh[:, 0].to(F32) * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, d_in).to(cd)
    y = rmsnorm(y * silu(z), p["norm_g"], 1e-5)
    return y @ p["w_out"].to(cd), state, conv_cache
