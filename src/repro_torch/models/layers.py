"""PyTorch layer library shared by all 10 architectures.

Port of ``repro.models.layers``, in the same functional style: ``init_*``
returns a dict of tensors, ``*_fwd`` are pure functions of tensors.
Attention is the reference's chunked online softmax (flash-style, in
plain tensor ops) so long prefills never materialise an (S, S) score
tensor. Compute dtype is bf16; params are stored f32.

Where the reference asks for ``preferred_element_type=float32`` the bf16
operands are widened to f32 before the product (a bf16 x bf16 product is
exact in f32), so the port accumulates in f32 as the reference does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

COMPUTE_DTYPE = torch.bfloat16
F32 = torch.float32


def _init(gen: torch.Generator, shape, scale=None):
    """N(0, 1) * scale, f32, on the generator's device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return torch.randn(shape, generator=gen, dtype=F32,
                       device=gen.device) * scale


def sigmoid(x):
    """``jax.nn.sigmoid`` as XLA computes it: 1 / (1 + exp(-x)), each step
    rounded to x's dtype (for bf16 that is what the reference's compiled
    code does; ``torch.sigmoid`` rounds once, a bf16 ulp away in ~30 % of
    outputs)."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * sigmoid(x)


def rmsnorm(x, gamma, eps: float):
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE sections)
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32,
                                         device=device) / hd))


def _rotate(x, ang):
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd), positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)      # (hd/2,)
    return _rotate(x, positions[..., None].to(F32) * freqs)


def apply_mrope(x, positions3, theta: float, sections=None):
    """M-RoPE (qwen2-vl): head_dim/2 frequencies split into (t, h, w)
    sections, each rotated by its own position stream.
    x: (B,S,H,hd), positions3: (B,S,3). Default split is qwen2-vl's
    (16, 24, 24) proportions (1/4, 3/8, 3/8) scaled to head_dim."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    if sections is None:
        half = hd // 2
        t = half // 4
        h = (half - t) // 2
        sections = (t, h, half - t - h)
    sec = np.asarray(sections)
    assert sec.sum() == hd // 2, "M-RoPE sections must cover head_dim/2"
    sec_id = torch.as_tensor(np.repeat(np.arange(3), sec), device=x.device)
    pos = positions3.to(F32)[:, :, sec_id]               # (B,S,hd/2)
    return _rotate(x, pos * freqs)


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention — no (S, S) materialisation
# ---------------------------------------------------------------------------


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None, q_chunk: int = 1024,
                      kv_chunk: int = 1024, unroll: bool = False):
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Skv, hd). GQA via head grouping.
    Online softmax over kv chunks for every q chunk. The reference maps
    its q chunks one by one (``lax.map``); they are independent, so the
    port steps all of them together through the kv chunks, each with its
    own positions and masks (the same arithmetic per element). ``unroll``
    (the reference's Python-loop mode, the same result) is accepted.
    `window`: sliding-window width (causal bands)."""
    b, hq, sq, hd = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    while sq % q_chunk:          # non-power-of-two seq: shrink to divide
        q_chunk //= 2
    while skv % kv_chunk:
        kv_chunk //= 2
    n_q, n_kv = sq // q_chunk, skv // kv_chunk
    # offset of q position 0 relative to kv position 0 (decode: skv - sq)
    q_off = skv - sq
    dev = q.device
    qb = q.reshape(b, hkv, group, n_q, q_chunk, hd).to(F32)
    q_pos = (q_off + torch.arange(sq, device=dev)).reshape(n_q, q_chunk)
    k32, v32 = k.to(F32), v.to(F32)
    acc = torch.zeros((b, hkv, group, n_q, q_chunk, hd), dtype=F32,
                      device=dev)
    m = torch.full((b, hkv, group, n_q, q_chunk), -math.inf, dtype=F32,
                   device=dev)
    denom = torch.zeros((b, hkv, group, n_q, q_chunk), dtype=F32,
                        device=dev)
    for ki in range(n_kv):
        kb = k32[:, :, ki * kv_chunk:(ki + 1) * kv_chunk]
        vb = v32[:, :, ki * kv_chunk:(ki + 1) * kv_chunk]
        s = torch.einsum("bkgnqd,bkcd->bkgnqc", qb, kb) * scale
        k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
        mask = torch.ones((n_q, q_chunk, kv_chunk), dtype=torch.bool,
                          device=dev)
        if causal:
            mask &= q_pos[..., None] >= k_pos
        if window is not None:
            mask &= q_pos[..., None] - k_pos < window
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.exp(torch.where(torch.isinf(m), 0.0, m) - m_safe)
        denom = denom * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgnqc,bkcd->bkgnqd", p.to(v.dtype).to(F32), vb)
        m = m_new
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, hd).to(v.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (init + fwd, train & decode)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_q: int
    n_kv: int
    hd: int
    qkv_bias: bool = False


def init_attention(gen: torch.Generator, dims: AttnDims):
    d, hd = dims.d_model, dims.hd
    p = {
        "wq": _init(gen, (d, dims.n_q * hd)),
        "wk": _init(gen, (d, dims.n_kv * hd)),
        "wv": _init(gen, (d, dims.n_kv * hd)),
        "wo": _init(gen, (dims.n_q * hd, d)),
    }
    if dims.qkv_bias:
        for name, n in (("bq", dims.n_q), ("bk", dims.n_kv),
                        ("bv", dims.n_kv)):
            p[name] = torch.zeros((n * hd,), dtype=F32, device=gen.device)
    return p


def _project_qkv(p, x, dims: AttnDims, positions, theta, mrope_pos=None):
    b, s, _ = x.shape
    cd = COMPUTE_DTYPE
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if dims.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = q.reshape(b, s, dims.n_q, dims.hd)
    k = k.reshape(b, s, dims.n_kv, dims.hd)
    v = v.reshape(b, s, dims.n_kv, dims.hd)
    if mrope_pos is not None:
        q = apply_mrope(q, mrope_pos, theta)
        k = apply_mrope(k, mrope_pos, theta)
    else:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def attention_fwd(p, x, dims: AttnDims, *, theta: float,
                  window: int | None = None, mrope_pos=None,
                  q_chunk: int = 1024, kv_chunk: int = 1024,
                  unroll: bool = False):
    """Training / prefill forward. x: (B, S, d) bf16."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, dims, positions, theta, mrope_pos)
    out = chunked_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
        unroll=unroll)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return (out @ p["wo"].to(COMPUTE_DTYPE)), (k, v)


def update_slot(cache, new, slot: int):
    """``lax.dynamic_update_slice_in_dim(cache, new, slot, 1)`` out of
    place: the start is clamped so that ``new`` fits, as XLA clamps it."""
    slot = min(max(int(slot), 0), cache.shape[1] - new.shape[1])
    out = cache.clone()
    out[:, slot:slot + new.shape[1]] = new
    return out


def attention_decode(p, x, cache_k, cache_v, pos: int, dims: AttnDims, *,
                     theta: float, rolling: bool = False, window=None):
    """One-token decode. x: (B, 1, d); cache: (B, S_cache, n_kv, hd);
    pos: the current position (an int).

    rolling=True: the cache is a circular buffer of width S_cache (uniform
    SWA archs); the buffer size IS the window. rolling=False: linear cache;
    `window` (>= 2^29 means global) masks older positions — used by mixed
    global/SWA stacks (hymba)."""
    b = x.shape[0]
    pos = int(pos)
    s_cache = cache_k.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, dims, positions, theta)
    slot = pos % s_cache if rolling else pos
    cache_k = update_slot(cache_k, k, slot)
    cache_v = update_slot(cache_v, v, slot)
    # scores over the cache; mask invalid (future / unwritten) slots
    qh = q.transpose(1, 2)                              # (B, nq, 1, hd)
    kh = cache_k.transpose(1, 2)
    vh = cache_v.transpose(1, 2)
    group = dims.n_q // dims.n_kv
    qh = qh.reshape(b, dims.n_kv, group, 1, dims.hd)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qh.to(F32),
                     kh.to(F32)) / math.sqrt(dims.hd)
    idx = torch.arange(s_cache, device=x.device)
    if rolling:
        valid = (idx <= pos) | (pos >= s_cache)
    else:
        valid = idx <= pos
        if window is not None:
            valid &= (pos - idx) < window
    s = torch.where(valid, s, -math.inf)
    pweights = torch.softmax(s, dim=-1).to(vh.dtype)
    out = torch.einsum("bkgqc,bkcd->bkgqd", pweights.to(F32), vh.to(F32))
    out = out.reshape(b, dims.n_q, 1, dims.hd).transpose(1, 2)
    out = out.reshape(b, 1, -1).to(COMPUTE_DTYPE)
    return out @ p["wo"].to(COMPUTE_DTYPE), cache_k, cache_v


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int):
    return {
        "wi": _init(gen, (d_model, d_ff)),
        "wg": _init(gen, (d_model, d_ff)),
        "wo": _init(gen, (d_ff, d_model)),
    }


def mlp_fwd(p, x):
    cd = COMPUTE_DTYPE
    h = silu(x @ p["wg"].to(cd)) * (x @ p["wi"].to(cd))
    return h @ p["wo"].to(cd)


# ---------------------------------------------------------------------------
# Embedding / logits (vocab-parallel-friendly shapes)
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   tie: bool):
    p = {"tok": _init(gen, (vocab, d_model), scale=0.02)}
    if not tie:
        p["unembed"] = _init(gen, (d_model, vocab))
    return p


def embed(p, tokens):
    return p["tok"][tokens].to(COMPUTE_DTYPE)


def logits(p, x, tie: bool):
    w = p["tok"].T if tie else p["unembed"]
    return x @ w.to(COMPUTE_DTYPE)
