"""DeepSeek-V3 Multi-head Latent Attention (MLA).

Port of ``repro.models.mla``. KV state is compressed into a per-token
latent c_kv (kv_lora_rank) plus a shared rope key (rope_head_dim); at
decode time only (latent, k_rope) is cached — 576 floats/token instead of
n_heads * 2 * head_dim. Queries are low-rank too (q_lora_rank). Prefill
decompresses the latent into per-head keys/values; decode keeps the cache
compressed and absorbs the decompression into the query/output
projections (the standard MLA inference absorption).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import MLAConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, F32, _init, apply_rope,
                                       chunked_attention, update_slot)


def init_mla(gen: torch.Generator, d_model: int, n_heads: int,
             cfg: MLAConfig):
    qd = cfg.nope_head_dim + cfg.rope_head_dim
    return {
        "wq_a": _init(gen, (d_model, cfg.q_lora_rank)),
        "wq_b": _init(gen, (cfg.q_lora_rank, n_heads * qd)),
        "wkv_a": _init(gen, (d_model, cfg.kv_lora_rank + cfg.rope_head_dim)),
        "wk_b": _init(gen, (cfg.kv_lora_rank, n_heads * cfg.nope_head_dim)),
        "wv_b": _init(gen, (cfg.kv_lora_rank, n_heads * cfg.v_head_dim)),
        "wo": _init(gen, (n_heads * cfg.v_head_dim, d_model)),
    }


def _latent(p, x, cfg: MLAConfig, positions, theta):
    """x -> (c_kv latent (B,S,r), k_rope (B,S,1,rd))."""
    kv_a = x @ p["wkv_a"].to(COMPUTE_DTYPE)             # (B,S,r+rd)
    c_kv = kv_a[..., : cfg.kv_lora_rank]
    k_rope = kv_a[..., cfg.kv_lora_rank:][:, :, None, :]
    k_rope = apply_rope(k_rope, positions, theta)
    return c_kv, k_rope


def _queries(p, x, n_heads, cfg: MLAConfig, positions, theta):
    cd = COMPUTE_DTYPE
    b, s, _ = x.shape
    q = (x @ p["wq_a"].to(cd)) @ p["wq_b"].to(cd)
    q = q.reshape(b, s, n_heads, cfg.nope_head_dim + cfg.rope_head_dim)
    q_nope = q[..., : cfg.nope_head_dim]
    q_rope = apply_rope(q[..., cfg.nope_head_dim:], positions, theta)
    return q_nope, q_rope


def mla_fwd(p, x, n_heads: int, cfg: MLAConfig, *, theta: float,
            q_chunk: int = 1024, kv_chunk: int = 1024,
            unroll: bool = False):
    """Training/prefill path: decompress latent into per-head K/V and run
    chunked attention. Returns (out, (c_kv, k_rope)) for cache priming."""
    cd = COMPUTE_DTYPE
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    c_kv, k_rope = _latent(p, x, cfg, positions, theta)
    q_nope, q_rope = _queries(p, x, n_heads, cfg, positions, theta)

    k_nope = (c_kv @ p["wk_b"].to(cd)).reshape(
        b, s, n_heads, cfg.nope_head_dim)
    v = (c_kv @ p["wv_b"].to(cd)).reshape(b, s, n_heads, cfg.v_head_dim)
    k = torch.cat(
        [k_nope, k_rope.expand(b, s, n_heads, cfg.rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    # pad v to k's head_dim for the shared attention helper, then slice
    v_p = F.pad(v, (0, k.shape[-1] - v.shape[-1]))
    out = chunked_attention(
        q.transpose(1, 2), k.transpose(1, 2), v_p.transpose(1, 2),
        causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk, unroll=unroll)
    out = out.transpose(1, 2)[..., : cfg.v_head_dim]
    out = out.reshape(b, s, -1)
    return out @ p["wo"].to(cd), (c_kv, k_rope[:, :, 0, :])


def mla_decode(p, x, cache_c, cache_kr, pos: int, n_heads: int,
               cfg: MLAConfig, *, theta: float):
    """Absorbed decode: scores = q_nope·W_UK·c_kv + q_rope·k_rope over the
    compressed cache. cache_c: (B, S, r); cache_kr: (B, S, rd)."""
    cd = COMPUTE_DTYPE
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    c_kv, k_rope = _latent(p, x, cfg, positions, theta)
    cache_c = update_slot(cache_c, c_kv, pos)
    cache_kr = update_slot(cache_kr, k_rope[:, :, 0, :], pos)

    q_nope, q_rope = _queries(p, x, n_heads, cfg, positions, theta)
    # absorb W_UK: q_lat (B,1,H,r) = q_nope @ W_UK^T per head
    wk = p["wk_b"].to(cd).reshape(cfg.kv_lora_rank, n_heads,
                                  cfg.nope_head_dim)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wk)
    s_nope = torch.einsum("bshr,btr->bhst", q_lat.to(F32), cache_c.to(F32))
    s_rope = torch.einsum("bshd,btd->bhst", q_rope.to(F32),
                          cache_kr.to(F32))
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    s = (s_nope + s_rope) * scale
    idx = torch.arange(cache_c.shape[1], device=x.device)
    s = torch.where(idx <= pos, s, -math.inf)
    w = torch.softmax(s, dim=-1)
    # attention over latent, then decompress through W_UV (absorbed output)
    lat = torch.einsum("bhst,btr->bshr", w.to(cd), cache_c)
    wv = p["wv_b"].to(cd).reshape(cfg.kv_lora_rank, n_heads,
                                  cfg.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", lat, wv).reshape(b, 1, -1)
    return out @ p["wo"].to(cd), cache_c, cache_kr
