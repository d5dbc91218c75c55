"""Mixture-of-Experts FFN: top-k router + capacity-based sort dispatch.

Port of ``repro.models.moe``. Sort-based dispatch (stable argsort by
expert id, gather into (E, C, d) slabs, batched expert matmul, scatter
back): no (T, E, C) one-hot tensors, so it scales to deepseek-v3's 256
experts. Tokens beyond a capacity slab are dropped (standard
capacity-factor semantics); an aux load-balancing loss is returned for
training.

Two scatters of the reference have duplicate indices, and the port gives
each the result XLA's sequential scatter gives on the CPU, on any device
and without atomics:

  * the drop sink: dropped tokens write a zero row to slot ``e*cap - 1``,
    which is also the last expert's last slot. The last write in sorted
    order wins, so that slot holds the last expert's kept token unless
    the last expert overflowed, and then it holds zeros (``_dispatch``);
  * the combine ``.at[st].add`` in bf16: each token's top_k contributions
    are added one at a time, rounded to bf16 after each add, in ascending
    expert order — the sorted order the reference scatters in
    (``_combine``).
"""

from __future__ import annotations

import torch

from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, F32, _init, init_mlp,
                                       mlp_fwd, silu)
from repro_torch.models.tuning import PERF, wsc


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             d_ff_shared: int):
    e, f = cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": _init(gen, (d_model, e), scale=0.02),
        "wi": _init(gen, (e, d_model, f)),
        "wg": _init(gen, (e, d_model, f)),
        "wo": _init(gen, (e, f, d_model)),
    }
    if cfg.n_shared:
        p["shared"] = init_mlp(gen, d_model, d_ff_shared * cfg.n_shared)
    return p


def top_k(probs, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, xt, cfg: MoEConfig):
    """Router: (T, d) -> probs (T, E), normalised top-k (weights, ids)."""
    gate_logits = xt.to(F32) @ p["router"]
    probs = torch.softmax(gate_logits, dim=-1)              # (T, E)
    topv, topi = top_k(probs, cfg.top_k)                    # (T, K)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, topv, topi


def _dispatch(xt, topi, topv, e: int, cap: int, top_k_: int):
    """One group: stable sort by expert -> (E*C, d) slab + the metadata
    the combine needs."""
    t, d = xt.shape
    dev = xt.device
    flat_e = topi.reshape(-1)                               # (T*K,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(top_k_)
    flat_w = topv.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    # position within its expert group
    same = torch.arange(se.numel(), device=dev)
    grp_start = torch.searchsorted(se, torch.arange(e, device=dev))
    pos_in_grp = same - grp_start[se]
    keep = pos_in_grp < cap
    slot = se * cap + torch.where(keep, pos_in_grp, 0)

    cd = COMPUTE_DTYPE
    xc = xt.to(cd)
    # kept rows have distinct slots; dropped rows all write the same zero
    # row to a spare slot past the slab, so every write is deterministic
    buf = torch.zeros((e * cap + 1, d), dtype=cd, device=dev)
    buf[torch.where(keep, slot, e * cap)] = torch.where(
        keep[:, None], xc[st], 0)
    slab = buf[: e * cap]
    # the sink slot e*cap-1: the reference's last write in sorted order
    # wins there (a dropped row writes the zero row xt_pad[t])
    sink = e * cap - 1
    target = torch.where(keep, slot, sink)
    last = torch.where(target == sink, same, -1).max()
    at = last.clamp(min=0).reshape(1)
    # index_select, not a 0-d index: no host read of the position (the
    # dry-run traces this under FakeTensorMode)
    last_row = torch.where(keep.index_select(0, at)[0],
                           xc.index_select(0, st.index_select(0, at))[0], 0)
    slab[sink] = torch.where(last >= 0, last_row, slab[sink])
    return slab.reshape(e, cap, d), (order, sw, keep, slot)


def _combine(out_slab, meta, topi):
    """The reference's ``zeros.at[st].add(contrib)`` in bf16, one token's
    contributions added in ascending expert order."""
    order, sw, keep, slot = meta
    t, k = topi.shape
    cd = COMPUTE_DTYPE
    d = out_slab.shape[-1]
    contrib = out_slab.reshape(-1, d)[slot] * sw[:, None].to(cd)
    contrib = torch.where(keep[:, None], contrib, 0)
    flat = torch.empty_like(contrib)
    flat[order] = contrib                                   # (T*K, d)
    by_expert = torch.argsort(topi, dim=1, stable=True)     # (T, K)
    flat = flat.reshape(t, k, d)
    flat = torch.gather(flat, 1, by_expert[..., None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=cd, device=out_slab.device)
    for j in range(k):
        out = out + flat[:, j]
    return out


def _experts(p, slabs):
    """Batched expert SwiGLU over (..., E, C, d) slabs."""
    cd = COMPUTE_DTYPE
    h = silu(torch.einsum("...ecd,edf->...ecf", slabs, p["wg"].to(cd)))
    h = wsc(h, "data", None, "model")
    h = h * wsc(torch.einsum("...ecd,edf->...ecf", slabs, p["wi"].to(cd)),
                "data", None, "model")
    return wsc(torch.einsum("...ecf,efd->...ecd", h, p["wo"].to(cd)),
               "data")


def _aux(probs, topi, e: int):
    """Switch-style load-balance loss."""
    first = topi[..., 0].reshape(-1)
    counts = torch.zeros(e, dtype=torch.int64, device=first.device)
    counts.scatter_add_(0, first, torch.ones_like(first))
    density = counts.to(F32) / first.numel()
    router_prob = probs.reshape(-1, e).mean(0)
    return e * torch.sum(density * router_prob)


def moe_fwd(p, x, cfg: MoEConfig, capacity_factor: float | None = None):
    """x: (B, S, d) -> (B, S, d), aux_loss.

    With tuning.PERF['moe_local_dispatch'] = G, tokens are dispatched in G
    independent groups (``_moe_fwd_grouped``): the argsort and capacity
    selection are group-local, as in the reference's expert-parallel
    pattern.
    """
    if PERF.get("moe_local_dispatch"):
        return _moe_fwd_grouped(p, x, cfg, capacity_factor,
                                PERF["moe_local_dispatch"])
    b, s, d = x.shape
    t = b * s
    xt = wsc(x.reshape(t, d), "data")
    probs, topv, topi = _route(p, xt, cfg)

    e = cfg.n_experts
    capacity_factor = (cfg.capacity_factor if capacity_factor is None
                       else capacity_factor)
    if PERF["moe_capacity"]:
        capacity_factor = PERF["moe_capacity"]
    cap = int(t * cfg.top_k * capacity_factor / e)
    cap = max(cap, 4)

    slab, meta = _dispatch(xt, topi, topv, e, cap, cfg.top_k)
    out_slab = _experts(p, wsc(slab, "data"))
    out = _combine(out_slab, meta, topi)
    if "shared" in p:
        out = out + mlp_fwd(p["shared"], xt.to(COMPUTE_DTYPE))
    return out.reshape(b, s, d), _aux(probs, topi, e)


def _moe_fwd_grouped(p, x, cfg: MoEConfig, capacity_factor, groups: int):
    """Group-local dispatch (the reference's EP all-to-all pattern; on one
    device the reshard is the identity)."""
    b, s, d = x.shape
    t = b * s
    assert t % groups == 0
    tg = t // groups
    e = cfg.n_experts
    capacity_factor = (cfg.capacity_factor if capacity_factor is None
                       else capacity_factor)
    cap = max(int(tg * cfg.top_k * capacity_factor / e), 4)

    xt = wsc(x.reshape(groups, tg, d), "data")              # (G, Tg, d)
    probs, topv, topi = _route(p, xt, cfg)
    slabs, metas = zip(*(_dispatch(xt[g], topi[g], topv[g], e, cap,
                                   cfg.top_k) for g in range(groups)))
    out_slab = _experts(p, torch.stack(slabs))              # (G, E, C, d)
    out = torch.stack([_combine(out_slab[g], metas[g], topi[g])
                       for g in range(groups)])             # (G, Tg, d)
    if "shared" in p:
        out = out + mlp_fwd(p["shared"], xt.to(COMPUTE_DTYPE))
    return out.reshape(b, s, d), _aux(probs, topi, e)
