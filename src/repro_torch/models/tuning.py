"""Performance-tuning knobs (the reference's perf switches).

Port of ``repro.models.tuning``: the same keys and defaults, read while the
model runs; the defaults reproduce the paper-faithful baseline.

  shard_hints   sharding hints on large SSD/MoE intermediates. ``wsc`` is
                the identity here: sharding comes with the distributed
                part of the port, and on one device a hint changes nothing.
  ssd_bf16      intra-chunk SSD decay/score tensors in bf16 (f32 accum).
  ssd_chunk     override SSD chunk length (lmat traffic ~ B*S*C*H).
  moe_capacity  override MoE capacity factor for dispatch slabs.
  moe_local_dispatch  dispatch MoE tokens in G independent groups.
"""

from __future__ import annotations

PERF = {
    "shard_hints": False,
    "ssd_bf16": False,
    "ssd_chunk": None,
    "moe_capacity": None,
    "moe_local_dispatch": None,
}


def set_perf(**kw):
    for k, v in kw.items():
        assert k in PERF, k
        PERF[k] = v


def reset_perf():
    PERF.update(shard_hints=False, ssd_bf16=False, ssd_chunk=None,
                moe_local_dispatch=None,
                moe_capacity=None)


def wsc(x, *spec):
    """The reference's ``with_sharding_constraint`` hint: the identity on
    one device (``spec`` names the mesh axes it would pin)."""
    return x
