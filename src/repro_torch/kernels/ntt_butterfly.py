"""Negacyclic NTT / INTT: the limb-folded K1 and the single-prime K12, each
a CUDA wrapper beside its plain version.

Port of ``repro.kernels.ntt_butterfly.ntt_limb_rows`` / ``intt_limb_rows``
(the TPU kernels ``_kernel_fwd_folded`` / ``_kernel_inv_folded``): an
(L, rows, N) stack of uint32 residues (int32 tensors holding the words),
limb l transformed with prime l's constants from the (L, K) seed table.
Forward: natural order in, bit-reversed out; inverse: bit-reversed in,
natural order out, N^-1 folded in.

  * ``limb_rows_cuda`` launches ``csrc/ntt_limbs.cu`` (a twiddle-heap
    prologue, then the tiled NTT block: one pass, a block per (limb, row),
    for N <= 2^11, else a column and a chunk pass) and counts its launches
    in ``LAUNCHES``;
  * ``limb_rows_plain`` runs ``common.ntt_stages_t`` / ``intt_stages_t``
    limb by limb, the schedule the kernel follows.

``ntt_limb_rows`` / ``intt_limb_rows`` (the reference's names) and
``ops.ntt_limbs`` / ``intt_limbs`` pick one by the tensor's device.

K12 is the port of ``ntt_rows`` / ``intt_rows`` (the TPU kernels
``_kernel_fwd`` / ``_kernel_inv``): (rows, N) words of ONE prime, the
shift-add REDC of paper eq. 9-11 (``common.ntt_stages`` /
``intt_stages``), the same orders as K1:

  * ``rows_cuda`` launches ``csrc/ntt_rows.cu`` (K1's twiddle-heap
    prologue and tiled passes on the one prime, under the shift-add REDC)
    and counts ``ntt_rows`` / ``intt_rows``;
  * ``rows_plain`` runs the static stage loops;
  * ``ntt_rows`` / ``intt_rows`` pick one by the tensor's device.
"""

from __future__ import annotations

import torch

from repro_torch.core import modmul
from repro_torch.kernels import common

LAUNCHES = {"ntt_limbs": 0, "intt_limbs": 0, "ntt_rows": 0, "intt_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def limb_rows_plain(x: torch.Tensor, plans, inverse: bool) -> torch.Tensor:
    """(L, rows, N) int32 words -> NTT (or INTT) of every limb, int32."""
    kc = common.stacked_kernel_consts(plans)
    stages = common.intt_stages_t if inverse else common.ntt_stages_t
    return torch.stack([
        modmul.i64_to_u32(stages(modmul.u32_to_i64(x[l]), kc, l))
        for l in range(x.shape[0])])


def limb_rows_cuda(x: torch.Tensor, plans, inverse: bool) -> torch.Tensor:
    """CUDA launch of ``ntt_limbs.cu``; same function as
    ``limb_rows_plain``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("limb_rows_cuda needs a CUDA tensor")
    kc = common.stacked_kernel_consts(plans)
    if x.dim() != 3 or x.shape[1] == 0:
        raise ValueError(f"x must be (L, rows >= 1, N), got {tuple(x.shape)}")
    L, rows, n = x.shape
    common.check_tensor(x, "x", torch.int32, (kc.n_limbs, rows, kc.n), dev)
    out = torch.empty_like(x)
    tw_heap = torch.empty((L, n), dtype=torch.int32, device=dev)
    common.launch("ntt_limbs_launch", dev, x.data_ptr(), out.data_ptr(),
                  common.device_seed_table(kc, dev).data_ptr(),
                  tw_heap.data_ptr(), L, rows, kc.logn, kc.n_scalars,
                  int(inverse))
    LAUNCHES["intt_limbs" if inverse else "ntt_limbs"] += 1
    return out


# ---------------------------------------------------------------------------
# K12: single-prime NTT / INTT with the shift-add REDC
# ---------------------------------------------------------------------------


def ntt_limb_rows(x: torch.Tensor, plans) -> torch.Tensor:
    """Forward negacyclic NTT of (L, rows, N) int32 words, all limbs in one
    launch (bit-reversed out): K1 on a CUDA tensor, the plain version on
    the CPU."""
    f = limb_rows_cuda if common.route(x.device) == "cuda" else limb_rows_plain
    return f(x, plans, False)


def intt_limb_rows(x: torch.Tensor, plans) -> torch.Tensor:
    """Inverse of ``ntt_limb_rows`` (bit-reversed in, N^-1 folded in)."""
    f = limb_rows_cuda if common.route(x.device) == "cuda" else limb_rows_plain
    return f(x, plans, True)


def rows_plain(x: torch.Tensor, plan, inverse: bool) -> torch.Tensor:
    """(rows, N) int32 words of one prime -> NTT (or INTT), int32."""
    pc = common.plan_consts(plan)
    stages = common.intt_stages if inverse else common.ntt_stages
    return modmul.i64_to_u32(stages(modmul.u32_to_i64(x), pc))


def rows_cuda(x: torch.Tensor, plan, inverse: bool) -> torch.Tensor:
    """CUDA launch of ``ntt_rows.cu``; same function as ``rows_plain``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("rows_cuda needs a CUDA tensor")
    kc = common.stacked_kernel_consts([plan])
    if x.dim() != 2 or x.shape[0] == 0:
        raise ValueError(f"x must be (rows >= 1, {kc.n}), got "
                         f"{tuple(x.shape)}")
    common.check_tensor(x, "x", torch.int32, (x.shape[0], kc.n), dev)
    out = torch.empty_like(x)
    tw_heap = torch.empty((1, kc.n), dtype=torch.int32, device=dev)
    common.launch("ntt_rows_launch", dev, x.data_ptr(), out.data_ptr(),
                  common.device_seed_table(kc, dev).data_ptr(),
                  common.device_sa_table([plan], dev).data_ptr(),
                  tw_heap.data_ptr(), x.shape[0], kc.logn, int(inverse))
    LAUNCHES["intt_rows" if inverse else "ntt_rows"] += 1
    return out


def ntt_rows(x: torch.Tensor, plan) -> torch.Tensor:
    """Forward negacyclic NTT of (rows, N) int32 words of one prime
    (bit-reversed out): K12 on a CUDA tensor, the plain version on the
    CPU."""
    f = rows_cuda if common.route(x.device) == "cuda" else rows_plain
    return f(x, plan, False)


def intt_rows(x: torch.Tensor, plan) -> torch.Tensor:
    """Inverse of ``ntt_rows`` (bit-reversed in, N^-1 folded in)."""
    f = rows_cuda if common.route(x.device) == "cuda" else rows_plain
    return f(x, plan, True)
