"""Limb-folded negacyclic NTT / INTT (K1): CUDA wrapper and plain version.

Port of ``repro.kernels.ntt_butterfly.ntt_limb_rows`` / ``intt_limb_rows``
(the TPU kernels ``_kernel_fwd_folded`` / ``_kernel_inv_folded``): an
(L, rows, N) stack of uint32 residues (int32 tensors holding the words),
limb l transformed with prime l's constants from the (L, K) seed table.
Forward: natural order in, bit-reversed out; inverse: bit-reversed in,
natural order out, N^-1 folded in.

  * ``limb_rows_cuda`` launches ``csrc/ntt_limbs.cu`` (grid (L, rows), one
    block per row) and counts its launches in ``LAUNCHES``;
  * ``limb_rows_plain`` runs ``common.ntt_stages_t`` / ``intt_stages_t``
    limb by limb, the schedule the kernel follows.

``ops.ntt_limbs`` / ``intt_limbs`` pick one by the tensor's device.
"""

from __future__ import annotations

import torch

from repro_torch.core import modmul
from repro_torch.kernels import common

LAUNCHES = {"ntt_limbs": 0, "intt_limbs": 0}


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
    L, rows, n = x.shape
    common.check_tensor(x, "x", torch.int32, (kc.n_limbs, rows, kc.n), dev)
    common.check_grid_rows(rows)
    out = torch.empty_like(x)
    common.launch("ntt_limbs_launch", dev, x.data_ptr(), out.data_ptr(),
                  common.device_seed_table(kc, dev).data_ptr(), L, rows,
                  kc.logn, kc.n_scalars, int(inverse))
    LAUNCHES["intt_limbs" if inverse else "ntt_limbs"] += 1
    return out
