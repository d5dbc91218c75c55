"""Oracles of the per-prime NTT kernels over the exact transforms.

Port of the NTT half of ``repro.kernels.ref``: ``ntt_rows`` / ``intt_rows``
run ``core.ntt.ntt`` / ``intt`` (table twiddles, the u64 REDC oracle) on
(rows, N) int32 tensors holding uint32 words. The reference's
``fourstep_permutation`` is the identity (the four-step output is in
natural order, out[k] = a(psi^(2k+1))), so it has no counterpart here.
"""

from __future__ import annotations

import torch

from repro_torch.core import modmul
from repro_torch.core import ntt as nttmod
from repro_torch.core.ntt import NTTPlan


def ntt_rows(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """(rows, N) int32 words -> forward negacyclic NTT (bit-reversed
    order), exact path."""
    return modmul.i64_to_u32(nttmod.ntt(modmul.u32_to_i64(x), plan))


def intt_rows(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Inverse of ``ntt_rows`` (bit-reversed input), exact path."""
    return modmul.i64_to_u32(nttmod.intt(modmul.u32_to_i64(x), plan))
