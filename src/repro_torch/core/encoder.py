"""The df32 Delta-scale of CKKS encode, and the round-trip precision metric.

Port of the df32 pieces of ``repro.core.encoder``: the power-of-two Delta
check, ``delta_scale_digits`` (exact round-to-nearest-even of coeff * Delta
into balanced base-2^22 digits), ``planes_to_coeff_df`` and
``boot_precision_bits``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dfloat as dfl


def _check_pow2_delta(delta) -> None:
    d = int(delta)
    if float(d) != float(delta) or d <= 0 or d & (d - 1):
        raise ValueError(
            f"datapath='df32' needs a power-of-two Delta (every CKKSParams "
            f"Delta is 2**delta_bits); got {delta!r}")


def delta_scale_digits(coeff: dfl.DF, delta):
    """df32 coefficient pair -> three int32 digit tensors of the exact
    RNE(coeff * Delta), value = d0 + d1*2^22 + d2*2^44."""
    _check_pow2_delta(delta)
    scaled = dfl.df_mul_pow2(coeff, float(delta))
    s, c, b = dfl.df_round_rne(scaled)
    d0, d1, d2 = dfl.expansion3_digits(s, c, b)
    return d0.to(torch.int32), d1.to(torch.int32), d2.to(torch.int32)


def planes_to_coeff_df(w: dfl.DFComplex) -> dfl.DF:
    """SpecialIFFT output -> (..., N) coefficient pair (re ++ im)."""
    return dfl.DF(torch.cat([w.re.hi, w.im.hi], dim=-1),
                  torch.cat([w.re.lo, w.im.lo], dim=-1))


def boot_precision_bits(z_ref: np.ndarray, z_got: np.ndarray) -> float:
    """-log2 of the max round-trip error (the paper's 'Boot. prec.')."""
    err = np.max(np.abs(z_got - z_ref))
    if err == 0:
        return np.inf
    return float(-np.log2(err))
