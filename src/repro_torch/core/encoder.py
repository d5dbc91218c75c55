"""CKKS encode / decode pieces around the Fourier kernels, and the
round-trip precision metric.

Port of ``repro.core.encoder``:

  * the df32 datapath: the power-of-two Delta check, ``delta_scale_digits``
    (exact round-to-nearest-even of coeff * Delta into balanced base-2^22
    digits) and ``planes_to_coeff_df``;
  * the f64 datapath: ``slots_to_coeffs_device`` / ``coeffs_to_slots_device``
    (float64 around the df32 SpecialIFFT / SpecialFFT kernel, K4),
    ``delta_scale_round`` (exact df64 rounding of coeff * Delta, any
    Delta) and ``coeffs_to_plaintext_data`` (exact fmod RNS reduction and
    the limb-folded NTT, K1);
  * ``slots_to_coeffs``: the host complex128 SpecialIFFT the server's
    plaintext encoder runs;
  * ``boot_precision_bits``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core import fft as fftmod
from repro_torch.core import rns


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


def slots_to_coeffs(z, ctx) -> np.ndarray:
    """(..., n_slots) complex slots -> (..., N) float64 coefficients by the
    host complex128 SpecialIFFT (re ++ im)."""
    p = ctx.params
    z = np.asarray(z, dtype=np.complex128)
    if z.shape[-1] != p.n_slots:
        raise ValueError(f"expected {p.n_slots} slots, got {z.shape[-1]}")
    w = fftmod.special_ifft(z, p.m)
    return np.concatenate([w.real, w.imag], axis=-1)


def slots_to_coeffs_device(re: torch.Tensor, im: torch.Tensor,
                           ctx) -> torch.Tensor:
    """(B, n_slots) float64 slot parts -> (B, N) float64 coefficients: df32
    split, SpecialIFFT (K4), float64 collapse."""
    from repro_torch.kernels import ops as kops    # kernels import core
    z = dfl.dfc_from_parts(re, im)
    w = dfl.dfc_from_planes(kops.special_ifft_planes(dfl.dfc_to_planes(z),
                                                     ctx.params.m))
    return torch.cat([dfl.df_to_float(w.re), dfl.df_to_float(w.im)], dim=-1)


def delta_scale_round(coeffs: torch.Tensor, delta) -> dfl.DF:
    """(..., N) float64 coefficients -> the integer-valued df64 pair of
    round(coeffs * Delta), exact (two_prod, then df_round)."""
    hi, lo = dfl.two_prod(coeffs, torch.tensor(float(delta),
                                               dtype=dfl.F64,
                                               device=coeffs.device))
    return dfl.df_round(dfl.DF(hi, lo))


def coeffs_to_plaintext_data(coeffs: torch.Tensor, ctx,
                             n_limbs: int) -> torch.Tensor:
    """(B, N) float64 coefficients -> (L, B, N) int32 NTT-domain words:
    exact Delta-scale and fmod RNS reduction, then the limb-folded NTT
    (K1; the reference's stacked NTT, the same words)."""
    from repro_torch.core import modmul
    from repro_torch.kernels import ops as kops
    scaled = delta_scale_round(coeffs, ctx.params.delta)
    residues = rns.to_rns_df(scaled, ctx.q_list[:n_limbs])
    return kops.ntt_limbs(modmul.i64_to_u32(residues).contiguous(), ctx,
                          n_limbs=n_limbs)


def coeffs_to_slots_device(hi: torch.Tensor, lo: torch.Tensor, ctx,
                           scale: torch.Tensor):
    """Integer-valued df64 coefficient pair (B, N) -> (B, n_slots) float64
    (re, im) slot parts: /scale in float64 (any scale, a (B, 1) or
    broadcastable float64 tensor), df32 split, SpecialFFT (K4), float64
    collapse."""
    from repro_torch.kernels import ops as kops
    n = ctx.params.n
    coeffs = hi / scale + lo / scale
    z = dfl.dfc_from_parts(coeffs[..., :n // 2], coeffs[..., n // 2:])
    w = dfl.dfc_from_planes(kops.special_fft_planes(dfl.dfc_to_planes(z),
                                                    ctx.params.m))
    return dfl.df_to_float(w.re), dfl.df_to_float(w.im)


def boot_precision_bits(z_ref: np.ndarray, z_got: np.ndarray) -> float:
    """-log2 of the max round-trip error (the paper's 'Boot. prec.')."""
    err = np.max(np.abs(z_got - z_ref))
    if err == 0:
        return np.inf
    return float(-np.log2(err))
