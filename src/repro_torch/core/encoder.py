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
  * the reference's encode / decode entry points (``encode``,
    ``encode_batch``, ``decode``, ``decode_coeff``, ``slots_to_coeffs``,
    ``coeffs_to_slots``), each with its ``fourier='host'|'device'``
    switch: ``'host'`` is the complex128 numpy SpecialFFT oracle (also what
    the server's plaintext encoder runs), ``'device'`` the df32 SpecialFFT
    kernel (K4) between float64 parts;
  * ``boot_precision_bits``.

Plaintexts hold int32 tensors of uint32 words on the caller's device
(default ``cuda``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core import fft as fftmod
from repro_torch.core import rns

FOURIERS = ("host", "device")


@dataclasses.dataclass
class Plaintext:
    """RNS plaintext in the NTT domain: (n_limbs, ..., N) int32 words."""

    data: torch.Tensor
    n_limbs: int
    scale: float


@dataclasses.dataclass
class PlaintextBatch:
    """Batch-major plaintexts in the NTT domain: (B, n_limbs, N) int32
    words, the layout the limb-folded encrypt kernel reads."""

    data: torch.Tensor
    n_limbs: int
    scale: float


def _check_fourier(fourier: str) -> None:
    if fourier not in FOURIERS:
        raise ValueError(f"fourier must be one of {FOURIERS}, got "
                         f"{fourier!r}")


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


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


def slots_to_coeffs(z, ctx, fourier: str = "host", device=None):
    """(..., n_slots) complex slots -> (..., N) float64 coefficients (re ++
    im): by the host complex128 SpecialIFFT (a numpy array), or with
    ``fourier='device'`` by the df32 SpecialIFFT kernel (a float64 tensor
    on `device`)."""
    _check_fourier(fourier)
    p = ctx.params
    z = np.asarray(z, dtype=np.complex128)
    if fourier == "device":
        dev = _device(device)
        return slots_to_coeffs_device(torch.from_numpy(z.real.copy()).to(dev),
                                      torch.from_numpy(z.imag.copy()).to(dev),
                                      ctx)
    assert z.shape[-1] == p.n_slots
    w = fftmod.special_ifft(z, p.m)
    return np.concatenate([w.real, w.imag], axis=-1)


def slots_to_coeffs_device(re: torch.Tensor, im: torch.Tensor,
                           ctx) -> torch.Tensor:
    """(..., n_slots) float64 slot parts -> (..., N) float64 coefficients:
    df32 split, SpecialIFFT (K4), float64 collapse."""
    from repro_torch.kernels import ops as kops    # kernels import core
    ns = ctx.params.n_slots
    assert re.shape[-1] == ns and re.shape == im.shape
    shp = re.shape
    z = dfl.dfc_from_parts(re.reshape(-1, ns), im.reshape(-1, ns))
    w = dfl.dfc_from_planes(kops.special_ifft_planes(dfl.dfc_to_planes(z),
                                                     ctx.params.m))
    return torch.cat([dfl.df_to_float(w.re).reshape(shp),
                      dfl.df_to_float(w.im).reshape(shp)], dim=-1)


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
    n, ns = ctx.params.n, ctx.params.n_slots
    assert hi.shape[-1] == n
    coeffs = hi / scale + lo / scale
    shp = coeffs[..., :ns].shape
    z = dfl.dfc_from_parts(coeffs[..., :n // 2].reshape(-1, ns),
                           coeffs[..., n // 2:].reshape(-1, ns))
    w = dfl.dfc_from_planes(kops.special_fft_planes(dfl.dfc_to_planes(z),
                                                    ctx.params.m))
    return (dfl.df_to_float(w.re).reshape(shp),
            dfl.df_to_float(w.im).reshape(shp))


def coeffs_to_slots(coeffs, ctx, scale, fourier: str = "host",
                    device=None) -> np.ndarray:
    """(..., N) integer-valued float64 coefficients -> (..., n_slots)
    complex128 slots: /scale, then the host complex128 SpecialFFT, or with
    ``fourier='device'`` the df32 SpecialFFT kernel on `device` (or on the
    coefficients' device when they are a tensor). `scale` is a scalar or
    an array broadcasting over the batch dims."""
    _check_fourier(fourier)
    p = ctx.params
    if fourier == "device":
        if not isinstance(coeffs, torch.Tensor):
            coeffs = torch.from_numpy(np.asarray(coeffs, np.float64)).to(
                _device(device))
        sc = torch.as_tensor(np.asarray(scale, np.float64),
                             device=coeffs.device)
        re, im = coeffs_to_slots_device(coeffs, torch.zeros_like(coeffs),
                                        ctx, sc)
        return re.cpu().numpy() + 1j * im.cpu().numpy()
    coeffs = np.asarray(coeffs) / scale                  # |v| < Q/2
    n = p.n
    zc = coeffs[..., :n // 2] + 1j * coeffs[..., n // 2:]
    return fftmod.special_fft(zc, p.m)


def encode(z, ctx, n_limbs: int | None = None, fourier: str = "host",
           device=None) -> Plaintext:
    """(..., n_slots) complex -> Plaintext at `n_limbs` (default: fresh),
    its words on `device` (default ``cuda``)."""
    p = ctx.params
    n_limbs = n_limbs if n_limbs is not None else p.n_limbs
    dev = _device(device)
    coeffs = slots_to_coeffs(z, ctx, fourier=fourier, device=dev)
    if fourier == "host":
        coeffs = torch.from_numpy(coeffs).to(dev)
    return Plaintext(coeffs_to_plaintext_data(coeffs, ctx, n_limbs),
                     n_limbs, p.delta)


def encode_batch(z, ctx, n_limbs: int | None = None, fourier: str = "host",
                 device=None) -> PlaintextBatch:
    """(B, n_slots) complex -> batch-major (B, L, N) PlaintextBatch."""
    pt = encode(z, ctx, n_limbs, fourier=fourier, device=device)
    return PlaintextBatch(pt.data.transpose(0, 1).contiguous(), pt.n_limbs,
                          pt.scale)


def decode_coeff(m_coeff: torch.Tensor, ctx, scale=None,
                 fourier: str = "host") -> np.ndarray:
    """Coefficient-domain decode: (2, ..., N) int32 residue words (after
    the INTT, e.g. a decrypt kernel's output) -> (..., n_slots) complex128
    slots by the df64 two-limb CRT, /scale and the SpecialFFT."""
    from repro_torch.core import modmul
    _check_fourier(fourier)
    p = ctx.params
    scale = scale if scale is not None else p.delta
    v = rns.crt2_to_df(modmul.u32_to_i64(m_coeff[0]),
                       modmul.u32_to_i64(m_coeff[1]), ctx.q_list[0],
                       ctx.q_list[1])
    if fourier == "device":
        sc = torch.as_tensor(np.asarray(scale, np.float64),
                             device=v.hi.device)
        re, im = coeffs_to_slots_device(v.hi, v.lo, ctx, sc)
        return re.cpu().numpy() + 1j * im.cpu().numpy()
    return coeffs_to_slots(v.hi.cpu().numpy() + v.lo.cpu().numpy(), ctx,
                           scale)


def decode(pt_ntt: torch.Tensor, ctx, scale: float | None = None,
           fourier: str = "host") -> np.ndarray:
    """(>=2, ..., N) int32 NTT-domain words -> (..., n_slots) complex128:
    the INTT of the first two limbs (K1), then ``decode_coeff``."""
    from repro_torch.kernels import ops as kops
    coeff = kops.intt_limbs(pt_ntt[:2].contiguous(), ctx, n_limbs=2)
    return decode_coeff(coeff, ctx, scale, fourier=fourier)


def boot_precision_bits(z_ref: np.ndarray, z_got: np.ndarray) -> float:
    """-log2 of the max round-trip error (the paper's 'Boot. prec.')."""
    err = np.max(np.abs(z_got - z_ref))
    if err == 0:
        return np.inf
    return float(-np.log2(err))
