"""Host tables of the CKKS canonical-embedding SpecialFFT, and its
complex128 numpy oracle.

Port of ``repro.core.fft``: the 5^j rotation group, the unit roots and
the forward stage indices (``kernels.fft_df.packed_twiddles`` packs them
into the df32 planes both FFT directions read); ``special_fft`` /
``special_ifft``, the host transforms the server's plaintext encoder runs
(``fhe_server.encoding.encode_plaintext``); ``special_fft_df`` /
``special_ifft_df``, the double-float reference of the df32 datapath on
``DFComplex`` tensors, in the reference's operation order; and
``special_fft_quantized``, the paper's Fig. 3c precision model (numpy
float64, every operation rounded to a given mantissa width; a model, not a
device path).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core.ntt import bitrev_indices


@functools.lru_cache(maxsize=16)
def rot_group(n_slots: int, m: int) -> np.ndarray:
    """5^j mod M for j < n_slots (M = 2N = 4*n_slots)."""
    out = np.empty(n_slots, dtype=np.int64)
    g = 1
    for j in range(n_slots):
        out[j] = g
        g = (g * 5) % m
    return out


@functools.lru_cache(maxsize=16)
def unit_roots(m: int) -> np.ndarray:
    k = np.arange(m)
    return np.exp(2j * np.pi * k / m)


def _stage_indices(n_slots: int, m: int, length: int) -> np.ndarray:
    lenh, lenq = length // 2, length * 4
    rg = rot_group(n_slots, m)[:lenh]
    return (rg % lenq) * (m // lenq)


def special_fft(vals: np.ndarray, m: int) -> np.ndarray:
    """Decode direction, coefficient side -> slots; vals (..., n)."""
    n = vals.shape[-1]
    roots = unit_roots(m)
    x = np.asarray(vals, dtype=np.complex128).copy()
    x = x[..., bitrev_indices(n)]
    length = 2
    while length <= n:
        lenh = length // 2
        w = roots[_stage_indices(n, m, length)]
        shp = x.shape[:-1]
        x = x.reshape(shp + (n // length, 2, lenh))
        u, v = x[..., 0, :], x[..., 1, :] * w
        x = np.stack([u + v, u - v], axis=-2).reshape(shp + (n,))
        length *= 2
    return x


def special_ifft(vals: np.ndarray, m: int) -> np.ndarray:
    """Encode direction, slots -> coefficient side (1/n included)."""
    n = vals.shape[-1]
    roots = unit_roots(m)
    x = np.asarray(vals, dtype=np.complex128).copy()
    length = n
    while length >= 2:
        lenh, lenq = length // 2, length * 4
        rg = rot_group(n, m)[:lenh]
        w = roots[(lenq - (rg % lenq)) * (m // lenq)]
        shp = x.shape[:-1]
        x = x.reshape(shp + (n // length, 2, lenh))
        u, v = x[..., 0, :], x[..., 1, :]
        x = np.stack([u + v, (u - v) * w], axis=-2).reshape(shp + (n,))
        length //= 2
    return x[..., bitrev_indices(n)] / n


# ---------------------------------------------------------------------------
# double-float datapath (df32; also runs as df64)
# ---------------------------------------------------------------------------


def _dfc_roots(idx: np.ndarray, m: int, dtype, device) -> dfl.DFComplex:
    """Unit roots at ``idx``, each part split into a (hi, lo) pair."""
    r = unit_roots(m)[idx]
    npt = np.float32 if dtype == dfl.F32 else np.float64
    parts = []
    for x in (r.real, r.imag):
        hi = x.astype(npt)
        lo = (x - hi).astype(npt)
        parts.append(dfl.DF(torch.as_tensor(hi, device=device),
                            torch.as_tensor(lo, device=device)))
    return dfl.DFComplex(*parts)


def _dfc_map(f, *zs: dfl.DFComplex) -> dfl.DFComplex:
    return dfl.DFComplex(
        dfl.DF(f(*(z.re.hi for z in zs)), f(*(z.re.lo for z in zs))),
        dfl.DF(f(*(z.im.hi for z in zs)), f(*(z.im.lo for z in zs))))


def special_fft_df(z: dfl.DFComplex, m: int, dtype=dfl.F32) -> dfl.DFComplex:
    """Decode direction on a df pair of (..., n) tensors."""
    n = z.re.hi.shape[-1]
    dev = z.re.hi.device
    x = _dfc_map(lambda a: a[..., torch.as_tensor(bitrev_indices(n),
                                                  device=dev)], z)
    length = 2
    while length <= n:
        lenh = length // 2
        w = _dfc_roots(_stage_indices(n, m, length), m, dtype, dev)
        shp = tuple(x.re.hi.shape[:-1])
        x = _dfc_map(lambda a: a.reshape(shp + (n // length, 2, lenh)), x)
        u = _dfc_map(lambda a: a[..., 0, :], x)
        v = dfl.dfc_mul(_dfc_map(lambda a: a[..., 1, :], x), w)
        x = _dfc_map(lambda a, b: torch.stack([a, b], dim=-2),
                     dfl.dfc_add(u, v), dfl.dfc_sub(u, v))
        x = _dfc_map(lambda a: a.reshape(shp + (n,)), x)
        length *= 2
    return x


def special_ifft_df(z: dfl.DFComplex, m: int, dtype=dfl.F32) -> dfl.DFComplex:
    """Encode direction on a df pair of (..., n) tensors (1/n included)."""
    n = z.re.hi.shape[-1]
    dev = z.re.hi.device
    x = z
    length = n
    while length >= 2:
        lenh, lenq = length // 2, length * 4
        rg = rot_group(n, m)[:lenh]
        w = _dfc_roots((lenq - (rg % lenq)) * (m // lenq), m, dtype, dev)
        shp = tuple(x.re.hi.shape[:-1])
        x = _dfc_map(lambda a: a.reshape(shp + (n // length, 2, lenh)), x)
        u = _dfc_map(lambda a: a[..., 0, :], x)
        v = _dfc_map(lambda a: a[..., 1, :], x)
        x = _dfc_map(lambda a, b: torch.stack([a, b], dim=-2),
                     dfl.dfc_add(u, v), dfl.dfc_mul(dfl.dfc_sub(u, v), w))
        x = _dfc_map(lambda a: a.reshape(shp + (n,)), x)
        length //= 2
    x = _dfc_map(lambda a: a[..., torch.as_tensor(bitrev_indices(n),
                                                  device=dev)], x)
    inv_n = dfl.df_const(1.0 / n, device=dev, dtype=dtype)
    return dfl.DFComplex(dfl.df_mul(x.re, inv_n), dfl.df_mul(x.im, inv_n))


# ---------------------------------------------------------------------------
# quantized-mantissa path (paper Fig. 3c sweep)
# ---------------------------------------------------------------------------


def _quantize(x: np.ndarray, mbits: int) -> np.ndarray:
    """Round-to-nearest to `mbits` mantissa bits (float64 container)."""
    mant, expo = np.frexp(x)
    scale = 2.0 ** mbits
    return np.ldexp(np.round(mant * scale) / scale, expo)


def _qc(x: np.ndarray, mbits: int) -> np.ndarray:
    return _quantize(x.real, mbits) + 1j * _quantize(x.imag, mbits)


def _qc_mul(a, b, mbits):
    # four real multiplies + two adds, each rounded — models the FP datapath
    re = _quantize(_quantize(a.real * b.real, mbits)
                   - _quantize(a.imag * b.imag, mbits), mbits)
    im = _quantize(_quantize(a.real * b.imag, mbits)
                   + _quantize(a.imag * b.real, mbits), mbits)
    return re + 1j * im


def special_fft_quantized(vals: np.ndarray, m: int, mbits: int,
                          inverse: bool = False) -> np.ndarray:
    """Transform with every FP op rounded to `mbits` mantissa bits."""
    n = vals.shape[-1]
    roots = _qc(unit_roots(m), mbits)
    x = _qc(np.asarray(vals, np.complex128).copy(), mbits)
    if not inverse:
        x = x[..., bitrev_indices(n)]
        length = 2
        while length <= n:
            lenh = length // 2
            w = roots[_stage_indices(n, m, length)]
            shp = x.shape[:-1]
            x = x.reshape(shp + (n // length, 2, lenh))
            u, v = x[..., 0, :], _qc_mul(x[..., 1, :], w, mbits)
            x = np.stack([_qc(u + v, mbits), _qc(u - v, mbits)],
                         axis=-2).reshape(shp + (n,))
            length *= 2
        return x
    length = n
    while length >= 2:
        lenh, lenq = length // 2, length * 4
        rg = rot_group(n, m)[:lenh]
        w = roots[(lenq - (rg % lenq)) * (m // lenq)]
        shp = x.shape[:-1]
        x = x.reshape(shp + (n // length, 2, lenh))
        u, v = x[..., 0, :], x[..., 1, :]
        x = np.stack([_qc(u + v, mbits), _qc_mul(_qc(u - v, mbits), w, mbits)],
                     axis=-2).reshape(shp + (n,))
        length //= 2
    x = x[..., bitrev_indices(n)] / n
    return _qc(x, mbits)
