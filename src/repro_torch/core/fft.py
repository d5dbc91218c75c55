"""Host tables of the CKKS canonical-embedding SpecialFFT, and its
complex128 numpy oracle.

Port of ``repro.core.fft`` without the df32 and quantized variants: the 5^j
rotation group, the unit roots and the forward stage indices
(``kernels.fft_df.packed_twiddles`` packs them into the df32 planes both
FFT directions read), and ``special_fft`` / ``special_ifft``, the host
transforms the server's plaintext encoder runs
(``fhe_server.encoding.encode_plaintext``).
"""

from __future__ import annotations

import functools

import numpy as np

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
