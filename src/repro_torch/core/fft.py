"""Host tables of the CKKS canonical-embedding SpecialFFT.

Port of the table half of ``repro.core.fft``: the 5^j rotation group, the
unit roots and the forward stage indices. ``kernels.fft_df.packed_twiddles``
packs them into the df32 planes both FFT directions read.
"""

from __future__ import annotations

import functools

import numpy as np


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
