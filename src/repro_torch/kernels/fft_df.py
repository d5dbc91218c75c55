"""df32 SpecialFFT / SpecialIFFT: packed twiddle planes and the plain stage
pipeline.

Port of ``repro.kernels.fft_df.packed_twiddles`` (host table, (4, n) f32
planes re_hi, re_lo, im_hi, im_lo plus per-stage offsets) and
``fft_stage_pipeline`` (the stage math both megakernels run; bit-reversal
stays outside it). The CUDA stage loop in ``csrc/client_common.cuh``
follows this schedule operation for operation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core import fft as fftmod


@functools.lru_cache(maxsize=16)
def packed_twiddles(n: int, m: int, inverse: bool):
    """(4, n) f32 planes (re_hi, re_lo, im_hi, im_lo) + stage offsets."""
    roots = fftmod.unit_roots(m)
    chunks, offsets, off = [], [], 0
    if not inverse:
        length = 2
        while length <= n:
            chunks.append(roots[fftmod._stage_indices(n, m, length)])
            offsets.append(off)
            off += length // 2
            length *= 2
    else:
        length = n
        while length >= 2:
            lenh, lenq = length // 2, length * 4
            rg = fftmod.rot_group(n, m)[:lenh]
            chunks.append(roots[(lenq - (rg % lenq)) * (m // lenq)])
            offsets.append(off)
            off += lenh
            length //= 2
    w = np.concatenate(chunks)
    w = np.concatenate([w, np.zeros(n - w.shape[0], np.complex128)])
    re_hi = w.real.astype(np.float32)
    re_lo = (w.real - re_hi).astype(np.float32)
    im_hi = w.imag.astype(np.float32)
    im_lo = (w.imag - im_hi).astype(np.float32)
    tw = np.stack([re_hi, re_lo, im_hi, im_lo])
    tw.setflags(write=False)
    return tw, tuple(offsets)


def _planes_map(z: dfl.DFComplex, f) -> dfl.DFComplex:
    return dfl.dfc_from_planes(tuple(f(p) for p in dfl.dfc_to_planes(z)))


def _stack2(a: dfl.DFComplex, b: dfl.DFComplex, dim: int) -> dfl.DFComplex:
    return dfl.dfc_from_planes(tuple(
        torch.stack([x, y], dim=dim)
        for x, y in zip(dfl.dfc_to_planes(a), dfl.dfc_to_planes(b))))


def fft_stage_pipeline(x: dfl.DFComplex, tw: torch.Tensor, offsets, *,
                       n: int, inverse: bool) -> dfl.DFComplex:
    """The df32 stage pipeline on a (rows, n) DFComplex. tw: the (4, n)
    packed planes as a float32 tensor; the inverse folds in 1/n."""
    rows = x.re.hi.shape[0]

    def stage_tw(off, lenh):
        return dfl.dfc_from_planes(tuple(tw[i, off:off + lenh]
                                         for i in range(4)))

    if not inverse:
        length, s = 2, 0
        while length <= n:
            lenh = length // 2
            w = stage_tw(offsets[s], lenh)
            x = _planes_map(x, lambda p: p.reshape(rows, n // length, 2,
                                                   lenh))
            u = _planes_map(x, lambda p: p[:, :, 0, :])
            v = dfl.dfc_mul(_planes_map(x, lambda p: p[:, :, 1, :]), w)
            x = _stack2(dfl.dfc_add(u, v), dfl.dfc_sub(u, v), 2)
            x = _planes_map(x, lambda p: p.reshape(rows, n))
            length *= 2
            s += 1
        return x
    length, s = n, 0
    while length >= 2:
        lenh = length // 2
        w = stage_tw(offsets[s], lenh)
        x = _planes_map(x, lambda p: p.reshape(rows, n // length, 2, lenh))
        u = _planes_map(x, lambda p: p[:, :, 0, :])
        v = _planes_map(x, lambda p: p[:, :, 1, :])
        x = _stack2(dfl.dfc_add(u, v), dfl.dfc_mul(dfl.dfc_sub(u, v), w), 2)
        x = _planes_map(x, lambda p: p.reshape(rows, n))
        length //= 2
        s += 1
    scale = dfl.df_const(1.0 / n, device=x.re.hi.device)
    return dfl.DFComplex(dfl.df_mul(x.re, scale), dfl.df_mul(x.im, scale))
