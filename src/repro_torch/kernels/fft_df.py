"""df32 SpecialFFT / SpecialIFFT (K4): packed twiddle planes, the plain
stage pipeline, and the kernel's CUDA wrapper.

Port of ``repro.kernels.fft_df``:

  * ``packed_twiddles`` (host table, (4, n) f32 planes re_hi, re_lo, im_hi,
    im_lo plus per-stage offsets) and ``fft_stage_pipeline`` (the stage
    math K4 and both megakernels run; bit-reversal stays outside it). The
    CUDA stage loops in ``csrc/client_common.cuh`` follow this schedule
    operation for operation;
  * ``special_fft_planes`` / ``special_ifft_planes``: the transforms on
    four (rows, n) float32 planes, the bit-reversal before the forward and
    after the inverse stages, as in the reference. CUDA tensors go to
    ``special_fft_cuda`` (launches ``csrc/fft_df.cu``, which replaces the
    TPU kernel ``_kernel`` and does the bit reversal in its loads and
    stores; counts its launches in ``LAUNCHES``), CPU tensors to
    ``special_fft_plain`` (a torch gather and ``fft_rows_plain``, the
    stages the megakernels' plain versions run too);
  * ``special_fft_rows`` / ``special_ifft_rows``: the same on (rows, n)
    complex numpy arrays (split into df32 planes and collapsed back), on
    the card unless the caller passes the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core import fft as fftmod
from repro_torch.core.ntt import bitrev_indices
from repro_torch.kernels import common

LAUNCHES = {"special_fft": 0, "special_ifft": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


# ---------------------------------------------------------------------------
# K4: the stage pipeline over (rows, n) planes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def device_twiddles(n: int, m: int, inverse: bool, device: str):
    """The packed (4, n) float32 twiddles of the direction on `device`."""
    return common.host_table(packed_twiddles(n, m, inverse)[0], device)


@functools.lru_cache(maxsize=32)
def device_bitrev(n: int, device: str):
    """The (n,) int64 bit-reversal permutation on `device`."""
    return common.host_table(bitrev_indices(n), device)


def _rows_shape(planes) -> tuple[int, int]:
    if len(planes) != 4 or planes[0].dim() != 2:
        raise ValueError("expected four (rows, n) float32 planes")
    return tuple(planes[0].shape)


def fft_rows_plain(planes, m: int, inverse: bool):
    """The stages of K4 on four (rows, n) float32 planes (no bit-reversal;
    the inverse folds in 1/n) -> four contiguous (rows, n) planes."""
    _, n = _rows_shape(planes)
    _, offsets = packed_twiddles(n, m, inverse)
    tw = device_twiddles(n, m, inverse, str(planes[0].device))
    z = fft_stage_pipeline(dfl.dfc_from_planes(tuple(planes)), tw, offsets,
                           n=n, inverse=inverse)
    return tuple(p.contiguous() for p in dfl.dfc_to_planes(z))


def bitrev_planes(planes):
    """Each plane's last axis in bit-reversed order (a torch gather)."""
    rev = device_bitrev(planes[0].shape[-1], str(planes[0].device))
    return tuple(p[..., rev] for p in planes)


def special_fft_plain(planes, m: int, inverse: bool):
    """The plain version of K4: forward, the bit reversal (a torch gather)
    and then the stages; inverse, the stages (1/n folded in) and then the
    bit reversal -> four contiguous (rows, n) planes."""
    _rows_shape(planes)
    if not inverse:
        return fft_rows_plain(bitrev_planes(planes), m, False)
    return bitrev_planes(fft_rows_plain(planes, m, True))


def special_fft_cuda(planes, m: int, inverse: bool):
    """CUDA launch of ``fft_df.cu``; same function as
    ``special_fft_plain``. The four planes may be (rows, n) views of one
    row stride (the staged decode's halves of (B, N) rows): the kernel
    reads them through it. The output planes are contiguous."""
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError("special_fft_cuda needs CUDA tensors")
    rows, n = _rows_shape(planes)
    if rows == 0:
        raise ValueError("special_fft_cuda needs at least one row")
    if any(p.stride() != planes[0].stride() for p in planes) \
            or planes[0].stride(1) != 1:
        planes = tuple(p.contiguous() for p in planes)
    for i, t in enumerate(planes):
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != (rows, n):
            raise ValueError(f"planes[{i}] must be a ({rows}, {n}) float32 "
                             f"tensor on {dev}")
    tw = device_twiddles(n, m, inverse, str(dev))
    outs = tuple(torch.empty((rows, n), dtype=torch.float32, device=dev)
                 for _ in planes)
    common.launch("special_fft_launch", dev, *(p.data_ptr() for p in planes),
                  planes[0].stride(0), *(o.data_ptr() for o in outs),
                  tw.data_ptr(), rows, n.bit_length() - 1, int(inverse))
    LAUNCHES["special_ifft" if inverse else "special_fft"] += 1
    return outs


def _special_fft(planes, m: int, inverse: bool):
    if common.route(planes[0].device) == "cuda":
        return special_fft_cuda(planes, m, inverse)
    return special_fft_plain(planes, m, inverse)


def special_fft_planes(planes, m: int):
    """Decode-direction transform on four (rows, n) float32 df planes:
    bit-reversal, then the forward stages."""
    return _special_fft(planes, m, inverse=False)


def special_ifft_planes(planes, m: int):
    """Encode-direction transform (1/n folded in) on four (rows, n)
    float32 df planes: the inverse stages, then bit-reversal."""
    return _special_fft(planes, m, inverse=True)


def _to_planes(z: np.ndarray, device):
    z = torch.as_tensor(np.asarray(z, np.complex128), device=device)
    return dfl.dfc_to_planes(dfl.dfc_from_parts(z.real, z.imag))


def _from_planes(planes) -> np.ndarray:
    return dfl.dfc_to_complex(dfl.dfc_from_planes(planes)).cpu().numpy()


def special_fft_rows(z: np.ndarray, m: int, device=None) -> np.ndarray:
    """Decode-direction transform of (rows, n) complex through K4 (on the
    card unless ``device`` is the CPU, then its plain version)."""
    dev = common.resolve_device(device, "special_fft_rows")
    return _from_planes(special_fft_planes(_to_planes(z, dev), m))


def special_ifft_rows(z: np.ndarray, m: int, device=None) -> np.ndarray:
    """Encode-direction transform (1/n included) of (rows, n) complex
    through K4."""
    dev = common.resolve_device(device, "special_ifft_rows")
    return _from_planes(special_ifft_planes(_to_planes(z, dev), m))
