"""Double-float32 (df32) error-free arithmetic, as eager PyTorch.

Port of ``repro.core.dfloat``: an unevaluated (hi, lo) pair of float32
values (df32, the kernels' datapath) or of float64 values (df64, the exact
host-side Delta-scale and CRT of ``datapath='f64'``), built from
Dekker/Knuth error-free transforms. The Veltkamp splitter follows the
operands' dtype (2^12 + 1 for float32, 2^27 + 1 for float64). The order of
every operation is the reference's, and each operation is a separate eager
op, so nothing can contract a multiply and an add into an FMA (which would
change the low word). Never run these under ``torch.compile``. Scalars enter
as Python floats exactly representable in the operands' dtype, or as
tensors of that dtype. ``effective_mantissa_bits`` is the worst-case
mantissa of a pair (49 bits for df32, 107 for df64).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

F32 = torch.float32
F64 = torch.float64


def _split_const(dtype) -> float:
    """Veltkamp splitter 2^ceil(p/2) + 1 for a p-bit mantissa."""
    return float(2 ** 12 + 1) if dtype == F32 else float(2 ** 27 + 1)


class DF(NamedTuple):
    """Unevaluated sum hi + lo with |lo| <= ulp(hi)/2."""

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def dtype(self):
        return self.hi.dtype


class DFComplex(NamedTuple):
    re: DF
    im: DF


def two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Requires |a| >= |b|."""
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    """Error-free a*b = p + e via Veltkamp splitting (no FMA)."""
    p = a * b
    c = _split_const(a.dtype)
    a_hi = c * a - (c * a - a)
    a_lo = a - a_hi
    b_hi = c * b - (c * b - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add(x: DF, y: DF) -> DF:
    s, e = two_sum(x.hi, y.hi)
    e = e + x.lo + y.lo
    return DF(*quick_two_sum(s, e))


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, DF(-y.hi, -y.lo))


def df_mul(x: DF, y: DF) -> DF:
    p, e = two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    return DF(*quick_two_sum(p, e))


def df_neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def df_const(value: float, device=None, dtype=F32) -> DF:
    """A Python float split into a pair of 0-d `dtype` tensors."""
    hi = torch.tensor(value, dtype=dtype, device=device)
    lo = torch.tensor(value - float(hi), dtype=dtype, device=device)
    return DF(hi, lo)


def df_from(x: torch.Tensor, dtype=F32) -> DF:
    """Wider float tensor -> (hi, lo) pair of `dtype`: hi = cast, lo = the
    residual (zero when `x` already has `dtype`)."""
    hi = x.to(dtype)
    if x.dtype == dtype:
        return DF(hi, torch.zeros_like(hi))
    return DF(hi, (x - hi.to(x.dtype)).to(dtype))


def df_to_float(x: DF) -> torch.Tensor:
    """Collapse a pair to one float64 tensor."""
    return x.hi.to(F64) + x.lo.to(F64)


def df_round(x: DF) -> DF:
    """Round to the nearest integer (ties to even), keeping a value wider
    than the mantissa exactly as an integer-valued pair."""
    rh = torch.round(x.hi)
    frac = (x.hi - rh) + x.lo            # exact: |x.hi - rh| <= 0.5
    rl = torch.round(frac)
    return DF(*quick_two_sum(rh, rl))


def dfc_from(z, dtype=F32) -> DFComplex:
    """Complex array or tensor -> DFComplex (each part split by
    ``df_from``)."""
    z = torch.as_tensor(z)
    return DFComplex(df_from(z.real, dtype), df_from(z.imag, dtype))


def dfc_from_parts(re: torch.Tensor, im: torch.Tensor,
                   dtype=F32) -> DFComplex:
    """Real / imaginary float64 parts -> a complex pair of `dtype`."""
    return DFComplex(df_from(re, dtype), df_from(im, dtype))


def dfc_from_planes(planes) -> DFComplex:
    rh, rl, ih, il = planes
    return DFComplex(DF(rh, rl), DF(ih, il))


def dfc_to_planes(z: DFComplex):
    return z.re.hi, z.re.lo, z.im.hi, z.im.lo


def dfc_to_complex(a: DFComplex) -> torch.Tensor:
    """Collapse to one complex128 tensor."""
    return torch.complex(df_to_float(a.re), df_to_float(a.im))


def dfc_add(a: DFComplex, b: DFComplex) -> DFComplex:
    return DFComplex(df_add(a.re, b.re), df_add(a.im, b.im))


def dfc_sub(a: DFComplex, b: DFComplex) -> DFComplex:
    return DFComplex(df_sub(a.re, b.re), df_sub(a.im, b.im))


def dfc_mul(a: DFComplex, b: DFComplex) -> DFComplex:
    """(ac - bd) + i(ad + bc) — four df multiplies."""
    ac = df_mul(a.re, b.re)
    bd = df_mul(a.im, b.im)
    ad = df_mul(a.re, b.im)
    bc = df_mul(a.im, b.re)
    return DFComplex(df_sub(ac, bd), df_add(ad, bc))


def effective_mantissa_bits(dtype) -> int:
    """Worst-case effective mantissa of a df pair (2p+1 bits). ``dtype`` a
    torch or a numpy float dtype."""
    if isinstance(dtype, torch.dtype):
        is_f32 = dtype == F32
    else:
        is_f32 = np.dtype(dtype) == np.float32
    p = 24 if is_f32 else 53
    return 2 * p + 1


# ---------------------------------------------------------------------------
# exact integer expansions (the df32 Delta-scale / CRT interior)
# ---------------------------------------------------------------------------


def _is_odd_int(x):
    """Parity of an integer-valued float32 tensor, exact at any magnitude."""
    half = x * 0.5
    return (x - 2.0 * torch.floor(half)) == 1.0


def df_round_rne(x: DF):
    """Exact round-to-nearest-even of hi + lo as a 3-term integer expansion
    (s, c, b); the reference's two_sum / compare / select chain."""
    s, err = two_sum(x.hi, x.lo)
    rs = torch.round(s)                     # half to even, as jnp.round
    t = s - rs
    f, e = two_sum(t, err)
    fr = torch.round(f)
    d = f - fr
    g, h = two_sum(d, e)
    up = (g > 0.5) | ((g == 0.5) & (h > 0))
    up_tie = (g == 0.5) & (h == 0)
    dn = (g < -0.5) | ((g == -0.5) & (h < 0))
    dn_tie = (g == -0.5) & (h == 0)
    odd = _is_odd_int(rs) != _is_odd_int(fr)
    adj = (up | (up_tie & odd)).to(F32) - (dn | (dn_tie & odd)).to(F32)
    a, b = two_sum(fr, adj)
    s1, c = two_sum(rs, a)
    return s1, c, b


def expansion3_digits(s, c, b):
    """Exact balanced digits (d0, d1, d2), value = d0 + d1*2^22 + d2*2^44,
    |d_i| < 2^23, of the integer s + c + b (|value| < 2^63)."""
    d2 = torch.round(s * 2.0 ** -44)
    s0 = s - d2 * 2.0 ** 44
    u, e2 = two_sum(c, b)
    t1, e1 = two_sum(s0, u)
    t2, t3 = two_sum(e1, e2)
    d1 = torch.round(t1 * 2.0 ** -22)
    d0 = ((t1 - d1 * 2.0 ** 22) + t2) + t3
    return d0, d1, d2


def df_mul_pow2(x: DF, scale: float) -> DF:
    """Exact multiply of a df pair by a power-of-two scalar."""
    return DF(x.hi * scale, x.lo * scale)


def terms4_to_df(w3, w2, w1, w0) -> DF:
    """Collapse four non-overlapping float32 terms (descending) to a pair."""
    s, e1 = two_sum(w1, w0)
    s, e2 = two_sum(w2, s)
    hi, e3 = two_sum(w3, s)
    lo = (e3 + e2) + e1
    return DF(*quick_two_sum(hi, lo))
