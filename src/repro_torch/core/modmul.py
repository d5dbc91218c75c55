"""Modular arithmetic on uint32 residues carried in int64 tensors.

Port of ``repro.core.modmul`` (the parts the client path runs): the
16-bit-limb 32x32 products, the traced-constant Montgomery REDC
(``mulmod_montgomery_limb_t``), Barrett on limbs (PRNG ``uniform_mod_q``),
``addmod``/``submod`` and the u32 word-pair helpers. The reference computes
in uint32 and wraps modulo 2^32; here every value is a non-negative int64
below 2^32 and each wrapping step masks with ``MASK32``. No product exceeds
2^48, so nothing depends on int64 overflow.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.primes import NTTPrime

MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF
_R_BITS = 32


@dataclasses.dataclass(frozen=True)
class MontgomeryConstants:
    """Per-prime constants (same fields as the reference)."""

    q: int
    qinv_neg: int        # -q^{-1} mod 2^32
    r2: int              # R^2 mod q
    r1: int              # R mod q
    mu: int              # floor(2^(2p) / q), p = bitlen(q) (Barrett)
    p_bw: int
    n_plus_1: int
    k_terms: tuple[tuple[int, int], ...]

    @classmethod
    def make(cls, prime: NTTPrime) -> "MontgomeryConstants":
        q = prime.q
        if q >= 1 << 31:
            raise ValueError(f"q={q} must be below 2^31")
        r = 1 << _R_BITS
        qinv = pow(q, -1, r)
        x = (1 << prime.p_bw) + prime.k * (1 << prime.n_plus_1)
        if (1 - x) % r != qinv:
            raise ValueError("eq.(11) closed form violated")
        return cls(q=q, qinv_neg=(-qinv) % r, r2=(r * r) % q, r1=r % q,
                   mu=(1 << (2 * q.bit_length())) // q, p_bw=prime.p_bw,
                   n_plus_1=prime.n_plus_1, k_terms=prime.k_terms)


def u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any integer tensor) -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def i64_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 holding the same uint32 bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def addmod(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def submod(a, b, q):
    return torch.where(a >= b, a - b, a + (q - b))


def mul32x32(a, b):
    """Full 32x32 -> (hi, lo) product of uint32 values, 16-bit limbs."""
    a0, a1 = a & MASK16, a >> 16
    b0, b1 = b & MASK16, b >> 16
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = (ll >> 16) + (lh & MASK16) + (hl & MASK16)
    lo = ((mid & MASK16) << 16) | (ll & MASK16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def mul32x32_lo(a, b):
    """Low 32 bits of a*b (the reference wraps; here: mask)."""
    a0, a1 = a & MASK16, a >> 16
    b0 = b & MASK16
    b1 = b >> 16
    return ((a0 * b0) + ((a0 * b1 + a1 * b0) << 16)) & MASK32


def _add64(hi_a, lo_a, hi_b, lo_b):
    lo = (lo_a + lo_b) & MASK32
    carry = (lo < lo_a).to(torch.int64)
    return (hi_a + hi_b + carry) & MASK32, lo


def _sub64(hi_a, lo_a, hi_b, lo_b):
    """(hi, lo) of a - b on u32 word pairs (a >= b), borrows masked."""
    borrow = (lo_a < lo_b).to(torch.int64)
    return (hi_a - hi_b - borrow) & MASK32, (lo_a - lo_b) & MASK32


def _ge64(hi_a, lo_a, hi_b, lo_b):
    return (hi_a > hi_b) | ((hi_a == hi_b) & (lo_a >= lo_b))


def _gt64(hi_a, lo_a, hi_b, lo_b):
    return (hi_a > hi_b) | ((hi_a == hi_b) & (lo_a > lo_b))


def mulmod_montgomery_limb_t(a, b_mont, q, qinv_neg):
    """Montgomery REDC(a * b_mont) with per-limb (q, -q^-1 mod 2^32):
    4 + 3 + 4 16-bit-limb multiplies, one conditional subtraction — the
    exact words ``repro.core.modmul.mulmod_montgomery_limb_t`` returns."""
    t_hi, t_lo = mul32x32(a, b_mont)
    m = mul32x32_lo(t_lo, qinv_neg)
    mq_hi, _ = mul32x32(m, q)
    u = t_hi + mq_hi + (t_lo != 0).to(torch.int64)
    return torch.where(u >= q, u - q, u)


def mulmod_barrett_limb(a, b, c: MontgomeryConstants):
    """Barrett on 32-bit limbs (plain residues), as the reference."""
    return mulmod_barrett_t(a, b, c.q, c.mu, c.q.bit_length())


def mulmod_barrett_t(a, b, q, mu, p):
    """``mulmod_barrett_limb`` with the constants (q, mu = 2^2p // q, p =
    bitlen(q)) as Python ints or broadcastable int64 tensors (one prime per
    row)."""
    t_hi, t_lo = mul32x32(a, b)
    t1 = ((t_hi << (32 - (p - 1))) | (t_lo >> (p - 1))) & MASK32
    f_hi, f_lo = mul32x32(t1, mu)
    m = ((f_hi << (32 - (p + 1))) | (f_lo >> (p + 1))) & MASK32
    mq_hi, mq_lo = mul32x32(m, q)
    borrow = (t_lo < mq_lo).to(torch.int64)
    r = (t_lo - mq_lo) & MASK32
    extra = (t_hi - mq_hi - borrow) & MASK32
    r = torch.where(extra > 0, (r - q) & MASK32, r)
    r = torch.where(r >= q, r - q, r)
    r = torch.where(r >= q, r - q, r)
    return r
