"""Modular arithmetic on uint32 residues carried in int64 tensors.

Port of ``repro.core.modmul``: the 16-bit-limb 32x32 products, the three
Montgomery REDC engines on 32-bit limbs (``mulmod_montgomery_limb_t`` with
per-limb constants, ``mulmod_montgomery_limb`` with static ones, and the
NTT-friendly shift-add ``mulmod_montgomery_sa_limb`` of paper eq. 9-11),
Barrett on limbs, ``addmod``/``submod``, the u32 word-pair helpers, and the
u64 oracles (``mulmod_naive_u64``, ``mulmod_montgomery_u64``,
``to_mont_u64``, ``from_mont_u64``) with their stacked-limb forms
(``mulmod_montgomery_u64_stacked``, ``mulmod_montgomery_stacked``), and
``OP_COSTS``, the engines' multiply counts (paper Table I). The
reference computes in uint32 and
wraps modulo 2^32; here every value is a non-negative int64 below 2^32 and
each wrapping step masks with ``MASK32``. No limb product exceeds 2^48, so
nothing depends on int64 overflow. The u64 oracles take residues below
q < 2^31, so their products stay below 2^62.
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
        assert q < 1 << 31
        r = 1 << _R_BITS
        qinv = pow(q, -1, r)
        x = (1 << prime.p_bw) + prime.k * (1 << prime.n_plus_1)
        assert (1 - x) % r == qinv, "eq.(11) closed form violated"
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


def _shift64(v, s: int):
    """(hi, lo) of a uint32 value shifted left by s in [0, 64)."""
    if s == 0:
        return torch.zeros_like(v), v
    if s < 32:
        return v >> (32 - s), (v << s) & MASK32
    return (v << (s - 32)) & MASK32, torch.zeros_like(v)


def _neg64(hi, lo):
    """(hi, lo) of -(hi, lo) mod 2^64."""
    lo_n = (~lo + 1) & MASK32
    hi_n = (~hi + (lo_n == 0).to(torch.int64)) & MASK32
    return hi_n, lo_n


def _mul_by_k64(v, k_terms):
    """(hi, lo) of v * k (two's complement mod 2^64) for k = sum of signed
    powers of two ((sign, exponent) terms): shifts and adds only."""
    hi = torch.zeros_like(v)
    lo = torch.zeros_like(v)
    for sign, e in k_terms:
        thi, tlo = _shift64(v, e)
        if sign < 0:
            thi, tlo = _neg64(thi, tlo)
        hi, lo = _add64(hi, lo, thi, tlo)
    return hi, lo


def mulmod_montgomery_limb(a, b_mont, c: MontgomeryConstants):
    """Vanilla Montgomery REDC with the prime's constants: 4 + 3 + 4
    16-bit-limb multiplies (``mulmod_montgomery_limb_t`` with c.q and
    c.qinv_neg)."""
    return mulmod_montgomery_limb_t(a, b_mont, c.q, c.qinv_neg)


def mulmod_montgomery_sa_limb(a, b_mont, c: MontgomeryConstants):
    """NTT-friendly Montgomery REDC (paper eq. 9-11): only a*b is a general
    multiply; m = t_lo * (-q^-1) and m*q are shifts and adds of the prime's
    k-terms (q = 2^p_bw + k 2^(n+1) + 1). The same words as the reference
    and as every other correct REDC."""
    assert c.p_bw < 32 and 0 < c.n_plus_1 < 32
    t_hi, t_lo = mul32x32(a, b_mont)
    # m = t_lo * (x - 1) mod 2^32,  x = 2^p_bw + k*2^(n+1)
    tk_lo = _mul_by_k64(t_lo, c.k_terms)[1]
    m = ((t_lo << c.p_bw) + (tk_lo << c.n_plus_1) - t_lo) & MASK32
    # m*q = (m << p_bw) + ((m*k) << (n+1)) + m   (64-bit shift-add)
    mq_hi, mq_lo = _shift64(m, c.p_bw)
    kk_hi, kk_lo = _mul_by_k64(m, c.k_terms)
    s = c.n_plus_1
    kk_hi = ((kk_hi << s) | (kk_lo >> (32 - s))) & MASK32
    kk_lo = (kk_lo << s) & MASK32
    mq_hi, mq_lo = _add64(mq_hi, mq_lo, kk_hi, kk_lo)
    mq_hi, _ = _add64(mq_hi, mq_lo, torch.zeros_like(m), m)
    u = (t_hi + mq_hi + (t_lo != 0).to(torch.int64)) & MASK32
    return torch.where(u >= c.q, u - c.q, u)


# Static op costs per modmul (the paper's Table-I analogue). "mul" counts the
# 16x16 general multiplies of the 16-bit-limb engines above (the reference's,
# which these plain versions copy op for op): ``mulmod_barrett_limb`` 12,
# ``mulmod_montgomery_limb`` 11, ``mulmod_montgomery_sa_limb`` 4; "corrections"
# the conditional subtractions. tests/test_torch_analytic.py counts the
# multiplies of each engine's run against this table.
OP_COSTS = {
    "barrett": {"mul": 12, "corrections": 2},
    "montgomery": {"mul": 11, "corrections": 1},
    "ntt_friendly": {"mul": 4, "corrections": 1},
}


# ---------------------------------------------------------------------------
# u64 oracles, carried as int64 (residues < q < 2^31: products < 2^62)
# ---------------------------------------------------------------------------


def mulmod_naive_u64(a, b, q: int):
    return (a * b) % q


def mulmod_montgomery_u64(a, b_mont, c: MontgomeryConstants):
    """REDC(a * b_mont) = a*b mod q, given b in Montgomery form."""
    return mulmod_montgomery_u64_t(a, b_mont, c.q, c.qinv_neg)


def mulmod_montgomery_u64_t(a, b_mont, q, qinv_neg):
    """The u64 REDC with the constants as Python ints or broadcastable
    int64 tensors (the reference's ``mulmod_montgomery_u64_t``, the f64
    datapath's engine of the server kernels). a < 2^32 and b_mont < q, so
    t = a b < 2^63; (t + m q) >> 32 (a sum that can pass 2^63) is taken as
    (t >> 32) + (m q >> 32) + carry, the carry being (t_lo != 0) since
    t + m q = 0 mod 2^32: nothing leans on int64 overflow."""
    t = a * b_mont
    t_lo = t & MASK32
    m = mul32x32_lo(t_lo, qinv_neg)
    u = (t >> 32) + ((m * q) >> 32) + (t_lo != 0).to(torch.int64)
    return torch.where(u >= q, u - q, u)


def mulmod_montgomery_u64_stacked(a, b_mont, q, qinv_neg):
    """REDC on stacked limbs: per-limb constants as broadcastable int64
    tensors (L, 1, ..., 1) against (L, ..., N) operands. Bit-identical per
    limb to ``mulmod_montgomery_u64`` with that limb's constants."""
    return mulmod_montgomery_u64_t(a, b_mont, q, qinv_neg)


def mulmod_montgomery_stacked(a, b_mont, q, qinv_neg):
    """Stacked-limb REDC on the 16-bit-limb engine, which the reference
    runs without x64; the same words as ``mulmod_montgomery_u64_stacked``.
    """
    return mulmod_montgomery_limb_t(a, b_mont, q, qinv_neg)


def to_mont_u64(a, c: MontgomeryConstants):
    return mulmod_montgomery_u64(a, c.r2, c)


def from_mont_u64(a, c: MontgomeryConstants):
    return mulmod_montgomery_u64(a, 1, c)
