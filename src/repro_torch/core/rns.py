"""Exact RNS digit reduction and two-limb CRT on the uint32 datapath.

Port of the df32 half of ``repro.core.rns``: balanced base-2^22 digits ->
per-limb residues (``digits_to_residue``, or every limb at once:
``digits_to_residues_stacked``), the two-limb CRT to a centered
(sign, hi, lo) word pair (``crt2_centered_u32``, reducing modulo fl64(Q)
as the reference does) and the exact /scale collapse to a df32 pair
(``centered_to_df``). Residues are int64 tensors holding uint32 values.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core import modmul

DIGIT_BITS = 22


@functools.lru_cache(maxsize=256)
def digit_consts(q: int) -> tuple[int, int]:
    """Montgomery-form radix constants (2^22 mod q, 2^44 mod q)."""
    r = 1 << 32
    return (((1 << DIGIT_BITS) * r) % q, ((1 << 2 * DIGIT_BITS) * r) % q)


def _digit_residue(d, q):
    """Signed digit in (-2^23, 2^23) -> residue (|d| < q)."""
    d = d.to(torch.int64)
    return torch.where(d < 0, d + q, d)


def digits_to_residue(d0, d1, d2, q, qinv_neg, c22_mont, c44_mont):
    """(d0 + d1*2^22 + d2*2^44) mod q; constants are Python ints or
    broadcastable int64 tensors."""
    r0 = _digit_residue(d0, q)
    m1 = modmul.mulmod_montgomery_limb_t(_digit_residue(d1, q), c22_mont,
                                         q, qinv_neg)
    m2 = modmul.mulmod_montgomery_limb_t(_digit_residue(d2, q), c44_mont,
                                         q, qinv_neg)
    return modmul.addmod(modmul.addmod(r0, m1, q), m2, q)


def digits_to_residues_stacked(d0, d1, d2, q_list) -> torch.Tensor:
    """All limbs at once: digits (..., N) -> (L, ..., N) int64 residues,
    each limb's constants broadcast along the leading axis."""
    shape = (len(q_list),) + (1,) * d0.dim()
    r = 1 << 32

    def col(values):
        return torch.tensor(values, dtype=torch.int64,
                            device=d0.device).reshape(shape)

    q = col([int(qi) for qi in q_list])
    qinv = col([(-pow(int(qi), -1, r)) % r for qi in q_list])
    c22 = col([digit_consts(int(qi))[0] for qi in q_list])
    c44 = col([digit_consts(int(qi))[1] for qi in q_list])
    return digits_to_residue(d0[None], d1[None], d2[None], q, qinv, c22, c44)


@functools.lru_cache(maxsize=64)
def crt2_consts(q0: int, q1: int) -> dict:
    """Constants of the two-limb CRT; ``q_w``/``half_w`` are the word pairs
    of fl64(q0*q1), the reference's (rounded) reduction modulus."""
    r = 1 << 32
    qq = int(float(q0 * q1))
    half = qq // 2
    return {
        "g0_mont": (pow(q1 % q0, -1, q0) * r) % q0,
        "g1_mont": (pow(q0 % q1, -1, q1) * r) % q1,
        "qinv0": (-pow(q0, -1, r)) % r,
        "qinv1": (-pow(q1, -1, r)) % r,
        "q_w": (qq >> 32, qq & 0xFFFFFFFF),
        "half_w": (half >> 32, half & 0xFFFFFFFF),
    }


def crt2_centered_u32(c0, c1, q0: int, q1: int):
    """Two-limb CRT -> (sign, hi, lo), value = sign * (hi*2^32 + lo): the
    reference's word-pair sequence, borrows masked to 32 bits."""
    k = crt2_consts(q0, q1)
    t0 = modmul.mulmod_montgomery_limb_t(c0, k["g0_mont"], q0, k["qinv0"])
    t1 = modmul.mulmod_montgomery_limb_t(c1, k["g1_mont"], q1, k["qinv1"])
    h0, l0 = modmul.mul32x32(t0, q1)
    h1, l1 = modmul.mul32x32(t1, q0)
    hi, lo = modmul._add64(h0, l0, h1, l1)
    qh, ql = k["q_w"]
    over = modmul._ge64(hi, lo, qh, ql)
    sh, sl = modmul._sub64(hi, lo, qh, ql)
    hi = torch.where(over, sh, hi)
    lo = torch.where(over, sl, lo)
    hh, hl = k["half_w"]
    gt = modmul._gt64(hi, lo, hh, hl)
    geq = modmul._ge64(hi, lo, qh, ql)
    dh, dl = modmul._sub64(hi, lo, qh, ql)
    qh_t = torch.full_like(hi, qh)
    ql_t = torch.full_like(lo, ql)
    nh, nl = modmul._sub64(qh_t, ql_t, hi, lo)
    neg = gt & ~geq
    out_h = torch.where(neg, nh, torch.where(gt & geq, dh, hi))
    out_l = torch.where(neg, nl, torch.where(gt & geq, dl, lo))
    one = torch.ones(hi.shape, dtype=dfl.F32, device=hi.device)
    sign = torch.where(neg, -one, one)
    return sign, out_h, out_l


def centered_to_df(sign, hi, lo, inv_scale) -> dfl.DF:
    """(sign, word pair) * inv_scale -> df32 pair: four exact 16-bit-field
    terms, exact power-of-two scaling, one pair collapse."""
    s = sign * inv_scale
    w0 = (lo & 0xFFFF).to(dfl.F32) * s
    w1 = (lo >> 16).to(dfl.F32) * 2.0 ** 16 * s
    w2 = (hi & 0xFFFF).to(dfl.F32) * 2.0 ** 32 * s
    w3 = (hi >> 16).to(dfl.F32) * 2.0 ** 48 * s
    return dfl.terms4_to_df(w3, w2, w1, w0)
