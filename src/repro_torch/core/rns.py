"""Exact RNS reduction, two-limb CRT and key-switch digits.

Port of ``repro.core.rns``:

  * the df32 datapath: balanced base-2^22 digits -> per-limb residues
    (``digits_to_residue``, or every limb at once:
    ``digits_to_residues_stacked``), the two-limb CRT to a centered
    (sign, hi, lo) word pair (``crt2_centered_u32``, reducing modulo
    fl64(Q) as the reference does) and the exact /scale collapse to a df32
    pair (``centered_to_df``);
  * the f64 datapath: integer-valued df64 pairs -> residues by exact fmod
    (``to_rns_df``, or one limb against a float64 modulus:
    ``to_rns_limb_t``, the step K5's f64 branch runs) and the two-limb CRT
    to a centered df64 pair (``crt2_to_df``; its products t*q < 2^62 are
    carried in int64);
  * the key-switch decomposition: ``ks_center_t`` (residue -> centered
    digit) and ``ks_residue_t`` (digit -> residue on another prime);
  * the exact Python-int oracles ``to_rns_exact`` / ``crt_exact`` (tests).

Residues are int64 tensors holding uint32 values.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core import modmul

DIGIT_BITS = 22


# ---------------------------------------------------------------------------
# the f64 datapath: exact df64 pairs
# ---------------------------------------------------------------------------


def to_rns_df(x: dfl.DF, q_list) -> torch.Tensor:
    """Integer-valued float64 pair (..., N) -> (L, ..., N) int64 residues.
    fmod of an integer-valued double by q < 2^31 is exact, so each residue
    is an exact function of the integer hi + lo."""
    qf = torch.tensor([float(q) for q in q_list], dtype=torch.float64,
                      device=x.hi.device).reshape(
        (len(q_list),) + (1,) * x.hi.dim())
    r = torch.fmod(x.hi[None], qf) + torch.fmod(x.lo[None], qf)  # (-2q, 2q)
    r = torch.fmod(r, qf)
    r = torch.where(r < 0, r + qf, r)
    return r.to(torch.int64)


def to_rns_limb_t(x: dfl.DF, qf) -> torch.Tensor:
    """One limb of ``to_rns_df``: `qf` a float64 modulus (a Python float
    or a 0-d tensor). The same fmod / select sequence, so the residues
    equal that limb of the broadcasted pass."""
    qf = torch.as_tensor(qf, dtype=torch.float64, device=x.hi.device)
    r = torch.fmod(x.hi, qf) + torch.fmod(x.lo, qf)     # in (-2q, 2q)
    r = torch.fmod(r, qf)
    r = torch.where(r < 0, r + qf, r)
    return r.to(torch.int64)


def _prod_df(a: torch.Tensor, b: float) -> dfl.DF:
    hi, lo = dfl.two_prod(a, torch.tensor(b, dtype=torch.float64,
                                          device=a.device))
    return dfl.DF(hi, lo)


def _cond_sub(v: dfl.DF, q: float) -> dfl.DF:
    over = v.hi >= q
    vq = dfl.df_sub(v, dfl.df_const(q, v.hi.device, torch.float64))
    return dfl.DF(torch.where(over, vq.hi, v.hi),
                  torch.where(over, vq.lo, v.lo))


def crt2_inverses(q0: int, q1: int) -> tuple[int, int]:
    """g_i = (Q/q_i)^-1 mod q_i of the two-limb CRT."""
    return pow(q1 % q0, -1, q0), pow(q0 % q1, -1, q1)


def crt2_to_df(c0: torch.Tensor, c1: torch.Tensor, q0: int,
               q1: int) -> dfl.DF:
    """Two-limb CRT -> the centered integer as an exact df64 pair.
    x = [c0 g0]_{q0} q1 + [c1 g1]_{q1} q0 (mod Q); each product t_i q_j <
    2^62 is made exact with two_prod, the sum and the conditional
    subtractions of fl64(Q) stay in df64. c0/c1: int64 residues."""
    g0, g1 = crt2_inverses(q0, q1)
    t0 = (c0.to(torch.int64) * g0) % q0          # < 2^63: exact in int64
    t1 = (c1.to(torch.int64) * g1) % q1
    a = _prod_df(t0.to(torch.float64), float(q1))
    b = _prod_df(t1.to(torch.float64), float(q0))
    v = dfl.df_add(a, b)                         # < 2Q
    qq = q0 * q1
    v = _cond_sub(v, float(qq))                  # mod Q
    half = float(qq) / 2.0
    over = v.hi > half
    vq = dfl.df_sub(v, dfl.df_const(float(qq), v.hi.device, torch.float64))
    return dfl.DF(torch.where(over, vq.hi, v.hi),
                  torch.where(over, vq.lo, v.lo))


# ---------------------------------------------------------------------------
# the df32 datapath: base-2^22 digits and u32 word pairs
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# key-switch decomposition (server-side evaluation)
# ---------------------------------------------------------------------------
# Every prime of the eq.(8) family lies in [2^30, 2^31), so a digit centered
# on its source prime (|w| <= q_src/2 < 2^30) is below every target modulus:
# base extension is one conditional add, no reduction.


def ks_center_t(v: torch.Tensor, q) -> torch.Tensor:
    """Residues in [0, q) -> centered digits in (-q/2, q/2] (q odd: values
    above q >> 1 map down by q), as int64 tensors."""
    return torch.where(v > (q >> 1), v - q, v)


def ks_residue_t(w: torch.Tensor, q) -> torch.Tensor:
    """Centered digit |w| < q -> its residue mod q (one conditional add)."""
    return torch.where(w < 0, w + q, w)


# ---------------------------------------------------------------------------
# exact oracles (tests only)
# ---------------------------------------------------------------------------


def to_rns_exact(values, q_list) -> np.ndarray:
    """Python ints -> (L, len(values)) uint32 residues."""
    return np.array([[int(v) % q for v in values] for q in q_list],
                    dtype=np.uint32)


def crt_exact(residues: np.ndarray, q_list) -> list[int]:
    """Full CRT of (L, N) residues to centered Python ints."""
    qq = math.prod(int(q) for q in q_list)
    basis = []
    for q in q_list:
        m = qq // int(q)
        basis.append(m * pow(m % int(q), -1, int(q)))
    out = []
    for j in range(residues.shape[1]):
        v = sum(int(residues[i, j]) * basis[i]
                for i in range(len(q_list))) % qq
        out.append(v - qq if v > qq // 2 else v)
    return out
