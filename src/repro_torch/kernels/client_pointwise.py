"""Plain per-limb stages of the client datapath (encrypt and decrypt).

Port of the stage functions of ``repro.kernels.client_pointwise`` that the
megakernels run: the Philox samplers keyed by one stream per batch row
(``sample_vee_k``), the df32 RNS digit stage, and the per-limb encrypt and
decrypt stages. Residues are int64 tensors holding uint32 values.
"""

from __future__ import annotations

import torch

from repro_torch.core import modmul, prng, rns
from repro_torch.core.encryptor import (STREAM_ENC_E0, STREAM_ENC_E1,
                                        STREAM_ENC_V)
from repro_torch.core.modmul import MASK32
from repro_torch.kernels import common


def _zo_k(seed128: int, stream: torch.Tensor, n: int):
    """(rows, n) ZO draws, one stream per row (int64 (rows, 1) column)."""
    return prng.zo_from_u32(prng.random_u32_rows(seed128, stream, n, 0))


def _cbd_k(seed128: int, stream: torch.Tensor, n: int):
    return prng.cbd_from_u32(prng.random_u32_rows(seed128, stream, n, 0),
                             prng.random_u32_rows(seed128, stream, n, 1))


def _to_residue_k(x, q: int):
    """Signed int32 in (-q, q) -> residue."""
    x = x.to(torch.int64)
    return torch.where(x < 0, x + q, x)


def sample_vee_k(seed: int, nonce: torch.Tensor, n: int):
    """Signed (v, e0, e1) for each batch row; nonce: int64 (rows, 1) column
    of uint32 nonces. Stream ids wrap modulo 2^32 as in the reference."""
    sv = (STREAM_ENC_V + 16 * nonce) & MASK32
    s0 = (STREAM_ENC_E0 + 16 * nonce) & MASK32
    s1 = (STREAM_ENC_E1 + 16 * nonce) & MASK32
    return _zo_k(seed, sv, n), _cbd_k(seed, s0, n), _cbd_k(seed, s1, n)


def rns_digit_stage(digits, kc: common.StackedKernelConsts, limb: int,
                    c22_mont: int, c44_mont: int):
    """Balanced base-2^22 digits -> this limb's residues."""
    d0, d1, d2 = digits
    return rns.digits_to_residue(
        d0, d1, d2, int(kc.table[limb, common.OFF_Q]),
        int(kc.table[limb, common.OFF_QINV]), c22_mont, c44_mont)


def encrypt_limb_stage(vee, pt_l, b_l, a_l, kc: common.StackedKernelConsts,
                       limb: int):
    """Signed (v, e0, e1) -> residues -> one stacked NTT -> c0 = v*b + e0 +
    pt, c1 = v*a + e1. pt_l/b_l/a_l int64; returns int64 (rows, N) each."""
    q = int(kc.table[limb, common.OFF_Q])
    qinv = int(kc.table[limb, common.OFF_QINV])
    v, e0, e1 = (_to_residue_k(x, q) for x in vee)
    h = common.ntt_stages_t(torch.cat([v, e0, e1], dim=0), kc, limb)
    v_h, e0_h, e1_h = torch.chunk(h, 3, dim=0)
    vb = modmul.mulmod_montgomery_limb_t(v_h, b_l, q, qinv)
    va = modmul.mulmod_montgomery_limb_t(v_h, a_l, q, qinv)
    c0_l = modmul.addmod(modmul.addmod(vb, e0_h, q), pt_l, q)
    c1_l = modmul.addmod(va, e1_h, q)
    return c0_l, c1_l


def decrypt_limb_stage(c0_l, c1_l, s_l, kc: common.StackedKernelConsts,
                       limb: int):
    """m = INTT(c0 + c1*s) for one limb (int64 in and out)."""
    q = int(kc.table[limb, common.OFF_Q])
    qinv = int(kc.table[limb, common.OFF_QINV])
    c1s = modmul.mulmod_montgomery_limb_t(c1_l, s_l, q, qinv)
    return common.intt_stages_t(modmul.addmod(c0_l, c1s, q), kc, limb)
