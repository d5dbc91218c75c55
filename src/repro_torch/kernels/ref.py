"""Oracles of the kernels over the exact transforms.

Port of ``repro.kernels.ref``: ``ntt_rows`` / ``intt_rows`` run
``core.ntt.ntt`` / ``intt`` (table twiddles, the u64 REDC oracle) on
(rows, N) int32 tensors holding uint32 words; ``encrypt_pointwise`` /
``decrypt_pointwise`` are the per-limb pointwise encrypt and decrypt under
the u64 REDC; ``special_fft_rows`` / ``special_ifft_rows`` the complex128
oracle of the SpecialFFT; ``fourstep_permutation``, the reference's flat
(k1, k2) -> k1*N2 + k2 slot map of the four-step output, which is the
identity (the four-step output is in natural order, out[k] =
a(psi^(2k+1))).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fft as fftmod
from repro_torch.core import modmul
from repro_torch.core import ntt as nttmod
from repro_torch.core.context import CKKSContext
from repro_torch.core.ntt import NTTPlan


def ntt_rows(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """(rows, N) int32 words -> forward negacyclic NTT (bit-reversed
    order), exact path."""
    return modmul.i64_to_u32(nttmod.ntt(modmul.u32_to_i64(x), plan))


def intt_rows(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Inverse of ``ntt_rows`` (bit-reversed input), exact path."""
    return modmul.i64_to_u32(nttmod.intt(modmul.u32_to_i64(x), plan))


def fourstep_permutation(n: int, n1: int) -> np.ndarray:
    """The flat index k1*N2 + k2 of each four-step output slot (k1, k2),
    N2 = n // n1: the identity permutation of arange(n), as in the
    reference. The four-step path is validated by round trip and by
    negacyclic polymul against the schoolbook oracle, which do not depend
    on the output order."""
    n2 = n // n1
    k1, k2 = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    return (k1 * n2 + k2).reshape(-1)


def special_fft_rows(z: np.ndarray, m: int) -> np.ndarray:
    """complex128 oracle of the decode-direction transform."""
    return fftmod.special_fft(z, m)


def special_ifft_rows(z: np.ndarray, m: int) -> np.ndarray:
    return fftmod.special_ifft(z, m)


def encrypt_pointwise(pt, v_ntt, e0_ntt, e1_ntt, b_mont, a_mont,
                      ctx: CKKSContext, n_limbs: int):
    """c0 = v*b + e0 + pt ; c1 = v*a + e1 (all NTT domain, per limb), on
    (L, N) int32 words -> two (n_limbs, N) int32 stacks."""
    u = modmul.u32_to_i64
    c0, c1 = [], []
    for i in range(n_limbs):
        q, c = ctx.q_list[i], ctx.plans[i].mont
        vb = modmul.mulmod_montgomery_u64(u(v_ntt[i]), u(b_mont[i]), c)
        va = modmul.mulmod_montgomery_u64(u(v_ntt[i]), u(a_mont[i]), c)
        c0.append(modmul.addmod(modmul.addmod(vb, u(e0_ntt[i]), q),
                                u(pt[i]), q))
        c1.append(modmul.addmod(va, u(e1_ntt[i]), q))
    return (modmul.i64_to_u32(torch.stack(c0)),
            modmul.i64_to_u32(torch.stack(c1)))


def decrypt_pointwise(c0, c1, s_mont, ctx: CKKSContext, n_limbs: int):
    """m_ntt = c0 + c1 * s per limb (NTT domain), int32 words."""
    u = modmul.u32_to_i64
    out = []
    for i in range(n_limbs):
        q, c = ctx.q_list[i], ctx.plans[i].mont
        c1s = modmul.mulmod_montgomery_u64(u(c1[i]), u(s_mont[i]), c)
        out.append(modmul.addmod(u(c0[i]), c1s, q))
    return modmul.i64_to_u32(torch.stack(out))
