"""Evaluation-key material for the server-side CKKS evaluator.

Port of ``repro.fhe_server.keys`` (eager PyTorch on the client's device; the
reference also computes it outside any TPU kernel). Hybrid (special-modulus
/ GHS) key switching: one NTT-friendly prime P beyond the L ciphertext
primes, and one key-switch key per source limb. The key for source limb j
encrypts the gadget

    g_j = P * q~_j * s_from   mod (Q * P),     q~_j = (Q/q_j) * (Q/q_j)^-1

whose residue is delta_ij * (P mod q_i) on ciphertext row i and 0 on the
special row, at every level l (q~_j = delta_ij mod q_i). Keys are generated
once at full L and sliced per level (``ServerEvaluator``). The PRNG stream
layout is the reference's, so the same client seed gives the same key
words.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import modmul, prng
from repro_torch.core import ntt as nttmod
from repro_torch.core.context import CKKSContext
from repro_torch.core.encryptor import SecretKey
from repro_torch.core.ntt import bitrev_indices

# Key-material PRNG streams. The encryption streams grow as 0x10000 + 16 *
# nonce, so key streams live in a high disjoint window: per-key offsets are
# key_id * 0x1000 + j * 64 + row (j < L <= 24, row <= L, so < 0x1000).
STREAM_KSK_A = 0x60000000
STREAM_KSK_E = 0x70000000


# ---------------------------------------------------------------------------
# Galois automorphisms in the NTT evaluation order
# ---------------------------------------------------------------------------


def galois_element(r: int, n: int) -> int:
    """Slot left-rotation by r (z'_j = z_{j+r}) <-> X -> X^g, g = 5^r mod
    2N."""
    return pow(5, r % (n // 2), 2 * n)


def galois_perm_ntt(g: int, n: int) -> np.ndarray:
    """int32 index permutation applying sigma_g to an NTT-domain row:
    sigma_g(A)[i] = A[perm[i]] with brv(perm[i]) = (g*e_i mod 2N - 1)/2,
    e_i = 2*brv(i)+1. The same for every prime row."""
    brv = bitrev_indices(n)
    m = 2 * n
    tgt = (g * (2 * brv + 1)) % m
    return brv[(tgt - 1) // 2].astype(np.int32)


def galois_apply_coeffs(coeffs: np.ndarray, g: int, n: int) -> np.ndarray:
    """Coefficient-domain oracle: a(X) -> a(X^g) mod X^N + 1 (signed)."""
    k = np.arange(n)
    e = (g * k) % (2 * n)
    sign = np.where(e < n, 1, -1).astype(coeffs.dtype)
    out = np.zeros_like(coeffs)
    out[..., e % n] = sign * coeffs
    return out


# ---------------------------------------------------------------------------
# key containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KeySwitchKey:
    """One switch s_from -> s: per source limb j an RLWE pair over Q * P.
    (L, L+1, N) int32 tensors holding uint32 words, Montgomery form; the
    row axis is the L ciphertext primes then the special prime (last, so a
    level-l slice keeps rows [0:l] + [L])."""

    b_mont: torch.Tensor
    a_mont: torch.Tensor

    @property
    def n_limbs(self) -> int:
        return int(self.b_mont.shape[0])


@dataclasses.dataclass(frozen=True)
class EvaluationKeys:
    """Public evaluation material the client hands to the server."""

    n: int
    n_limbs: int
    special_q: int                       # the key-switch prime P
    relin: KeySwitchKey | None           # s^2 -> s   (ct x ct)
    rot: dict                            # {r: KeySwitchKey} sigma_g(s) -> s

    @property
    def rotations(self) -> tuple:
        return tuple(sorted(self.rot))


# ---------------------------------------------------------------------------
# extended-stack helpers (ciphertext primes + special prime)
# ---------------------------------------------------------------------------


def ext_plans(ctx: CKKSContext):
    return tuple(ctx.plans) + (ctx.special_plan(),)


@functools.lru_cache(maxsize=16)
def _ext_sp(ctx: CKKSContext) -> nttmod.StackedPlans:
    return nttmod.stack_plans(ext_plans(ctx))


def _sp_mul(a, b_mont, sp: nttmod.StackedPlans):
    dev = a.device
    return modmul.mulmod_montgomery_limb_t(
        a, b_mont, sp.rows(sp.q, a.dim(), dev),
        sp.rows(sp.qinv_neg, a.dim(), dev))


def _sp_to_mont(x, sp: nttmod.StackedPlans):
    return _sp_mul(x, sp.rows(sp.r2, x.dim(), x.device), sp)


def _sp_small_to_ntt(coeffs, sp: nttmod.StackedPlans):
    """Signed small polynomial (N,) -> (rows, N) NTT-domain residues."""
    q = sp.rows(sp.q, 2, coeffs.device)
    return nttmod.ntt_stacked(prng.signed_to_residue(coeffs[None], q), sp)


# ---------------------------------------------------------------------------
# key generation
# ---------------------------------------------------------------------------


def make_keyswitch_key(ctx: CKKSContext, s_from, s_ext_mont, seed: int,
                       key_id: int) -> KeySwitchKey:
    """ksk_j = (b_j, a_j), b_j = e_j - a_j*s + delta_row-j * (P mod q_j) *
    s_from, every row NTT domain over the extended stack. s_from: (L+1, N)
    plain NTT residues of the source secret, s_ext_mont: (L+1, N)
    Montgomery form of the target secret s (int64 tensors)."""
    L, n = ctx.params.n_limbs, ctx.n
    sp = _ext_sp(ctx)
    dev = s_from.device
    p_special = ctx.special_plan().prime.q
    q_ext = tuple(ctx.q_list) + (p_special,)
    q_col = sp.rows(sp.q, 2, dev)
    b_mont = torch.empty((L, L + 1, n), dtype=torch.int32, device=dev)
    a_mont = torch.empty_like(b_mont)
    for j in range(L):
        base = key_id * 0x1000 + j * 64
        a = prng.uniform_mod_q_rows(
            seed, [STREAM_KSK_A + base + i for i in range(L + 1)], n, q_ext,
            device=dev)
        e_ntt = _sp_small_to_ntt(prng.cbd(seed, STREAM_KSK_E + base, n,
                                          device=dev), sp)
        b = modmul.submod(e_ntt, _sp_mul(a, s_ext_mont, sp), q_col)
        # the gadget lands on row j only: (P mod q_j) * s_from[j]
        qj = q_ext[j]
        pm_mont = (p_special % qj) * ((1 << 32) % qj) % qj
        grow = modmul.mulmod_montgomery_limb_t(s_from[j], pm_mont, qj,
                                               int(sp.qinv_neg[j]))
        b[j] = modmul.addmod(b[j], grow, qj)
        b_mont[j] = modmul.i64_to_u32(_sp_to_mont(b, sp))
        a_mont[j] = modmul.i64_to_u32(_sp_to_mont(a, sp))
    return KeySwitchKey(b_mont=b_mont, a_mont=a_mont)


def make_evaluation_keys(ctx: CKKSContext, sk: SecretKey, rotations=(),
                         include_relin: bool = True,
                         seed: int | None = None) -> EvaluationKeys:
    """Relinearization (s^2 -> s; none when ``include_relin`` is False) and
    one rotation key per requested slot rotation (sigma_g(s) -> s), on the
    secret key's device. Deterministic in (seed, key id), the seed the
    profile's when None, as in the reference."""
    seed = seed if seed is not None else ctx.params.seed
    n = ctx.n
    sp = _ext_sp(ctx)
    s_plain = _sp_small_to_ntt(sk.s_coeffs, sp)          # (L+1, N)
    s_mont = _sp_to_mont(s_plain, sp)
    relin = None
    if include_relin:
        s2 = _sp_mul(s_plain, s_mont, sp)                # s^2, plain domain
        relin = make_keyswitch_key(ctx, s2, s_mont, seed, key_id=0)
    rot = {}
    for r in rotations:
        rn = int(r) % (n // 2)
        if rn == 0 or rn in rot:
            continue
        perm = torch.from_numpy(
            galois_perm_ntt(galois_element(rn, n), n).astype(np.int64)).to(
            s_plain.device)
        rot[rn] = make_keyswitch_key(ctx, s_plain[:, perm], s_mont, seed,
                                     key_id=1 + rn)
    return EvaluationKeys(n=n, n_limbs=ctx.params.n_limbs,
                          special_q=int(ctx.special_plan().prime.q),
                          relin=relin, rot=rot)
