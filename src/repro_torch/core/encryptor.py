"""CKKS client key generation and the ciphertext batch container.

Port of ``repro.core.encryptor`` (the client path): the PRNG stream-id
layout (unchanged, so port and reference draw the same streams), ``keygen``
(bit-identical ``s_mont``/``b_mont``/``a_mont`` for the same seed), and
``SecretKey`` / ``PublicKey`` / ``Ciphertext`` / ``CiphertextBatch``
(whose indexing and iteration yield per-row ``Ciphertext`` views, the list
interop ``FHEClient.decrypt_batch`` takes). Keys and ciphertexts
are stored as int32 tensors holding uint32 words: the layout the CUDA
kernels read.

    keygen:   s <- ternary;  a <- U(R_Q) (NTT domain);  e <- CBD
              pk = (b, a),  b = e - a*s
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import modmul, prng
from repro_torch.core import ntt as nttmod
from repro_torch.core.context import CKKSContext

# PRNG stream-id layout (stream = base + limb for per-limb polynomials)
STREAM_SECRET = 0x100
STREAM_PK_A = 0x1000
STREAM_PK_E = 0x2000
STREAM_ENC_V = 0x10000       # + 16*nonce
STREAM_ENC_E0 = 0x20000
STREAM_ENC_E1 = 0x30000


@dataclasses.dataclass
class SecretKey:
    s_mont: torch.Tensor      # (L, N) int32: NTT domain, Montgomery form
    s_coeffs: torch.Tensor    # (N,) int32 ternary coefficients


@dataclasses.dataclass
class PublicKey:
    b_mont: torch.Tensor      # (L, N) int32: NTT domain, Montgomery form
    a_mont: torch.Tensor
    a_stream: int | None = STREAM_PK_A


@dataclasses.dataclass
class Ciphertext:
    """One (L, N) int32 ciphertext (NTT domain) with its scale."""

    c0: torch.Tensor
    c1: torch.Tensor
    n_limbs: int
    scale: float


@dataclasses.dataclass
class CiphertextBatch:
    """(B, L, N) int32 residue stacks (NTT domain) with one shared scale."""

    c0: torch.Tensor
    c1: torch.Tensor
    n_limbs: int
    scale: float

    def __len__(self) -> int:
        return self.c0.shape[0]

    def __getitem__(self, i: int) -> Ciphertext:
        return Ciphertext(c0=self.c0[i], c1=self.c1[i],
                          n_limbs=self.n_limbs, scale=self.scale)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    @classmethod
    def from_cts(cls, cts) -> "CiphertextBatch":
        """Stack ciphertexts of one shared scale (at the fewest limbs)."""
        cts = list(cts)
        if not cts:
            raise ValueError("cannot build a CiphertextBatch from 0 "
                             "ciphertexts")
        if any(ct.scale != cts[0].scale for ct in cts):
            raise ValueError("CiphertextBatch holds one shared scale; for "
                             "mixed scales decode rows with a per-row "
                             "scale array (FHEClient.decrypt_batch does)")
        n_limbs = min(ct.n_limbs for ct in cts)
        return cls(c0=torch.stack([ct.c0[:n_limbs] for ct in cts]),
                   c1=torch.stack([ct.c1[:n_limbs] for ct in cts]),
                   n_limbs=n_limbs, scale=cts[0].scale)

    def truncated(self, n_limbs: int) -> "CiphertextBatch":
        """First `n_limbs` limbs (the 2-limb server-return view); a view,
        no copy."""
        return CiphertextBatch(c0=self.c0[:, :n_limbs],
                               c1=self.c1[:, :n_limbs], n_limbs=n_limbs,
                               scale=self.scale)


def _small_poly_to_ntt(coeffs, sp: nttmod.StackedPlans):
    """Signed small polynomial (N,) -> (L, N) NTT-domain residues."""
    q = sp.rows(sp.q, 2, coeffs.device)
    return nttmod.ntt_stacked(prng.signed_to_residue(coeffs[None], q), sp)


def _mont_mul(a, b_mont, sp: nttmod.StackedPlans):
    dev = a.device
    return modmul.mulmod_montgomery_limb_t(
        a, b_mont, sp.rows(sp.q, a.ndim, dev), sp.rows(sp.qinv_neg, a.ndim,
                                                       dev))


def keygen(ctx: CKKSContext, seed: int | None = None, device=None):
    """(SecretKey, PublicKey) for `seed` (default: the profile's seed)."""
    p = ctx.params
    seed = seed if seed is not None else p.seed
    L, n = p.n_limbs, p.n
    sp = ctx.stacked_plans(L)
    r2 = sp.rows(sp.r2, 2, device)

    s = prng.ternary(seed, STREAM_SECRET, n, device=device)
    s_mont = _mont_mul(_small_poly_to_ntt(s, sp), r2, sp)
    a = torch.stack([
        prng.uniform_mod_q(seed, STREAM_PK_A + i, n, ctx.q_list[i],
                           device=device)
        for i in range(L)])
    e_ntt = _small_poly_to_ntt(prng.cbd(seed, STREAM_PK_E, n, device=device),
                               sp)
    b = modmul.submod(e_ntt, _mont_mul(a, s_mont, sp),
                      sp.rows(sp.q, 2, device))
    sk = SecretKey(s_mont=modmul.i64_to_u32(s_mont), s_coeffs=s)
    pk = PublicKey(b_mont=modmul.i64_to_u32(_mont_mul(b, r2, sp)),
                   a_mont=modmul.i64_to_u32(_mont_mul(a, r2, sp)))
    return sk, pk
