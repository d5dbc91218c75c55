"""CKKS client key generation, encryption and decryption, and the
ciphertext containers.

Port of ``repro.core.encryptor``: the PRNG stream-id layout (unchanged, so
port and reference draw the same streams), ``keygen`` (bit-identical
``s_mont``/``b_mont``/``a_mont`` for the same seed), the per-ciphertext
reference entry points ``encrypt`` (public key), ``encrypt_symmetric_seeded``
(secret key; ``a`` travels as its stream id, half the upload),
``expand_seeded`` and ``decrypt``, and ``SecretKey`` / ``PublicKey`` /
``Ciphertext`` / ``CiphertextBatch`` (whose indexing and iteration yield
per-row ``Ciphertext`` views, the list interop ``FHEClient.decrypt_batch``
takes). Keys and ciphertexts are stored as int32 tensors holding uint32
words: the layout the CUDA kernels read. Everything here is eager torch on
the device of its inputs.

    keygen:   s <- ternary;  a <- U(R_Q) (NTT domain);  e <- CBD
              pk = (b, a),  b = e - a*s
    encrypt:  ct = (v*b + e0 + pt, v*a + e1)
    seeded:   ct = (-a*s + e + pt, stream id of a)
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
    """One (L, N) int32 ciphertext (NTT domain) with its scale. A seeded
    ciphertext has ``c1 = None`` and the PRNG stream id of ``a`` in
    ``a_stream`` (``expand_seeded`` regenerates it)."""

    c0: torch.Tensor
    c1: torch.Tensor | None
    n_limbs: int
    scale: float
    a_stream: int | None = None


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


# ---------------------------------------------------------------------------
# per-ciphertext reference entry points (int64 words inside, int32 out)
# ---------------------------------------------------------------------------


def _u(t: torch.Tensor) -> torch.Tensor:
    return modmul.u32_to_i64(t)


def _q_rows(sp: nttmod.StackedPlans, device) -> torch.Tensor:
    return sp.rows(sp.q, 2, device)


def _uniform_rows(seed: int, a_stream: int, ctx: CKKSContext, n_limbs: int,
                  device) -> torch.Tensor:
    """(L, N) uniform residues: limb i draws stream a_stream + 1024 i."""
    return torch.stack([
        prng.uniform_mod_q(seed, a_stream + 1024 * i, ctx.params.n,
                           ctx.q_list[i], device=device)
        for i in range(n_limbs)])


def encrypt(pt, pk: PublicKey, ctx: CKKSContext, seed: int | None = None,
            nonce: int = 0) -> Ciphertext:
    """Public-key encryption of a ``Plaintext`` (L, N):
    ct = (v*b + e0 + pt, v*a + e1), (v, e0, e1) drawn under `nonce`."""
    p = ctx.params
    seed = seed if seed is not None else p.seed
    L, n = pt.n_limbs, p.n
    dev = pt.data.device
    sp = ctx.stacked_plans(L)
    q = _q_rows(sp, dev)
    v = prng.zo(seed, STREAM_ENC_V + 16 * nonce, n, device=dev)
    e0 = prng.cbd(seed, STREAM_ENC_E0 + 16 * nonce, n, device=dev)
    e1 = prng.cbd(seed, STREAM_ENC_E1 + 16 * nonce, n, device=dev)
    v_ntt, e0_ntt, e1_ntt = (_small_poly_to_ntt(x, sp) for x in (v, e0, e1))
    c0 = modmul.addmod(
        modmul.addmod(_mont_mul(v_ntt, _u(pk.b_mont[:L]), sp), e0_ntt, q),
        _u(pt.data), q)
    c1 = modmul.addmod(_mont_mul(v_ntt, _u(pk.a_mont[:L]), sp), e1_ntt, q)
    return Ciphertext(c0=modmul.i64_to_u32(c0), c1=modmul.i64_to_u32(c1),
                      n_limbs=L, scale=pt.scale)


def encrypt_symmetric_seeded(pt, sk: SecretKey, ctx: CKKSContext,
                             seed: int | None = None,
                             nonce: int = 1) -> Ciphertext:
    """Symmetric seeded encryption: ct = (-a*s + e + pt, None), with ``a``
    the uniform draw of stream ``STREAM_ENC_V + 16*nonce + 7`` (+ 1024 per
    limb), carried as that stream id: half a full ciphertext's words."""
    p = ctx.params
    seed = seed if seed is not None else p.seed
    L, n = pt.n_limbs, p.n
    dev = pt.data.device
    sp = ctx.stacked_plans(L)
    q = _q_rows(sp, dev)
    a_stream = STREAM_ENC_V + 16 * nonce + 7
    a = _uniform_rows(seed, a_stream, ctx, L, dev)
    e_ntt = _small_poly_to_ntt(
        prng.cbd(seed, STREAM_ENC_E0 + 16 * nonce, n, device=dev), sp)
    a_s = _mont_mul(a, _u(sk.s_mont[:L]), sp)
    c0 = modmul.addmod(modmul.submod(e_ntt, a_s, q), _u(pt.data), q)
    return Ciphertext(c0=modmul.i64_to_u32(c0), c1=None, n_limbs=L,
                      scale=pt.scale, a_stream=a_stream)


def expand_seeded(ct: Ciphertext, ctx: CKKSContext,
                  seed: int | None = None) -> Ciphertext:
    """Regenerate c1 = a of a seeded ciphertext from its stream id (the
    receiver's side)."""
    assert ct.c1 is None and ct.a_stream is not None
    seed = seed if seed is not None else ctx.params.seed
    a = _uniform_rows(seed, ct.a_stream, ctx, ct.n_limbs, ct.c0.device)
    return Ciphertext(c0=ct.c0, c1=modmul.i64_to_u32(a), n_limbs=ct.n_limbs,
                      scale=ct.scale)


def decrypt(ct: Ciphertext, sk: SecretKey, ctx: CKKSContext,
            n_limbs: int | None = None) -> torch.Tensor:
    """pt' = c0 + c1*s over the first `n_limbs` limbs (default min(L, 2)),
    NTT domain, (n_limbs, N) int32 words. A seeded ciphertext is expanded
    first (under the profile's seed)."""
    if ct.c1 is None:
        ct = expand_seeded(ct, ctx)
    L = n_limbs if n_limbs is not None else min(ct.n_limbs, 2)
    sp = ctx.stacked_plans(L)
    c1s = _mont_mul(_u(ct.c1[:L]), _u(sk.s_mont[:L]), sp)
    return modmul.i64_to_u32(modmul.addmod(_u(ct.c0[:L]), c1s,
                                           _q_rows(sp, ct.c0.device)))
