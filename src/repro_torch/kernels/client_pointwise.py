"""Per-limb stages of the client datapath, the limb-folded encrypt (K2)
and decrypt (K3) kernels, and their per-limb forms (K13).

Port of ``repro.kernels.client_pointwise``:

  * the stage functions the kernels run: the Philox samplers keyed by one
    stream per batch row (``sample_vee_k``), the df32 RNS digit stage, and
    the per-limb encrypt and decrypt stages (int64 tensors holding uint32
    values);
  * ``encrypt_limbs_cuda`` launches ``csrc/client_pointwise.cu``'s K2
    (replaces the TPU kernel ``_encrypt_kernel_folded``; K5's encrypt body
    on the tiled NTT block, reading pt through its strides),
    ``decrypt_limbs_cuda`` its K3 (replaces ``_decrypt_kernel_folded``;
    an INTT stage on the same tiled block, c0 + c1*s in its first load);
    ``encrypt_limbs_plain`` / ``decrypt_limbs_plain`` are the same
    functions composed from the stages, limb by limb. Both take and return
    int32 tensors holding uint32 words; each CUDA wrapper counts its
    launches in ``LAUNCHES``. ``encrypt_limbs`` / ``decrypt_limbs`` (the
    reference's names; ``ops.encrypt_fused`` / ``decrypt_fused`` call
    them) pick one by the tensors' device;
  * K13, the port of ``encrypt_limb`` / ``decrypt_limb`` (the TPU kernels
    ``_encrypt_kernel`` / ``_decrypt_kernel``): one limb of a (B, N) batch,
    one launch per limb, the shift-add REDC of paper eq. 9-11.
    ``encrypt_limb_cuda`` / ``decrypt_limb_cuda`` launch
    ``csrc/client_pointwise.cu``'s K13a (K2's tiled encrypt body on the
    one limb) / K13b (K3's tiled INTT stage on the one limb),
    ``encrypt_limb_plain`` / ``decrypt_limb_plain`` are the plain
    versions, and ``encrypt_limb`` /
    ``decrypt_limb`` pick one by the tensors' device. Their words equal
    K2's / K3's on that limb.
"""

from __future__ import annotations

import torch

from repro_torch.core import modmul, prng, rns
from repro_torch.core.encryptor import (STREAM_ENC_E0, STREAM_ENC_E1,
                                        STREAM_ENC_V)
from repro_torch.core.modmul import MASK32
from repro_torch.kernels import common

LAUNCHES = {"encrypt_limbs": 0, "decrypt_limbs": 0, "encrypt_limb": 0,
            "decrypt_limb": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


# ---------------------------------------------------------------------------
# K2: limb-folded encrypt
# ---------------------------------------------------------------------------


def nonce_column(nonce0: int, batch: int, device) -> torch.Tensor:
    """Row r encrypts under nonce0 + r, wrapped mod 2^32."""
    return (int(nonce0) + torch.arange(batch, dtype=torch.int64,
                                       device=device)
            ).reshape(batch, 1) & MASK32


def encrypt_limbs_plain(pt, b_mont, a_mont, ctx, seed: int, nonce0: int):
    """pt: (B, L, N) int32 NTT-domain plaintext words; b_mont/a_mont:
    (>= L, N) public-key rows -> (c0, c1), each (B, L, N) int32."""
    batch, n_limbs, n = pt.shape
    kc = common.stacked_kernel_consts(ctx.plans[:n_limbs])
    vee = sample_vee_k(seed, nonce_column(nonce0, batch, pt.device), n)
    b = modmul.u32_to_i64(b_mont)
    a = modmul.u32_to_i64(a_mont)
    c0 = torch.empty_like(pt)
    c1 = torch.empty_like(pt)
    for l in range(n_limbs):
        c0_l, c1_l = encrypt_limb_stage(vee, modmul.u32_to_i64(pt[:, l]),
                                        b[l], a[l], kc, l)
        c0[:, l] = modmul.i64_to_u32(c0_l)
        c1[:, l] = modmul.i64_to_u32(c1_l)
    return c0, c1


def encrypt_limbs_cuda(pt, b_mont, a_mont, ctx, seed: int, nonce0: int):
    """CUDA launch of K2; same inputs and outputs as
    ``encrypt_limbs_plain``. pt may be any (B, L, N) view whose (row, limb)
    rows are contiguous (the (L, B, N) -> (B, L, N) transpose): the kernel
    reads it through its row and limb strides. c0 / c1 are contiguous."""
    dev = pt.device
    if dev.type != "cuda":
        raise ValueError("encrypt_limbs_cuda needs CUDA tensors")
    if pt.dim() != 3:
        raise ValueError(f"pt must be (B, L, N), got {tuple(pt.shape)}")
    batch, n_limbs, n = pt.shape
    if pt.dtype != torch.int32:
        raise TypeError(f"pt has dtype {pt.dtype}, expected torch.int32")
    if pt.stride(2) != 1:
        raise ValueError("pt: each (row, limb)'s N words must be contiguous")
    common.check_grid_rows(batch)
    common.check_key_rows(b_mont, "b_mont", n_limbs, n, dev)
    common.check_key_rows(a_mont, "a_mont", n_limbs, n, dev)
    kc = common.stacked_kernel_consts(ctx.plans[:n_limbs])
    c0, c1, v_scratch = (
        torch.empty((batch, n_limbs, n), dtype=torch.int32, device=dev)
        for _ in range(3))
    tw_heap = torch.empty((n_limbs, n), dtype=torch.int32, device=dev)
    noise = torch.empty((batch, 3, n), dtype=torch.int8, device=dev)
    common.launch("encrypt_limbs_launch", dev, pt.data_ptr(), pt.stride(0),
                  pt.stride(1), b_mont.data_ptr(), a_mont.data_ptr(),
                  common.device_seed_table(kc, dev).data_ptr(),
                  c0.data_ptr(), c1.data_ptr(), v_scratch.data_ptr(),
                  tw_heap.data_ptr(), noise.data_ptr(), batch, n_limbs,
                  kc.logn, kc.n_scalars, *prng.seed_words(seed),
                  int(nonce0) & MASK32)
    LAUNCHES["encrypt_limbs"] += 1
    return c0, c1


# ---------------------------------------------------------------------------
# K3: limb-folded decrypt
# ---------------------------------------------------------------------------


def decrypt_limbs_plain(c0, c1, s_mont, ctx):
    """c0/c1: (B, L_dec, N) int32 ciphertext words (any strides); s_mont:
    (>= L_dec, N) -> coefficient-domain residues (B, L_dec, N) int32."""
    batch, n_limbs, n = c0.shape
    kc = common.stacked_kernel_consts(ctx.plans[:n_limbs])
    m = torch.empty((batch, n_limbs, n), dtype=torch.int32, device=c0.device)
    for l in range(n_limbs):
        m[:, l] = modmul.i64_to_u32(decrypt_limb_stage(
            modmul.u32_to_i64(c0[:, l]), modmul.u32_to_i64(c1[:, l]),
            modmul.u32_to_i64(s_mont[l]), kc, l))
    return m


def decrypt_limbs_cuda(c0, c1, s_mont, ctx):
    """CUDA launch of K3; same function as ``decrypt_limbs_plain``. c0/c1
    may be the L_dec-limb view of a (B, L, N) batch (rows of any stride,
    each row's limbs contiguous)."""
    dev = c0.device
    if dev.type != "cuda":
        raise ValueError("decrypt_limbs_cuda needs CUDA tensors")
    batch, n_limbs, n = c0.shape
    common.check_limb_views(c0, c1, n_limbs, n, dev)
    if c1.shape[1] != n_limbs:
        raise ValueError("c0 and c1 must hold the same limbs")
    if batch == 0:
        raise ValueError("decrypt_limbs_cuda needs at least one row")
    common.check_key_rows(s_mont, "s_mont", n_limbs, n, dev)
    kc = common.stacked_kernel_consts(ctx.plans[:n_limbs])
    m = torch.empty((batch, n_limbs, n), dtype=torch.int32, device=dev)
    tw_heap = torch.empty((n_limbs, n), dtype=torch.int32, device=dev)
    common.launch("decrypt_limbs_launch", dev, c0.data_ptr(), c1.data_ptr(),
                  c0.stride(0), s_mont.data_ptr(),
                  common.device_seed_table(kc, dev).data_ptr(), m.data_ptr(),
                  tw_heap.data_ptr(), batch, n_limbs, kc.logn, kc.n_scalars)
    LAUNCHES["decrypt_limbs"] += 1
    return m


def encrypt_limbs(pt, b_mont, a_mont, ctx, seed: int, nonce0: int = 0):
    """Fused encrypt of a (B, L, N) batch, all limbs in one launch: K2 on
    CUDA tensors (pt read through its strides), the plain version on CPU
    tensors. Returns (c0, c1), each (B, L, N), contiguous; row r encrypts
    under nonce nonce0 + r."""
    if common.route(pt.device) == "cuda":
        return encrypt_limbs_cuda(pt, b_mont, a_mont, ctx, seed, nonce0)
    return encrypt_limbs_plain(pt.contiguous(), b_mont, a_mont, ctx, seed,
                               nonce0)


def decrypt_limbs(c0, c1, s_mont, ctx):
    """Fused decrypt of a (B, L_dec, N) batch, all limbs in one launch: K3
    on CUDA tensors, the plain version on CPU tensors. Returns the
    coefficient-domain residues (B, L_dec, N)."""
    f = (decrypt_limbs_cuda if common.route(c0.device) == "cuda"
         else decrypt_limbs_plain)
    return f(c0, c1, s_mont, ctx)


# ---------------------------------------------------------------------------
# K13: per-limb encrypt / decrypt with the shift-add REDC
# ---------------------------------------------------------------------------


def encrypt_limb_plain(pt_l, b_mont_l, a_mont_l, ctx, limb: int, seed: int,
                       nonce0: int = 0):
    """pt_l: (B, N) int32 NTT-domain words of limb `limb`; b_mont_l /
    a_mont_l: (N,) public-key rows -> (c0, c1), each (B, N) int32. Row r
    encrypts under nonce0 + r (mod 2^32)."""
    batch, n = pt_l.shape
    pc = common.plan_consts(ctx.plans[limb])
    q, c = pc.q, pc.mont
    vee = sample_vee_k(seed, nonce_column(nonce0, batch, pt_l.device), n)
    v, e0, e1 = (_to_residue_k(x, q) for x in vee)
    v_h, e0_h, e1_h = torch.chunk(
        common.ntt_stages(torch.cat([v, e0, e1], dim=0), pc), 3, dim=0)
    vb = modmul.mulmod_montgomery_sa_limb(v_h, modmul.u32_to_i64(b_mont_l),
                                          c)
    va = modmul.mulmod_montgomery_sa_limb(v_h, modmul.u32_to_i64(a_mont_l),
                                          c)
    c0 = modmul.addmod(modmul.addmod(vb, e0_h, q),
                       modmul.u32_to_i64(pt_l), q)
    c1 = modmul.addmod(va, e1_h, q)
    return modmul.i64_to_u32(c0), modmul.i64_to_u32(c1)


def _limb_consts(ctx, limb: int, dev):
    plan = ctx.plans[limb]
    kc = common.stacked_kernel_consts([plan])
    return (kc, common.device_seed_table(kc, dev),
            common.device_sa_table([plan], dev))


def _check_limb_batch(t, name: str, n: int, dev) -> None:
    if t.dim() != 2 or t.shape[0] == 0:
        raise ValueError(f"{name} must be (B >= 1, {n}), got "
                         f"{tuple(t.shape)}")
    common.check_tensor(t, name, torch.int32, (t.shape[0], n), dev)


def encrypt_limb_cuda(pt_l, b_mont_l, a_mont_l, ctx, limb: int, seed: int,
                      nonce0: int = 0):
    """CUDA launch of K13a; same inputs and outputs as
    ``encrypt_limb_plain``."""
    dev = pt_l.device
    if dev.type != "cuda":
        raise ValueError("encrypt_limb_cuda needs CUDA tensors")
    kc, table, sa = _limb_consts(ctx, limb, dev)
    _check_limb_batch(pt_l, "pt_l", kc.n, dev)
    for name, t in (("b_mont_l", b_mont_l), ("a_mont_l", a_mont_l)):
        common.check_tensor(t, name, torch.int32, (kc.n,), dev)
    batch = pt_l.shape[0]
    common.check_grid_rows(batch)
    c0, c1, v_scratch = (torch.empty_like(pt_l) for _ in range(3))
    tw_heap = torch.empty((1, kc.n), dtype=torch.int32, device=dev)
    noise = torch.empty((batch, 3, kc.n), dtype=torch.int8, device=dev)
    common.launch("encrypt_limb_launch", dev, pt_l.data_ptr(),
                  b_mont_l.data_ptr(), a_mont_l.data_ptr(), table.data_ptr(),
                  sa.data_ptr(), c0.data_ptr(), c1.data_ptr(),
                  v_scratch.data_ptr(), tw_heap.data_ptr(), noise.data_ptr(),
                  batch, kc.logn, *prng.seed_words(seed),
                  int(nonce0) & MASK32)
    LAUNCHES["encrypt_limb"] += 1
    return c0, c1


def encrypt_limb(pt_l, b_mont_l, a_mont_l, ctx, limb: int, seed: int,
                 nonce0: int = 0):
    """Encrypt one limb of a (B, N) batch: K13a on CUDA tensors, the plain
    version on the CPU."""
    f = (encrypt_limb_cuda if common.route(pt_l.device) == "cuda"
         else encrypt_limb_plain)
    return f(pt_l, b_mont_l, a_mont_l, ctx, limb, seed, nonce0)


def decrypt_limb_plain(c0_l, c1_l, s_mont_l, ctx, limb: int):
    """m = INTT(c0 + c1*s) of one limb: (B, N) int32 ciphertext words and
    an (N,) secret-key row -> (B, N) coefficient-domain residues."""
    pc = common.plan_consts(ctx.plans[limb])
    c1s = modmul.mulmod_montgomery_sa_limb(
        modmul.u32_to_i64(c1_l), modmul.u32_to_i64(s_mont_l), pc.mont)
    m_ntt = modmul.addmod(modmul.u32_to_i64(c0_l), c1s, pc.q)
    return modmul.i64_to_u32(common.intt_stages(m_ntt, pc))


def decrypt_limb_cuda(c0_l, c1_l, s_mont_l, ctx, limb: int):
    """CUDA launch of K13b; same function as ``decrypt_limb_plain``."""
    dev = c0_l.device
    if dev.type != "cuda":
        raise ValueError("decrypt_limb_cuda needs CUDA tensors")
    kc, table, sa = _limb_consts(ctx, limb, dev)
    _check_limb_batch(c0_l, "c0_l", kc.n, dev)
    common.check_tensor(c1_l, "c1_l", torch.int32, tuple(c0_l.shape), dev)
    common.check_tensor(s_mont_l, "s_mont_l", torch.int32, (kc.n,), dev)
    batch = c0_l.shape[0]
    m = torch.empty_like(c0_l)
    tw_heap = torch.empty((1, kc.n), dtype=torch.int32, device=dev)
    common.launch("decrypt_limb_launch", dev, c0_l.data_ptr(),
                  c1_l.data_ptr(), s_mont_l.data_ptr(), table.data_ptr(),
                  sa.data_ptr(), m.data_ptr(), tw_heap.data_ptr(), batch,
                  kc.logn)
    LAUNCHES["decrypt_limb"] += 1
    return m


def decrypt_limb(c0_l, c1_l, s_mont_l, ctx, limb: int):
    """Decrypt one limb of a (B, N) batch: K13b on CUDA tensors, the plain
    version on the CPU."""
    f = (decrypt_limb_cuda if common.route(c0_l.device) == "cuda"
         else decrypt_limb_plain)
    return f(c0_l, c1_l, s_mont_l, ctx, limb)
