"""The port's building blocks against the JAX package, in one process.

Integer blocks (Philox and its samplers, the 16-bit-limb products, REDC,
addmod/submod, the digit reduction, the two-limb CRT, the OTF-twiddle
NTT/INTT stage loops) are exact, so eager JAX is compared directly. The
df32 blocks compare with the JAX side under ``jax.disable_jit()``: op by
op, XLA has nothing to contract into an FMA, so it is IEEE-strict like the
port. The constant tables are host numpy on both sides and are compared on
``tiny``, ``test``, ``paper``, ``server``, ``tinyboot``, ``n14`` and
``boot``. The host names of the reference's core and kernel modules that
no client path runs (the stacked transforms and REDCs, the df FFTs, the
context cache, the plan keys, the ``ref`` oracles, K4 on complex rows) are
held against theirs at the end. Tolerance everywhere: 0 (words, or ULPs),
but K4 on complex rows against the complex128 oracle (2^-40 of the rows'
scale).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import cache as jcache
from repro.core import context as jctx
from repro.core import fft as jfftc
from repro.core import dfloat as jdfl
from repro.core import encoder as jenc
from repro.core import encryptor as jencr
from repro.core import modmul as jmod
from repro.core import ntt as jntt
from repro.core import prng as jprng
from repro.core import rns as jrns
from repro.kernels import common as jcommon
from repro.kernels import fft_df as jfft
from repro.kernels import ref as jref

from repro_torch.core import cache as tcache
from repro_torch.core import context as tctx
from repro_torch.core import fft as tfftc
from repro_torch.core import dfloat as tdfl
from repro_torch.core import encoder as tenc
from repro_torch.core import encryptor as tencr
from repro_torch.core import modmul as tmod
from repro_torch.core import ntt as tntt
from repro_torch.core import prng as tprng
from repro_torch.core import rns as trns
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import fft_df as tfft
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SEEDS = [0x243F6A8885A308D313198A2E03707344, (1 << 128) - 1, 12345]
MASK32 = 0xFFFFFFFF


def _i64(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a).astype(np.int64))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _rand_u32(rng, shape, hi=1 << 32):
    return rng.integers(0, hi, size=shape, dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# Philox and the samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("stream", [0, 0x10000 + 16 * 77, MASK32])
def test_philox_draws(seed, stream):
    n = 257
    for words in (1, 2):
        want = jprng.random_u32(seed, stream, n, words=words)
        got = tprng.random_u32(seed, stream, n, words=words)
        if words == 1:
            want, got = [want], [got]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(_u32(g), np.asarray(w))


@pytest.mark.parametrize("seed", SEEDS)
def test_samplers(seed):
    n = 4096
    for stream in (0x100, 0x30000 + 16 * 5):
        np.testing.assert_array_equal(
            tprng.zo(seed, stream, n).numpy(),
            np.asarray(jprng.zo(seed, stream, n)))
        np.testing.assert_array_equal(
            tprng.cbd(seed, stream, n).numpy(),
            np.asarray(jprng.cbd(seed, stream, n)))
        np.testing.assert_array_equal(
            tprng.ternary(seed, stream, n).numpy(),
            np.asarray(jprng.ternary(seed, stream, n)))
    q = jctx.get_context("test").q_list[3]
    np.testing.assert_array_equal(
        _u32(tprng.uniform_mod_q(seed, 0x1003, n, q)),
        np.asarray(jprng.uniform_mod_q(seed, 0x1003, n, q)))


def test_popcount21_wraps_like_uint32():
    x = np.concatenate([np.arange(0, 1 << 12, dtype=np.uint32),
                        np.array([MASK32, (1 << 21) - 1, 1 << 21],
                                 np.uint32)])
    np.testing.assert_array_equal(
        _u32(tprng.popcount21(_i64(x))),
        np.asarray(jprng._popcount21(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# 16-bit-limb products, REDC, modular add/sub
# ---------------------------------------------------------------------------

EDGE = np.array([0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                 MASK32 - 1, MASK32], np.uint32)


def test_mul32x32_and_lo():
    rng = np.random.default_rng(1)
    a = np.concatenate([_rand_u32(rng, 4000), np.repeat(EDGE, len(EDGE))])
    b = np.concatenate([_rand_u32(rng, 4000), np.tile(EDGE, len(EDGE))])
    hi, lo = tmod.mul32x32(_i64(a), _i64(b))
    jhi, jlo = jmod.mul32x32(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(_u32(hi), np.asarray(jhi))
    np.testing.assert_array_equal(_u32(lo), np.asarray(jlo))
    np.testing.assert_array_equal(
        _u32(tmod.mul32x32_lo(_i64(a), _i64(b))),
        np.asarray(jmod.mul32x32_lo(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("profile", ["tiny", "test"])
def test_redc_addmod_submod(profile):
    ctx = jctx.get_context(profile)
    rng = np.random.default_rng(2)
    for plan in ctx.plans:
        q, qinv = plan.prime.q, plan.mont.qinv_neg
        a = np.concatenate([_rand_u32(rng, 3000, q),
                            np.array([0, 1, q - 1], np.uint32)])
        b = np.concatenate([_rand_u32(rng, 3000, q),
                            np.array([q - 1, 0, q - 1], np.uint32)])
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        np.testing.assert_array_equal(
            _u32(tmod.mulmod_montgomery_limb_t(_i64(a), _i64(b), q, qinv)),
            np.asarray(jmod.mulmod_montgomery_limb_t(
                ja, jb, np.uint32(q), np.uint32(qinv))))
        np.testing.assert_array_equal(
            _u32(tmod.addmod(_i64(a), _i64(b), q)),
            np.asarray(jmod.addmod(ja, jb, q)))
        np.testing.assert_array_equal(
            _u32(tmod.submod(_i64(a), _i64(b), q)),
            np.asarray(jmod.submod(ja, jb, q)))


def test_word_pair_helpers():
    rng = np.random.default_rng(3)
    w = [_rand_u32(rng, 2000) for _ in range(4)]
    w[2][:50] = w[0][:50]                       # equal high words
    t = [_i64(x) for x in w]
    j = [jnp.asarray(x) for x in w]
    for tf, jf in ((tmod._add64, jmod._add64), (tmod._sub64, jmod._sub64)):
        for got, want in zip(tf(*t), jf(*j)):
            np.testing.assert_array_equal(_u32(got), np.asarray(want))
    for tf, jf in ((tmod._ge64, jmod._ge64), (tmod._gt64, jmod._gt64)):
        np.testing.assert_array_equal(tf(*t).numpy(), np.asarray(jf(*j)))


# ---------------------------------------------------------------------------
# digit reduction and two-limb CRT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("profile", ["tiny", "paper"])
def test_digits_to_residue(profile):
    q_list = jctx.get_context(profile).q_list
    rng = np.random.default_rng(4)
    d = [rng.integers(-(1 << 23) + 1, 1 << 23, size=3000).astype(np.int32)
         for _ in range(3)]
    for q in q_list[:4]:
        qinv = (-pow(q, -1, 1 << 32)) % (1 << 32)
        c22, c44 = trns.digit_consts(q)
        assert (c22, c44) == jrns.digit_consts(q)
        got = trns.digits_to_residue(*(torch.tensor(x) for x in d), q, qinv,
                                     c22, c44)
        want = jrns.digits_to_residue(*(jnp.asarray(x) for x in d),
                                      np.uint32(q), np.uint32(qinv),
                                      np.uint32(c22), np.uint32(c44))
        np.testing.assert_array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("profile", ["tiny", "test", "paper"])
def test_crt2_centered(profile):
    q0, q1 = jctx.get_context(profile).q_list[:2]
    assert trns.crt2_consts(q0, q1) == jrns.crt2_consts(q0, q1)
    rng = np.random.default_rng(5)
    m0 = np.concatenate([_rand_u32(rng, 3000, q0),
                         np.array([0, q0 - 1, 0, q0 - 1], np.uint32)])
    m1 = np.concatenate([_rand_u32(rng, 3000, q1),
                         np.array([0, q1 - 1, q1 - 1, 0], np.uint32)])
    sign, hi, lo = trns.crt2_centered_u32(_i64(m0), _i64(m1), q0, q1)
    js, jh, jl = jrns.crt2_centered_u32(jnp.asarray(m0), jnp.asarray(m1),
                                        q0, q1)
    np.testing.assert_array_equal(sign.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_u32(hi), np.asarray(jh))
    np.testing.assert_array_equal(_u32(lo), np.asarray(jl))


# ---------------------------------------------------------------------------
# the OTF-twiddle NTT / INTT stage loops on the stacked table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("profile,row", [("tiny", 0), ("test", 5)])
def test_ntt_intt_stages(profile, row):
    """Integer-only, so the JAX side may be jitted (one compile each)."""
    jc, tc = jctx.get_context(profile), tctx.get_context(profile)
    jkc = jcommon.stacked_kernel_consts(jc.plans)
    tkc = tcommon.stacked_kernel_consts(tc.plans)
    table = jnp.asarray(jkc.table)
    q, qinv = jkc.table[row, 0], jkc.table[row, 1]
    x = _rand_u32(np.random.default_rng(6), (2, jc.params.n), int(q))
    for jf, tf in ((jcommon.ntt_stages_t, tcommon.ntt_stages_t),
                   (jcommon.intt_stages_t, tcommon.intt_stages_t)):
        want = jax.jit(lambda v, f=jf: f(v, table, jkc, q, qinv, row))(
            jnp.asarray(x))
        np.testing.assert_array_equal(_u32(tf(_i64(x), tkc, row)),
                                      np.asarray(want))


# ---------------------------------------------------------------------------
# constant tables and the paper-profile keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("profile", ["tiny", "test", "paper", "server",
                                     "tinyboot", "n14", "boot"])
def test_constant_tables(profile):
    jc, tc = jctx.get_context(profile), tctx.get_context(profile)
    p = jc.params
    assert tc.q_list == jc.q_list
    for L in (p.n_limbs, 2):
        jkc = jcommon.stacked_kernel_consts(jc.plans[:L])
        tkc = tcommon.stacked_kernel_consts(tc.plans[:L])
        np.testing.assert_array_equal(tkc.table, jkc.table)
        assert (tkc.fwd_off, tkc.inv_off, tkc.n_scalars) == \
            (jkc.fwd_off, jkc.inv_off, jkc.n_scalars)
    assert tcommon.stacked_digit_consts(tc.q_list) == \
        jcommon.stacked_digit_consts(jc.q_list)
    for inverse in (False, True):
        ttw, toff = tfft.packed_twiddles(p.n_slots, p.m, inverse)
        jtw, joff = jfft.packed_twiddles(p.n_slots, p.m, inverse)
        np.testing.assert_array_equal(ttw.view(np.uint32),
                                      jtw.view(np.uint32))
        assert toff == joff
    for n in (p.n, p.n_slots):
        np.testing.assert_array_equal(tntt.bitrev_indices(n),
                                      jntt.bitrev_indices(n))


# SHA-256 of the JAX package's paper-profile keys for the profile seed,
# ``repro.core.encryptor.keygen(get_context("paper"))`` (uint32 words, C
# order). The live JAX keygen at N = 2^16 takes ~20 s on a CPU; tiny and
# test keygen are held against the live reference in test_torch_slice.py.
PAPER_KEY_SHA256 = {
    "s_mont": "1186b9845d0a889d1b93af9fba379c13e27e4be15151884a5b0867388d3abbb5",
    "b_mont": "13e7b6094675a76104837b0a0d055de39e46d8ae03a70b630793dec3506f9de7",
    "a_mont": "2abeb121e19bc5ec7a72667b16dec0f475f45abdb81ef9bfa011550a061cb70f",
}


def test_keygen_paper_digest():
    import hashlib
    sk, pk = tencr.keygen(tctx.get_context("paper"), device="cpu")
    for name, t in (("s_mont", sk.s_mont), ("b_mont", pk.b_mont),
                    ("a_mont", pk.a_mont)):
        assert tuple(t.shape) == (24, 1 << 16) and t.dtype == torch.int32
        words = np.ascontiguousarray(t.numpy().view(np.uint32))
        assert hashlib.sha256(words.tobytes()).hexdigest() == \
            PAPER_KEY_SHA256[name], name


# ---------------------------------------------------------------------------
# df32 blocks (JAX side op by op: jax.disable_jit)
# ---------------------------------------------------------------------------


def _same_bits(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def _df_pairs(rng, size, scale=1.0):
    hi = (rng.standard_normal(size) * scale).astype(np.float32)
    lo = (hi.astype(np.float64) * rng.uniform(-2 ** -25, 2 ** -25, size)
          ).astype(np.float32)
    return hi, lo


def test_df_mul():
    rng = np.random.default_rng(7)
    xh, xl = _df_pairs(rng, 4096)
    yh, yl = _df_pairs(rng, 4096, 1e3)
    with jax.disable_jit():
        want = jdfl.df_mul(jdfl.DF(jnp.asarray(xh), jnp.asarray(xl)),
                           jdfl.DF(jnp.asarray(yh), jnp.asarray(yl)))
        got = tdfl.df_mul(tdfl.DF(torch.tensor(xh), torch.tensor(xl)),
                          tdfl.DF(torch.tensor(yh), torch.tensor(yl)))
    _same_bits(got.hi, want.hi)
    _same_bits(got.lo, want.lo)


def _round_cases(rng):
    """Pairs whose exact value is at or near k + 1/2 for odd and even k,
    on both sides of zero and at large magnitudes, plus random values."""
    k = np.array([0, 1, 2, 3, 10, 11, 2 ** 20, 2 ** 20 + 1, 2 ** 23 - 1],
                 np.float64)
    hi, lo = [], []
    for kk in np.concatenate([k, -k]):
        for off in (0.5, -0.5, 0.25):
            hi.append(kk + off)
            lo.append(0.0)
    for kk in (2.0 ** 30, 2.0 ** 30 + 2 ** 7, 3.0 * 2 ** 40):
        for sign in (1.0, -1.0):
            for small in (0.5, -0.5, 0.5 + 2 ** -8, 0.0):
                hi.append(sign * kk)
                lo.append(sign * small)
    rh, rl = _df_pairs(rng, 2048, 2.0 ** 40)
    return (np.concatenate([np.asarray(hi, np.float32), rh]),
            np.concatenate([np.asarray(lo, np.float32), rl]))


def test_df_round_rne_and_digits():
    hi, lo = _round_cases(np.random.default_rng(8))
    with jax.disable_jit():
        want = jdfl.df_round_rne(jdfl.DF(jnp.asarray(hi), jnp.asarray(lo)))
        got = tdfl.df_round_rne(tdfl.DF(torch.tensor(hi), torch.tensor(lo)))
        for g, w in zip(got, want):
            _same_bits(g, w)
        wd = jdfl.expansion3_digits(*want)
        gd = tdfl.expansion3_digits(*got)
    for g, w in zip(gd, wd):
        _same_bits(g, w)


@pytest.mark.parametrize("delta_bits", [40, 55])
def test_delta_scale_digits(delta_bits):
    rng = np.random.default_rng(9)
    hi, lo = _df_pairs(rng, 2048, 0.3)
    delta = float(2 ** delta_bits)
    with jax.disable_jit():
        want = jenc.delta_scale_digits(
            jdfl.DF(jnp.asarray(hi), jnp.asarray(lo)), delta)
        got = tenc.delta_scale_digits(
            tdfl.DF(torch.tensor(hi), torch.tensor(lo)), delta)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        tenc._check_pow2_delta(3.0 * 2 ** 40)


def test_centered_to_df():
    q0, q1 = jctx.get_context("paper").q_list[:2]
    rng = np.random.default_rng(10)
    m0, m1 = _rand_u32(rng, 3000, q0), _rand_u32(rng, 3000, q1)
    sign, hi, lo = jrns.crt2_centered_u32(jnp.asarray(m0), jnp.asarray(m1),
                                          q0, q1)
    inv = np.float32(2.0 ** -55)
    with jax.disable_jit():
        want = jrns.centered_to_df(sign, hi, lo, inv)
        got = trns.centered_to_df(
            torch.tensor(np.asarray(sign)), _i64(hi), _i64(lo),
            torch.tensor(inv))
    _same_bits(got.hi, want.hi)
    _same_bits(got.lo, want.lo)


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_stage_pipeline(inverse):
    n, m = 32, 128
    rng = np.random.default_rng(11)
    planes = [_df_pairs(rng, (3, n))[i % 2] for i in range(4)]
    tw, offsets = jfft.packed_twiddles(n, m, inverse)
    with jax.disable_jit():
        want = jfft.fft_stage_pipeline(
            jdfl.dfc_from_planes(tuple(jnp.asarray(p) for p in planes)),
            jnp.asarray(tw), offsets, n=n, inverse=inverse)
        got = tfft.fft_stage_pipeline(
            tdfl.dfc_from_planes(tuple(torch.tensor(p) for p in planes)),
            torch.tensor(tw), offsets, n=n, inverse=inverse)
    for g, w in zip(tdfl.dfc_to_planes(got), jdfl.dfc_to_planes(want)):
        _same_bits(g, w)


# ---------------------------------------------------------------------------
# host names no client path runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("profile", ["tiny", "test"])
def test_stacked_transforms_and_redc(profile):
    """``intt_stacked`` (and ``ntt_stacked`` before it), the stacked REDCs
    and ``StackedPlans.bcast`` == the reference's, word for word."""
    jc, tc = jctx.get_context(profile), tctx.get_context(profile)
    L, n = jc.params.n_limbs, jc.params.n
    jsp, tsp = jc.stacked_plans(), tc.stacked_plans()
    rng = np.random.default_rng(31)
    q = np.array(jc.q_list, np.uint64)[:, None, None]
    x = (rng.integers(0, 1 << 32, (L, 2, n), dtype=np.uint64) % q).astype(
        np.uint32)
    np.testing.assert_array_equal(
        _u32(tntt.ntt_stacked(_i64(x), tsp)),
        np.asarray(jntt.ntt_stacked(jnp.asarray(x), jsp)))
    np.testing.assert_array_equal(
        _u32(tntt.intt_stacked(_i64(x), tsp)),
        np.asarray(jntt.intt_stacked(jnp.asarray(x), jsp)))
    for i in (0, L - 1):
        np.testing.assert_array_equal(
            _u32(tntt.intt_stacked(_i64(x), tsp)[i]),
            _u32(tntt.intt(_i64(x[i]), tc.plans[i])))
    qb = tsp.bcast(tsp.q, 3)
    assert qb.shape == (L, 1, 1) and qb.shape == jsp.bcast(jsp.q, 3).shape
    np.testing.assert_array_equal(qb.astype(np.uint64), jsp.bcast(jsp.q, 3))
    b = (rng.integers(0, 1 << 32, (L, 2, n), dtype=np.uint64) % q).astype(
        np.uint32)
    qi = jsp.bcast(jsp.qinv_neg, 3)
    want = np.asarray(jmod.mulmod_montgomery_stacked(
        jnp.asarray(x), jnp.asarray(b), jnp.asarray(jsp.bcast(jsp.q, 3)),
        jnp.asarray(qi)))
    tq = torch.as_tensor(qb)
    tqi = torch.as_tensor(tsp.bcast(tsp.qinv_neg, 3))
    for f in (tmod.mulmod_montgomery_stacked,
              tmod.mulmod_montgomery_u64_stacked):
        np.testing.assert_array_equal(_u32(f(_i64(x), _i64(b), tq, tqi)),
                                      want)
    np.testing.assert_array_equal(want, np.asarray(
        jmod.mulmod_montgomery_u64_stacked(
            jnp.asarray(x), jnp.asarray(b),
            jnp.asarray(jsp.bcast(jsp.q, 3)), jnp.asarray(qi))))


def test_polymul_seeds_and_stage_twiddles():
    """``negacyclic_polymul`` == the O(N^2) oracle and the reference;
    ``stage_twiddles_np`` and ``TwiddleSeeds.nbytes`` == the reference's."""
    jc, tc = jctx.get_context("tiny"), tctx.get_context("tiny")
    rng = np.random.default_rng(32)
    for jp, tp in zip(jc.plans[:2], tc.plans[:2]):
        q = jp.prime.q
        a = rng.integers(0, q, jp.n, dtype=np.uint64)
        b = rng.integers(0, q, jp.n, dtype=np.uint64)
        got = tntt.negacyclic_polymul(_i64(a), _i64(b), tp).numpy()
        np.testing.assert_array_equal(
            got.astype(np.uint64), jntt.negacyclic_polymul_schoolbook(a, b,
                                                                      q))
        np.testing.assert_array_equal(got.astype(np.uint64), np.asarray(
            jntt.negacyclic_polymul(jnp.asarray(a), jnp.asarray(b), jp)))
        assert tp.seeds.nbytes() == jp.seeds.nbytes()
        s = jp.seeds
        for base, step in zip(s.fwd_base + s.inv_base,
                              s.fwd_step + s.inv_step):
            for m in (1, 8, jp.n // 2):
                np.testing.assert_array_equal(
                    tntt.stage_twiddles_np(base, step, m, q),
                    jntt.stage_twiddles_np(base, step, m, q))


@pytest.mark.parametrize("inverse", [False, True])
def test_special_fft_df(inverse):
    """The df32 reference transforms == the reference's op by op (JAX
    side under ``jax.disable_jit``), on every plane."""
    p = jctx.get_context("test").params
    rng = np.random.default_rng(33)
    z = (rng.standard_normal((2, p.n_slots))
         + 1j * rng.standard_normal((2, p.n_slots)))
    jf = jfftc.special_ifft_df if inverse else jfftc.special_fft_df
    tf = tfftc.special_ifft_df if inverse else tfftc.special_fft_df
    with jax.disable_jit():
        want = jf(jdfl.dfc_from(jnp.asarray(z)), p.m)
    got = tf(tdfl.dfc_from(z), p.m)
    for g, w in zip(tdfl.dfc_to_planes(got), jdfl.dfc_to_planes(want)):
        _same_bits(g, w)


def test_df_names():
    """``df_neg``, ``dfc_from``, ``dfc_to_complex`` and ``DF.dtype`` ==
    the reference's."""
    rng = np.random.default_rng(34)
    z = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    tz, jz = tdfl.dfc_from(z), jdfl.dfc_from(jnp.asarray(z))
    for g, w in zip(tdfl.dfc_to_planes(tz), jdfl.dfc_to_planes(jz)):
        _same_bits(g, w)
    assert tz.re.dtype == torch.float32 and jz.re.dtype == jnp.float32
    assert tdfl.dfc_from(z, tdfl.F64).im.dtype == torch.float64
    neg = tdfl.df_neg(tz.re)
    _same_bits(neg.hi, jdfl.df_neg(jz.re).hi)
    _same_bits(neg.lo, jdfl.df_neg(jz.re).lo)
    got = tdfl.dfc_to_complex(tz)
    assert got.dtype == torch.complex128
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jdfl.dfc_to_complex(jz)))


def test_context_names():
    """``q_product`` / ``modulus_bits`` == the reference's; the bounded
    context cache evicts down to its capacity and counts evictions, as the
    reference's does; ``plan_key`` / ``plans_key`` are its keys."""
    from repro_torch.core.context import CKKSParams
    for profile in ("tiny", "paper"):
        jc, tc = jctx.get_context(profile), tctx.get_context(profile)
        for L in (2, jc.params.n_limbs):
            assert tc.q_product(L) == jc.q_product(L)
            assert tc.modulus_bits(L) == jc.modulus_bits(L)
        assert tc.modulus_bits() == jc.modulus_bits()
        assert tcache.plan_key(tc.plans[0]) == jcache.plan_key(jc.plans[0])
        assert tcache.plans_key(tc.plans) == jcache.plans_key(jc.plans)
    old = tctx.set_context_cache_capacity(2)
    try:
        ev = tctx.context_cache_evictions()
        assert tctx.context_cache_len() <= 2
        for k in range(3):
            tctx.get_context(CKKSParams(logn=6, n_limbs=3, decrypt_limbs=2,
                                        delta_bits=40, seed=k))
        assert tctx.context_cache_len() == 2
        assert tctx.context_cache_evictions() >= ev + 1
    finally:
        assert tctx.set_context_cache_capacity(old) == 2


def test_ref_oracles():
    """``ref.encrypt_pointwise`` / ``decrypt_pointwise`` and the complex
    oracles == the reference's."""
    jc, tc = jctx.get_context("tiny"), tctx.get_context("tiny")
    L, n = jc.params.n_limbs, jc.params.n
    rng = np.random.default_rng(35)
    q = np.array(jc.q_list, np.uint64)[:, None]
    w = [(rng.integers(0, 1 << 32, (L, n), dtype=np.uint64) % q).astype(
        np.uint32) for _ in range(6)]
    want = jref.encrypt_pointwise(*map(jnp.asarray, w), jc, L)
    got = tref.encrypt_pointwise(*map(_i64, w), tc, L)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(_u32(g), np.asarray(x))
    np.testing.assert_array_equal(
        _u32(tref.decrypt_pointwise(*map(_i64, w[:3]), tc, 2)),
        np.asarray(jref.decrypt_pointwise(*map(jnp.asarray, w[:3]), jc, 2)))
    z = rng.standard_normal((2, 32)) + 1j * rng.standard_normal((2, 32))
    m = jc.params.m
    np.testing.assert_array_equal(tref.special_fft_rows(z, m),
                                  jref.special_fft_rows(z, m))
    np.testing.assert_array_equal(tref.special_ifft_rows(z, m),
                                  jref.special_ifft_rows(z, m))


@pytest.mark.parametrize("inverse", [False, True])
def test_k4_on_complex_rows(inverse):
    """``fft_df.special_fft_rows`` / ``special_ifft_rows`` and
    ``ops.special_fft`` / ``special_ifft`` on the CPU (K4's plain version)
    == the df32 planes route, within 2^-40 of the complex128 oracle; a
    1-D input comes back 1-D."""
    p = tctx.get_context("test").params
    rng = np.random.default_rng(36)
    z = rng.standard_normal((3, p.n_slots)) + 1j * rng.standard_normal(
        (3, p.n_slots))
    rows = tfft.special_ifft_rows if inverse else tfft.special_fft_rows
    op = tops.special_ifft if inverse else tops.special_fft
    oracle = tfftc.special_ifft if inverse else tfftc.special_fft
    got = rows(z, p.m, "cpu")
    planes = tdfl.dfc_to_planes(tdfl.dfc_from(z))
    f = tfft.special_ifft_planes if inverse else tfft.special_fft_planes
    np.testing.assert_array_equal(
        got, tdfl.dfc_to_complex(tdfl.dfc_from_planes(f(planes, p.m))))
    want = oracle(z, p.m)
    assert np.max(np.abs(got - want)) <= 2.0 ** -40 * np.max(np.abs(want))
    np.testing.assert_array_equal(op(z[1], p.m, "cpu"), got[1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rows(z, p.m)
