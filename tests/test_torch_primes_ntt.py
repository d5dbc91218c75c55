"""The prime-family, Montgomery and OTF-twiddle checks of the reference's
``tests/test_modmul.py`` and ``tests/test_ntt.py`` that no other port test
holds, on the port's host code, with the reference's inputs:

  * the eq. (8) family, p_bw 30, n+1 17, 32 primes: each prime, q = 2^30 +
    k 2^17 + 1 with k the sum of its k-terms, 2^17 | q - 1, q < 2^31, a
    negacyclic NTT of 2^16 (``test_modmul.py:25``); eq. (11)'s closed form
    holds for every one (``MontgomeryConstants.make`` asserts it, ``:36``);
    psi, the primitive 2^17-th root of the first four, has psi^(2^16) = -1
    and psi^(2^17) = 1 (``:42``);
  * the OTF seeds (base, step) of every stage regenerate that stage's psi
    table, N = 64 and 1024, prime 2 (``test_ntt.py:57``).

These values are deterministic integers, so each is also held equal to the
reference's, called in-process (host code: no kernel runs): the primes
and their k-terms, the Montgomery constants, the roots, the seeds and the
generated stage twiddles.
"""

import numpy as np
import pytest

from repro.core import modmul as ref_modmul
from repro.core import ntt as ref_ntt
from repro.core import primes as ref_primes
from repro_torch.core import modmul
from repro_torch.core import ntt as nttmod
from repro_torch.core.primes import (find_ntt_friendly_primes, is_prime,
                                     primitive_2nth_root)

PRIMES = find_ntt_friendly_primes(p_bw=30, n_plus_1=17, count=32)
REF_PRIMES = ref_primes.find_ntt_friendly_primes(p_bw=30, n_plus_1=17,
                                                 count=32)
NTT_PRIMES = find_ntt_friendly_primes(p_bw=30, n_plus_1=17, count=8)


def test_prime_family_structure():
    for p in PRIMES:
        assert is_prime(p.q)
        assert (p.q - 1) % (1 << 17) == 0, "must support N=2^16 negacyclic NTT"
        assert p.q < 1 << 31
        k = sum(s * (1 << e) for s, e in p.k_terms)
        assert k == p.k
        assert p.q == (1 << 30) + k * (1 << 17) + 1
        assert p.max_ntt_logn() >= 16


def test_primes_equal_reference():
    assert [(p.q, p.p_bw, p.k, p.n_plus_1, tuple(p.k_terms))
            for p in PRIMES] == [
        (p.q, p.p_bw, p.k, p.n_plus_1, tuple(p.k_terms)) for p in REF_PRIMES]


def test_eq11_closed_form():
    """``make`` asserts eq. (11) for each of the 32; its constants are the
    reference's."""
    for p, r in zip(PRIMES, REF_PRIMES):
        c = modmul.MontgomeryConstants.make(p)
        w = ref_modmul.MontgomeryConstants.make(r)
        assert (c.q, c.qinv_neg, c.r2, c.r1, c.mu) == (
            w.q, w.qinv_neg, w.r2, w.r1, w.mu)


def test_eq11_closed_form_violation_asserts():
    """A prime whose k disagrees with its q breaks eq. (11): the reference's
    ``AssertionError`` in both packages."""
    import dataclasses
    bad = dataclasses.replace(PRIMES[0], k=PRIMES[0].k + 1)
    ref_bad = dataclasses.replace(REF_PRIMES[0], k=REF_PRIMES[0].k + 1)
    with pytest.raises(AssertionError, match="eq.\\(11\\)"):
        ref_modmul.MontgomeryConstants.make(ref_bad)
    with pytest.raises(AssertionError, match="eq.\\(11\\)"):
        modmul.MontgomeryConstants.make(bad)


def test_primitive_root():
    for p in PRIMES[:4]:
        psi = primitive_2nth_root(p.q, 1 << 17)
        assert pow(psi, 1 << 16, p.q) == p.q - 1
        assert pow(psi, 1 << 17, p.q) == 1
        assert psi == ref_primes.primitive_2nth_root(p.q, 1 << 17)


@pytest.mark.parametrize("n", [64, 1024])
def test_otf_seeds_regenerate_tables(n):
    """The (base, step) seeds regenerate every stage's twiddles: the
    unified OTF TF Gen invariant (paper §IV-B)."""
    plan = nttmod.make_plan(NTT_PRIMES[2], n)
    q = plan.prime.q
    r = (1 << 32) % q
    logn = n.bit_length() - 1
    psi_brv = (plan.psi_brv_mont * pow(pow(r, -1, q), 1, q)) % q
    for s in range(logn):
        m = 1 << s
        got = nttmod.stage_twiddles_np(
            plan.seeds.fwd_base[s], plan.seeds.fwd_step[s], m, q)
        np.testing.assert_array_equal(got, psi_brv[m:2 * m])


@pytest.mark.parametrize("n", [64, 1024])
def test_otf_seeds_and_tables_equal_reference(n):
    plan = nttmod.make_plan(NTT_PRIMES[2], n)
    ref = ref_ntt.make_plan(
        ref_primes.find_ntt_friendly_primes(p_bw=30, n_plus_1=17,
                                            count=8)[2], n)
    assert plan.psi == ref.psi
    for f in ("fwd_base", "fwd_step", "inv_base", "inv_step", "n_inv"):
        assert tuple(np.atleast_1d(getattr(plan.seeds, f))) == tuple(
            np.atleast_1d(getattr(ref.seeds, f))), f
    np.testing.assert_array_equal(plan.psi_brv_mont,
                                  np.asarray(ref.psi_brv_mont))
    np.testing.assert_array_equal(plan.psi_inv_brv_mont,
                                  np.asarray(ref.psi_inv_brv_mont))
    q = plan.prime.q
    for s in range(plan.seeds.logn):
        m = 1 << s
        np.testing.assert_array_equal(
            nttmod.stage_twiddles_np(plan.seeds.fwd_base[s],
                                     plan.seeds.fwd_step[s], m, q),
            ref_ntt.stage_twiddles_np(ref.seeds.fwd_base[s],
                                      ref.seeds.fwd_step[s], m, q))
