"""NTT-friendly prime generation (ABC-FHE eq. 8) — the port's own copy of
``repro.core.primes`` (pure Python; the port imports nothing of ``repro``).

The paper selects primes of the form

    Q = 2^p_bw + k * 2^(n+1) + 1,       k = ±2^a ± 2^b ± 2^c        (eq. 8)

so that the Montgomery factor QInv = Q^{-1} (mod R) collapses to

    QInv ≡ -2^p_bw - k * 2^(n+1) + 1    (mod R)                     (eq. 11)

and every multiplication inside Montgomery reduction except the initial
a*b product becomes shift-and-add.

TPU adaptation: the ASIC uses a 44-bit datapath with 36-bit primes; TPUs have
native 32-bit integer lanes, so the production profile here uses R = 2^32 and
30-bit primes q = 2^30 + k*2^17 + 1 (n+1 = 17 supports negacyclic NTT up to
N = 2^16). Exactness of eq. (11) requires val2(Q-1)^2 >= log2(R); with
val2(Q-1) >= 17 and R = 2^32 this always holds (derivation in modmul.py).

This module is pure Python/NumPy (host-side parameter generation only).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache


# --- deterministic Miller-Rabin, valid for all q < 2^64 ---------------------

_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@dataclasses.dataclass(frozen=True)
class NTTPrime:
    """A prime of the ABC-FHE eq. (8) family with its shift-add structure."""

    q: int
    p_bw: int               # exponent of the leading power of two
    k: int                  # signed k = sum of signed powers of two
    n_plus_1: int           # exponent of the 2N factor (q ≡ 1 mod 2^(n+1))
    k_terms: tuple[tuple[int, int], ...]  # ((sign, exp), ...) with k = Σ s*2^e

    @property
    def bit_length(self) -> int:
        return self.q.bit_length()

    def max_ntt_logn(self) -> int:
        """Largest log2(N) for which a negacyclic NTT exists mod q."""
        v = 0
        m = self.q - 1
        while m % 2 == 0:
            m //= 2
            v += 1
        return v - 1  # need a primitive 2N-th root of unity


def _signed_power_sums(max_exp: int, n_terms: int):
    """All k = ±2^a ± 2^b ± 2^c ... with distinct, decreasing exponents.

    Yields (k, ((sign, exp), ...)). Includes 1- and 2-term degenerate forms,
    which are the special cases of eq. (8) with coincident exponents.
    """
    from itertools import combinations, product

    for terms in range(1, n_terms + 1):
        for exps in combinations(range(max_exp, -1, -1), terms):
            for signs in product((1, -1), repeat=terms):
                k = sum(s * (1 << e) for s, e in zip(signs, exps))
                yield k, tuple(zip(signs, exps))


@lru_cache(maxsize=64)
def find_ntt_friendly_primes(
    p_bw: int = 30,
    n_plus_1: int = 17,
    count: int = 64,
    max_k_exp: int | None = None,
    word_bits: int = 32,
) -> tuple[NTTPrime, ...]:
    """Enumerate eq. (8) primes, largest |k| last, deduplicated, sorted by q.

    Constraints enforced:
      * q ≡ 1 (mod 2^n_plus_1)  — automatic from the form when p_bw >= n_plus_1
      * q < 2^(word_bits - 1)   — so two residues add without uint overflow
      * q prime.
    """
    if max_k_exp is None:
        max_k_exp = p_bw - n_plus_1 - 1  # keep |k|*2^(n+1) < 2^p_bw
    seen: dict[int, NTTPrime] = {}
    for k, terms in _signed_power_sums(max_k_exp, 3):
        q = (1 << p_bw) + k * (1 << n_plus_1) + 1
        if q <= 1 or q >= 1 << (word_bits - 1):
            continue
        if q in seen or not is_prime(q):
            continue
        seen[q] = NTTPrime(q=q, p_bw=p_bw, k=k, n_plus_1=n_plus_1, k_terms=terms)
    primes = sorted(seen.values(), key=lambda p: abs(p.k))
    if len(primes) < count:
        raise ValueError(
            f"only {len(primes)} eq.(8) primes with p_bw={p_bw}, "
            f"n+1={n_plus_1} (< requested {count})"
        )
    return tuple(primes[:count])


def census_paper_claim(n_plus_1: int = 17) -> dict[int, int]:
    """Reproduce the paper's §IV-A claim: 'the required 32-36 bit primes
    amount to a total of 443' for N = 2^16.

    Returns {bitwidth: count} over the eq. (8) family with 3-term k.
    """
    found: set[int] = set()
    for p_bw in range(31, 37):
        for k, _terms in _signed_power_sums(max_exp=p_bw - n_plus_1 - 1,
                                            n_terms=3):
            q = (1 << p_bw) + k * (1 << n_plus_1) + 1
            if q <= 1:
                continue
            if 32 <= q.bit_length() <= 36 and is_prime(q):
                found.add(q)
    hist: dict[int, int] = {}
    for q in found:
        hist[q.bit_length()] = hist.get(q.bit_length(), 0) + 1
    hist["total"] = len(found)  # type: ignore[index]
    return hist


def primitive_2nth_root(q: int, two_n: int) -> int:
    """Smallest-generator primitive (2N)-th root of unity mod q."""
    assert (q - 1) % two_n == 0, "q-1 must be divisible by 2N"
    cofactor = (q - 1) // two_n
    for g in range(2, 1 << 20):
        psi = pow(g, cofactor, q)
        if psi == 1:
            continue
        # psi has order dividing 2N; primitive iff psi^(N) == -1
        if pow(psi, two_n // 2, q) == q - 1:
            return psi
    raise RuntimeError(f"no primitive root found for q={q}")
