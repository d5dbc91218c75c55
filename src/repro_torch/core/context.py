"""CKKSParams, the named profiles and the per-profile CKKSContext.

Port of ``repro.core.context``. Parameters and profiles are the
reference's, value for value: a port client and a JAX client built from the
same profile draw the same primes, plans and seeds, and ``special_plan``
the same key-switching prime P. Contexts are memoised in a bounded LRU
(``set_context_cache_capacity``, ``context_cache_len``,
``context_cache_evictions``), as in the reference. ``CKKSContext`` also
carries the paper's memory terms (§IV-B / Fig. 6b: the twiddle tables
against their OTF seeds, the key material and the per-encryption mask
and errors if they were fetched from memory).
"""

from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core import cache
from repro_torch.core import ntt as nttmod
from repro_torch.core.primes import NTTPrime, find_ntt_friendly_primes


@dataclasses.dataclass(frozen=True)
class CKKSParams:
    logn: int = 16
    n_limbs: int = 24            # fresh ciphertext limbs
    decrypt_limbs: int = 2       # limbs of server-returned ciphertexts
    delta_bits: int = 58         # scale Delta = 2^delta_bits
    p_bw: int = 30               # eq.(8) leading exponent (32-bit words)
    seed: int = 0x243F6A8885A308D313198A2E03707344  # pi digits, 128-bit

    @property
    def n(self) -> int:
        return 1 << self.logn

    @property
    def n_slots(self) -> int:
        return self.n // 2

    @property
    def m(self) -> int:
        return 2 * self.n

    @property
    def delta(self) -> float:
        return float(2 ** self.delta_bits)


PROFILES = {
    "paper": CKKSParams(logn=16, n_limbs=24, decrypt_limbs=2,
                        delta_bits=55),
    "n15": CKKSParams(logn=15, n_limbs=24, decrypt_limbs=2, delta_bits=55),
    "n14": CKKSParams(logn=14, n_limbs=24, decrypt_limbs=2, delta_bits=55),
    "test": CKKSParams(logn=10, n_limbs=6, decrypt_limbs=2, delta_bits=50),
    "tiny": CKKSParams(logn=6, n_limbs=3, decrypt_limbs=2, delta_bits=40),
    "server": CKKSParams(logn=10, n_limbs=8, decrypt_limbs=2, delta_bits=30),
    "tinyboot": CKKSParams(logn=6, n_limbs=8, decrypt_limbs=2,
                           delta_bits=30),
    "boot": CKKSParams(logn=16, n_limbs=24, decrypt_limbs=2, delta_bits=30),
}


class CKKSContext:
    """Immutable parameter / prime / plan state for one parameter set."""

    def __init__(self, params: CKKSParams):
        self.params = params
        # q ≡ 1 mod 2N, and the eq.(11) closed form at R = 2^32 needs
        # n+1 >= 16: small rings draw from the n+1 = 16 family.
        n_plus_1 = max(params.logn + 1, 16)
        self.primes: tuple[NTTPrime, ...] = find_ntt_friendly_primes(
            p_bw=params.p_bw, n_plus_1=n_plus_1, count=params.n_limbs)
        self.q_list: tuple[int, ...] = tuple(p.q for p in self.primes)
        self.plans: tuple[nttmod.NTTPlan, ...] = tuple(
            nttmod.make_plan(p, params.n) for p in self.primes)
        assert params.delta < self.q_list[0] * self.q_list[1] / 4, \
            "Delta too large for 2-limb decrypt"
        self._n_plus_1 = n_plus_1
        self._special_plan: nttmod.NTTPlan | None = None

    def special_plan(self) -> nttmod.NTTPlan:
        """NTT plan of the key-switching special prime P: the next prime of
        the same eq.(8) search, run with count L+1 (the search is prefix-
        stable, so the ciphertext primes are untouched). Built on first use:
        a client that never makes evaluation keys never pays for it."""
        if self._special_plan is None:
            primes = find_ntt_friendly_primes(
                p_bw=self.params.p_bw, n_plus_1=self._n_plus_1,
                count=self.params.n_limbs + 1)
            assert primes[:-1] == self.primes, "prime search not prefix-stable"
            self._special_plan = nttmod.make_plan(primes[-1], self.params.n)
        return self._special_plan

    @property
    def n(self) -> int:
        return self.params.n

    def stacked_plans(self, n_limbs: int | None = None
                      ) -> nttmod.StackedPlans:
        n_limbs = n_limbs if n_limbs is not None else self.params.n_limbs
        return _stacked(self, n_limbs)

    def q_product(self, n_limbs: int) -> int:
        return math.prod(self.q_list[:n_limbs])

    def modulus_bits(self, n_limbs: int | None = None) -> float:
        n_limbs = n_limbs if n_limbs is not None else self.params.n_limbs
        return sum(math.log2(q) for q in self.q_list[:n_limbs])

    # --- memory accounting (paper §IV-B / Fig. 6b terms) -------------------

    def twiddle_table_bytes(self) -> int:
        return sum(p.table_nbytes() for p in self.plans)

    def twiddle_seed_bytes(self) -> int:
        return sum(p.seeds.nbytes() for p in self.plans)

    def key_material_bytes(self) -> int:
        """Public key (b, a) across limbs, uint32 words."""
        return 2 * self.params.n_limbs * self.n * 4

    def mask_error_bytes(self) -> int:
        """Per-encryption randomness (v, e0, e1) if fetched from memory."""
        return 3 * self.params.n_limbs * self.n * 4


@functools.lru_cache(maxsize=16)
def _stacked(ctx: CKKSContext, n_limbs: int) -> nttmod.StackedPlans:
    return nttmod.stack_plans(ctx.plans[:n_limbs])


_CONTEXT_CACHE = cache.LRUCache(capacity=16, name="contexts")


def context_for(params: CKKSParams) -> CKKSContext:
    """Context memo keyed by the frozen parameter set (LRU-bounded; see
    ``set_context_cache_capacity``)."""
    return _CONTEXT_CACHE.get_or_build(params, lambda: CKKSContext(params))


def set_context_cache_capacity(capacity: int) -> int:
    """Bound the context cache (evicting LRU entries down to ``capacity``
    at once); returns the previous capacity."""
    return _CONTEXT_CACHE.set_capacity(capacity)


def context_cache_len() -> int:
    """Number of contexts the cache holds."""
    return len(_CONTEXT_CACHE)


def context_cache_evictions() -> int:
    """Contexts evicted since the process started (monotonic)."""
    return _CONTEXT_CACHE.evictions


def get_context(profile: str | CKKSParams = "paper") -> CKKSContext:
    """Context for a named profile, or directly for a CKKSParams value."""
    if isinstance(profile, CKKSParams):
        return context_for(profile)
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}; "
                         f"known: {sorted(PROFILES)}")
    return context_for(PROFILES[profile])
