"""Multi-tenant key contexts: per-tenant seeds, nonce leases, LRU registry.

Port of ``repro.fhe_client.tenancy`` (no framework code beyond the
client it builds): seeds, fingerprints, leases and the registry are the
reference's, so a tenant's derived seed — and with it every key and
ciphertext word — is the same in both packages.

A service with ONE key owner is not enough: a co-resident
deployment — several models / several users sharing the accelerator — needs
one CKKS key context *per tenant*: its own secret/public key pair, its own
Philox randomness streams, its own nonce counter. Two invariants make that
safe and testable:

**Stream disjointness.** Every Philox draw in the pipeline is keyed by a
128-bit seed (``encryptor`` stream constants partition the per-seed counter
space). Lanes therefore get *derived seeds*: ``tenant_seed(params, tid)``
hashes the FULL parameter-set fingerprint (every ``CKKSParams`` field, not
just the base seed — the shipped profiles all share one default base seed)
with the tenant id, so no two ``(tenant, params)`` lanes — including the
same tenant under two parameter sets, or the anonymous ``None`` tenant
under two parameter sets — can ever draw (v, e0, e1) or key material from
the same stream, regardless of nonce accounting. A registry-built lane's
seed is always a hash output, so it also never collides with the raw base
seed of a caller-constructed ``FHEClient`` (the service's default lane);
use ``install`` when the caller's instance itself must be the session.

**Bit-transparency.** A lane's derived seed depends only on
``(params, tenant_id)`` — never on who else is resident, admission order,
or registry capacity. Combined with per-tenant nonce counters this gives
the contract the isolation tests pin: the ciphertexts a tenant receives
co-resident are bit-identical to the ones it would receive running alone.

The ``KeyContextRegistry`` is the retention policy: an LRU of
``(tenant_id, CKKSParams) -> FHEClient`` bounded to ``capacity`` live key
contexts (each holds its keys and key material on the card — the
expensive part). Eviction persists the tenant's **nonce watermark**;
re-admission rebuilds the client (same derived seed => same keys,
bit-identical behaviour) and restores the watermark, so nonces never rewind
across evictions (RLWE randomness must never be reused under one key).
The ``NonceLedger`` turns that "never" into an assertion: every lease is
recorded per seed and overlapping ranges raise.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict

from repro_torch.core.context import CKKSParams, PROFILES


_SEED_MASK = (1 << 128) - 1


def params_fingerprint(params) -> bytes:
    """Canonical byte fingerprint of a ``CKKSParams`` — EVERY field, in
    declaration order. The shipped profiles all share one default base
    seed, so a lane identity must cover the whole parameter set: two
    parameter sets that differ in any field (ring degree, limb counts,
    scale, prime bit-width, base seed) are distinct lanes."""
    params = _resolve_params(params)
    parts = [b"ckks-lane-v1"]
    for f in dataclasses.fields(params):
        parts.append(f"{f.name}={getattr(params, f.name)}".encode("utf-8"))
    return b"\x00".join(parts)


def tenant_seed(params, tenant_id) -> int:
    """Derive a ``(tenant, params)`` lane's 128-bit Philox seed: a
    SHA-256 over the FULL parameter-set fingerprint and the tenant id.
    Deterministic, order-free, and independent of co-residents (the
    bit-transparency contract), and distinct across parameter sets even
    when they share a base seed — the same tenant (or the anonymous
    ``None`` tenant) under two parameter sets must never draw key
    material, mask or error polynomials from one Philox stream, nor run
    two independent nonce counters against one ledger watermark.

    The digest-valued seed also structurally avoids the raw base seed a
    caller-constructed ``FHEClient`` uses, so a registry-built anonymous
    lane never shares a stream with the service's default client.
    """
    h = hashlib.sha256()
    h.update(params_fingerprint(params))
    if tenant_id is None:
        h.update(b"\x00anon\x00")
    else:
        h.update(b"\x00tenant\x00")
        h.update(str(tenant_id).encode("utf-8"))
    return int.from_bytes(h.digest()[:16], "little") & _SEED_MASK


@dataclasses.dataclass(frozen=True)
class NonceLease:
    """A leased half-open nonce range ``[base, base + count)`` under one
    128-bit seed. Rows of a batch encrypt under ``base + r``."""

    seed: int
    base: int
    count: int

    @property
    def end(self) -> int:
        return self.base + self.count


class NonceLedger:
    """Records every nonce lease per seed and rejects overlap.

    Distinct tenants have distinct derived seeds, so disjointness across
    tenants is structural; the ledger guards the remaining failure modes —
    a rewound counter after eviction/restart, or two clients accidentally
    constructed with the same seed — by raising instead of silently reusing
    RLWE randomness.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # seed -> high watermark (max end of any lease granted)
        self._watermark: dict[int, int] = {}
        self.leases_granted = 0

    def lease(self, seed: int, base: int, count: int) -> NonceLease:
        if count < 0:
            raise ValueError(f"lease count must be >= 0, got {count}")
        seed = int(seed)
        base = int(base)
        with self._lock:
            high = self._watermark.get(seed, 0)
            if base < high:
                raise RuntimeError(
                    f"nonce lease [{base}, {base + count}) under seed "
                    f"{seed:#x} overlaps already-leased range [0, {high}): "
                    "nonce counters must never rewind (RLWE randomness "
                    "reuse)")
            self._watermark[seed] = base + count
            self.leases_granted += 1
            return NonceLease(seed=seed, base=base, count=count)

    def lease_next(self, seed: int, count: int) -> NonceLease:
        """Atomically lease the next ``count`` nonces at the seed's
        current watermark (read-watermark-then-lease without a gap —
        the mesh router's central nonce authority grants ranges this
        way, one lease per dispatched chunk)."""
        if count < 0:
            raise ValueError(f"lease count must be >= 0, got {count}")
        seed = int(seed)
        with self._lock:
            base = self._watermark.get(seed, 0)
            self._watermark[seed] = base + count
            self.leases_granted += 1
            return NonceLease(seed=seed, base=base, count=count)

    def watermark(self, seed: int) -> int:
        with self._lock:
            return self._watermark.get(int(seed), 0)


def _resolve_params(params) -> CKKSParams:
    if isinstance(params, CKKSParams):
        return params
    return PROFILES[params]


@dataclasses.dataclass
class TenantSession:
    """A live (tenant, params) key context: the client plus accounting."""

    tenant_id: object
    params: CKKSParams
    client: object              # FHEClient (duck-typed for the factory hook)
    builds: int = 1             # times this (tenant, params) was (re)built
    leases: int = 0

    @property
    def seed(self) -> int:
        return self.client.seed


class KeyContextRegistry:
    """LRU registry of per-tenant key contexts.

    ``get(tenant_id, params)`` returns the live ``TenantSession``, building
    it on first use (or after eviction) via ``client_factory(params, seed)``
    — by default ``FHEClient(params, seed=...)`` with every Fourier/pipeline
    kwarg (and ``device``: the service passes its own) inherited from the
    registry. Keys, per-device key copies and nonce counter
    live on the session's client; evicting a session drops all of that
    except the **nonce watermark**, which is persisted in the registry and
    restored on re-admission so a returning tenant continues its nonce
    sequence instead of rewinding it.

    ``take_nonces`` is the service's single nonce authority: it advances the
    tenant client's counter AND records the lease in the shared
    ``NonceLedger`` (overlap => raise).
    """

    def __init__(self, capacity: int = 4, client_factory=None,
                 ledger: NonceLedger | None = None, **client_kwargs):
        if capacity < 1:
            raise ValueError(f"registry capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.ledger = ledger if ledger is not None else NonceLedger()
        self._client_kwargs = dict(client_kwargs)
        self._factory = client_factory or self._default_factory
        self._lock = threading.RLock()
        self._sessions: OrderedDict[tuple, TenantSession] = OrderedDict()
        # (tenant_id, params) -> persisted nonce watermark + build count of
        # evicted sessions, so re-admission never rewinds and tests can pin
        # "rebuilt exactly once per re-admission".
        self._watermarks: dict[tuple, int] = {}
        self._builds: dict[tuple, int] = {}
        self.evictions = 0

    @staticmethod
    def _default_factory(params: CKKSParams, seed: int, **kwargs):
        from repro_torch.fhe_client.client import FHEClient
        return FHEClient(profile=params, seed=seed, **kwargs)

    # -- admission ----------------------------------------------------------

    def get(self, tenant_id, params="test") -> TenantSession:
        """Live session for ``(tenant_id, params)`` (params value or profile
        name), building/rebuilding and LRU-bumping as needed.

        Construction (prime search, keygen — potentially
        seconds) runs OUTSIDE the registry lock: one tenant's cold build
        must never stall another tenant's counter advance or lookup. Two
        threads racing the same cold key may both build; the first insert
        wins and the loser's client is discarded before it ever leases a
        nonce (same derived seed => the discarded keys were identical
        anyway)."""
        params = _resolve_params(params)
        key = (tenant_id, params)
        with self._lock:
            sess = self._sessions.get(key)
            if sess is not None:
                self._sessions.move_to_end(key)
                return sess
        seed = tenant_seed(params, tenant_id)
        client = self._factory(params, seed, **self._client_kwargs)
        with self._lock:
            sess = self._sessions.get(key)
            if sess is not None:          # lost the build race: keep winner
                self._sessions.move_to_end(key)
                return sess
            # restore the persisted watermark: a returning tenant resumes
            # its nonce sequence (fresh keys are identical — same seed —
            # so rewinding WOULD be randomness reuse). The ledger watermark
            # also covers leases taken against a just-evicted session.
            client.nonce = max(int(client.nonce),
                               self._watermarks.get(key, 0),
                               self.ledger.watermark(seed))
            builds = self._builds.get(key, 0) + 1
            self._builds[key] = builds
            sess = TenantSession(tenant_id=tenant_id, params=params,
                                 client=client, builds=builds)
            self._sessions[key] = sess
            self._trim()
            return sess

    def install(self, tenant_id, client) -> TenantSession:
        """Admit an externally constructed client as a tenant (the
        single-tenant ``ClientService(client=...)`` back-compat path: the
        caller's instance IS the session, seed and nonce state included)."""
        params = client.ctx.params
        key = (tenant_id, params)
        with self._lock:
            client.nonce = max(int(client.nonce), self._watermarks.get(key, 0))
            builds = self._builds.get(key, 0) + 1
            self._builds[key] = builds
            sess = TenantSession(tenant_id=tenant_id, params=params,
                                 client=client, builds=builds)
            self._sessions[key] = sess
            self._sessions.move_to_end(key)
            self._trim()
            return sess

    def peek(self, tenant_id, params) -> TenantSession | None:
        """Session if resident, else None. No LRU bump, no build."""
        with self._lock:
            return self._sessions.get((tenant_id, _resolve_params(params)))

    def _trim(self):
        while len(self._sessions) > self.capacity:
            key, sess = self._sessions.popitem(last=False)
            self._watermarks[key] = int(sess.client.nonce)
            self.evictions += 1

    def evict(self, tenant_id, params) -> bool:
        """Explicitly drop a session (watermark persisted). True if it was
        resident."""
        key = (tenant_id, _resolve_params(params))
        with self._lock:
            sess = self._sessions.pop(key, None)
            if sess is None:
                return False
            self._watermarks[key] = int(sess.client.nonce)
            self.evictions += 1
            return True

    # -- nonce authority ----------------------------------------------------

    def take_nonces(self, tenant_id, params, count: int) -> int:
        """Lease ``count`` nonces for the tenant; returns the base. Advances
        the tenant client's counter and records the lease in the ledger.

        Session resolution (which may cold-build) happens outside the
        registry lock; only the counter advance + ledger record are
        locked. If the session is evicted between the two, advancing its
        orphaned counter is still safe: the lease lands in the ledger,
        and re-admission resumes from the ledger watermark."""
        sess = self.get(tenant_id, params)
        with self._lock:
            base = sess.client.take_nonces(count)
            self.ledger.lease(sess.seed, base, count)
            sess.leases += 1
            return base

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def resident_keys(self) -> list[tuple]:
        with self._lock:
            return list(self._sessions.keys())

    def resident_clients(self) -> list:
        """Live clients of every resident session (LRU order, oldest
        first) — the set the table-cache probe walks."""
        with self._lock:
            return [s.client for s in self._sessions.values()]

    def stats(self) -> dict:
        with self._lock:
            return {
                "resident": len(self._sessions),
                "capacity": self.capacity,
                "evictions": self.evictions,
                "builds": dict(self._builds),
                "leases_granted": self.ledger.leases_granted,
            }
