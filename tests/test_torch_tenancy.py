"""The port's multi-tenant key contexts and the service's tenant lanes, on
the CPU.

Mirrors the cache, tenancy and service halves of
``tests/test_multi_tenant.py`` (its ``workload_matrix`` cases belong to the
benchmark): the bounded ``LRUCache``; derived per-tenant seeds (no shared
Philox streams; equal to the JAX package's seeds in
``tests/test_torch_policy.py``), non-overlapping nonce leases that survive
registry eviction, LRU retention that rebuilds a client exactly once per
re-admission; bit-transparency (a tenant's co-resident ciphertexts equal a
solo client's from the same nonce base); buckets that never mix tenants.
The registry builds its clients on the device it is given (the service
passes its own; here the CPU). Tolerance: 0.
"""

import dataclasses
from collections import deque

import numpy as np
import pytest
import torch

from repro_torch.core import cache
from repro_torch.core.context import PROFILES
from repro_torch.fhe_client.client import FHEClient
from repro_torch.fhe_client.service import ClientService
from repro_torch.fhe_client.service.batcher import CoalescingBatcher, Request
from repro_torch.fhe_client.tenancy import (KeyContextRegistry, NonceLedger,
                                            tenant_seed)

TINY = PROFILES["tiny"]
CPU = torch.device("cpu")


def _ct_equal(a, b) -> bool:
    return torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)


def _msgs(n_slots, b=2, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, n_slots))
            + 1j * r.standard_normal((b, n_slots))) * 0.5


def _registry(capacity):
    return KeyContextRegistry(capacity=capacity, device=CPU)


# ---------------------------------------------------------------------------
# cache layer
# ---------------------------------------------------------------------------


class TestLRUCache:
    def test_eviction_order_and_hook(self):
        evicted = []
        c = cache.LRUCache(capacity=2,
                           on_evict=lambda k, v: evicted.append(k))
        c.put("a", 1)
        c.put("b", 2)
        assert c.get("a") == 1
        c.put("c", 3)
        assert "b" not in c and "a" in c and "c" in c
        assert evicted == ["b"] and c.evictions == 1

    def test_set_capacity_trims(self):
        c = cache.LRUCache(capacity=8)
        for i in range(8):
            c.put(i, i)
        assert c.set_capacity(2) == 8 and set(c.keys()) == {6, 7}

    def test_get_or_build_builds_once_and_named_stats(self):
        calls = []
        c = cache.LRUCache(capacity=4, name="test_tenancy_memo")
        for _ in range(3):
            c.get_or_build("k", lambda: calls.append(1) or "v")
        assert calls == [1]
        st = cache.cache_stats()["test_tenancy_memo"]
        assert (st["hits"], st["misses"], st["size"]) == (2, 1, 1)
        with pytest.raises(ValueError):
            cache.LRUCache(capacity=0)

    def test_port_memos_report_under_reference_names(self):
        stats = cache.cache_stats()
        for name in ("plan_consts", "stacked_kernel_consts", "server_consts",
                     "stacked_plans", "contexts", "ntt_plans", "ntt_primes",
                     *cache.TABLE_MEMOS):
            assert {"size", "capacity", "hits", "misses",
                    "evictions"} <= set(stats[name]), name


# ---------------------------------------------------------------------------
# tenancy: seeds, nonce ledger, registry
# ---------------------------------------------------------------------------


class TestTenantSeed:
    def test_anon_lane_never_aliases_raw_base_seed(self):
        assert tenant_seed(TINY, None) != TINY.seed

    def test_derived_seeds_distinct_and_deterministic(self):
        sa, sb = tenant_seed(TINY, "alice"), tenant_seed(TINY, "bob")
        assert sa != sb and TINY.seed not in (sa, sb)
        assert sa == tenant_seed(TINY, "alice")
        assert 0 <= sa < (1 << 128) and 0 <= sb < (1 << 128)

    def test_seed_depends_on_full_fingerprint(self):
        assert PROFILES["tiny"].seed == PROFILES["test"].seed
        for tid in ("alice", None):
            assert tenant_seed(PROFILES["tiny"], tid) \
                != tenant_seed(PROFILES["test"], tid)
        for change in ({"seed": TINY.seed + 1}, {"delta_bits": 39},
                       {"n_limbs": 4}):
            assert tenant_seed(dataclasses.replace(TINY, **change),
                               "alice") != tenant_seed(TINY, "alice")


class TestNonceLedger:
    def test_disjoint_leases_ok_overlap_rejected(self):
        led = NonceLedger()
        led.lease(seed=7, base=0, count=4)
        led.lease(seed=7, base=4, count=2)
        led.lease(seed=9, base=0, count=8)
        with pytest.raises(RuntimeError, match="rewind"):
            led.lease(seed=7, base=5, count=1)
        assert led.watermark(7) == 6 and led.watermark(9) == 8
        lease = led.lease_next(7, 3)
        assert (lease.base, lease.end) == (6, 9)

    def test_gap_lease_advances_watermark(self):
        led = NonceLedger()
        led.lease(seed=1, base=10, count=2)
        assert led.watermark(1) == 12
        with pytest.raises(RuntimeError):
            led.lease(seed=1, base=0, count=1)


class TestRegistry:
    def test_get_builds_once_and_is_lru(self):
        reg = _registry(2)
        a = reg.get("alice", TINY)
        assert reg.get("alice", TINY) is a and a.builds == 1
        assert a.client.device == CPU
        reg.get("bob", TINY)
        reg.get("alice", TINY)
        reg.get("carol", TINY)                  # evicts bob (LRU)
        assert reg.peek("bob", TINY) is None
        assert reg.peek("alice", TINY) is not None
        assert reg.evictions == 1

    def test_distinct_tenant_seeds_and_keys(self):
        reg = _registry(4)
        a = reg.get("alice", TINY).client
        b = reg.get("bob", TINY).client
        assert a.seed == tenant_seed(TINY, "alice") != b.seed
        assert not torch.equal(a.keys.pk.b_mont, b.keys.pk.b_mont)

    def test_nonce_watermark_survives_eviction(self):
        reg = _registry(1)
        assert reg.take_nonces("alice", TINY, 4) == 0
        reg.get("bob", TINY)                    # evicts alice
        assert reg.take_nonces("alice", TINY, 2) == 4   # never rewound
        sess = reg.get("alice", TINY)
        assert sess.builds >= 2
        assert reg.ledger.watermark(sess.seed) == 6

    def test_capacity_validation(self):
        with pytest.raises(ValueError):
            KeyContextRegistry(capacity=0)

    def test_default_factory_builds_on_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            KeyContextRegistry(capacity=1).get("alice", TINY)

    def test_same_tenant_two_param_sets_lease_independently(self):
        tiny2 = dataclasses.replace(TINY, delta_bits=38)
        reg = _registry(4)
        for tid in ("alice", None):
            assert reg.get(tid, TINY).seed != reg.get(tid, tiny2).seed
            assert reg.take_nonces(tid, TINY, 4) == 0
            assert reg.take_nonces(tid, tiny2, 4) == 0


def test_coresident_equals_solo_bit_identity():
    msgs = _msgs(TINY.n_slots, b=2, seed=3)
    reg = _registry(4)
    reg.get("bob", TINY).client.encode_encrypt_batch(msgs)
    ct_co = reg.get("alice", TINY).client.encode_encrypt_batch(msgs)
    ct_solo = _registry(4).get("alice",
                               TINY).client.encode_encrypt_batch(msgs)
    assert _ct_equal(ct_co, ct_solo)
    ct_bob = _registry(4).get("bob", TINY).client.encode_encrypt_batch(msgs)
    assert not _ct_equal(ct_co, ct_bob)


def test_eviction_readmission_rebuilds_exactly_once():
    """Evicting a tenant drops its client; re-admission rebuilds it exactly
    once, resumes its nonce sequence, and encrypts bit-identically to an
    uninterrupted client at the same nonce position."""
    msgs = _msgs(TINY.n_slots, b=2, seed=5)
    reg = _registry(1)
    alice = reg.get("alice", TINY).client
    alice.encode_encrypt_batch(msgs)
    assert reg.get("alice", TINY).client is alice
    alice.encode_encrypt_batch(msgs)
    reg.get("bob", TINY)
    assert reg.evictions == 1
    alice2 = reg.get("alice", TINY).client
    assert alice2 is not alice and reg.get("alice", TINY).builds == 2
    nonce_resume = alice2.nonce
    assert nonce_resume == 2 * msgs.shape[0]
    ct = alice2.encode_encrypt_batch(msgs)
    solo = FHEClient(TINY, seed=tenant_seed(TINY, "alice"), device="cpu")
    solo.nonce = nonce_resume
    assert _ct_equal(ct, solo.encode_encrypt_batch(msgs))


# ---------------------------------------------------------------------------
# service layer: lanes, strict submit validation, mixing rejection
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tenant_svc():
    return ClientService(FHEClient("tiny", device="cpu"), buckets=(1, 2, 4))


def test_service_tenant_roundtrip_and_bit_transparency(tenant_svc):
    svc = tenant_svc
    msgs = _msgs(TINY.n_slots, b=3, seed=11)
    rid_a = svc.submit_encrypt(msgs[0], tenant="alice")
    rid_b = svc.submit_encrypt(msgs[1], tenant="bob")
    rid_d = svc.submit_encrypt(msgs[2])
    svc.flush()
    ct_a, ct_b = svc.result(rid_a), svc.result(rid_b)
    svc.result(rid_d)
    sess = svc.registry.peek("alice", TINY)
    assert sess.client.device == CPU
    (rec,) = [r for r in svc.dispatch_log if r.rids == (rid_a,)]
    solo = FHEClient(TINY, seed=tenant_seed(TINY, "alice"), device="cpu")
    solo.nonce = rec.nonce0
    ct_solo = solo.encode_encrypt_batch(msgs[:1])
    assert torch.equal(ct_a.c0, ct_solo.c0[0])
    assert torch.equal(ct_a.c1, ct_solo.c1[0])
    assert not torch.equal(ct_a.c0, ct_b.c0)
    rid = svc.submit_decrypt((ct_a.c0[:2].numpy().view(np.uint32),
                              ct_a.c1[:2], ct_a.scale), tenant="alice")
    svc.flush()
    np.testing.assert_allclose(svc.result(rid), msgs[0], atol=1e-6)


def test_cross_tenant_bucket_mixing_rejected():
    b = CoalescingBatcher(buckets=(4,))
    q = deque([
        Request(rid=0, kind="enc", payload=np.zeros(4, complex),
                t_submit=0.0, tenant=("alice", TINY)),
        Request(rid=1, kind="enc", payload=np.zeros(4, complex),
                t_submit=0.0, tenant=("bob", TINY)),
    ])
    with pytest.raises(ValueError, match="cross-tenant"):
        b.coalesce_enc(q, nonce0=0, n_slots=4, tenant=("alice", TINY))
    assert [r.rid for r in q] == [0, 1]
    with pytest.raises(ValueError, match="cross-tenant"):
        b.coalesce_dec(q, tenant=("alice", TINY))
    assert [r.rid for r in q] == [0, 1]


def test_default_plus_anon_param_lane_interleave(tenant_svc):
    svc = tenant_svc
    tiny2 = dataclasses.replace(TINY, delta_bits=38)
    msgs = _msgs(TINY.n_slots, b=2, seed=23)
    rid_anon = svc.submit_encrypt(msgs[0], params=tiny2)
    rid_dflt = svc.submit_encrypt(msgs[1])
    svc.flush()
    assert svc.result(rid_anon) is not None
    assert svc.result(rid_dflt) is not None
    sess = svc.registry.peek(None, tiny2)
    assert sess is not None and sess.seed != svc.client.seed


def test_submit_encrypt_strict_validation(tenant_svc):
    svc = tenant_svc
    ns = TINY.n_slots
    ok = np.zeros(ns, complex)
    with pytest.raises(ValueError, match="1-D"):
        svc.submit_encrypt(ok[None])
    with pytest.raises(ValueError, match="slots"):
        svc.submit_encrypt(np.zeros(ns + 1, complex))
    with pytest.raises(ValueError, match="numeric"):
        svc.submit_encrypt(np.array(["x"] * ns))
    bad = ok.copy()
    bad[3] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        svc.submit_encrypt(bad)
    bad[3] = np.inf * 1j
    with pytest.raises(ValueError, match="non-finite"):
        svc.submit_encrypt(bad)
    assert svc.pending()["enc"] == 0


def test_service_nonce_rewind_rejected(tenant_svc):
    svc = tenant_svc
    msgs = _msgs(TINY.n_slots, b=1, seed=13)
    rid = svc.submit_encrypt(msgs[0])
    svc.flush()
    svc.result(rid)
    saved = svc.client.nonce
    svc.client.nonce = 0
    try:
        svc.submit_encrypt(msgs[0])
        with pytest.raises(RuntimeError, match="rewind"):
            svc.flush()
    finally:
        svc.client.nonce = saved
        for q in svc._queues.values():
            q.clear()


def test_service_lane_queues_never_share(tenant_svc):
    svc = tenant_svc
    msgs = _msgs(TINY.n_slots, b=1, seed=17)
    svc.submit_encrypt(msgs[0], tenant="alice")
    svc.submit_encrypt(msgs[0], tenant="bob")
    lanes = {k[0] for k, n in svc.pending_by_lane().items() if n}
    assert len(lanes) == 2
    assert svc.pending() == {"enc": 2, "dec": 0}
    svc.flush()
    log = svc.dispatch_log
    assert all(len(rec.rids) == 1 for rec in log[-2:])


def test_tenant_lanes_warm_before_start_on_two_streams():
    """A resident tenant lane is warmed with the default one; its jobs run
    on either oversubscribed stream under its own keys and lease."""
    svc = ClientService(FHEClient("tiny", device="cpu"), buckets=(2,),
                        n_streams=2, oversubscribe=True, max_wait_s=0.002)
    svc.registry.get("alice", TINY)
    assert svc.warm_up() == 2 * 2 * 2          # 2 lanes x 2 streams x 2
    msgs = _msgs(TINY.n_slots, b=4, seed=29)
    with svc:
        rids = [svc.submit_encrypt(m, tenant="alice") for m in msgs]
        rows = [svc.result(r, timeout=60.0) for r in rids]
    solo = FHEClient(TINY, seed=tenant_seed(TINY, "alice"), device="cpu")
    for rec in svc.dispatch_log:
        solo.nonce = rec.nonce0
        direct = solo.encode_encrypt_batch(msgs[[rids.index(r)
                                                  for r in rec.rids]])
        for i, r in enumerate(rec.rids):
            assert torch.equal(rows[rids.index(r)].c0, direct.c0[i])


def test_tenant_lane_first_seen_while_running_warms_on_submit():
    """A tenant lane that first shows up while the loop runs is warmed by
    its first submit, before the request is queued (so the dispatch
    thread never builds), and the warm-up takes none of its nonces: its
    first job leases the solo client's first base."""
    svc = ClientService(FHEClient("tiny", device="cpu"), buckets=(2,),
                        n_streams=2, oversubscribe=True, max_wait_s=0.002)
    lane = ("bob", TINY)
    msgs = _msgs(TINY.n_slots, b=2, seed=31)
    solo = FHEClient(TINY, seed=tenant_seed(TINY, "bob"), device="cpu")
    with svc:
        rid = svc.submit_encrypt(msgs[0], tenant="bob")
        assert lane in svc._warm
        rids = [rid, svc.submit_encrypt(msgs[1], tenant="bob")]
        rows = [svc.result(r, timeout=60.0) for r in rids]
    assert svc._warm_lane(lane) == 0
    base = solo.nonce
    assert [rec.nonce0 for rec in svc.dispatch_log][0] == base
    for rec in svc.dispatch_log:
        solo.nonce = rec.nonce0
        direct = solo.encode_encrypt_batch(
            np.concatenate([msgs[[rids.index(r) for r in rec.rids]],
                            np.zeros((rec.bucket - len(rec.rids),
                                      TINY.n_slots), complex)]))
        for i, r in enumerate(rec.rids):
            assert torch.equal(rows[rids.index(r)].c0, direct.c0[i])
            assert torch.equal(rows[rids.index(r)].c1, direct.c1[i])
