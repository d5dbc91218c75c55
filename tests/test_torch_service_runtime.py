"""The port's always-on client service on the CPU: deadline firing,
bounded-queue backpressure, and the fault-injected failure story.

Mirrors ``tests/test_service_runtime.py``. The contract under test:
whatever faults, retries, deadlines or padding a request rides through,
its result is bit-identical to the port's direct batched client from the
same nonce base (the job's nonce-range lease travels with it onto
surviving streams), and the structured event log replays exactly the
recovery that happened. Fault-recovery tests run two OVERSUBSCRIBED
logical streams on the client's one CPU device. ``start()`` first launches
every (kind, bucket) shape once (``warm_up``, leasing its own nonces), so
a test that pins a nonce base warms the service before reading the base.
The soak is short (Poisson arrivals, 24 requests, a mid-run stream kill).
Tolerance: 0.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.fhe_client.client import FHEClient
from repro_torch.fhe_client.service import (ClientService, FaultInjector,
                                            FaultSpec, QueueFull,
                                            RequestFailed)
from repro_torch.fhe_client.service.batcher import now


def _msgs(client, b, seed=0):
    rng = np.random.default_rng(seed)
    n = client.ctx.params.n_slots
    return (rng.standard_normal((b, n))
            + 1j * rng.standard_normal((b, n))) * 0.5


@pytest.fixture(scope="module")
def rt_client():
    return FHEClient("tiny", device="cpu")


@pytest.fixture(scope="module")
def twin():
    """Same seed as ``rt_client``: the direct path from a pinned base."""
    return FHEClient("tiny", device="cpu")


def _direct(client, msgs):
    """The direct batched ciphertexts of ``msgs`` from ``client``'s next
    nonce, without advancing its counter (a same-seed client computes
    them)."""
    ref = FHEClient("tiny", seed=client.seed, device="cpu")
    ref.nonce = client.nonce
    return ref.encode_encrypt_batch(msgs)


def _assert_rows(rows, direct):
    for i, row in enumerate(rows):
        assert torch.equal(row.c0, direct.c0[i])
        assert torch.equal(row.c1, direct.c1[i])


def test_monotonic_timestamps(monkeypatch):
    """Deadline math must survive wall-clock jumps: the service clock is
    time.monotonic, never time.time."""
    import time as time_mod

    def boom():
        raise AssertionError("service timestamps must not read time.time")

    monkeypatch.setattr(time_mod, "time", boom)
    t0 = now()
    assert now() >= t0


# ---------------------------------------------------------------------------
# always-on lifecycle + deadline firing
# ---------------------------------------------------------------------------


def _wait_until(pred, timeout=20.0, interval=0.002):
    deadline = now() + timeout
    while not pred():
        if now() > deadline:
            raise TimeoutError("condition not met in time")
        threading.Event().wait(interval)


def test_always_on_deadline_fire_bit_identical(rt_client):
    """3 messages into a started service (buckets=(2,)): the full bucket
    fires immediately, the partial tail fires on its max-wait deadline —
    and both are bit-identical to one direct B=3 call from the same nonce
    base. result() blocks until the loop completes them (no flush)."""
    cl = rt_client
    msgs = _msgs(cl, 3, seed=21)
    svc = ClientService(client=cl, buckets=(2,), max_wait_s=0.05)
    svc.warm_up()                        # start() warms; its nonces first
    direct = _direct(cl, msgs)
    with svc:
        assert svc.running
        rids = [svc.submit_encrypt(m) for m in msgs]
        rows = [svc.result(r, timeout=60.0) for r in rids]
    assert not svc.running
    _assert_rows(rows, direct)
    kinds = svc.events.kinds()
    assert "full_fire" in kinds          # the (r0, r1) bucket
    assert "deadline_fire" in kinds      # the padded r2 tail
    (ev,) = svc.events.replay("deadline_fire")
    assert ev.rids == (rids[2],)


def test_always_on_admits_while_in_flight_and_drains(rt_client):
    """Submissions keep landing while earlier rounds execute; stop(drain)
    completes everything."""
    cl = rt_client
    svc = ClientService(client=cl, buckets=(2,), max_wait_s=0.002)
    with svc:
        rids = []
        for wave in range(3):            # successive waves, no flush between
            rids += [svc.submit_encrypt(m)
                     for m in _msgs(cl, 2, seed=30 + wave)]
        _wait_until(lambda: all(svc.done(r) for r in rids))
        st = svc.stats()
        assert st["completed"] == len(rids) and st["failed_requests"] == 0
        for r in rids:
            assert svc.peek(r) is not None      # non-consuming
        for r in rids:
            svc.result(r)


def test_stop_without_drain_fails_queued(rt_client):
    cl = rt_client
    svc = ClientService(client=cl, buckets=(4,), max_wait_s=120.0)
    svc.start()
    rid = svc.submit_encrypt(_msgs(cl, 1, seed=40)[0])   # partial: waits
    svc.stop(drain=False)
    with pytest.raises(RequestFailed, match="stopped before dispatch"):
        svc.result(rid)


def test_loop_crash_is_contained_and_surfaced(rt_client):
    """A dispatch-thread crash never loses requests silently: queued rids
    fail, a loop_error event is recorded, and the next call re-raises."""
    cl = rt_client
    svc = ClientService(client=cl, buckets=(2,), max_wait_s=0.002)

    def explode(*a, **k):
        raise RuntimeError("synthetic dispatch bug")

    svc.scheduler.dispatch = explode
    svc.start()
    rid = svc.submit_encrypt(_msgs(cl, 1, seed=41)[0])
    _wait_until(lambda: svc._loop.crashed is not None)
    assert "loop_error" in svc.events.kinds()
    with pytest.raises((RequestFailed, RuntimeError)):
        svc.result(rid, timeout=5.0)
    with pytest.raises(RuntimeError, match="dispatch loop crashed"):
        svc.submit_encrypt(_msgs(cl, 1, seed=42)[0])
    svc._loop = None                     # crashed loop: nothing to join


# ---------------------------------------------------------------------------
# bounded queues + backpressure
# ---------------------------------------------------------------------------


def test_backpressure_reject(rt_client):
    cl = rt_client
    svc = ClientService(client=cl, buckets=(4,), queue_capacity=2,
                        backpressure="reject")
    m = _msgs(cl, 1, seed=50)[0]
    svc.submit_encrypt(m)
    svc.submit_encrypt(m)
    with pytest.raises(QueueFull, match="capacity 2"):
        svc.submit_encrypt(m)
    assert "reject" in svc.events.kinds()
    # capacity is per kind: the dec queue still admits
    ct = cl.encode_encrypt_batch(_msgs(cl, 1, seed=51)).truncated(2)[0]
    svc.submit_decrypt(ct)
    svc.flush()


def test_backpressure_block_times_out(rt_client):
    cl = rt_client
    svc = ClientService(client=cl, buckets=(4,), queue_capacity=1,
                        backpressure="block", submit_timeout_s=0.05,
                        fire_mode="full")    # partial bucket: never fires
    m = _msgs(cl, 1, seed=52)[0]
    # closed-loop (not running): blocking would deadlock — nothing can
    # drain the queue — so a full queue raises without waiting
    svc.submit_encrypt(m)
    t0 = now()
    with pytest.raises(QueueFull):
        svc.submit_encrypt(m)
    assert now() - t0 < 0.05
    svc.flush()
    # always-on but unable to fire: the submit blocks its full timeout
    svc.start()
    try:
        svc.submit_encrypt(m)
        t0 = now()
        with pytest.raises(QueueFull, match="after blocking"):
            svc.submit_encrypt(m)
        assert now() - t0 >= 0.04
    finally:
        svc.stop(drain=True)             # drain overrides 'full': completes
    assert svc.stats()["failed_requests"] == 0


def test_backpressure_block_unblocks_when_loop_drains(rt_client):
    """In always-on mode a blocked submit completes once the loop frees
    queue space — backpressure, not deadlock."""
    cl = rt_client
    svc = ClientService(client=cl, buckets=(1,), queue_capacity=1,
                        backpressure="block", submit_timeout_s=30.0,
                        max_wait_s=0.001)
    with svc:
        rids = [svc.submit_encrypt(m) for m in _msgs(cl, 6, seed=53)]
        for r in rids:
            svc.result(r, timeout=60.0)
    assert svc.stats()["failed_requests"] == 0


def test_bad_constructor_args(rt_client):
    with pytest.raises(ValueError, match="backpressure"):
        ClientService(client=rt_client, backpressure="drop")
    with pytest.raises(ValueError, match="fire_mode"):
        ClientService(client=rt_client, fire_mode="sometimes")


# ---------------------------------------------------------------------------
# result retrieval semantics
# ---------------------------------------------------------------------------


def test_peek_done_and_consumed_semantics(rt_client):
    cl = rt_client
    svc = ClientService(client=cl, buckets=(2,))
    rid = svc.submit_encrypt(_msgs(cl, 1, seed=60)[0])
    assert svc.done(rid) is False
    with pytest.raises(KeyError, match="still pending"):
        svc.peek(rid)
    with pytest.raises(KeyError, match="unknown request id"):
        svc.done(rid + 999)
    svc.flush()
    assert svc.done(rid) is True
    row = svc.peek(rid)                  # non-consuming: repeatable
    assert torch.equal(svc.peek(rid).c0, row.c0)
    svc.result(rid)                      # consumes
    assert svc.done(rid) is True         # completed-and-consumed is done
    with pytest.raises(KeyError, match="already retrieved"):
        svc.peek(rid)
    with pytest.raises(KeyError, match="unknown request id"):
        svc.peek(rid + 999)


def test_submit_decrypt_validation(rt_client):
    cl = rt_client
    n = cl.ctx.params.n
    svc = ClientService(client=cl, buckets=(2,))
    good0 = np.zeros((2, n), np.uint32)
    with pytest.raises(ValueError, match="Ciphertext or a"):
        svc.submit_decrypt(object())
    with pytest.raises(ValueError, match="limb stack"):
        svc.submit_decrypt((good0[:1], good0[:1], 1.0))        # 1 limb
    with pytest.raises(ValueError, match="ring degree"):
        svc.submit_decrypt((good0[:, : n // 2],
                            good0[:, : n // 2], 1.0))          # wrong N
    with pytest.raises(ValueError, match="limb counts differ"):
        svc.submit_decrypt((good0, np.zeros((3, n), np.uint32), 1.0))
    with pytest.raises(ValueError, match="scale"):
        svc.submit_decrypt((good0, good0, -1.0))
    with pytest.raises(ValueError, match="scale"):
        svc.submit_decrypt((good0, good0, float("nan")))
    with pytest.raises(TypeError, match="uint32"):
        svc.submit_decrypt((good0.astype(np.float64), good0, 1.0))
    with pytest.raises(ValueError, match="Ciphertext or a"):
        svc.submit_decrypt((good0, good0))
    assert svc.pending() == {"enc": 0, "dec": 0}   # nothing was admitted


# ---------------------------------------------------------------------------
# fault injection: stream death, bounded retry, bit-identity
# ---------------------------------------------------------------------------


def test_launch_fault_recovers_bit_identical(rt_client):
    """ACCEPTANCE: a FaultInjector kills stream 1 mid-round; every request
    still completes, bit-identical to the direct batched path from the
    same nonce base, and the event log replays the recovery."""
    cl = rt_client
    msgs = _msgs(cl, 5, seed=70)
    base = cl.nonce
    direct = cl.encode_encrypt_batch(msgs)
    cl.nonce = base

    svc = ClientService(client=cl, buckets=(2,), n_streams=2,
                        oversubscribe=True,
                        faults=FaultInjector.kill_stream(1, after=0))
    cts = svc.encrypt_many(msgs)         # 3 jobs over 2 streams, one dies
    assert torch.equal(cts.c0, direct.c0) and torch.equal(cts.c1, direct.c1)

    kinds = svc.events.kinds()
    # the recovery replays in order: the job bounced off the dying stream,
    # the stream was declared dead, the fleet degraded to one stream
    assert kinds.index("requeue") < kinds.index("stream_failed") \
        < kinds.index("degraded")
    (failed,) = svc.events.replay("stream_failed")
    assert failed.stream == 1
    assert svc.scheduler.alive_streams == [0]
    assert svc.stats()["failed_requests"] == 0
    # every launch that actually ran (the log) went to the survivor
    assert {r.stream for r in svc.dispatch_log} == {0}


def test_materialize_fault_retries_bit_identical(rt_client):
    """A result_error after a 'successful' launch (the async-dispatch
    failure shape): the job retries on the survivor under the SAME nonce
    lease, so the retried ciphertexts are bit-identical."""
    cl = rt_client
    msgs = _msgs(cl, 4, seed=71)
    base = cl.nonce
    direct = cl.encode_encrypt_batch(msgs)
    cl.nonce = base

    faults = FaultInjector([FaultSpec(stream=0, kind="result_error",
                                      after=0, count=1)])
    svc = ClientService(client=cl, buckets=(2,), n_streams=2,
                        oversubscribe=True, faults=faults)
    cts = svc.encrypt_many(msgs)
    assert torch.equal(cts.c0, direct.c0) and torch.equal(cts.c1, direct.c1)
    assert faults.fired() == 1
    (ok,) = svc.events.replay("retry_ok")
    assert ok.attempt == 1
    # the retry appears in the dispatch log as attempt=1 on a survivor
    retried = [r for r in svc.dispatch_log if r.attempt == 1]
    assert len(retried) == 1 and retried[0].stream == 1
    assert svc.stats()["retries"] == 1


def test_always_on_survives_stream_death(rt_client):
    """The full tentpole path at once: always-on loop + deadline firing +
    a stream killed mid-run; everything completes on the survivor."""
    cl = rt_client
    msgs = _msgs(cl, 6, seed=72)
    svc = ClientService(client=cl, buckets=(2,), n_streams=2,
                        oversubscribe=True, max_wait_s=0.05,
                        faults=FaultInjector.kill_stream(0, after=1))
    svc.warm_up()                        # bypasses the fault seams
    direct = _direct(cl, msgs)
    with svc:
        rids = [svc.submit_encrypt(m) for m in msgs]
        rows = [svc.result(r, timeout=60.0) for r in rids]
    _assert_rows(rows, direct)
    assert "stream_failed" in svc.events.kinds()
    assert svc.scheduler.alive_streams == [1]
    assert svc.stats()["failed_requests"] == 0


def test_all_streams_dead_fails_requests_loudly(rt_client):
    cl = rt_client
    faults = FaultInjector([FaultSpec(stream=None, kind="error",
                                      after=0, count=None)])
    svc = ClientService(client=cl, buckets=(2,), n_streams=2,
                        oversubscribe=True, faults=faults, max_retries=1)
    rid = svc.submit_encrypt(_msgs(cl, 1, seed=73)[0])
    svc.flush()
    with pytest.raises(RequestFailed) as exc:
        svc.result(rid)
    assert exc.value.rid == rid
    assert svc.scheduler.n_alive == 0
    assert "request_failed" in svc.events.kinds()
    # a dead fleet keeps failing fast instead of hanging
    rid2 = svc.submit_encrypt(_msgs(cl, 1, seed=74)[0])
    svc.flush()
    with pytest.raises(RequestFailed):
        svc.result(rid2)


def test_job_timeout_isolates_slow_stream(rt_client):
    """A stream returning correct-but-late results is isolated (never the
    last one) so later jobs avoid it."""
    cl = rt_client
    faults = FaultInjector([FaultSpec(stream=0, kind="delay", after=0,
                                      count=None, delay_s=0.05)])
    svc = ClientService(client=cl, buckets=(2,), n_streams=2,
                        oversubscribe=True, faults=faults,
                        job_timeout_s=0.01)
    cts = svc.encrypt_many(_msgs(cl, 4, seed=75))
    assert cts.c0.shape[0] == 4          # slow results still land
    assert svc.scheduler.alive_streams == [1]
    (ev,) = svc.events.replay("stream_failed")
    assert "timeout" in ev.detail
    # degraded to the last stream: it is never killed, however slow
    svc.encrypt_many(_msgs(cl, 2, seed=76))
    assert svc.scheduler.n_alive == 1




def test_warm_up_leases_its_nonces_and_builds_nothing_later(rt_client):
    """``start()`` launches every (kind, bucket) shape once per stream
    before the loop runs; its encrypts lease no nonce (neither the
    client's counter nor the ledger moves: the first job leases the base
    the reference service, which has no warm-up, would), and a second
    start warms nothing."""
    from repro_torch.telemetry import table_cache_entries
    cl = rt_client
    svc = ClientService(client=cl, buckets=(1, 2), n_streams=2,
                        oversubscribe=True, max_wait_s=0.002)
    base = cl.nonce
    watermark = svc.registry.ledger.watermark(cl.seed)
    with svc:
        pass
    assert cl.nonce == base
    assert svc.registry.ledger.watermark(cl.seed) == watermark
    warm = table_cache_entries(svc.lane_clients())
    assert svc.warm_up() == 0
    with svc:
        rids = [svc.submit_encrypt(m) for m in _msgs(cl, 3, seed=80)]
        for r in rids:
            svc.result(r, timeout=60.0)
    assert table_cache_entries(svc.lane_clients()) == warm
    assert svc.stats()["jobs_dispatched"] == 2     # warm-up is not logged
    assert svc.dispatch_log[0].nonce0 == base


def test_poisson_soak_under_faults(rt_client):
    """Open-loop Poisson arrivals against the always-on engine with a
    mid-run stream kill: every request completes bit-identical to the
    direct path and round-trips through decrypt within CKKS tolerance."""
    import time

    cl = rt_client
    rng = np.random.default_rng(7)
    n_req = 24
    msgs = _msgs(cl, n_req, seed=77)
    svc = ClientService(client=cl, buckets=(1, 2, 4), n_streams=2,
                        oversubscribe=True, max_wait_s=0.003,
                        faults=FaultInjector.kill_stream(0, after=3))
    svc.warm_up()
    base = cl.nonce
    with svc:
        rids = []
        for m in msgs:
            time.sleep(float(rng.exponential(0.002)))
            rids.append(svc.submit_encrypt(m))
        rows = [svc.result(r, timeout=120.0) for r in rids]
    assert svc.stats()["failed_requests"] == 0
    assert "stream_failed" in svc.events.kinds()
    # each row == the direct path from its own job's nonce base (a retried
    # job keeps its lease: every record of it carries the same base)
    ref = FHEClient("tiny", seed=cl.seed, device="cpu")
    bases = {}
    for rec in svc.dispatch_log:
        assert bases.setdefault(rec.rids, rec.nonce0) == rec.nonce0
        assert rec.nonce0 >= base
    assert sorted(r for rids in bases for r in rids) == sorted(rids)
    index = {rid: i for i, rid in enumerate(rids)}
    for job_rids, nonce0 in bases.items():
        ref.nonce = nonce0
        direct = ref.encode_encrypt_batch(msgs[[index[r] for r in job_rids]])
        _assert_rows([rows[index[r]] for r in job_rids], direct)
    dec = ClientService(client=cl, buckets=(4,))
    out = dec.decrypt_many([(r.c0[:2], r.c1[:2], r.scale) for r in rows])
    assert np.max(np.abs(out - msgs)) < 1e-3
