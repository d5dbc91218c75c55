"""The port's telemetry layer: labeled metrics, request-lifecycle spans,
Chrome-trace export, the warm-path odometer and the service wiring.

Mirrors ``tests/test_telemetry.py`` on the CPU. Three contracts:

  * **Reconciliation.** Every telemetry view of one window agrees: the
    ``fhe_jobs_total`` counter vs the scheduler dispatch log, the
    ``fhe_events_total`` counter vs ``EventLog.replay``, span stamps vs the
    dispatch records that launched them. ``reset_telemetry`` clears all
    of them TOGETHER.
  * **Boundedness.** The span ring, the live-span index and every metric's
    label-set map are hard-bounded; a 1k-request soak holds memory flat.
  * **No new work when warm, none from telemetry.** The reference pins
    jit re-lowerings; the port has no jit, so ``table_cache_entries``
    (table memos, nvcc compiles, per-device key copies) stays put on a
    warm path, and a disabled scope allocates no span, creates no series
    and launches nothing more.
"""

import json

import numpy as np
import pytest

from repro_torch.fhe_client.client import FHEClient
from repro_torch.fhe_client.service import (ClientService, ServiceTelemetry,
                                            lane_fingerprint)
from repro_torch.fhe_client.service.faults import EventLog
from repro_torch.kernels import ops
from repro_torch.telemetry import (DEFAULT_TIME_BUCKETS, OVERFLOW_LABEL,
                                   STAGES, MetricsRegistry, Span, Tracer,
                                   launches, spans_to_chrome_trace,
                                   table_cache_entries,
                                   validate_chrome_trace)


# ---------------------------------------------------------------------------
# metrics primitives (no jax, no service)
# ---------------------------------------------------------------------------


def test_counter_labels_and_snapshot():
    reg = MetricsRegistry()
    c = reg.counter("reqs", "requests", ("lane", "kind"))
    c.inc(lane="a", kind="enc")
    c.inc(2, lane="a", kind="enc")
    c.inc(lane="b", kind="dec")
    assert c.value(lane="a", kind="enc") == 3
    assert c.value(lane="b", kind="dec") == 1
    assert c.value(lane="never", kind="seen") == 0
    snap = reg.snapshot()["reqs"]
    assert snap["kind"] == "counter"
    assert {"labels": {"lane": "a", "kind": "enc"}, "value": 3.0} \
        in snap["series"]
    # registration is idempotent; a kind/label mismatch raises
    assert reg.counter("reqs", labelnames=("lane", "kind")) is c
    with pytest.raises(ValueError):
        reg.gauge("reqs", labelnames=("lane", "kind"))
    with pytest.raises(ValueError):
        reg.counter("reqs", labelnames=("other",))
    # recording with wrong label names raises
    with pytest.raises(ValueError):
        c.inc(lane="a")


def test_gauge_set_and_reset_window():
    reg = MetricsRegistry()
    g = reg.gauge("depth", labelnames=("q",))
    g.set(7, q="enc")
    g.inc(q="enc")
    assert g.value(q="enc") == 8
    reg.reset()
    assert g.value(q="enc") == 0           # series dropped...
    g.set(1, q="enc")                      # ...but the instrument survives
    assert reg.snapshot()["depth"]["series"][0]["value"] == 1.0


def test_label_cardinality_bound_folds_to_overflow():
    reg = MetricsRegistry()
    c = reg.counter("c", labelnames=("tenant",), max_series=4)
    for i in range(10):
        c.inc(tenant=f"t{i}")
    assert c.n_series() == 5               # 4 real + 1 overflow
    assert c.value(tenant=OVERFLOW_LABEL) == 6
    assert c.value(tenant="t1") == 1       # pre-bound series still live


def test_histogram_quantiles_and_exposition():
    reg = MetricsRegistry()
    h = reg.histogram("lat", labelnames=("stage",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in [0.0005] * 50 + [0.05] * 50:
        h.observe(v, stage="total")
    s = h.summary(stage="total")
    assert s["count"] == 100
    assert s["sum"] == pytest.approx(0.025 + 2.5)
    assert 0 < s["p50"] <= 0.001           # median inside the first bucket
    assert 0.01 < s["p99"] <= 0.1          # p99 inside the third
    assert h.summary(stage="empty")["count"] == 0
    # exposition: cumulative buckets, _sum/_count, TYPE lines
    text = reg.exposition()
    assert "# TYPE lat histogram" in text
    assert 'lat_bucket{stage="total",le="0.001"} 50' in text
    assert 'lat_bucket{stage="total",le="+Inf"} 100' in text
    assert 'lat_count{stage="total"} 100' in text
    # snapshot carries bounds + per-series counts for offline quantiles
    snap = reg.snapshot()["lat"]
    assert snap["bounds"] == [0.001, 0.01, 0.1, 1.0]
    assert sum(snap["series"][0]["counts"]) == 100


def test_default_time_buckets_cover_us_to_minutes():
    assert DEFAULT_TIME_BUCKETS[0] == 1e-6
    assert DEFAULT_TIME_BUCKETS[-1] == 60.0
    assert list(DEFAULT_TIME_BUCKETS) == sorted(DEFAULT_TIME_BUCKETS)


# ---------------------------------------------------------------------------
# tracer primitives
# ---------------------------------------------------------------------------


def _fake_span(rid, kind="enc", stream=0, t0=0.0):
    s = Span(rid, kind, "default")
    dt = 0.001
    for i, stage in enumerate(("submit", "admit", "coalesce", "launch",
                               "materialize", "demux")):
        s.mark(stage, t0 + i * dt)
    s.stream = stream
    return s


def test_tracer_ring_and_live_bounds():
    tr = Tracer(capacity=4, clock=lambda: 0.0)
    spans = [tr.begin(rid, "enc", "default") for rid in range(10)]
    assert tr.n_live() <= 4                # abandoned spans evicted
    for s in spans:
        if s is not None:
            tr.finish(s)
    assert len(tr) <= 4
    assert tr.dropped > 0
    assert [s.rid for s in tr.spans()] == [6, 7, 8, 9]   # newest kept
    tr.reset()
    assert len(tr) == 0 and tr.n_live() == 0 and tr.dropped == 0


def test_tracer_sampling_is_deterministic():
    tr = Tracer(capacity=64, sample_every=4)
    got = [tr.begin(rid, "enc", "default") for rid in range(16)]
    sampled = [rid for rid, s in enumerate(got) if s is not None]
    assert sampled == [0, 4, 8, 12]        # rid % k, replayable
    # disabled tracer never allocates
    off = Tracer(capacity=64, enabled=False)
    assert off.begin(0, "enc", "default") is None
    assert off.n_live() == 0


def test_mark_all_skips_unsampled():
    s = Span(0, "enc", "default")
    Tracer.mark_all([s, None, None], "launch", 1.5, stream=3, round=7)
    assert s.t("launch") == 1.5 and s.stream == 3 and s.round == 7
    # retries re-stamp: t() returns the LAST stamp
    s.mark("launch", 2.5)
    assert s.t("launch") == 2.5
    assert s.t("materialize") is None
    assert set(STAGES) >= set(s.stages())


def test_chrome_trace_schema_and_track_monotonicity():
    # two streams + coalesced jobs sharing exact timestamps (tie nudge)
    spans = [_fake_span(i, kind="enc" if i % 2 else "dec",
                        stream=i % 2, t0=float(i // 4)) for i in range(8)]
    trace = spans_to_chrome_trace(spans)
    n = validate_chrome_trace(trace)
    assert n == 4 * len(spans)             # queued/dispatch/execute/demux
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "M"}
    assert "process_name" in names and "thread_name" in names
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e["name"] == "thread_name"}
    assert {"queue:enc", "queue:dec", "stream 0", "stream 1"} <= tracks
    # the validator actually rejects out-of-order tracks
    bad = {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 0, "tid": 1, "ts": 2.0, "dur": 1.0},
        {"name": "b", "ph": "X", "pid": 0, "tid": 1, "ts": 2.0, "dur": 1.0},
    ]}
    with pytest.raises(ValueError, match="strictly increasing"):
        validate_chrome_trace(bad)
    with pytest.raises(ValueError, match="dur"):
        validate_chrome_trace({"traceEvents": [
            {"name": "a", "ph": "X", "pid": 0, "tid": 1, "ts": 0.0}]})


def test_event_sink_folds_into_counters():
    tele = ServiceTelemetry(trace_capacity=8)
    log = EventLog(sink=tele.event_sink)
    log.record("full_fire")
    log.record("reject")
    log.record("reject")
    assert tele.events.value(kind="reject") == 2
    assert tele.events.value(kind="full_fire") == 1
    assert len(log.replay("reject")) == 2   # the log itself still records


def test_lane_fingerprint_never_leaks_tenant_id():
    from repro_torch.core.context import PROFILES
    p = PROFILES["tiny"]
    assert lane_fingerprint(None) == "default"
    fp = lane_fingerprint(("alice-tenant-42", p))
    assert len(fp) == 12 and int(fp, 16) >= 0      # short hex digest
    assert "alice" not in fp and "42" != fp
    assert fp != lane_fingerprint(("bob", p))      # distinct per tenant
    assert fp == lane_fingerprint(("alice-tenant-42", p))   # stable


# ---------------------------------------------------------------------------
# service integration (tiny profile, module-scoped client)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tele_client():
    return FHEClient("tiny", device="cpu")


def _msgs(client, b, seed=0):
    rng = np.random.default_rng(seed)
    n = client.ctx.params.n_slots
    return (rng.standard_normal((b, n))
            + 1j * rng.standard_normal((b, n))) * 0.5


def _run_mix(svc, client, n_enc=6, n_dec=2, seed=0):
    """Closed-loop mixed pass; returns the rids (results consumed)."""
    msgs = _msgs(client, n_enc, seed)
    rids = [svc.submit_encrypt(m) for m in msgs]
    svc.flush()
    cts = [svc.result(r) for r in rids]
    dec_rids = [svc.submit_decrypt(ct) for ct in cts[:n_dec]]
    svc.flush()
    for r in dec_rids:
        svc.result(r)
    return rids + dec_rids


def test_span_tree_replays_dispatch_log(tele_client):
    svc = ClientService(client=tele_client, buckets=(2,), max_wait_s=0.05)
    rids = _run_mix(svc, tele_client)
    spans = {s.rid: s for s in svc.telemetry.tracer.spans()}
    assert set(spans) == set(rids)          # sample_every=1: all present
    # index dispatch records by rid for stamp cross-checks
    rec_by_rid = {}
    for rec in svc.dispatch_log:
        for rid in rec.rids:
            rec_by_rid[rid] = rec
    for rid in rids:
        s = spans[rid]
        # the lifecycle chain is connected and causally ordered
        stages = ["submit", "admit", "coalesce", "launch", "materialize",
                  "demux", "result"]
        if s.kind == "enc":
            stages.insert(3, "lease")
        ts = [s.t(stage) for stage in stages]
        assert None not in ts, f"rid {rid} missing stages: {s.stages()}"
        assert ts == sorted(ts), f"rid {rid} stamps out of order: {ts}"
        # routing metadata replays the dispatch record that launched it
        rec = rec_by_rid[rid]
        assert s.stream == rec.stream
        assert s.round == rec.round
        assert s.kind == rec.kind
        assert s.t("launch") == pytest.approx(rec.t_launch)
        assert s.lane == "default"
    # the event counter replays the event log, kind by kind
    for kind in set(svc.events.kinds()):
        assert svc.telemetry.events.value(kind=kind) == \
            len(svc.events.replay(kind))


def test_jobs_counter_agrees_with_dispatch_log(tele_client):
    """The by_stream window fix: counter totals and dispatch-log totals
    are windowed TOGETHER, so they agree before and after a reset."""
    svc = ClientService(client=tele_client, buckets=(2,), max_wait_s=0.05)
    jobs = svc.telemetry.jobs

    def counter_by_stream():
        out = {}
        for (stream, _kind), v in jobs.series().items():
            out[int(stream)] = out.get(int(stream), 0) + int(v)
        return out

    _run_mix(svc, tele_client)
    st = svc.stats()
    by_stream = counter_by_stream()
    assert sum(by_stream.values()) == st["jobs_dispatched"] \
        == len(svc.dispatch_log)
    assert by_stream == st["jobs_by_stream"]

    svc.reset_telemetry()                  # one window boundary for BOTH
    assert len(svc.dispatch_log) == 0
    assert sum(counter_by_stream().values()) == 0
    assert svc.stats()["jobs_by_stream"] == {}

    _run_mix(svc, tele_client, seed=1)     # agreement holds in window 2
    st = svc.stats()
    by_stream = counter_by_stream()
    assert sum(by_stream.values()) == st["jobs_dispatched"] \
        == len(svc.dispatch_log)
    assert by_stream == st["jobs_by_stream"]


def test_stats_keys_backward_compatible_plus_stages(tele_client):
    svc = ClientService(client=tele_client, buckets=(2,), max_wait_s=0.05)
    rids = _run_mix(svc, tele_client)
    st = svc.stats()
    for key in ("lanes", "tenants", "n_streams", "alive_streams",
                "shards_per_stream", "buckets", "jobs_dispatched",
                "rounds", "jobs_by_stream", "modes", "running", "queued",
                "inflight", "completed", "failed_requests", "retries",
                "events", "stages", "telemetry"):
        assert key in st, key
    # histograms observe EVERY request (sampling only affects spans)
    for stage in ("queue_wait", "dispatch", "execute", "total"):
        assert st["stages"][stage]["count"] == len(rids)
        assert st["stages"][stage]["p50_s"] <= st["stages"][stage]["p99_s"]
    assert st["telemetry"]["enabled"]
    assert st["completed"] == len(rids)


def test_reset_window_vs_lifetime(tele_client):
    svc = ClientService(client=tele_client, buckets=(2,), max_wait_s=0.05)
    rids = _run_mix(svc, tele_client)
    svc.reset_telemetry()
    st = svc.stats()
    assert st["completed"] == len(rids)    # lifetime survives
    assert st["jobs_dispatched"] == 0      # window restarts
    assert st["events"] == 0
    assert st["stages"]["total"]["count"] == 0
    assert len(svc.telemetry.tracer) == 0
    with pytest.raises(KeyError):
        svc.latency(rids[0])               # latencies are windowed


def test_trace_export_round_trips(tele_client, tmp_path):
    svc = ClientService(client=tele_client, buckets=(2,), max_wait_s=0.05)
    rids = _run_mix(svc, tele_client)
    path = tmp_path / "trace.json"
    svc.export_trace(path)
    with open(path) as f:
        trace = json.load(f)               # valid JSON on disk
    assert validate_chrome_trace(trace) > 0
    rids_in_trace = {e["args"]["rid"] for e in trace["traceEvents"]
                     if e["ph"] == "X" and "rid" in e.get("args", {})}
    assert rids_in_trace == set(rids)
    assert trace["otherData"]["format"].startswith("fhe-client-service")


def test_telemetry_snapshot_is_jsonable_and_complete(tele_client):
    svc = ClientService(client=tele_client, buckets=(2,), max_wait_s=0.05)
    _run_mix(svc, tele_client)
    snap = svc.telemetry_snapshot()
    json.dumps(snap)                       # CI artifact format
    assert snap["enabled"]
    assert "fhe_stage_seconds" in snap["metrics"]
    assert "fhe_requests_total" in snap["metrics"]
    # the six bounded memos all report hit/miss/eviction counters
    for name in ("plan_consts", "stacked_kernel_consts", "server_consts",
                 "stacked_plans", "contexts", "ntt_plans", "ntt_primes"):
        assert {"size", "capacity", "hits", "misses",
                "evictions"} <= set(snap["caches"][name]), name
    assert snap["caches"]["plan_consts"]["hits"] > 0   # warm path hit it
    assert snap["registry"]["leases_granted"] > 0
    assert snap["fhe_table_cache_entries"] > 0
    assert "fhe_jit_cache_entries" not in snap
    # Prometheus exposition renders every registered metric
    text = svc.telemetry.exposition()
    assert "# TYPE fhe_stage_seconds histogram" in text
    assert "fhe_requests_total{" in text


def test_table_cache_probe_warm_path_stable(tele_client):
    """The shared warm-path odometer: a replayed warm workload leaves the
    table-cache entry count (table memos + nvcc compiles + per-device key
    copies) unchanged."""
    svc = ClientService(client=tele_client, buckets=(2,), max_wait_s=0.05)
    _run_mix(svc, tele_client)             # warm every (kind, bucket)
    warm = table_cache_entries(svc.lane_clients())
    assert warm > 0
    _run_mix(svc, tele_client, seed=3)     # same shapes, new data
    assert table_cache_entries(svc.lane_clients()) == warm
    # a new device for the client's keys is new work the odometer sees
    svc2 = ClientService(client=tele_client, buckets=(2,),
                         devices=["cpu", "meta"], n_streams=2)
    assert table_cache_entries(svc2.lane_clients()) == warm + 1


def test_launch_counts_exported_by_kernel(tele_client):
    """``telemetry.launches`` is ``ops.launches``: every CUDA wrapper's
    count by kernel; on the CPU the plain versions count nothing."""
    ops.reset_launches()
    svc = ClientService(client=tele_client, buckets=(2,), max_wait_s=0.05)
    _run_mix(svc, tele_client)
    counts = launches()
    assert counts == ops.launches()
    assert {"encode_encrypt_stream", "decrypt_decode_stream"} <= set(counts)
    assert not any(counts.values())


def test_disabled_overhead_pin(tele_client):
    """telemetry=False: no added build work, no spans, no metric series —
    and identical launch behavior to an enabled service over the same warm
    client."""
    svc_on = ClientService(client=tele_client, buckets=(2,),
                           max_wait_s=0.05)
    _run_mix(svc_on, tele_client)          # warm (fills the table memos)
    warm = table_cache_entries([tele_client])
    ops.reset_launches()
    _run_mix(svc_on, tele_client, seed=5)
    launches_enabled = ops.launches()

    svc_off = ClientService(client=tele_client, buckets=(2,),
                            max_wait_s=0.05, telemetry=False)
    ops.reset_launches()
    _run_mix(svc_off, tele_client, seed=5)
    # telemetry (on or off) adds no build work and no launch
    assert ops.launches() == launches_enabled
    assert table_cache_entries([tele_client]) == warm
    assert not svc_off.telemetry.enabled
    assert len(svc_off.telemetry.tracer) == 0
    assert svc_off.telemetry.tracer.n_live() == 0
    for m in svc_off.telemetry.metrics.metrics():
        assert m.n_series() == 0, m.name
    assert svc_off.stats()["stages"] == {}
    assert svc_off.telemetry_snapshot()["metrics"]\
        ["fhe_requests_total"]["series"] == []


def test_soak_bounded_memory(tele_client):
    """1k requests through a small trace ring: spans, live index and
    latency dict stay bounded; every result still correct-ish (decode
    round-trip is covered elsewhere — here we pin accounting)."""
    svc = ClientService(client=tele_client, buckets=(4,), max_wait_s=0.05,
                        trace_capacity=32)
    n, chunk = 1000, 100
    msgs = _msgs(tele_client, chunk, seed=9)
    done = 0
    for i in range(n // chunk):
        rids = [svc.submit_encrypt(msgs[j]) for j in range(chunk)]
        svc.flush()
        for r in rids:
            svc.result(r)
        done += len(rids)
        if i == 4:
            svc.reset_telemetry()          # a mid-soak window boundary
    assert done == n
    tr = svc.telemetry.tracer
    assert len(tr) <= 32 and tr.n_live() <= 32
    assert tr.dropped > 0                  # the ring actually wrapped
    # label cardinality stays tiny: one lane, one kind, fixed stages
    for m in svc.telemetry.metrics.metrics():
        assert m.n_series() <= 10, m.name
    # windowed structures reflect only the post-reset half
    st = svc.stats()
    assert st["completed"] == n            # lifetime
    assert st["stages"]["total"]["count"] == n // 2   # window
    assert len(svc._latencies) == n // 2
    # trace still exports cleanly after wrapping
    assert validate_chrome_trace(svc.telemetry.chrome_trace()) > 0


def test_sampled_tracing_histograms_see_everything(tele_client):
    """sample_every=4: only every 4th rid gets a span, but histograms
    and counters still observe every request."""
    svc = ClientService(client=tele_client, buckets=(2,), max_wait_s=0.05,
                        trace_sample_every=4)
    rids = _run_mix(svc, tele_client)
    sampled = {s.rid for s in svc.telemetry.tracer.spans()}
    assert sampled == {r for r in rids if r % 4 == 0}
    assert svc.stats()["stages"]["total"]["count"] == len(rids)
