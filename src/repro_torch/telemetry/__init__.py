"""Unified telemetry layer: labeled metrics, request-lifecycle tracing,
Chrome-trace export, and the warm-path table-cache probe.

Port of ``repro.telemetry`` (no framework code, a near-copy): the
snapshot gauge ``fhe_jit_cache_entries`` is ``fhe_table_cache_entries``
here (``probe.table_cache_entries``: the port has no jit); every other
key is the reference's.

The paper's headline numbers are latency claims; reproducing them needs
per-stage accounting, not aggregate speedups ("Does FHE Need Compute
Acceleration?" makes exactly this methodological point). This package is
the one observability surface the serving stack records into:

  * ``telemetry.metrics``  — labeled counters/gauges/fixed-bucket
    histograms with lock-cheap recording, JSON snapshots and Prometheus
    text exposition (bounded label cardinality, fingerprint-only labels);
  * ``telemetry.tracing``  — per-request span contexts stamped at every
    lifecycle stage (submit -> admit -> coalesce -> lease -> launch ->
    materialize -> demux -> result), a bounded completed-span ring, and
    Chrome trace-event JSON export (one track per stream + queue tracks);
  * ``telemetry.probe``    — the table-cache odometer (table memos, nvcc
    compiles) shared by the tests and the metrics snapshot, and the
    kernels' launch counts;
  * ``ServiceTelemetry``   — the per-service bundle of all three, with
    the stage hooks ``ClientService``/``DualStreamScheduler`` call.

Privacy contract (DESIGN.md §8): telemetry records stage names, stream
indices, request ids, durations and lane fingerprints. It NEVER records
message plaintext, ciphertext contents, key material, or seeds.
"""

from __future__ import annotations

import json
import time

from repro_torch.telemetry import metrics, probe, tracing
from repro_torch.telemetry.metrics import (Counter, DEFAULT_TIME_BUCKETS,
                                           Gauge, Histogram, MetricsRegistry,
                                           OVERFLOW_LABEL)
from repro_torch.telemetry.probe import launches, table_cache_entries
from repro_torch.telemetry.tracing import (STAGES, Span, Tracer,
                                           spans_to_chrome_trace,
                                           validate_chrome_trace)

# interval stages the per-stage latency histogram records, as
# (name, from-stamp, to-stamp); "total" is the submit->materialized
# latency ``ClientService.latency`` also reports
STAGE_INTERVALS = (
    ("queue_wait", "submit", "coalesce"),
    ("dispatch", "coalesce", "launch"),
    ("execute", "launch", "materialize"),
    ("total", "submit", "demux"),
)

STAGE_NAMES = tuple(name for name, _a, _b in STAGE_INTERVALS)


class ServiceTelemetry:
    """One service's telemetry scope: a metrics registry + a span tracer
    behind the stage hooks the service layers call.

    ``enabled=False`` is the near-zero-cost path: every hook returns
    after one boolean check, no span is ever allocated, no metric series
    ever created (pinned by the disabled-overhead test). Enabled is the
    service default; span SAMPLING (``sample_every``) bounds tracing cost
    under load while the histograms still see every request.
    """

    def __init__(self, enabled: bool = True, trace_capacity: int = 4096,
                 sample_every: int = 1, clock=time.monotonic):
        self.enabled = enabled
        self.clock = clock
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(capacity=trace_capacity,
                             sample_every=sample_every, clock=clock,
                             enabled=enabled)
        m = self.metrics
        self.requests = m.counter(
            "fhe_requests_total", "requests admitted", ("lane", "kind"))
        self.completed = m.counter(
            "fhe_requests_completed_total", "requests completed",
            ("lane", "kind"))
        self.failed = m.counter(
            "fhe_requests_failed_total",
            "requests failed after exhausting retries", ("lane", "kind"))
        self.rejects = m.counter(
            "fhe_rejects_total", "submits bounced by backpressure",
            ("lane", "kind"))
        self.queue_depth = m.gauge(
            "fhe_queue_depth", "queued requests per lane queue",
            ("lane", "kind"))
        self.jobs = m.counter(
            "fhe_jobs_total", "batch jobs launched", ("stream", "kind"))
        self.rounds = m.counter(
            "fhe_rounds_total", "scheduler rounds by mode", ("mode",))
        self.events = m.counter(
            "fhe_events_total",
            "service events by kind (EventLog sink: stream deaths, "
            "requeues, retries, fires, rejects, loop errors)", ("kind",))
        self.stage_seconds = m.histogram(
            "fhe_stage_seconds", "per-stage request latency",
            ("stage", "kind"))

    # -- submission ----------------------------------------------------------

    def on_submit(self, rid: int, kind: str, lane: str, t: float):
        """Span (or None) for a newly admitted request."""
        if not self.enabled:
            return None
        return self.tracer.begin(rid, kind, lane, t=t)

    def on_admit(self, span, lane: str, kind: str, depth: int,
                 t: float) -> None:
        if not self.enabled:
            return
        if span is not None:
            span.mark("admit", t)
        self.requests.inc(lane=lane, kind=kind)
        self.queue_depth.set(depth, lane=lane, kind=kind)

    def on_reject(self, lane: str, kind: str) -> None:
        if not self.enabled:
            return
        self.rejects.inc(lane=lane, kind=kind)

    # -- coalescing ----------------------------------------------------------

    def on_coalesce(self, job, lane: str, depth: int) -> None:
        """One job built from a lane queue: stamp spans, observe the
        per-request queue wait, refresh the queue-depth gauge."""
        if not self.enabled:
            return
        t = job.t_coalesce
        Tracer.mark_all(job.spans, "coalesce", t)
        for t_sub in job.t_submits:
            self.stage_seconds.observe(t - t_sub, stage="queue_wait",
                                       kind=job.kind)
        self.queue_depth.set(depth, lane=lane, kind=job.kind)

    def on_lease(self, job, t: float) -> None:
        if not self.enabled:
            return
        Tracer.mark_all(job.spans, "lease", t)

    # -- dispatch (called by the scheduler) ----------------------------------

    def on_launch(self, rec, job) -> None:
        if not self.enabled:
            return
        self.jobs.inc(stream=rec.stream, kind=rec.kind)
        Tracer.mark_all(job.spans, "launch", rec.t_launch,
                        stream=rec.stream, round=rec.round,
                        attempt=rec.attempt)
        if job.t_coalesce:
            dt = rec.t_launch - job.t_coalesce
            for _ in range(job.n_real):
                self.stage_seconds.observe(dt, stage="dispatch",
                                           kind=rec.kind)

    def on_round(self, mode) -> None:
        if not self.enabled:
            return
        self.rounds.inc(mode=getattr(mode, "value", mode))

    # -- completion ----------------------------------------------------------

    def on_materialize(self, rec, job, t: float) -> None:
        if not self.enabled:
            return
        Tracer.mark_all(job.spans, "materialize", t, stream=rec.stream)
        if rec.t_launch:
            dt = t - rec.t_launch
            for _ in range(job.n_real):
                self.stage_seconds.observe(dt, stage="execute",
                                           kind=rec.kind)

    def on_complete(self, job, lane: str, t_done: float) -> None:
        if not self.enabled:
            return
        Tracer.mark_all(job.spans, "demux", t_done)
        for t_sub in job.t_submits:
            self.stage_seconds.observe(t_done - t_sub, stage="total",
                                       kind=job.kind)
        self.completed.inc(job.n_real, lane=lane, kind=job.kind)
        for span in job.spans:
            self.tracer.finish(span)

    def on_fail(self, job, lane: str, t: float) -> None:
        if not self.enabled:
            return
        Tracer.mark_all(job.spans, "failed", t)
        self.failed.inc(job.n_real, lane=lane, kind=job.kind)
        for span in job.spans:
            self.tracer.finish(span)

    def on_fail_request(self, span, lane: str, kind: str, t: float) -> None:
        """One request failed OUTSIDE a job (popped straight off a queue
        by the crash/stop path, never coalesced): finish its span and
        count it, so failure accounting reconciles with ``_failures``
        even when the dispatch loop dies."""
        if not self.enabled:
            return
        if span is not None:
            span.mark("failed", t)
            self.tracer.finish(span)
        self.failed.inc(lane=lane, kind=kind)

    def on_result(self, rid: int, t: float) -> None:
        if not self.enabled:
            return
        self.tracer.stamp_result(rid, t=t)

    # -- EventLog sink -------------------------------------------------------

    def event_sink(self, ev) -> None:
        """Fold the structured event stream into labeled counters — the
        scheduler's stream-death/requeue/retry accounting and the
        runtime's fire/reject events arrive here without those layers
        knowing about metrics."""
        if not self.enabled:
            return
        self.events.inc(kind=ev.kind)

    # -- reporting -----------------------------------------------------------

    def stage_summaries(self) -> dict:
        """{stage: {count, p50_s, p99_s}} over both kinds — the
        ``stats()`` histogram block."""
        if not self.enabled:
            return {}
        out = {}
        for stage in STAGE_NAMES:
            total = {"count": 0, "p50_s": 0.0, "p99_s": 0.0}
            parts = []
            for kind in ("enc", "dec"):
                s = self.stage_seconds.summary(stage=stage, kind=kind)
                if s["count"]:
                    parts.append(s)
            total["count"] = sum(p["count"] for p in parts)
            if parts:
                # conservative merge across kinds: count-weighted p50,
                # max p99 (exact per-kind numbers live in the snapshot)
                total["p50_s"] = sum(
                    p["p50"] * p["count"] for p in parts) / total["count"]
                total["p99_s"] = max(p["p99"] for p in parts)
            out[stage] = total
        return out

    def snapshot(self) -> dict:
        """JSON-able telemetry snapshot (metrics + trace-ring state)."""
        return {
            "enabled": self.enabled,
            "metrics": self.metrics.snapshot(),
            "trace": {
                "spans": len(self.tracer),
                "live": self.tracer.n_live(),
                "dropped": self.tracer.dropped,
                "capacity": self.tracer.capacity,
                "sample_every": self.tracer.sample_every,
            },
        }

    def exposition(self) -> str:
        return self.metrics.exposition()

    def chrome_trace(self) -> dict:
        return self.tracer.chrome_trace()

    def export_chrome_trace(self, path) -> dict:
        """Write (and validate) the Chrome trace JSON; returns it."""
        trace = self.chrome_trace()
        validate_chrome_trace(trace)
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace

    def reset(self) -> None:
        """Telemetry window boundary: every metric series and the span
        ring drop to empty; registrations and instrument wiring stay."""
        self.metrics.reset()
        self.tracer.reset()


class MeshTelemetry:
    """Telemetry scope for the multi-process service mesh front-end.

    The router (not the workers) measures the transport: every frame
    crossing a worker socket lands in ``wire_bytes`` labeled by worker,
    inner wire kind and direction — which is what turns the paper's
    seeded-compression claim into a measured wire-bytes/request number
    (kind 2 submits carry half the bytes of kind 1). Labels follow the
    privacy contract: worker indices, wire kinds and lane fingerprints
    only — never tenant ids, seeds or payload contents.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.metrics = MetricsRegistry()
        m = self.metrics
        self.wire_bytes = m.counter(
            "mesh_wire_bytes_total",
            "frame payload bytes per worker socket by inner wire kind "
            "and direction ('send' = router->worker)",
            ("worker", "kind", "dir"))
        self.requests = m.counter(
            "mesh_requests_total", "per-message submits accepted",
            ("lane", "kind"))
        self.chunks = m.counter(
            "mesh_chunks_total", "chunks dispatched to workers",
            ("worker", "kind"))
        self.requeues = m.counter(
            "mesh_requeues_total",
            "in-flight chunks re-sent to a survivor after a worker died",
            ("worker",))
        self.workers_alive = m.gauge(
            "mesh_workers_alive", "live worker processes")
        # direction totals for the per-request byte report (the labeled
        # counter can't be summed across series without a snapshot walk)
        self._dir_bytes = {"send": 0, "recv": 0}
        self._n_requests = 0

    def on_submit(self, lane: str, kind: str) -> None:
        if not self.enabled:
            return
        self._n_requests += 1
        self.requests.inc(lane=lane, kind=kind)

    def on_frame(self, worker: int, kind, direction: str,
                 n_bytes: int) -> None:
        """One frame on a worker socket; ``kind`` is the inner wire kind
        (or a short op tag like 'ctl' for control frames)."""
        if not self.enabled:
            return
        self.wire_bytes.inc(n_bytes, worker=worker, kind=kind,
                            dir=direction)
        self._dir_bytes[direction] = \
            self._dir_bytes.get(direction, 0) + n_bytes

    def on_chunk(self, worker: int, kind: str) -> None:
        if not self.enabled:
            return
        self.chunks.inc(worker=worker, kind=kind)

    def on_requeue(self, dead_worker: int) -> None:
        if not self.enabled:
            return
        self.requeues.inc(worker=dead_worker)

    def set_workers_alive(self, n: int) -> None:
        if not self.enabled:
            return
        self.workers_alive.set(n)

    def wire_report(self) -> dict:
        """Measured transport totals: bytes by direction and
        wire-bytes/request (the bench row's headline column)."""
        n = max(self._n_requests, 1)
        return {
            "requests": self._n_requests,
            "send_bytes": self._dir_bytes.get("send", 0),
            "recv_bytes": self._dir_bytes.get("recv", 0),
            "send_bytes_per_request": self._dir_bytes.get("send", 0) / n,
            "recv_bytes_per_request": self._dir_bytes.get("recv", 0) / n,
        }

    def snapshot(self) -> dict:
        return {"enabled": self.enabled,
                "metrics": self.metrics.snapshot(),
                "wire": self.wire_report()}

    def reset(self) -> None:
        self.metrics.reset()
        self._dir_bytes = {"send": 0, "recv": 0}
        self._n_requests = 0


__all__ = [
    "Counter", "DEFAULT_TIME_BUCKETS", "Gauge",
    "Histogram", "MeshTelemetry", "MetricsRegistry", "OVERFLOW_LABEL",
    "STAGES", "STAGE_INTERVALS", "STAGE_NAMES", "ServiceTelemetry",
    "Span", "Tracer", "launches", "metrics", "probe",
    "spans_to_chrome_trace", "table_cache_entries", "tracing",
    "validate_chrome_trace",
]
