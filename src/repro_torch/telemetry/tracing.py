"""Request-lifecycle span tracing + Chrome trace-event export.

Every sampled request carries ONE ``Span`` from ``submit_*`` to
``result()``; the layers it passes through stamp named stages onto it
(monotonic clock, the same source as the service's deadline math):

    submit -> admit -> coalesce -> [lease] -> launch -> materialize
           -> demux -> result            (``failed`` replaces the tail
                                          when the retry budget runs out)

Completed spans land in a bounded ring (oldest evicted first) and export
as Chrome trace-event JSON — loadable in ``chrome://tracing`` / Perfetto —
with one track per execution stream plus per-kind queue tracks, so "where
does a request's time go" is a picture, not a guess.

Cost model: a ``Tracer`` with ``enabled=False`` (or a request outside the
sample) returns ``None`` from ``begin`` and every downstream ``mark_all``
skips Nones — the disabled path is one attribute check per stage, no
allocation, no kernel-side effect (pinned by test). Spans hold request
ids, stage names, stream indices and lane FINGERPRINTS only: never
message plaintext, key material, or seeds.

Port of ``repro.telemetry.tracing``: no framework code, a near-copy.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict

# canonical stage order (span validity tests check stamps stay sorted)
STAGES = ("submit", "admit", "coalesce", "lease", "launch",
          "materialize", "demux", "result", "failed")

_STAGE_RANK = {s: i for i, s in enumerate(STAGES)}


class Span:
    """One request's lifecycle: (stage, t) stamps plus routing metadata.

    Mutable and unlocked by design: a span is only ever touched by the
    thread currently carrying its request (submitter -> dispatch thread ->
    completion thread; handoffs happen through the service's own locks),
    so stamping is append-to-list cheap."""

    __slots__ = ("rid", "kind", "lane", "marks", "stream", "round",
                 "attempt")

    def __init__(self, rid: int, kind: str, lane: str):
        self.rid = rid
        self.kind = kind
        self.lane = lane
        self.marks: list[tuple[str, float]] = []
        self.stream: int | None = None
        self.round: int | None = None
        self.attempt = 0

    def mark(self, stage: str, t: float) -> None:
        self.marks.append((stage, t))

    def t(self, stage: str) -> float | None:
        """Timestamp of the LAST stamp of ``stage`` (retries re-stamp
        launch/materialize; the final attempt is the one that completed)."""
        out = None
        for s, ts in self.marks:
            if s == stage:
                out = ts
        return out

    def stages(self) -> list[str]:
        return [s for s, _t in self.marks]

    def as_dict(self) -> dict:
        return {"rid": self.rid, "kind": self.kind, "lane": self.lane,
                "stream": self.stream, "round": self.round,
                "attempt": self.attempt, "marks": list(self.marks)}


class Tracer:
    """Span factory + bounded completed-span ring.

    ``sample_every=k`` keeps every k-th request id (deterministic —
    replayable against the dispatch log, unlike random sampling);
    ``capacity`` bounds the completed ring AND the live index, so a
    soak of any length holds at most ``2 * capacity`` spans.
    """

    def __init__(self, capacity: int = 4096, sample_every: int = 1,
                 clock=time.monotonic, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, "
                             f"got {sample_every}")
        self.capacity = int(capacity)
        self.sample_every = int(sample_every)
        self.clock = clock
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: OrderedDict[int, Span] = OrderedDict()  # completed
        self._live: OrderedDict[int, Span] = OrderedDict()  # in flight
        self.dropped = 0                  # spans evicted from the ring

    # -- span lifecycle ------------------------------------------------------

    def begin(self, rid: int, kind: str, lane: str,
              t: float | None = None) -> Span | None:
        """Span for a new request, or None (disabled / outside sample)."""
        if not self.enabled or rid % self.sample_every:
            return None
        span = Span(rid, kind, lane)
        span.mark("submit", self.clock() if t is None else t)
        with self._lock:
            self._live[rid] = span
            while len(self._live) > self.capacity:  # abandoned requests
                self._live.popitem(last=False)
                self.dropped += 1
        return span

    def finish(self, span: Span | None) -> None:
        """Move a span into the completed ring (it stays reachable by rid
        for the final ``result`` stamp until evicted)."""
        if span is None:
            return
        with self._lock:
            self._live.pop(span.rid, None)
            self._ring[span.rid] = span
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
                self.dropped += 1

    def stamp_result(self, rid: int, t: float | None = None) -> None:
        """Final lifecycle stamp, from ``result(rid)`` retrieval."""
        if not self.enabled:
            return
        with self._lock:
            span = self._ring.get(rid)
        if span is not None and span.t("result") is None:
            span.mark("result", self.clock() if t is None else t)

    @staticmethod
    def mark_all(spans, stage: str, t: float, stream=None, round=None,
                 attempt=None) -> None:
        """Stamp a stage onto every sampled span of one job (Nones — the
        unsampled or disabled requests — skip)."""
        for span in spans:
            if span is None:
                continue
            span.mark(stage, t)
            if stream is not None:
                span.stream = stream
            if round is not None:
                span.round = round
            if attempt is not None:
                span.attempt = attempt

    # -- introspection -------------------------------------------------------

    def spans(self) -> list[Span]:
        """Completed spans, oldest first."""
        with self._lock:
            return list(self._ring.values())

    def span(self, rid: int) -> Span | None:
        with self._lock:
            return self._ring.get(rid) or self._live.get(rid)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def n_live(self) -> int:
        with self._lock:
            return len(self._live)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._live.clear()
            self.dropped = 0

    # -- Chrome trace export -------------------------------------------------

    def chrome_trace(self) -> dict:
        """Completed spans as a Chrome trace-event JSON object
        (``chrome://tracing`` / Perfetto "trace event format"): complete
        ('X') duration events on one track per stream plus per-kind queue
        tracks, timestamps in microseconds on the monotonic clock's
        origin. Per-track timestamps are strictly increasing (ties from
        coalesced jobs sharing a launch get a sub-microsecond nudge so
        viewers and the schema check agree on ordering)."""
        return spans_to_chrome_trace(self.spans())


# track ids: queues low, streams from _STREAM_TID0 (one track per stream)
_QUEUE_TIDS = {"enc": 1, "dec": 2}
_STREAM_TID0 = 10


def _span_events(span: Span):
    """(tid, name, ts, dur, args) slices for one span's stage intervals."""
    args = {"rid": span.rid, "lane": span.lane, "kind": span.kind}
    qtid = _QUEUE_TIDS.get(span.kind, 3)
    t_sub, t_coal = span.t("submit"), span.t("coalesce")
    t_launch, t_mat = span.t("launch"), span.t("materialize")
    t_demux = span.t("demux")
    if t_sub is not None and t_coal is not None:
        yield (qtid, "queued", t_sub, t_coal - t_sub, args)
    if t_coal is not None and t_launch is not None:
        yield (qtid, "dispatch", t_coal, t_launch - t_coal, args)
    stid = _STREAM_TID0 + (span.stream or 0)
    sargs = dict(args, stream=span.stream, round=span.round,
                 attempt=span.attempt)
    if t_launch is not None and t_mat is not None:
        yield (stid, f"execute:{span.kind}", t_launch, t_mat - t_launch,
               sargs)
    if t_mat is not None and t_demux is not None:
        yield (stid, "demux", t_mat, t_demux - t_mat, sargs)
    t_fail = span.t("failed")
    if t_fail is not None and t_sub is not None:
        yield (qtid, "failed", t_sub, t_fail - t_sub, sargs)


def spans_to_chrome_trace(spans) -> dict:
    """Chrome trace-event JSON for a span list (see
    ``Tracer.chrome_trace``)."""
    raw = []
    tids = set()
    for span in spans:
        for tid, name, ts, dur, args in _span_events(span):
            tids.add(tid)
            raw.append({"name": name, "cat": "fhe", "ph": "X", "pid": 0,
                        "tid": tid, "ts": ts * 1e6,
                        "dur": max(dur, 0.0) * 1e6, "args": args})
    # strictly increasing ts per track: sort, then nudge exact ties by a
    # nanosecond step (far below the monotonic clock's resolution)
    raw.sort(key=lambda e: (e["tid"], e["ts"]))
    last: dict[int, float] = {}
    for e in raw:
        prev = last.get(e["tid"])
        if prev is not None and e["ts"] <= prev:
            e["ts"] = prev + 1e-3
        last[e["tid"]] = e["ts"]
    events = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
               "args": {"name": "fhe-client-service"}}]
    for tid in sorted(tids):
        name = (f"stream {tid - _STREAM_TID0}" if tid >= _STREAM_TID0 else
                {1: "queue:enc", 2: "queue:dec"}.get(tid, "queue:other"))
        events.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": tid, "args": {"name": name}})
    return {"traceEvents": events + raw,
            "displayTimeUnit": "ms",
            "otherData": {"format": "fhe-client-service trace v1"}}


def validate_chrome_trace(trace: dict) -> int:
    """Schema smoke check shared by the test tier and the CI artifact
    step: the object round-trips through JSON, every event carries the
    required keys, and per-track timestamps of duration events are
    strictly increasing. Returns the duration-event count; raises
    ``ValueError`` on any violation."""
    trace = json.loads(json.dumps(trace))   # must be JSON-serializable
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace has no traceEvents list")
    last: dict[tuple, float] = {}
    n_dur = 0
    for e in events:
        for k in ("name", "ph", "pid", "tid"):
            if k not in e:
                raise ValueError(f"event missing {k!r}: {e}")
        if e["ph"] == "M":
            continue
        if e["ph"] != "X":
            raise ValueError(f"unexpected phase {e['ph']!r}: {e}")
        for k in ("ts", "dur"):
            if not isinstance(e.get(k), (int, float)):
                raise ValueError(f"event missing numeric {k!r}: {e}")
        if e["dur"] < 0:
            raise ValueError(f"negative duration: {e}")
        track = (e["pid"], e["tid"])
        prev = last.get(track)
        if prev is not None and e["ts"] <= prev:
            raise ValueError(
                f"track {track} timestamps not strictly increasing: "
                f"{e['ts']} after {prev}")
        last[track] = e["ts"]
        n_dur += 1
    return n_dur
