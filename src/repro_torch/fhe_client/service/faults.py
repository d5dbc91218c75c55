"""Fault injection + structured event log for the client service.

The always-on runtime only counts as robust if its failure handling is
*exercised*: this module is the seam the scheduler and dispatch loop call
at every launch/materialize so tests (and the fault-injected bench rows)
can kill a stream mid-round, delay it past the straggler budget, or flake
a bounded number of launches — then assert that every submitted request
still completes, that retried ciphertexts are bit-identical (the job's
nonce-range lease travels with it onto the surviving stream), and that
the structured event log records exactly the recovery that happened.

Nothing here is test-only: ``ServiceEvent``/``EventLog`` are the service's
production observability surface (bounded, monotonic-stamped, replayable),
and ``FaultInjector`` is a no-op unless faults are armed.

Port of ``repro.fhe_client.service.faults``: no framework code, a near-copy.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time


class StreamFault(RuntimeError):
    """Injected (or detected) failure of one execution stream."""

    def __init__(self, stream: int, reason: str = "injected fault"):
        super().__init__(f"stream {stream}: {reason}")
        self.stream = stream
        self.reason = reason


class AllStreamsFailed(RuntimeError):
    """Every execution stream is dead; the service cannot make progress."""


class RequestFailed(RuntimeError):
    """A request exhausted its retry budget; raised by ``result(rid)``."""

    def __init__(self, rid: int, attempts: int, cause: Exception):
        super().__init__(f"request {rid} failed after {attempts} attempts: "
                         f"{cause!r}")
        self.rid = rid
        self.attempts = attempts
        self.cause = cause


# ---------------------------------------------------------------------------
# structured event log
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServiceEvent:
    """One structured service event (monotonic-stamped, replayable).

    ``kind`` vocabulary (tests replay these):
      * ``deadline_fire`` — a partially-filled bucket dispatched because
        its oldest request hit the max-wait deadline
      * ``full_fire``     — a full bucket dispatched without waiting
      * ``drain_fire``    — remaining requests dispatched at stop/flush
      * ``reject``        — a submit bounced off the bounded queue
      * ``stream_failed`` — a stream was marked dead (injected error,
        materialize failure, or straggler timeout)
      * ``requeue``       — a failed stream's job re-queued onto survivors
        (same nonce lease — the retried ciphertexts stay bit-identical)
      * ``retry_ok``      — a re-queued job completed on a survivor
      * ``request_failed``— a job exhausted its retry budget
      * ``degraded``      — the service dropped to single-stream operation
      * ``loop_error``    — the dispatch/completion thread recorded an
        unexpected exception (surfaced on the next submit/result call)
    """
    seq: int
    t: float                       # time.monotonic() at record time
    kind: str
    stream: int | None = None
    round: int | None = None
    rids: tuple = ()
    attempt: int = 0
    detail: str = ""


class EventLog:
    """Append-only, thread-safe, bounded event log.

    ``replay(kind=...)`` filters chronologically — the fault tests assert
    recovery through this, and long-running services read it as telemetry
    (bounded at ``maxlen`` events so it never grows without limit).

    ``sink`` is the telemetry seam: every recorded event is also handed to
    it (outside the log's lock), which is how scheduler stream-death /
    requeue / retry accounting and the runtime's fire/reject events fold
    into the labeled metric counters (``ServiceTelemetry.event_sink``)
    without this module depending on the metrics layer.
    """

    def __init__(self, maxlen: int = 4096, clock=time.monotonic,
                 sink=None):
        self.maxlen = maxlen
        self.clock = clock
        self.sink = sink
        self._events: list[ServiceEvent] = []
        self._seq = itertools.count()
        self._lock = threading.Lock()

    def record(self, kind: str, stream=None, round=None, rids=(),
               attempt: int = 0, detail: str = "") -> ServiceEvent:
        ev = ServiceEvent(seq=next(self._seq), t=self.clock(), kind=kind,
                          stream=stream, round=round, rids=tuple(rids),
                          attempt=attempt, detail=detail)
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self.maxlen:
                del self._events[:len(self._events) - self.maxlen]
        if self.sink is not None:
            self.sink(ev)
        return ev

    def replay(self, kind: str | None = None) -> list[ServiceEvent]:
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e.kind == kind]

    def kinds(self) -> list[str]:
        return [e.kind for e in self.replay()]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaultSpec:
    """One armed fault.

    ``stream``  — stream index to hit (None = any stream)
    ``kind``    — 'error' raises StreamFault at launch; 'result_error'
                  raises at materialize (the launch "succeeded" but its
                  output cannot be read back — the async-dispatch failure
                  shape); 'delay' sleeps ``delay_s`` in the materialize
                  path, where job durations are measured (drives the
                  straggler/job-timeout detection)
    ``after``   — skip the first ``after`` matching launches
    ``count``   — number of launches to affect (None = every one from
                  ``after`` on: a permanently dead stream)
    """
    stream: int | None = None
    kind: str = "error"
    after: int = 0
    count: int | None = 1
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ("error", "result_error", "delay"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultInjector:
    """Configurable per-stream/per-launch fault source.

    The scheduler calls ``on_launch`` before every stream launch and
    ``on_materialize`` before every result read-back; each armed spec
    matches by stream and fires for its configured launch window. Thread-
    safe: the dispatch and completion threads probe concurrently.
    """

    def __init__(self, specs=()):
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        self._seen: dict[int, int] = {}       # id(spec) -> matching launches
        self._fired: dict[int, int] = {}      # id(spec) -> faults fired
        self._lock = threading.Lock()

    @classmethod
    def kill_stream(cls, stream: int, after: int = 0) -> "FaultInjector":
        """Injector that permanently fails ``stream`` from its
        ``after``-th launch on (the mid-round stream-death scenario)."""
        return cls([FaultSpec(stream=stream, kind="error", after=after,
                              count=None)])

    def add(self, spec: FaultSpec) -> None:
        with self._lock:
            self.specs.append(spec)

    def _matches(self, spec: FaultSpec, stream: int, phase: str) -> bool:
        if spec.stream is not None and spec.stream != stream:
            return False
        if phase == "materialize":
            return spec.kind in ("result_error", "delay")
        return spec.kind == "error"

    def _probe(self, stream: int, phase: str):
        """Returns the first spec firing for this (stream, phase) launch."""
        with self._lock:
            for spec in self.specs:
                if not self._matches(spec, stream, phase):
                    continue
                k = id(spec)
                seen = self._seen.get(k, 0)
                self._seen[k] = seen + 1
                if seen < spec.after:
                    continue
                if spec.count is not None and \
                        self._fired.get(k, 0) >= spec.count:
                    continue
                self._fired[k] = self._fired.get(k, 0) + 1
                return spec
        return None

    def on_launch(self, stream: int, round: int, job) -> None:
        spec = self._probe(stream, "launch")
        if spec is None:
            return
        raise StreamFault(stream, f"injected {spec.kind} at launch "
                                  f"(round {round}, job rids={job.rids})")

    def on_materialize(self, stream: int, round: int, job) -> None:
        spec = self._probe(stream, "materialize")
        if spec is None:
            return
        if spec.kind == "delay":
            time.sleep(spec.delay_s)
            return
        raise StreamFault(stream, f"injected result_error at materialize "
                                  f"(round {round}, job rids={job.rids})")

    def fired(self) -> int:
        """Total faults fired so far (delays included)."""
        with self._lock:
            return sum(self._fired.values())
