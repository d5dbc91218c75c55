"""Always-on dispatch runtime: the background loop behind
``ClientService.start()``.

Port of ``repro.fhe_client.service.runtime`` (no framework code, a
near-copy). The dispatch thread launches each job on its stream's CUDA
stream and hands ``(record, job, (out, events))`` to the completion
thread, which synchronizes on the job's own events — never on the whole
device — before it reads the results back.

Structure (the MaxText offline-inference engine's thread layout — a
``JetThread`` per role with a queue between them — adapted to the FHE
client's coalesce->launch->materialize pipeline):

    submitters (any threads)          bounded queues + backpressure
        -> dispatch JetThread         waits for a firing condition
           (coalesce + launch)        (full bucket OR oldest-request
                                      deadline, ``core.scheduler.
                                      ready_to_fire``), reserves nonces,
                                      launches rounds via the scheduler
        -> completion queue           (record, job, (out, events)) per
                                      launch
        -> completion JetThread       materializes in launch order,
           (block + demux + retry)    runs the failure/retry story,
                                      stores per-request results

Because launching and materializing live on different threads, the
dispatch thread is already coalescing (and launching) the next round
while the completion thread blocks on the previous one's events — host
coalescing overlaps device execution, which is what keeps the streams
busy under a sustained open-loop request arrival (the paper's premise:
the client must keep up with a stream, not a benchmark's pre-formed
batch).

Failure containment: a JetThread never dies silently. Any unexpected
exception is recorded (``crashed``), logged as a ``loop_error`` event,
every queued/in-flight request is failed with ``RequestFailed``, and the
next ``submit``/``result`` call re-raises — no request is ever silently
lost.
"""

from __future__ import annotations

import queue
import threading

from repro_torch.core import scheduler as policy
from repro_torch.fhe_client.service.batcher import now, oldest_age
from repro_torch.fhe_client.service.faults import (AllStreamsFailed,
                                                   RequestFailed)


class JetThread(threading.Thread):
    """Thread that records its exception instead of dying silently (the
    MaxText offline-engine pattern, minus the hard ``os._exit``: a serving
    library surfaces the error to its caller instead of killing the
    host process)."""

    def __init__(self, target, name: str, on_error=None):
        super().__init__(target=target, name=name, daemon=True)
        self.exception: BaseException | None = None
        self._on_error = on_error

    def run(self):
        try:
            super().run()
        except BaseException as e:  # noqa: BLE001 — record, never vanish
            self.exception = e
            if self._on_error is not None:
                self._on_error(e)


_SENTINEL = object()


class DispatchLoop:
    """The background dispatch + completion thread pair for one service."""

    def __init__(self, service):
        self.service = service
        self._stop_req = False
        self._drain_req = False
        self._completion_q: queue.Queue = queue.Queue()
        self._dispatch = JetThread(self._dispatch_loop, "fhe-svc-dispatch",
                                   on_error=self._record_crash)
        self._completion = JetThread(self._completion_loop,
                                     "fhe-svc-completion",
                                     on_error=self._record_crash)

    # --- lifecycle ----------------------------------------------------------

    @property
    def alive(self) -> bool:
        return self._dispatch.is_alive() or self._completion.is_alive()

    @property
    def crashed(self) -> BaseException | None:
        return self._dispatch.exception or self._completion.exception

    def start(self):
        self._dispatch.start()
        self._completion.start()

    def stop(self, drain: bool = True, timeout: float = 30.0):
        svc = self.service
        with svc._cond:
            self._stop_req = True
            self._drain_req = drain
            if not drain:
                self._fail_queued_locked(
                    RuntimeError("service stopped before dispatch"))
            svc._cond.notify_all()
        self._dispatch.join(timeout=timeout)
        self._completion.join(timeout=timeout)
        if self._dispatch.is_alive() or self._completion.is_alive():
            raise TimeoutError(
                f"dispatch loop did not stop within {timeout}s "
                f"(a hung device computation?)")

    def drain(self, timeout: float = 60.0):
        """Fire everything pending (partial buckets included) and wait
        until the queues and in-flight jobs are empty — the always-on
        analogue of ``flush()``."""
        svc = self.service
        deadline = now() + timeout
        with svc._cond:
            self._drain_req = True
            svc._cond.notify_all()
            while any(svc._queues.values()) or svc._inflight:
                if self.crashed is not None:
                    return            # crash path already failed requests
                remaining = deadline - now()
                if remaining <= 0:
                    raise TimeoutError(f"drain did not complete within "
                                       f"{timeout}s")
                svc._cond.wait(timeout=remaining)

    # --- crash containment --------------------------------------------------

    def _record_crash(self, exc: BaseException):
        svc = self.service
        svc.events.record("loop_error", detail=repr(exc))
        with svc._cond:
            self._fail_queued_locked(exc)
            svc._cond.notify_all()    # wake result()/submit waiters

    def _fail_queued_locked(self, cause):
        svc = self.service
        t = now()
        for (lane, kind), q in svc._queues.items():
            fp = svc._lane_fp(lane)
            while q:
                req = q.popleft()
                svc._failures[req.rid] = RequestFailed(req.rid, 0, cause)
                # these requests never reached a job, so the usual
                # on_fail(job) accounting can't see them: count + finish
                # their spans here or the failed counter undercounts and
                # the spans leak as forever-live
                svc.telemetry.on_fail_request(req.span, fp, kind, t)

    # --- dispatch thread ----------------------------------------------------

    def _fire_decision_locked(self):
        """Per-queue firing decisions: {(lane, kind): (fire, partial)} over
        every tenant lane, plus how long to sleep if nothing fires. Each
        lane's queues are judged independently — one tenant's full bucket
        fires immediately even while another's partial tail is still
        waiting out its deadline."""
        svc = self.service
        t = now()
        full = svc.batcher.max_bucket
        decision, waits = {}, []
        for key, q in svc._queues.items():
            age = oldest_age(q, t)
            fire = policy.ready_to_fire(len(q), age, full, svc.max_wait_s,
                                        svc.fire_mode)
            # deadline/eager fires include the partial tail; a pure
            # full-bucket fire leaves the tail waiting for its deadline
            partial = fire and (len(q) < full
                                or svc.fire_mode == "eager"
                                or age >= svc.max_wait_s)
            decision[key] = (fire, partial)
            if q and not fire and svc.fire_mode == "deadline":
                waits.append(max(svc.max_wait_s - age, 0.0))
        if self._drain_req:
            for key, q in svc._queues.items():
                if q:
                    decision[key] = (True, True)
        next_wait = min(waits) if waits else None
        return decision, next_wait

    def _dispatch_loop(self):
        svc = self.service
        while True:
            with svc._cond:
                while True:
                    decision, next_wait = self._fire_decision_locked()
                    if any(f for f, _p in decision.values()):
                        break
                    if self._stop_req:
                        break
                    if self._drain_req and not any(svc._queues.values()):
                        self._drain_req = False
                    svc._cond.wait(timeout=next_wait)
                stopping = self._stop_req and not any(svc._queues.values())
                draining = self._drain_req
                firing = [key for key, (fire, _p) in decision.items()
                          if fire and svc._queues.get(key)]
            if stopping:
                break
            # build/readmit any cold tenant session OUTSIDE _cond before
            # coalescing: keygen under the service condition would
            # stall submitters, the completion thread and every other
            # lane. Requests admitted to a firing lane in this window are
            # simply coalesced too; brand-new lanes wait one iteration.
            svc._prepare_lanes(firing)
            with svc._cond:
                enc_jobs, dec_jobs = svc._coalesce_locked(decision)
            # --- outside _cond: record fire events + launch ---------------
            for jobs, kind in ((enc_jobs, "enc"), (dec_jobs, "dec")):
                for job in jobs:
                    full = job.n_real >= svc.batcher.max_bucket
                    svc.events.record(
                        "drain_fire" if draining and not full else
                        ("full_fire" if full else "deadline_fire"),
                        rids=job.rids,
                        detail=f"{kind} bucket {job.bucket} "
                               f"({job.n_real} real)")
            if enc_jobs or dec_jobs:
                with svc._sched_lock:
                    launched, undispatched = svc.scheduler.dispatch(
                        enc_jobs, dec_jobs)
                for job in undispatched:
                    svc._fail(job, 0, AllStreamsFailed(
                        f"no alive stream for job rids={job.rids}"))
                for item in launched:
                    self._completion_q.put(item)
        self._completion_q.put(_SENTINEL)

    # --- completion thread --------------------------------------------------

    def _completion_loop(self):
        svc = self.service
        while True:
            item = self._completion_q.get()
            if item is _SENTINEL:
                break
            rec, job, launched = item
            svc._run_job(rec, job, launched)
