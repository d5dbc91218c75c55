"""Dual-stream scheduler: the RSC mode policy executed on CUDA streams.

Port of ``repro.fhe_client.service.scheduler``. ``core.scheduler``
reproduces the paper's dual-RSC task scheduling analytically; this module
*executes* that policy. Each stream is one device group
(``distributed.sharding.stream_groups``) with one ``torch.cuda.Stream``
per device, standing in for one Reconfigurable Streaming Core; jobs from
the coalescing batcher are assigned to streams round by round with the
SAME pure policy functions (``assign_streams`` / ``round_mode``) the
analytic model exposes, so the dispatch log the service records is — by
construction, and by test — the schedule ``core.scheduler.plan_rounds``
predicts.

Execution (``StreamExecutor.launch``):

  * the operands are placed on the stream's device inside
    ``with torch.cuda.stream(s)``: the host-to-device copies of an encrypt
    job's message planes and a decrypt job's scales run on that stream,
    and a decrypt job's stacked ciphertext rows (made on the calling
    thread's stream) are waited for and recorded on it;
  * the client's ``encrypt_impl`` / ``decrypt_impl`` launches the job's
    kernels (K5 / K6 on the default client; K1-K4 on a staged one) on the
    stream; a multi-device group splits the rows, one launch per device,
    shard s under the nonce base ``ops.shard_nonce_base(nonce0, s,
    rows)``, so row r still encrypts under ``nonce0 + r``;
  * a ``torch.cuda.Event`` is recorded on each stream it used, and
    ``(out, events)`` returns without blocking: the service's completion
    side synchronizes on those events (never on the whole device, which
    would serialise the streams).

Streams from ``torch.cuda.Stream()`` do not wait on the legacy default
stream, nor it on them: every cross-stream read above is ordered by an
explicit wait and recorded for the caching allocator. On the CPU (the
tests' logical devices) a stream is ``None`` and a launch runs the plain
versions synchronously.
"""

from __future__ import annotations

import copy
import dataclasses
from collections import deque

import torch

from repro_torch.core import scheduler as policy
from repro_torch.distributed import sharding as shd
from repro_torch.fhe_client.client import ClientKeys
from repro_torch.fhe_client.service.batcher import DecJob, EncJob, now
from repro_torch.fhe_client.service.faults import AllStreamsFailed, EventLog
from repro_torch.kernels import ops as kops
from repro_torch.telemetry.probe import DEVICE_CLIENTS_ATTR


@dataclasses.dataclass(frozen=True)
class DispatchRecord:
    """One job launch: which stream ran what, under which top-level mode.
    ``attempt > 0`` marks a retry of a failed stream's job (same job, same
    nonce lease, surviving stream); ``nonce0`` is an encrypt job's nonce
    base (row r under ``nonce0 + r``), None for a decrypt job."""
    round: int
    stream: int
    kind: str                       # 'enc' | 'dec'
    mode: policy.Mode
    bucket: int
    rids: tuple
    attempt: int = 0
    t_launch: float = 0.0           # monotonic launch timestamp (0 = unset)
    nonce0: int | None = None


def _moved(obj, device):
    """A copy of a key dataclass with every tensor field on ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


class StreamExecutor:
    """One execution stream: a device group, one CUDA stream per device.

    Multi-tenant: ``client_for`` maps a job's lane key to that tenant's
    client; a lane of None is the anonymous default ``client``. A tenant's
    keys on a device other than its client's are cached ON the tenant's
    client (a shallow copy of it with the keys moved there, keyed by
    device name), NOT in an executor-side table keyed by ``id(client)``:
    an id-keyed table could serve a dead client's keys to a new one, and
    an executor-held reference would keep evicted tenants' key material
    alive past registry eviction. The copies die with the client.
    """

    def __init__(self, client, devices, index: int, client_for=None):
        self.client = client
        self._client_for = client_for
        self.devices = tuple(shd.normalize_device(d) for d in devices)
        self.index = index
        self.n_shards = len(self.devices)
        self.streams = tuple(torch.cuda.Stream(device=d)
                             if d.type == "cuda" else None
                             for d in self.devices)
        # place the default tenant's keys on every device of the group at
        # construction (the warm state tests pin)
        for d in self.devices:
            self.client_on(client, d)

    def resolve(self, job):
        """The client whose keys/nonce lease this job runs under."""
        if job.tenant is None or self._client_for is None:
            return self.client
        return self._client_for(job.tenant)

    def client_on(self, client, device):
        """``client`` itself when it lives on ``device``; else its copy
        with the keys on ``device``, built on first use and cached on the
        client (nonces are never drawn from the copy)."""
        if shd.normalize_device(client.device) == device:
            return client
        table = vars(client).setdefault(DEVICE_CLIENTS_ATTR, {})
        dc = table.get(str(device))
        if dc is None:
            dc = copy.copy(client)
            vars(dc).pop(DEVICE_CLIENTS_ATTR, None)
            dc.device = device
            dc.keys = ClientKeys(_moved(client.keys.sk, device),
                                 _moved(client.keys.pk, device))
            table[str(device)] = dc
        return dc

    # --- launches (async: no blocking here) ---------------------------------

    def _run(self, client, batch: int, shard_fn, reads=()):
        """Launch ``shard_fn(device_client, rows, shard, shard_rows)`` on
        each device's row slice, on that device's stream
        (``ops.split_rows``); returns ``(out, events)``. ``reads``: CUDA
        tensors made on the calling thread's stream that the launches read
        (the stream waits for that stream and records them)."""
        callers = [torch.cuda.current_stream(d) if st is not None else None
                   for d, st in zip(self.devices, self.streams)]
        events = []

        def launch(s, dev, sl, rows):
            st = self.streams[s]
            if st is not None and reads:
                st.wait_stream(callers[s])
                for t in reads:
                    if t.is_cuda:
                        t.record_stream(st)
            out = shard_fn(self.client_on(client, dev), sl, s, rows)
            if st is not None:
                ev = torch.cuda.Event()
                ev.record(st)
                events.append(ev)
            return out

        outs = kops.split_rows(batch, self.devices, launch, self.streams)
        if self.n_shards == 1:
            return outs[0], tuple(events)
        return self._gather(outs, events)

    def _gather(self, outs, events):
        """Shard outputs -> one stack per output on the group's first
        device, ordered after every shard's kernels (on the first stream
        when the group is on the card)."""
        dev0, st0 = self.devices[0], self.streams[0]
        if st0 is None:
            return tuple(kops.gather_rows(parts, dev0)
                         for parts in zip(*outs)), ()
        with torch.cuda.stream(st0):
            for ev in events[1:]:
                st0.wait_event(ev)
            for out in outs:
                for t in out:
                    t.record_stream(st0)
            gathered = tuple(kops.gather_rows(parts, dev0)
                             for parts in zip(*outs))
            ev = torch.cuda.Event()
            ev.record(st0)
        return gathered, (ev,)

    def launch(self, job):
        """Launch one job's kernels on this stream; returns ``(out,
        events)`` without blocking: (c0, c1) (bucket, L, N) for an encrypt
        job, the decrypt core's parts for a decrypt job."""
        client = self.resolve(job)
        if isinstance(job, EncJob):
            if job.messages.shape[1] != client.ctx.params.n_slots:
                raise ValueError(
                    f"tenant-purity violation: job for lane {job.tenant!r} "
                    f"carries {job.messages.shape[1]}-slot messages but the "
                    f"lane's parameter set has n_slots="
                    f"{client.ctx.params.n_slots}")

            def enc(dc, sl, s, rows):
                ops = dc.encrypt_operands(job.messages[sl])
                return dc.encrypt_impl(
                    *ops, kops.shard_nonce_base(job.nonce0, s, rows))

            return self._run(client, job.bucket, enc)
        assert isinstance(job, DecJob)
        c0, c1 = job.cts.c0, job.cts.c1

        def dec(dc, sl, s, rows):
            return dc.decrypt_impl(
                c0[sl].to(dc.device), c1[sl].to(dc.device),
                dc._scale_operand(job.scales[sl], rows))

        return self._run(client, job.bucket, dec, reads=(c0, c1))


class DualStreamScheduler:
    """Maps batch jobs onto the stream executors, round by round, with the
    analytic scheduler's mode policy, and records the dispatch log.

    Failure story: ``faults`` (a ``FaultInjector``) is probed at every
    launch and materialize; a stream whose launch raises is marked dead
    (``mark_failed``), its job is re-queued at the FRONT of its kind's
    queue (same job object, same nonce lease — the retried ciphertexts
    stay bit-identical), and subsequent rounds plan over the surviving
    streams only. ``events`` (an ``EventLog``) records every failure,
    re-queue and degradation so tests can replay the recovery.
    """

    def __init__(self, client, devices=None, n_streams: int | None = None,
                 oversubscribe: bool = False, faults=None, events=None,
                 client_for=None, telemetry=None):
        groups = shd.stream_groups(devices, n_streams,
                                   oversubscribe=oversubscribe)
        self.streams = [StreamExecutor(client, g, i, client_for=client_for)
                        for i, g in enumerate(groups)]
        self.faults = faults
        self.telemetry = telemetry
        self.events = events if events is not None else EventLog()
        self._alive = [True] * len(self.streams)
        self.log: list[DispatchRecord] = []
        self._round = 0

    @property
    def n_streams(self) -> int:
        return len(self.streams)

    @property
    def pad_multiple(self) -> int:
        """Devices per stream group — the batcher pads buckets to this so
        every batch axis divides every stream's device group."""
        return self.streams[0].n_shards

    # --- stream liveness ----------------------------------------------------

    @property
    def alive_streams(self) -> list[int]:
        return [i for i, a in enumerate(self._alive) if a]

    @property
    def n_alive(self) -> int:
        return sum(self._alive)

    def mark_failed(self, stream: int, detail: str = "") -> None:
        """Declare a stream dead; it takes no further launches. Records a
        ``stream_failed`` event (+ ``degraded`` on the 2->1 transition).
        Never raises — callers check ``n_alive`` to decide whether any
        work can still run."""
        if not self._alive[stream]:
            return
        self._alive[stream] = False
        self.events.record("stream_failed", stream=stream,
                           round=self._round, detail=detail)
        if self.n_alive == 1:
            self.events.record("degraded", stream=self.alive_streams[0],
                               round=self._round,
                               detail="single-stream operation")

    def revive_all(self) -> None:
        """Bring every stream back (deployment-level recovery seam; tests
        use it between fault scenarios)."""
        self._alive = [True] * len(self.streams)

    # --- launches -----------------------------------------------------------

    def launch_job(self, stream: int, job, attempt: int = 0):
        """Fault-seamed single-job launch on one stream (no log entry);
        returns ``(out, events)`` without blocking."""
        if self.faults is not None:
            self.faults.on_launch(stream=stream, round=self._round, job=job)
        return self.streams[stream].launch(job)

    def dispatch(self, enc_jobs, dec_jobs):
        """Launch every pending job; returns ``(launched, undispatched)``
        with ``launched`` = [(record, job, (out, events))] in launch order
        (``out`` unmaterialized, ``events`` the CUDA events that mark its
        completion) and ``undispatched`` = jobs that could not launch
        because every stream died. Each round assigns ``core.scheduler``'s
        policy pick to the ALIVE streams and launches before the round is
        blocked on — with no failures the dispatch log is exactly
        ``plan_rounds(n_enc, n_dec, n_alive)`` and ``undispatched`` is
        empty. A launch that raises marks its stream dead and re-queues
        the job at the FRONT of its queue (same job, same nonce lease) for
        the surviving streams."""
        enc_q, dec_q = deque(enc_jobs), deque(dec_jobs)
        launched = []
        while enc_q or dec_q:
            alive = self.alive_streams
            if not alive:
                break
            kinds = policy.assign_streams(len(enc_q), len(dec_q),
                                          len(alive))
            mode = policy.round_mode(kinds)
            for stream, kind in zip(alive, kinds):
                q = enc_q if kind == "enc" else dec_q
                job = q.popleft()
                try:
                    out = self.launch_job(stream, job)
                except Exception as e:  # noqa: BLE001 — any launch failure
                    q.appendleft(job)
                    self.events.record(
                        "requeue", stream=stream, round=self._round,
                        rids=job.rids, detail=f"launch failed: {e}")
                    self.mark_failed(stream, detail=repr(e))
                    break               # re-plan the round over survivors
                rec = DispatchRecord(
                    round=self._round, stream=stream, kind=kind, mode=mode,
                    bucket=job.bucket, rids=job.rids, t_launch=now(),
                    nonce0=getattr(job, "nonce0", None))
                self.log.append(rec)
                if self.telemetry is not None:
                    self.telemetry.on_launch(rec, job)
                launched.append((rec, job, out))
            else:
                # full round launched: count it by mode (a broken round
                # re-plans and is counted when it completes)
                if self.telemetry is not None:
                    self.telemetry.on_round(mode)
            self._round += 1
        return launched, list(enc_q) + list(dec_q)

    def relaunch(self, job, attempt: int):
        """Re-launch one failed job on the surviving streams (bounded-
        retry path; the job keeps its nonce lease so the retried rows are
        bit-identical). Returns (record, (out, events)). Tries each alive
        stream
        in turn, marking further failures dead as it goes; raises
        ``AllStreamsFailed`` when none survives."""
        kind = "enc" if isinstance(job, EncJob) else "dec"
        while True:
            alive = self.alive_streams
            if not alive:
                raise AllStreamsFailed(
                    f"no alive stream to retry job rids={job.rids}")
            stream = alive[0]
            try:
                out = self.launch_job(stream, job, attempt=attempt)
            except Exception as e:  # noqa: BLE001
                self.events.record(
                    "requeue", stream=stream, round=self._round,
                    rids=job.rids, attempt=attempt,
                    detail=f"retry launch failed: {e}")
                self.mark_failed(stream, detail=repr(e))
                continue
            rec = DispatchRecord(
                round=self._round, stream=stream, kind=kind,
                mode=policy.round_mode((kind,)), bucket=job.bucket,
                rids=job.rids, attempt=attempt, t_launch=now(),
                nonce0=getattr(job, "nonce0", None))
            self.log.append(rec)
            if self.telemetry is not None:
                self.telemetry.on_launch(rec, job)
                self.telemetry.on_round(rec.mode)
            self._round += 1
            return rec, out

    def check_materialize(self, rec: DispatchRecord, job) -> None:
        """Materialize-phase fault seam (called right before a result is
        blocked on; the injected 'result_error' failure shape)."""
        if self.faults is not None:
            self.faults.on_materialize(stream=rec.stream, round=rec.round,
                                       job=job)

    def clear_log(self):
        """Reset the dispatch log and round counter (telemetry window
        boundary; the log otherwise grows one record per job forever)."""
        self.log.clear()
        self._round = 0

    def modes_executed(self, start: int = 0):
        """[(mode, kinds)] per round from the dispatch log (from log entry
        ``start`` on) — directly comparable to ``plan_rounds`` output."""
        rounds: dict[int, list] = {}
        for rec in self.log[start:]:
            rounds.setdefault(rec.round, []).append(rec)
        out = []
        for r in sorted(rounds):
            recs = sorted(rounds[r], key=lambda x: x.stream)
            out.append((recs[0].mode, tuple(x.kind for x in recs)))
        return out
