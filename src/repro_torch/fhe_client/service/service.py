"""ClientService: the servable engine over the batched client pipeline.

Port of ``repro.fhe_client.service.service``. Request flow (BTS/FAB-class
server accelerators presume the client side can keep up with a request
stream):

    submit_encrypt/submit_decrypt      per-message requests, FIFO queues
        -> CoalescingBatcher           bucketed, tail-padded batch jobs
        -> DualStreamScheduler         RSC mode policy on CUDA streams
        -> the client's kernels        one launch per job per device
                                       (K5 / K6 on the default client)
        -> demux                       per-request results, padding dropped

Two operating modes share that flow:

  * **closed-loop** (the default): ``submit_*`` only enqueues; ``flush``
    coalesces, dispatches every pending job (all launches go out on their
    streams before any result is waited for, so the streams overlap),
    then synchronizes on each job's own CUDA events and demultiplexes
    results.
  * **always-on** (``start()``/``stop()``): a background dispatch loop
    (``service.runtime``) fires full buckets immediately and partially-
    filled buckets when their oldest request hits the ``max_wait_s``
    deadline, admits new requests while rounds are in flight (host
    coalescing overlaps device execution), and exerts backpressure when
    the bounded submission queues fill (block-with-timeout or reject).

Failure story (both modes): a ``FaultInjector`` seam at every launch and
materialize, per-job straggler/timeout detection reusing
``distributed.elastic.FleetMonitor``, bounded retry that re-queues a
failed stream's jobs onto surviving streams under the SAME nonce-range
lease (retried ciphertexts stay bit-identical), graceful degradation to
single-stream operation, and a structured ``EventLog`` tests replay.

Determinism contract: the service draws nonces from the CLIENT's counter
(padded rows included), so the ciphertext for any submitted message is
bit-identical to ``client.encode_encrypt_batch`` from the same nonce
base, regardless of bucket shape, padding, stream assignment, device
count — or which stream finally ran it after a mid-round failure. Tests
pin exactly this.

Devices: with no client the service builds ``FHEClient(profile)`` on the
card, and with no ``devices`` it runs its streams on every CUDA device
(``distributed.sharding.stream_groups``); a CPU client (the tests') runs
its streams on its own device as logical streams. Nothing here moves work
to the CPU on a failure.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import deque

import numpy as np
import torch

from repro_torch.core import cache as core_cache
from repro_torch.core import scheduler as policy
from repro_torch.core.context import CKKSParams, PROFILES
from repro_torch.core.encryptor import Ciphertext, CiphertextBatch
from repro_torch.distributed.elastic import FleetMonitor
from repro_torch.fhe_client.client import FHEClient
from repro_torch.fhe_client.service.batcher import (CoalescingBatcher,
                                                    DEFAULT_BUCKETS, DecJob,
                                                    EncJob, Request, now,
                                                    row_words, stack_rows)
from repro_torch.fhe_client.service.faults import (AllStreamsFailed,
                                                   EventLog, RequestFailed)
from repro_torch.fhe_client.service.scheduler import DualStreamScheduler
from repro_torch.fhe_client.tenancy import (KeyContextRegistry,
                                            params_fingerprint)
from repro_torch.telemetry import ServiceTelemetry, table_cache_entries


def lane_fingerprint(lane) -> str:
    """Short, stable metric/trace label for a lane: ``"default"`` for the
    anonymous lane, else a hash over the tenant id and the FULL parameter
    fingerprint. Telemetry label values are fingerprints by contract —
    they never carry raw tenant identifiers, plaintext, keys or seeds."""
    if lane is None:
        return "default"
    tenant_id, params = lane
    h = hashlib.sha256()
    h.update(params_fingerprint(params))
    h.update(b"\x00lane\x00" + str(tenant_id).encode("utf-8"))
    return h.hexdigest()[:12]


class QueueFull(RuntimeError):
    """Bounded submission queue rejected (or timed out) a submit — the
    backpressure signal a front-end sheds load on."""


class ClientService:
    """Request-coalescing, dual-stream FHE client service.

    Robustness/lifecycle knobs (all optional; the defaults give the
    closed-loop behaviour):

    ``queue_capacity``   — max queued requests per kind (None = unbounded).
    ``backpressure``     — 'block' (wait up to ``submit_timeout_s`` for
                           space, then raise ``QueueFull``) or 'reject'
                           (raise immediately).
    ``max_wait_s``       — always-on deadline: a partially-filled bucket
                           dispatches once its oldest request waited this
                           long (see ``core.scheduler.ready_to_fire``).
    ``fire_mode``        — partial-round firing policy: 'deadline' |
                           'eager' | 'full'.
    ``max_retries``      — bounded per-job retries after a stream failure.
    ``job_timeout_s``    — a job materializing slower than this marks its
                           stream failed (straggler isolation); None = off.
    ``faults``           — a ``FaultInjector`` armed at every launch/
                           materialize (tests + fault-injected benches).
    ``oversubscribe``    — allow more streams than devices (logical
                           streams sharing hardware: independent failure
                           domains, and on one card two CUDA streams whose
                           kernels may overlap).
    ``devices``          — the devices the streams run on (default: every
                           CUDA device, or the client's own device when the
                           client is on the CPU).
    ``nonce_authority``  — ``(lane, count) -> base``: every nonce lease
                           comes from it, not from the lane's client (a
                           mesh worker's router-granted ranges).
    """

    def __init__(self, client: FHEClient | None = None, profile="test",
                 buckets=DEFAULT_BUCKETS, devices=None,
                 n_streams: int | None = None, *, oversubscribe=False,
                 faults=None, max_retries: int = 2,
                 queue_capacity: int | None = None,
                 backpressure: str = "block", submit_timeout_s: float = 1.0,
                 max_wait_s: float = 0.005, fire_mode: str = "deadline",
                 job_timeout_s: float | None = None,
                 straggler_factor: float = 4.0, straggler_patience: int = 2,
                 registry: KeyContextRegistry | None = None,
                 tenant_capacity: int = 4,
                 telemetry: ServiceTelemetry | bool | None = None,
                 trace_capacity: int = 4096, trace_sample_every: int = 1,
                 nonce_authority=None):
        if backpressure not in ("block", "reject"):
            raise ValueError(f"backpressure must be 'block' or 'reject', "
                             f"got {backpressure!r}")
        if fire_mode not in policy.FIRE_MODES:
            raise ValueError(f"fire_mode must be one of "
                             f"{policy.FIRE_MODES}, got {fire_mode!r}")
        self.client = client if client is not None else FHEClient(profile)
        if devices is None and self.client.device.type != "cuda":
            devices = [self.client.device]
        # Telemetry scope (ON by default; spans sampled per
        # ``trace_sample_every``). ``telemetry=False`` builds a disabled
        # scope: every hook short-circuits on one boolean, no span is
        # allocated, no metric series created — the near-zero-cost path
        # the disabled-overhead test pins. Pass a ``ServiceTelemetry`` to
        # share one scope across services.
        if isinstance(telemetry, ServiceTelemetry):
            self.telemetry = telemetry
        else:
            enabled = True if telemetry is None else bool(telemetry)
            self.telemetry = ServiceTelemetry(
                enabled=enabled, trace_capacity=trace_capacity,
                sample_every=trace_sample_every, clock=now)
        self._lane_fps: dict = {}     # lane -> fingerprint label (memo)
        # Multi-tenant key contexts: named tenants resolve through the
        # registry (derived seeds, per-tenant nonce counters, LRU-bounded
        # compiled cores). The anonymous default tenant (lane None) is
        # ALWAYS self.client, never registry-managed: the caller's instance
        # — its seed, fourier/pipeline config and nonce state — must not be
        # silently rebuilt by an eviction. Default-lane leases still go
        # through the shared ledger, so overlap with any tenant is caught.
        self.registry = registry if registry is not None \
            else KeyContextRegistry(capacity=tenant_capacity,
                                    device=self.client.device)
        self.events = EventLog(clock=now, sink=self.telemetry.event_sink)
        self.scheduler = DualStreamScheduler(
            self.client, devices=devices, n_streams=n_streams,
            oversubscribe=oversubscribe, faults=faults, events=self.events,
            client_for=self._client_for, telemetry=self.telemetry)
        self.batcher = CoalescingBatcher(
            buckets, pad_multiple=self.scheduler.pad_multiple)
        self.monitor = FleetMonitor(
            n_hosts=self.scheduler.n_streams,
            heartbeat_timeout=(job_timeout_s or 3600.0) * 8,
            straggler_factor=straggler_factor,
            patience=straggler_patience, clock=now)
        # External nonce authority seam: ``(lane, count) -> base``. When
        # set, ``_take_nonces`` delegates every lease to it instead of
        # advancing the lane client's counter / local ledger — the mesh
        # worker path, where nonce ranges are granted centrally by the
        # router so retries across workers stay under ONE lease.
        self.nonce_authority = nonce_authority
        self.max_retries = int(max_retries)
        self.queue_capacity = queue_capacity
        self.backpressure = backpressure
        self.submit_timeout_s = submit_timeout_s
        self.max_wait_s = max_wait_s
        self.fire_mode = fire_mode
        self.job_timeout_s = job_timeout_s

        # all request state is guarded by one condition (submitters, the
        # dispatch loop and the completion thread all touch it)
        self._cond = threading.Condition()
        # queues are LANE-keyed: (lane, kind) -> deque, lane = None for the
        # default tenant or (tenant_id, CKKSParams) for a named one. A
        # bucket only ever drains ONE queue, so buckets never mix tenants
        # or parameter sets by construction (and the batcher re-checks).
        self._queues: dict[tuple, deque] = {(None, "enc"): deque(),
                                            (None, "dec"): deque()}
        self._rr_offset = 0           # round-robin cursor over lanes
        self._results: dict[int, object] = {}
        self._failures: dict[int, RequestFailed] = {}
        self._latencies: dict[int, float] = {}
        self._consumed: set[int] = set()
        self._next_rid = 0
        self._inflight = 0            # real requests coalesced, not done
        self._completed_total = 0
        self._retries_total = 0
        # scheduler/monitor mutations are serialized separately (the
        # dispatch and completion threads both launch); never held while
        # holding _cond
        self._sched_lock = threading.Lock()
        self._loop = None             # runtime.DispatchLoop when running
        self._warm: set = set()       # lanes whose shapes are launched once
        self._warm_lock = threading.Lock()

    # --- lifecycle (always-on mode) -----------------------------------------

    @property
    def running(self) -> bool:
        return self._loop is not None and self._loop.alive

    def start(self):
        """Start the background dispatch loop: from here on, submits are
        admitted while rounds are in flight, full buckets fire
        immediately, and partial buckets fire on the ``max_wait_s``
        deadline. Every (kind, bucket) shape of the known lanes is
        launched once first (``warm_up``), so the dispatch thread never
        builds a table or a kernel. Idempotent; returns self (usable as a
        context manager)."""
        from repro_torch.fhe_client.service.runtime import DispatchLoop
        if self._loop is not None and self._loop.alive:
            return self
        self.warm_up()
        self._loop = DispatchLoop(self)
        self._loop.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Stop the dispatch loop. ``drain=True`` dispatches everything
        still queued (partial buckets included) and waits for in-flight
        jobs; ``drain=False`` fails queued requests with RequestFailed.
        Idempotent."""
        loop, self._loop = self._loop, None
        if loop is not None:
            loop.stop(drain=drain, timeout=timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop(drain=exc_type is None)

    def _check_loop(self):
        """Surface a crashed dispatch/completion thread to the caller."""
        loop = self._loop
        if loop is not None and loop.crashed is not None:
            raise RuntimeError("service dispatch loop crashed") \
                from loop.crashed

    # --- tenant lanes -------------------------------------------------------

    def _resolve_lane(self, tenant, params):
        """(lane, CKKSParams) for a submit. ``tenant=None, params=None``
        is the anonymous default lane (the caller-supplied client);
        anything else is a registry-managed lane keyed by
        (tenant_id, params) — params defaults to the service client's."""
        if params is None:
            p = self.client.ctx.params
        elif isinstance(params, CKKSParams):
            p = params
        else:
            p = PROFILES[params]
        if tenant is None and p == self.client.ctx.params:
            return None, p
        return (tenant, p), p

    def _client_for(self, lane):
        """The FHEClient a lane's jobs run under (builds/readmits the
        tenant session through the registry for named lanes)."""
        if lane is None:
            return self.client
        tenant_id, params = lane
        return self.registry.get(tenant_id, params).client

    def _take_nonces(self, lane, count: int) -> int:
        """The single nonce authority: advance the lane client's counter
        and record the lease in the shared ledger (overlap => raise).

        Under an external ``nonce_authority`` (a mesh worker: the ROUTER
        owns the ledger and grants ranges per dispatched chunk) the local
        counter and ledger are bypassed entirely — a chunk retried on a
        different worker must reuse its original base without a local
        ledger calling that reuse a rewind."""
        if self.nonce_authority is not None:
            return int(self.nonce_authority(lane, count))
        if lane is None:
            base = self.client.take_nonces(count)
            self.registry.ledger.lease(self.client.seed, base, count)
            return base
        tenant_id, params = lane
        return self.registry.take_nonces(tenant_id, params, count)

    def _lane_fp(self, lane) -> str:
        """Memoized telemetry label for a lane (bounded: lanes are bounded
        by the queue table, which lives for the service)."""
        fp = self._lane_fps.get(lane)
        if fp is None:
            fp = self._lane_fps[lane] = lane_fingerprint(lane)
        return fp

    def _prepare_lanes(self, keys):
        """Build/readmit the tenant session behind every named lane in
        ``keys`` (an iterable of (lane, kind) queue keys) OUTSIDE
        ``_cond``. Session construction — prime search, keygen,
        potentially seconds — must never run under the
        service-wide condition: it would stall every submitter, the
        completion thread and all other lanes' dispatch. With lanes
        prepared, coalescing under ``_cond`` only advances counters."""
        for lane in {lane for lane, _kind in keys if lane is not None}:
            self._ensure_lane(lane)

    def _ensure_lane(self, lane):
        """Build/readmit a named lane's session and, while the dispatch
        loop runs, warm it if it is new (``_warm_lane``). A submit calls
        this before it queues the request, so a lane that first shows up
        while the service runs is warmed on the submitting thread and the
        dispatch thread never builds."""
        if lane is None:
            return
        self.registry.get(*lane)
        if self.running:
            self._warm_lane(lane)

    # --- submission ---------------------------------------------------------

    def _admit(self, kind: str, payload, lane=None) -> int:
        """Enqueue under the bounded-queue/backpressure policy. Queues
        (and their capacity bound) are per (lane, kind) — one tenant
        saturating its lane never blocks another's submits."""
        self._check_loop()
        key = (lane, kind)
        fp = self._lane_fp(lane)
        with self._cond:
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = deque()
            cap = self.queue_capacity
            if cap is not None:
                if self.backpressure == "reject":
                    if len(q) >= cap:
                        self.telemetry.on_reject(fp, kind)
                        self.events.record("reject", detail=f"{kind} queue "
                                           f"at capacity {cap}")
                        raise QueueFull(
                            f"{kind} queue at capacity {cap} "
                            f"(backpressure='reject')")
                else:
                    deadline = now() + self.submit_timeout_s
                    while len(q) >= cap:
                        remaining = deadline - now()
                        if remaining <= 0 or not self.running:
                            self.telemetry.on_reject(fp, kind)
                            self.events.record(
                                "reject", detail=f"{kind} submit timed out "
                                f"after {self.submit_timeout_s}s at "
                                f"capacity {cap}")
                            raise QueueFull(
                                f"{kind} queue still at capacity {cap} "
                                f"after blocking {self.submit_timeout_s}s")
                        self._cond.wait(timeout=remaining)
            rid = self._next_rid
            self._next_rid += 1
            t = now()
            span = self.telemetry.on_submit(rid, kind, fp, t)
            q.append(Request(rid=rid, kind=kind, payload=payload,
                             t_submit=t, tenant=lane, span=span))
            self.telemetry.on_admit(span, fp, kind, len(q), t)
            self._cond.notify_all()   # wake the dispatch loop
        return rid

    def submit_encrypt(self, message, *, tenant=None, params=None) -> int:
        """Queue one (n_slots,) complex message for encode+encrypt under
        ``tenant``'s keys (None = the service's own client). Returns the
        request id; the result is a ``Ciphertext`` row.

        Validation happens HERE, at the submit boundary (symmetric to
        ``submit_decrypt``): a malformed message failing later inside a
        dispatch would take the whole coalesced batch — and its reserved
        nonces — down with it. Strict by design: no silent flatten, no
        silent truncation, no NaN smuggled into a kernel launch.

        A named lane's key context is also built HERE (outside the
        service condition) if it isn't resident yet, and warmed if the
        loop runs, so a cold tenant's first submit pays its own keygen and
        warm-up cost instead of the dispatch loop stalling every lane
        under ``_cond``."""
        lane, p = self._resolve_lane(tenant, params)
        self._ensure_lane(lane)
        msg = np.asarray(message)
        if msg.ndim != 1:
            raise ValueError(
                f"message must be a 1-D (n_slots,) vector, got ndim="
                f"{msg.ndim} shape {msg.shape} — batch submits go one "
                f"message at a time (the batcher coalesces)")
        if msg.shape[0] != p.n_slots:
            raise ValueError(f"message must hold {p.n_slots} slots for "
                             f"this lane's parameter set, got shape "
                             f"{msg.shape}")
        if not np.issubdtype(msg.dtype, np.number):
            raise ValueError(
                f"message dtype {msg.dtype} is not numeric — slot "
                f"vectors are complex (or real) scalars")
        msg = msg.astype(np.complex128)
        if not (np.isfinite(msg.real).all() and np.isfinite(msg.imag).all()):
            raise ValueError("message contains non-finite values (NaN/Inf "
                             "cannot be CKKS-encoded)")
        return self._admit("enc", msg, lane)

    def submit_decrypt(self, ct, *, tenant=None, params=None) -> int:
        """Queue one server-returned ciphertext (``Ciphertext`` or a
        (c0, c1, scale) triple of (>=2, N) stacks of words: int32 tensors
        or uint32 / int32 arrays) for decrypt+decode.
        Returns the request id; the result is an (n_slots,) complex row.

        Validation happens HERE, at the submit boundary: a malformed
        payload failing later inside a dispatch would take the whole
        coalesced batch (and its reserved nonces) down with it. A named
        lane's key context is built (and warmed) here too, outside
        ``_cond``, like ``submit_encrypt``."""
        lane, p = self._resolve_lane(tenant, params)
        self._ensure_lane(lane)
        if isinstance(ct, Ciphertext):
            if ct.c1 is None:
                raise ValueError("expand seeded ciphertexts "
                                 "(encryptor.expand_seeded) before "
                                 "submitting for decryption")
            payload = (ct.c0, ct.c1, float(ct.scale))
        elif isinstance(ct, (tuple, list)) and len(ct) == 3:
            c0, c1, scale = ct
            payload = (c0, c1, float(scale))
        else:
            raise ValueError(
                "submit_decrypt takes a Ciphertext or a (c0, c1, "
                f"scale) triple, got {type(ct).__name__}")
        n = p.n
        shapes = {}
        for name, poly in (("c0", payload[0]), ("c1", payload[1])):
            shape = np.shape(poly)
            if len(shape) != 2 or shape[0] < 2:
                raise ValueError(
                    f"decrypt {name} must be a (>=2, N={n}) limb stack, "
                    f"got shape {shape}")
            if shape[1] != n:
                raise ValueError(
                    f"decrypt {name} has ring degree {shape[1]}, but this "
                    f"client's parameter set has N={n} — wrong parameter "
                    f"set or transposed stack (shape {shape})")
            shapes[name] = shape
            row_words(poly)           # int32 / uint32 words, else raises
        if shapes["c0"][0] != shapes["c1"][0]:
            raise ValueError(
                f"decrypt c0/c1 limb counts differ: c0 has "
                f"{shapes['c0'][0]} limbs, c1 has {shapes['c1'][0]} — "
                f"the pair must come from the same ciphertext level")
        if not np.isfinite(payload[2]) or payload[2] <= 0:
            raise ValueError(f"decrypt scale must be a positive finite "
                             f"number, got {payload[2]!r}")
        return self._admit("dec", payload, lane)

    # --- coalescing (shared by flush and the dispatch loop) -----------------

    def _rr_queue_keys(self):
        """Queue keys with the LANE order rotated by a round-robin cursor
        (advanced once per coalesce pass), so under sustained multi-tenant
        load no lane's buckets are systematically drained — and its jobs
        launched — after everyone else's."""
        lanes = []
        for lane, _kind in self._queues:
            if lane not in lanes:
                lanes.append(lane)
        if len(lanes) > 1:
            off = self._rr_offset % len(lanes)
            lanes = lanes[off:] + lanes[:off]
        self._rr_offset += 1
        return [(lane, kind) for lane in lanes for kind in ("enc", "dec")
                if (lane, kind) in self._queues]

    def _coalesce_locked(self, decision=None):
        """Pop queued requests into jobs + reserve per-lane nonces. Caller
        holds ``_cond``. ``decision`` maps queue key (lane, kind) ->
        (fire, allow_partial); None fires everything, partial tails
        included (the flush/drain path). Lanes drain in round-robin order;
        each lane's jobs carry its own nonce lease from its own client.
        Returns (enc_jobs, dec_jobs)."""
        enc_jobs, dec_jobs = [], []
        for key in self._rr_queue_keys():
            lane, kind = key
            fire, partial = (True, True) if decision is None \
                else decision.get(key, (False, False))
            if not fire or not self._queues[key]:
                continue
            fp = self._lane_fp(lane)
            if kind == "enc":
                p = lane[1] if lane is not None else self.client.ctx.params
                jobs, n_nonces = self.batcher.coalesce_enc(
                    self._queues[key], nonce0=0, n_slots=p.n_slots,
                    allow_partial=partial, tenant=lane)
                if n_nonces:
                    base = self._take_nonces(lane, n_nonces)
                    t_lease = now()
                    jobs = [dataclasses.replace(j, nonce0=base + j.nonce0)
                            for j in jobs]
                    for j in jobs:
                        self.telemetry.on_lease(j, t_lease)
                enc_jobs += jobs
            else:
                jobs = self.batcher.coalesce_dec(
                    self._queues[key], allow_partial=partial, tenant=lane,
                    device=self._lane_device(lane))
                dec_jobs += jobs
            depth = len(self._queues[key])
            for j in jobs:
                self.telemetry.on_coalesce(j, fp, depth)
        self._inflight += sum(j.n_real for j in enc_jobs + dec_jobs)
        if enc_jobs or dec_jobs:
            self._cond.notify_all()   # queue space freed: wake submitters
        return enc_jobs, dec_jobs

    # --- completion / failure handling --------------------------------------

    def _sync_monitor_locked(self):
        """Mirror scheduler stream deaths into the fleet monitor (the
        monitor's median-based straggler math must not count the dead)."""
        alive = set(self.scheduler.alive_streams)
        for s in range(self.scheduler.n_streams):
            if s not in alive and self.monitor.hosts[s].alive:
                self.monitor.mark_failed(s)

    def _store(self, job, rows, t_done):
        """Demux one completed job's real rows into per-request results."""
        with self._cond:
            for rid, t_sub, row in zip(job.rids, job.t_submits, rows):
                self._results[rid] = row
                self._latencies[rid] = t_done - t_sub
            self._inflight -= job.n_real
            self._completed_total += job.n_real
            self._cond.notify_all()
        self.telemetry.on_complete(job, self._lane_fp(job.tenant), t_done)

    def _fail(self, job, attempt, cause):
        """Exhausted retries (or no streams left): fail the job's rids."""
        self.events.record("request_failed", rids=job.rids, attempt=attempt,
                           detail=repr(cause))
        with self._cond:
            for rid in job.rids:
                self._failures[rid] = RequestFailed(rid, attempt + 1, cause)
            self._inflight -= job.n_real
            self._completed_total += job.n_real
            self._cond.notify_all()
        self.telemetry.on_fail(job, self._lane_fp(job.tenant), now())

    def _lane_device(self, lane):
        """Device of a lane's client (where its decrypt rows stack). A
        named lane's session is built by ``_prepare_lanes`` first."""
        if lane is None:
            return self.client.device
        return self.registry.get(*lane).client.device

    def _demux(self, job, out):
        """Materialized job output -> real result rows, under the job's
        OWN lane client (a tenant's results decode with its parameter set
        and scales, never the default client's)."""
        client = self._client_for(job.tenant)
        if isinstance(job, EncJob):
            c0, c1 = out
            p = client.ctx.params
            return [Ciphertext(c0=c0[i], c1=c1[i], n_limbs=p.n_limbs,
                               scale=p.delta) for i in range(job.n_real)]
        msgs = client.decrypt_results(out, job.scales)
        return [msgs[i] for i in range(job.n_real)]

    def _run_job(self, rec, job, launched):
        """Materialize one launched job (``launched`` = (out, events)),
        with the full failure story: materialize-phase fault seam, stream
        death -> bounded retry on survivors (same job, same nonce lease),
        straggler/timeout detection via the fleet monitor. Waits on the
        job's own CUDA events only — a device-wide synchronize would
        serialise the streams. Stores results or failures."""
        attempt = rec.attempt
        out, events = launched
        while True:
            t0 = now()
            try:
                self.scheduler.check_materialize(rec, job)
                for ev in events:
                    ev.synchronize()
            except Exception as e:  # noqa: BLE001 — any materialize failure
                with self._sched_lock:
                    self.scheduler.mark_failed(rec.stream, detail=repr(e))
                    self._sync_monitor_locked()
                    if attempt >= self.max_retries \
                            or self.scheduler.n_alive == 0:
                        self._fail(job, attempt, e)
                        return
                    attempt += 1
                    self._retries_total += 1
                    self.events.record(
                        "requeue", stream=rec.stream, round=rec.round,
                        rids=job.rids, attempt=attempt,
                        detail=f"materialize failed: {e}")
                    try:
                        rec, (out, events) = self.scheduler.relaunch(
                            job, attempt)
                    except AllStreamsFailed as dead:
                        self._fail(job, attempt, dead)
                        return
                continue
            break
        dt = now() - t0
        t_done = now()
        self.telemetry.on_materialize(rec, job, t_done)
        with self._sched_lock:
            self.monitor.heartbeat(rec.stream)
            self.monitor.report_step_time(rec.stream, dt)
            if self.job_timeout_s is not None and dt > self.job_timeout_s \
                    and self.scheduler.n_alive > 1:
                # the result arrived, but far past budget: isolate the
                # straggling stream so later jobs avoid it (never kill the
                # last stream over a slow-but-correct result)
                self.scheduler.mark_failed(
                    rec.stream, detail=f"job took {dt:.4f}s "
                    f"(timeout {self.job_timeout_s}s)")
            else:
                for s in self.monitor.stragglers():
                    if s in self.scheduler.alive_streams \
                            and self.scheduler.n_alive > 1:
                        self.scheduler.mark_failed(
                            s, detail="straggler (fleet-monitor policy)")
            self._sync_monitor_locked()
        if attempt > 0:
            self.events.record("retry_ok", stream=rec.stream,
                               round=rec.round, rids=job.rids,
                               attempt=attempt)
        self._store(job, self._demux(job, out), t_done)

    # --- execution (closed-loop mode) ---------------------------------------

    def pending(self) -> dict:
        """Queued request counts aggregated by kind (all lanes)."""
        with self._cond:
            out = {"enc": 0, "dec": 0}
            for (_lane, kind), q in self._queues.items():
                out[kind] += len(q)
            return out

    def pending_by_lane(self) -> dict:
        """Queued request counts per (lane, kind) queue."""
        with self._cond:
            return {k: len(q) for k, q in self._queues.items()}

    def flush(self):
        """Complete every queued request; returns how many finished.

        Closed-loop mode: coalesce + dispatch + materialize synchronously.
        Always-on mode: nudge the loop to fire everything pending
        (partial buckets included) and wait for the queues and in-flight
        jobs to drain."""
        if self.running:
            start_total = self._completed_total
            self._loop.drain()
            with self._cond:
                return self._completed_total - start_total
        with self._cond:
            queued_keys = [k for k, q in self._queues.items() if q]
        self._prepare_lanes(queued_keys)
        with self._cond:
            enc_jobs, dec_jobs = self._coalesce_locked()
        with self._sched_lock:
            launched, undispatched = self.scheduler.dispatch(enc_jobs,
                                                             dec_jobs)
        done0 = self._completed_total
        for job in undispatched:      # every stream died before launch
            self._fail(job, 0, AllStreamsFailed(
                f"no alive stream for job rids={job.rids}"))
        for rec, job, handle in launched:
            self._run_job(rec, job, handle)
        return self._completed_total - done0

    # --- warm-up ------------------------------------------------------------

    def warm_up(self) -> int:
        """Launch every (kind, bucket) shape once on every stream, for the
        default lane and every resident tenant lane not warmed yet, and
        wait for each on its own events: the kernels are built and every
        table memo is filled before any dispatch thread runs, so the
        warm path does no new work (``fhe_table_cache_entries`` stays put).
        Warm-up takes no nonce from any lane (``_warm_lane``), so a lane's
        jobs lease the same bases as under the reference service, which
        has no warm-up; nothing enters the dispatch log, the telemetry or
        the fault seams. Returns the launches made."""
        lanes = [None] + [(s_key[0], s_key[1])
                          for s_key in self.registry.resident_keys()]
        return sum(self._warm_lane(lane) for lane in lanes)

    def _warm_lane(self, lane) -> int:
        """Warm one lane (see ``warm_up``); returns the launches made, 0
        when it is warm already. Its encrypts run zero messages under the
        fixed nonce base 0 and never lease: their outputs are dropped on
        the device, so no ciphertext made under that base is ever seen."""
        with self._warm_lock:
            if lane in self._warm:
                return 0
            client = self._client_for(lane)
            p = client.ctx.params
            n = 0
            for bucket in self.batcher.buckets:
                zeros = torch.zeros((bucket, 2, p.n), dtype=torch.int32,
                                    device=client.device)
                enc = EncJob(messages=np.zeros((bucket, p.n_slots),
                                               np.complex128),
                             nonce0=0, rids=(), t_submits=(), tenant=lane)
                dec = DecJob(cts=CiphertextBatch(c0=zeros, c1=zeros,
                                                 n_limbs=2, scale=p.delta),
                             scales=np.full((bucket, 1), p.delta),
                             rids=(), t_submits=(), tenant=lane)
                for ex in self.scheduler.streams:
                    for job in (enc, dec):
                        _out, events = ex.launch(job)
                        for ev in events:
                            ev.synchronize()
                        n += 1
            self._warm.add(lane)
            return n

    # --- result retrieval ----------------------------------------------------

    def _lookup(self, rid: int, consume: bool):
        """Shared result/peek lookup. Caller holds ``_cond``."""
        if rid in self._failures:
            raise self._failures[rid]
        if rid in self._results:
            row = self._results.pop(rid) if consume else self._results[rid]
            if consume:
                self._consumed.add(rid)
                self.telemetry.on_result(rid, now())
            return row
        return _PENDING

    def result(self, rid: int, timeout: float | None = 30.0):
        """Result for a request id, consumed on retrieval (``peek`` is the
        non-consuming read). Closed-loop: flushes if the request is still
        queued. Always-on: blocks until the loop completes it (or
        ``timeout`` elapses). Raises ``RequestFailed`` if the request
        exhausted its retry budget, and KeyError with a precise reason
        (unknown rid vs already consumed) otherwise."""
        self._check_loop()
        with self._cond:
            got = self._lookup(rid, consume=True)
            if got is not _PENDING:
                return got
            if rid >= self._next_rid:
                raise KeyError(f"unknown request id {rid} (nothing was "
                               f"ever submitted under it)")
            if rid in self._consumed:
                raise KeyError(f"request {rid} was already retrieved — "
                               f"result() consumes; use peek() for "
                               f"non-consuming reads")
            if self.running:
                deadline = None if timeout is None else now() + timeout
                while True:
                    got = self._lookup(rid, consume=True)
                    if got is not _PENDING:
                        return got
                    self._check_loop()
                    remaining = (None if deadline is None
                                 else deadline - now())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            f"request {rid} not completed within "
                            f"{timeout}s (still queued or in flight)")
                    self._cond.wait(timeout=remaining)
            queued = any(req.rid == rid for q in self._queues.values()
                         for req in q)
        if not queued:
            raise KeyError(f"request {rid} has no stored result and is "
                           f"not queued (already retrieved?)")
        self.flush()
        with self._cond:
            got = self._lookup(rid, consume=True)
        if got is _PENDING:
            raise KeyError(f"request {rid} did not complete in flush")
        return got

    def peek(self, rid: int):
        """Non-consuming read of a completed request's result. Raises
        KeyError('still pending') if the request exists but has not
        completed — use ``done(rid)`` to poll without raising."""
        with self._cond:
            got = self._lookup(rid, consume=False)
            if got is not _PENDING:
                return got
            if rid >= self._next_rid:
                raise KeyError(f"unknown request id {rid} (nothing was "
                               f"ever submitted under it)")
            if rid in self._consumed:
                raise KeyError(f"request {rid} was already retrieved — "
                               f"result() consumes; peek() only sees "
                               f"results not yet consumed")
            raise KeyError(f"request {rid} is still pending (queued or in "
                           f"flight)")

    def done(self, rid: int) -> bool:
        """True once a request has completed (result ready, already
        consumed, or failed); False while queued/in flight. Raises
        KeyError for rids never issued."""
        with self._cond:
            if rid >= self._next_rid:
                raise KeyError(f"unknown request id {rid} (nothing was "
                               f"ever submitted under it)")
            return (rid in self._results or rid in self._consumed
                    or rid in self._failures)

    def latency(self, rid: int) -> float:
        """Submit-to-materialize latency (s) of a completed request.
        Latency entries and the dispatch log accumulate until
        ``reset_telemetry`` — long-running servers should reset between
        reporting windows."""
        return self._latencies[rid]

    def reset_telemetry(self):
        """Start a new telemetry WINDOW: drop accumulated latencies,
        events, the dispatch log, every metric series and the trace ring
        (results still pending retrieval are kept). Bounds memory on
        long-running services; per-window stats start fresh afterwards.

        Window semantics — what a reset does and does not clear:

          * WINDOWED (cleared together, so they always reconcile):
            per-rid latencies, the ``EventLog``, the scheduler dispatch
            log + round counter, every metric series (counters,
            gauges, ``fhe_stage_seconds`` histograms), and the span ring.
            ``stats()`` keys derived from these — ``jobs_dispatched``,
            ``rounds``, ``jobs_by_stream``, ``modes``, ``events``,
            ``stages`` — restart at zero, and the ``fhe_jobs_total``
            counter restarts WITH the dispatch log (the two are asserted
            equal in tests; neither can silently drift past the other).
          * LIFETIME (never cleared here): ``completed``, ``retries``,
            ``failed_requests``, registry/ledger accounting
            (builds/evictions/leases), pending results and queued
            requests. These answer "what has this service ever done",
            not "what happened this window"."""
        with self._cond:
            self._latencies.clear()
        self.events.clear()
        self.scheduler.clear_log()
        self.telemetry.reset()

    # --- batch conveniences (the example / bench entry points) -------------

    def encrypt_many(self, messages) -> CiphertextBatch:
        """Submit a (B, n_slots) message batch through the queue and gather
        the rows back into one CiphertextBatch (submission order), on the
        service client's device (``torch.stack``; rows on another device
        move there)."""
        rids = [self.submit_encrypt(m) for m in np.asarray(messages)]
        self.flush()
        rows = [self.result(r) for r in rids]
        n_limbs = rows[0].n_limbs
        return CiphertextBatch(
            c0=stack_rows([r.c0 for r in rows], self.client.device, n_limbs),
            c1=stack_rows([r.c1 for r in rows], self.client.device, n_limbs),
            n_limbs=n_limbs, scale=rows[0].scale)

    def decrypt_many(self, cts) -> np.ndarray:
        """Submit each row of a CiphertextBatch (or iterable of
        Ciphertexts) through the queue; returns (B, n_slots) complex."""
        rids = [self.submit_decrypt(ct) for ct in cts]
        self.flush()
        return np.stack([self.result(r) for r in rids])

    # --- introspection ------------------------------------------------------

    @property
    def dispatch_log(self):
        return self.scheduler.log

    def stats(self) -> dict:
        log = self.scheduler.log
        by_stream = {}
        for rec in log:
            by_stream[rec.stream] = by_stream.get(rec.stream, 0) + 1
        with self._cond:
            queued = {"enc": 0, "dec": 0}
            for (_lane, kind), q in self._queues.items():
                queued[kind] += len(q)
            lanes = {lane for lane, _k in self._queues}
            inflight = self._inflight
            completed = self._completed_total
            failed = len(self._failures)
        return {
            "lanes": len(lanes),
            "tenants": self.registry.stats(),
            "n_streams": self.scheduler.n_streams,
            "alive_streams": self.scheduler.alive_streams,
            "shards_per_stream": self.scheduler.pad_multiple,
            "buckets": self.batcher.buckets,
            "jobs_dispatched": len(log),
            "rounds": len({rec.round for rec in log}),
            "jobs_by_stream": by_stream,
            "modes": [m.value for m, _k in self.scheduler.modes_executed()],
            "running": self.running,
            "queued": queued,
            "inflight": inflight,
            "completed": completed,
            "failed_requests": failed,
            "retries": self._retries_total,
            "events": len(self.events),
            "stages": self.telemetry.stage_summaries(),
            "telemetry": {
                "enabled": self.telemetry.enabled,
                "spans": len(self.telemetry.tracer),
                "spans_dropped": self.telemetry.tracer.dropped,
                "sample_every": self.telemetry.tracer.sample_every,
            },
        }

    def telemetry_snapshot(self) -> dict:
        """One JSON-able snapshot of everything the service can observe:
        the labeled metric series (+ histogram buckets), trace-ring state,
        every bounded derived-state memo's hit/miss/eviction counters
        (``core.cache.cache_stats``), key-context registry accounting, the
        nonce-ledger lease total, and the table-cache odometer over all
        resident tenant clients (``fhe_table_cache_entries`` — a fixed
        warm workload leaves it unchanged; a delta is new build work on
        the warm path)."""
        snap = self.telemetry.snapshot()
        reg = self.registry.stats()
        snap["caches"] = core_cache.cache_stats()
        snap["registry"] = {
            "resident": reg["resident"],
            "capacity": reg["capacity"],
            "evictions": reg["evictions"],
            "builds_total": sum(reg["builds"].values()),
            "leases_granted": reg["leases_granted"],
        }
        snap["fhe_table_cache_entries"] = table_cache_entries(
            self.lane_clients())
        return snap

    def lane_clients(self) -> list:
        """Every client currently serving a lane: the default-lane client
        plus each resident tenant session's (the table-cache probe set)."""
        return [self.client] + self.registry.resident_clients()

    def export_trace(self, path) -> dict:
        """Validate + write the Chrome trace JSON (Perfetto-loadable) for
        the current window; returns the trace dict."""
        return self.telemetry.export_chrome_trace(path)


class _Pending:
    """Sentinel: request exists but has no stored result yet."""

    def __repr__(self):
        return "<pending>"


_PENDING = _Pending()
