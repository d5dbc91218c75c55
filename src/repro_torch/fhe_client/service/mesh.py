"""Multi-process service mesh: worker processes behind a tenant-routing
front-end, speaking the deterministic wire format over sockets.

Port of ``repro.fhe_client.service.mesh``: the same frame layout, op codes,
lane identities, chunking, nonce leasing and failure story, so a port
router can drive workers of either package. The mesh runs N worker
processes (``service.worker``), each running a full ``ClientService`` on
its device, behind a front-end ``MeshRouter`` that

  * accepts per-message submits exactly like ``ClientService`` (same
    validation, same lane resolution),
  * coalesces each lane's FIFO queue into chunks with the same bucket
    policy the single-process batcher uses,
  * leases every enc chunk's nonce range CENTRALLY from one
    ``NonceLedger`` (``lease_next``) — the single nonce authority for
    the whole fleet — and ships the granted base with the chunk,
  * routes each chunk by its kind-5 tenant-envelope lane identity and
    load-balances across the least-loaded live workers,
  * reassembles per-request results from the workers' replies.

The wire format is the only transport encoding: every data frame's
payload is a kind-5 tenant envelope wrapping kind 1/2/3/4 payloads (enc
submits travel as kind-3 complex message batches, dec submits as kind-1
full or kind-2 seeded ciphertexts — the seeded path is the paper's
a-regeneration trick, measured here as wire bytes/request — enc results
return as kind-1 batches, dec results as kind-3 rows, and evaluation keys
broadcast as kind 4). Secret keys never cross the boundary: workers derive
each lane's keys locally from the deterministic (params, tenant) seed
derivation, so only public/evaluation material is ever serialized.

Bit-transparency holds ACROSS the process boundary: chunks replicate the
solo batcher's FIFO grouping and padded-bucket nonce accounting, workers
run their leases through a router-granted ``nonce_authority`` instead of
local counters, and lane key material is a pure function of
(params, tenant id) — so every mesh result is bit-identical to the
single-process service from the same base nonce, whichever worker ran
it, retries after a worker death included (the re-sent chunk carries the
SAME granted base: same lease, same bytes).

Failure story: a worker dying mid-round (socket EOF, broken pipe, or
process exit) is detected in the router's completion loop, mirrored into
the ``FleetMonitor``, and every chunk in flight on it is re-sent verbatim
to a survivor. The monitor's straggler policy is polled from the same
loop.

Devices: ``device`` (default ``cuda``, the card) is where every worker
builds its client (passed as ``--device``) and where the router's results
land. A router for the card on a host without CUDA raises; nothing moves
to the CPU unless the caller passes ``device='cpu'``.

The router is single-threaded by design (one front-end thread submits
and flushes); workers process one chunk at a time.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import selectors
import socket
import struct
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core.context import CKKSParams, PROFILES
from repro_torch.core.encryptor import Ciphertext, CiphertextBatch
from repro_torch.distributed.elastic import FleetMonitor
from repro_torch.fhe_client.service import wire
from repro_torch.fhe_client.service.batcher import (CoalescingBatcher,
                                                    DEFAULT_BUCKETS, now,
                                                    row_words)
from repro_torch.fhe_client.service.faults import EventLog
from repro_torch.fhe_client.service.service import lane_fingerprint
from repro_torch.fhe_client.tenancy import NonceLedger, tenant_seed
from repro_torch.telemetry import MeshTelemetry

# --------------------------------------------------------------------------
# transport framing (the only layer added on top of the wire format:
# length + op + routing tag + nonce grant, all fixed little-endian)
# --------------------------------------------------------------------------

# payload_len u32, op u8, pad3, tag u64, aux u64 (nonce base / flags),
# count u32 (granted nonce count for enc chunks)
FRAME = struct.Struct("<IBxxxQQI")

OP_HELLO = 1       # worker -> router on connect; aux = worker id
OP_SUBMIT = 2      # router -> worker; payload = tenant envelope
OP_RESULT = 3      # worker -> router; payload = tenant envelope
OP_ERROR = 4       # worker -> router; payload = utf-8 error text
OP_EVAL_KEYS = 5   # both directions; payload = tenant envelope
OP_SHUTDOWN = 6    # router -> worker; clean exit

# Reserved lane ids for the envelope's tenant-id plane. User tenants
# may be any string EXCEPT these.
DEFAULT_LANE_ID = "__default__"   # the service's own default client lane
ANON_LANE_ID = "__anon__"         # anonymous tenant under non-default params
RESERVED_LANE_IDS = frozenset((DEFAULT_LANE_ID, ANON_LANE_ID))

_SEED128 = (1 << 128) - 1


class MeshError(RuntimeError):
    """Mesh-level failure (protocol violation, startup failure)."""


class AllWorkersFailed(MeshError):
    """Every worker process is dead; the mesh cannot make progress."""


class MeshRequestError(MeshError):
    """A request failed on its worker (raised by ``result(rid)``)."""

    def __init__(self, rid: int, detail: str):
        super().__init__(f"request {rid} failed in the mesh: {detail}")
        self.rid = rid
        self.detail = detail


def send_frame(sock, op: int, payload: bytes = b"", tag: int = 0,
               aux: int = 0, count: int = 0) -> int:
    """Write one frame; returns the payload length (for wire metrics)."""
    sock.sendall(FRAME.pack(len(payload), op, tag, aux, count) + payload)
    return len(payload)


def _recv_exact(sock, n: int) -> bytearray | None:
    """Read exactly n bytes into one buffer (no copy per read: a frame of
    fresh ciphertexts at N=2^16 is hundreds of MB); None on a clean EOF
    mid-read or at start."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            return None
        got += k
    return buf


def recv_frame(sock):
    """-> (op, tag, aux, count, payload) or None on EOF; the payload is a
    ``bytearray``."""
    hdr = _recv_exact(sock, FRAME.size)
    if hdr is None:
        return None
    n, op, tag, aux, count = FRAME.unpack(hdr)
    payload = _recv_exact(sock, n) if n else b""
    if n and payload is None:
        return None
    return op, tag, aux, count, payload


def lane_wire_identity(lane, default_params: CKKSParams):
    """(tenant-id plane, params) a lane travels under in a kind-5
    envelope. ``lane`` uses the service convention: None is the default
    lane, else ``(tenant_id, CKKSParams)`` with ``tenant_id=None`` for
    the anonymous non-default-params lane."""
    if lane is None:
        return DEFAULT_LANE_ID, default_params
    tenant_id, params = lane
    if tenant_id is None:
        return ANON_LANE_ID, params
    return str(tenant_id), params


def _masked(params: CKKSParams) -> CKKSParams:
    """Params with the seed masked to the 128-bit width the envelope
    carries, so lane comparisons agree on both sides of the wire."""
    m = int(params.seed) & _SEED128
    if m == params.seed:
        return params
    return dataclasses.replace(params, seed=m)


# --------------------------------------------------------------------------
# router
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Chunk:
    """One dispatched unit of work: its lane, rids, and the exact frame
    fields — kept so a retry after a worker death re-sends the SAME
    bytes (same nonce grant => bit-identical retried ciphertexts)."""
    tag: int
    lane: object
    kind: str                 # 'enc' | 'dec'
    wire_kind: int            # inner payload kind (metrics label)
    rids: tuple
    payload: bytes
    aux: int                  # granted nonce base (enc) or 0
    count: int                # granted nonce count (enc) or 0
    worker: int = -1
    t_sent: float = 0.0


class _WorkerHandle:
    """One worker process and its socket. ``t_spawn`` / ``t_hello`` /
    ``t_first_reply`` are the host clock (``now``) at spawn, at its HELLO
    and at its first answered chunk: the start-up cost ``stats()``
    reports."""

    def __init__(self, wid: int, proc, conn, t_spawn: float = 0.0):
        self.id = wid
        self.proc = proc
        self.conn = conn
        self.alive = True
        self.outstanding = 0
        self.t_spawn = t_spawn
        self.t_hello = now()
        self.t_first_reply: float | None = None


class MeshRouter:
    """Front-end of the multi-process service mesh.

    ``n_workers`` worker subprocesses are spawned on construction; each
    connects back over localhost TCP and says HELLO. Submits mirror the
    ``ClientService`` API (``submit_encrypt``/``submit_decrypt`` with
    ``tenant``/``params`` lanes, ``flush``, ``result``); decrypt submits
    additionally accept SEEDED ciphertexts, which travel as kind-2
    payloads (half the bytes) and are expanded worker-side — the
    measured version of the paper's upload-compression claim.

    ``worker_faults`` maps worker id -> number of SUBMIT frames after
    which that worker kills itself before handling the next one (the
    deterministic mid-round-death seam the recovery tests use).

    ``device`` (keyword-only, default ``cuda``) is the device every worker
    runs its client on and the router's results land on.
    """

    def __init__(self, n_workers: int = 2, profile="test",
                 buckets=DEFAULT_BUCKETS, *, seed: int | None = None,
                 telemetry: MeshTelemetry | bool | None = None,
                 worker_faults: dict | None = None,
                 registry_capacity: int = 4,
                 startup_timeout_s: float = 300.0,
                 flush_timeout_s: float = 600.0,
                 straggler_factor: float = 4.0,
                 straggler_patience: int = 2,
                 device=None):
        if n_workers < 1:
            raise ValueError(f"need >= 1 worker, got {n_workers}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the mesh runs its workers on the card but "
                               "CUDA is not available; pass device='cpu' "
                               "for a CPU mesh")
        p = profile if isinstance(profile, CKKSParams) else PROFILES[profile]
        if seed is not None:
            p = dataclasses.replace(p, seed=int(seed))
        self.params = _masked(p)
        self.batcher = CoalescingBatcher(buckets, pad_multiple=1)
        if isinstance(telemetry, MeshTelemetry):
            self.telemetry = telemetry
        else:
            self.telemetry = MeshTelemetry(
                enabled=True if telemetry is None else bool(telemetry))
        self.events = EventLog(clock=now)
        self.ledger = NonceLedger()
        self.monitor = FleetMonitor(
            n_hosts=n_workers, heartbeat_timeout=flush_timeout_s * 8,
            straggler_factor=straggler_factor,
            patience=straggler_patience, clock=now)
        self.flush_timeout_s = flush_timeout_s
        self._queues: dict[tuple, list] = {}   # (lane, kind) -> [(rid, obj)]
        self._results: dict[int, object] = {}
        self._failures: dict[int, MeshRequestError] = {}
        self._inflight: dict[int, _Chunk] = {}
        self._next_rid = 0
        self._tags = itertools.count(1)
        self._completed_total = 0
        self.requeues_total = 0
        self._closed = False
        self._sel = selectors.DefaultSelector()
        self.workers: dict[int, _WorkerHandle] = {}
        self._spawn_workers(n_workers, worker_faults or {},
                            registry_capacity, startup_timeout_s)

    # -- startup / shutdown -------------------------------------------------

    def _worker_cmd(self, wid: int, port: int, registry_capacity: int,
                    die_after: int | None):
        p = self.params
        cmd = [sys.executable, "-m", "repro_torch.fhe_client.service.worker",
               "--port", str(port), "--worker-id", str(wid),
               "--logn", str(p.logn), "--n-limbs", str(p.n_limbs),
               "--decrypt-limbs", str(p.decrypt_limbs),
               "--delta-bits", str(p.delta_bits), "--p-bw", str(p.p_bw),
               "--seed", str(p.seed),
               "--buckets", ",".join(str(b) for b in self.batcher.buckets),
               "--registry-capacity", str(registry_capacity),
               "--device", str(self.device)]
        if die_after is not None:
            cmd += ["--die-after-submits", str(die_after)]
        return cmd

    def _spawn_workers(self, n: int, faults: dict, registry_capacity: int,
                       timeout_s: float):
        """Start the workers as fresh interpreters (never a fork of this
        process) and wait for each HELLO. A failed start-up kills every
        worker it started before it raises."""
        import repro_torch
        env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(repro_torch.__file__))
        env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                                   if env.get("PYTHONPATH") else "")
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        procs, t_spawn = {}, {}
        try:
            lst.bind(("127.0.0.1", 0))
            lst.listen(n)
            lst.settimeout(timeout_s)
            port = lst.getsockname()[1]
            for wid in range(n):
                t_spawn[wid] = now()
                procs[wid] = subprocess.Popen(
                    self._worker_cmd(wid, port, registry_capacity,
                                     faults.get(wid)), env=env)
            for _ in range(n):
                try:
                    conn, _addr = lst.accept()
                except socket.timeout:
                    raise MeshError(
                        f"workers did not all connect within {timeout_s}s "
                        f"({len(self.workers)}/{n} up)") from None
                frame = recv_frame(conn)
                if frame is None or frame[0] != OP_HELLO \
                        or int(frame[2]) not in procs:
                    conn.close()
                    raise MeshError(f"bad worker handshake: {frame!r}")
                wid = int(frame[2])
                w = _WorkerHandle(wid, procs.pop(wid), conn, t_spawn[wid])
                self.workers[wid] = w
                self._sel.register(conn, selectors.EVENT_READ, w)
                self.events.record("worker_up", stream=wid)
        except BaseException:
            for proc in list(procs.values()) + [
                    w.proc for w in self.workers.values()]:
                proc.kill()
                proc.wait()
            for w in self.workers.values():
                w.conn.close()
            self._sel.close()
            raise
        finally:
            lst.close()
        # by worker id, whatever order the HELLOs came in
        self.workers = dict(sorted(self.workers.items()))
        self.telemetry.set_workers_alive(len(self.alive_workers))

    @property
    def alive_workers(self) -> list[int]:
        return [w.id for w in self.workers.values() if w.alive]

    def kill_worker(self, wid: int) -> None:
        """Hard-kill one worker process (tests: the external-death
        scenario — detection happens in the flush loop, not here)."""
        self.workers[wid].proc.kill()

    def close(self):
        if self._closed:
            return
        self._closed = True
        for w in self.workers.values():
            if w.alive:
                try:
                    send_frame(w.conn, OP_SHUTDOWN)
                except OSError:
                    pass
            w.conn.close()
        for w in self.workers.values():
            try:
                w.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait()
        self._sel.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()

    def _check_open(self):
        if self._closed:
            raise MeshError("router is closed")

    # -- lanes --------------------------------------------------------------

    def _resolve_lane(self, tenant, params):
        if params is None:
            p = self.params
        elif isinstance(params, CKKSParams):
            p = _masked(params)
        else:
            p = _masked(PROFILES[params])
        if tenant is not None and str(tenant) in RESERVED_LANE_IDS:
            raise ValueError(f"tenant id {tenant!r} is reserved for mesh "
                             f"lane routing")
        if tenant is None and p == self.params:
            return None, p
        return (tenant, p), p

    def _lane_seed(self, lane) -> int:
        """The Philox seed a lane's nonce accounting runs under — the
        default client's raw seed, or the registry's derived seed,
        exactly as the workers' clients will use them."""
        if lane is None:
            return self.params.seed
        tenant_id, params = lane
        return tenant_seed(params, tenant_id)

    # -- submission ---------------------------------------------------------

    def _admit(self, lane, kind: str, item) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queues.setdefault((lane, kind), []).append((rid, item))
        self.telemetry.on_submit(lane_fingerprint(lane), kind)
        return rid

    def submit_encrypt(self, message, *, tenant=None, params=None) -> int:
        """Queue one (n_slots,) complex message; same validation contract
        as ``ClientService.submit_encrypt``."""
        self._check_open()
        lane, p = self._resolve_lane(tenant, params)
        msg = np.asarray(message)
        if msg.ndim != 1:
            raise ValueError(f"message must be a 1-D (n_slots,) vector, "
                             f"got ndim={msg.ndim} shape {msg.shape}")
        if msg.shape[0] != p.n_slots:
            raise ValueError(f"message must hold {p.n_slots} slots for "
                             f"this lane's parameter set, got {msg.shape}")
        if not np.issubdtype(msg.dtype, np.number):
            raise ValueError(f"message dtype {msg.dtype} is not numeric")
        msg = msg.astype(np.complex128)
        if not (np.isfinite(msg.real).all() and np.isfinite(msg.imag).all()):
            raise ValueError("message contains non-finite values")
        return self._admit(lane, "enc", msg)

    def submit_decrypt(self, ct, *, tenant=None, params=None) -> int:
        """Queue one ciphertext for decrypt+decode. Accepts a full
        ``Ciphertext``, a (c0, c1, scale) triple of (>=2, N) word stacks
        (int32 tensors on any device, or uint32 / int32 arrays) — or a
        SEEDED ``Ciphertext`` (``c1=None`` with an ``a_stream``), which
        ships kind-2 at half the bytes and is expanded on the worker."""
        self._check_open()
        lane, p = self._resolve_lane(tenant, params)
        if isinstance(ct, Ciphertext) and ct.c1 is None:
            if ct.a_stream is None:
                raise ValueError("seeded ciphertext needs an a_stream id")
            inner = wire.serialize_ciphertext_seeded(ct)
            return self._admit(lane, "dec", inner)
        if isinstance(ct, Ciphertext):
            c0, c1, scale = ct.c0, ct.c1, ct.scale
        elif isinstance(ct, (tuple, list)) and len(ct) == 3:
            c0, c1, scale = ct
        else:
            raise ValueError(
                "submit_decrypt takes a Ciphertext or a (c0, c1, "
                f"scale) triple, got {type(ct).__name__}")
        for name, poly in (("c0", c0), ("c1", c1)):
            shape = np.shape(poly)
            if len(shape) != 2 or shape[0] < 2 or shape[1] != p.n:
                raise ValueError(f"decrypt {name} must be a (>=2, N={p.n}) "
                                 f"limb stack, got shape {shape}")
            row_words(poly)           # int32 / uint32 words, else raises
        if not np.isfinite(scale) or scale <= 0:
            raise ValueError(f"decrypt scale must be positive finite, "
                             f"got {scale!r}")
        batch = CiphertextBatch(c0=c0[None], c1=c1[None],
                                n_limbs=int(np.shape(c0)[0]),
                                scale=float(scale))
        return self._admit(lane, "dec", wire.serialize_ciphertext_batch(batch))

    # -- dispatch -----------------------------------------------------------

    def _pick_worker(self) -> _WorkerHandle:
        alive = [w for w in self.workers.values() if w.alive]
        if not alive:
            raise AllWorkersFailed("no live worker to dispatch to")
        return min(alive, key=lambda w: (w.outstanding, w.id))

    def _send_chunk(self, chunk: _Chunk, requeue_from: int | None = None):
        """Dispatch one chunk to the least-loaded survivor. If NO
        survivor exists the chunk's requests are failed (recorded per
        rid) BEFORE ``AllWorkersFailed`` propagates — a request must
        never vanish without a stored failure."""
        while True:
            try:
                w = self._pick_worker()
            except AllWorkersFailed:
                self._fail_chunk(chunk, "every worker died")
                raise
            chunk.worker = w.id
            chunk.t_sent = now()
            try:
                n = send_frame(w.conn, OP_SUBMIT, chunk.payload,
                               tag=chunk.tag, aux=chunk.aux,
                               count=chunk.count)
            except OSError as e:
                # the dead worker's OTHER in-flight chunks requeue here
                # too (this chunk is not in _inflight yet, so it cannot
                # be double-sent); recursion is bounded by the fleet size
                try:
                    self._worker_died(w, f"send failed: {e!r}")
                except AllWorkersFailed:
                    self._fail_chunk(chunk, "every worker died")
                    raise
                continue
            w.outstanding += 1
            self._inflight[chunk.tag] = chunk
            self.telemetry.on_chunk(w.id, chunk.kind)
            self.telemetry.on_frame(w.id, chunk.wire_kind, "send", n)
            if requeue_from is not None:
                self.telemetry.on_requeue(requeue_from)
                self.requeues_total += 1
                self.events.record("requeue", stream=w.id, rids=chunk.rids,
                                   detail=f"re-sent chunk {chunk.tag} from "
                                          f"dead worker {requeue_from} "
                                          f"under the same nonce grant")
            return

    def _pump(self):
        """Coalesce every lane queue into chunks and dispatch them. Enc
        chunks replicate the solo batcher's FIFO grouping and padded
        nonce accounting: groups of at most max_bucket, each leasing
        ``bucket_for(k)`` nonces from the central ledger. All leases are
        taken BEFORE any send — the lease sequence is a pure function of
        the submission order, never of worker-death timing."""
        chunks = []
        for key in list(self._queues):
            lane, kind = key
            q = self._queues[key]
            if not q:
                continue
            self._queues[key] = []
            tid, p = lane_wire_identity(lane, self.params)
            if kind == "enc":
                seed = self._lane_seed(lane)
                for i in range(0, len(q), self.batcher.max_bucket):
                    group = q[i:i + self.batcher.max_bucket]
                    b = self.batcher.bucket_for(len(group))
                    lease = self.ledger.lease_next(seed, b)
                    inner = wire.serialize_result(
                        np.stack([m for _rid, m in group]))
                    chunks.append(_Chunk(
                        tag=next(self._tags), lane=lane, kind="enc",
                        wire_kind=wire.KIND_RESULT,
                        rids=tuple(rid for rid, _m in group),
                        payload=wire.serialize_tenant_envelope(tid, p,
                                                               inner),
                        aux=lease.base, count=lease.count))
            else:
                for rid, inner in q:
                    chunks.append(_Chunk(
                        tag=next(self._tags), lane=lane, kind="dec",
                        wire_kind=wire.payload_kind(inner), rids=(rid,),
                        payload=wire.serialize_tenant_envelope(tid, p,
                                                               inner),
                        aux=0, count=0))
        fleet_gone = None
        for chunk in chunks:
            if fleet_gone is not None:
                self._fail_chunk(chunk, "every worker died")
                continue
            try:
                self._send_chunk(chunk)
            except AllWorkersFailed as e:
                fleet_gone = e
        if fleet_gone is not None:
            raise fleet_gone

    # -- completion ---------------------------------------------------------

    def _worker_died(self, w: _WorkerHandle, detail: str,
                     requeue: bool = True):
        if not w.alive:
            return
        w.alive = False
        w.outstanding = 0
        self._sel.unregister(w.conn)   # registered once, while alive
        w.conn.close()
        self.monitor.mark_failed(w.id)
        self.telemetry.set_workers_alive(len(self.alive_workers))
        self.events.record("worker_failed", stream=w.id, detail=detail)
        if not requeue:
            return
        orphans = [c for c in self._inflight.values() if c.worker == w.id]
        for chunk in orphans:
            del self._inflight[chunk.tag]
        fleet_gone = None
        for chunk in orphans:
            if fleet_gone is not None:
                # no survivor will reappear: fail the rest immediately
                # (the first failed chunk was recorded by _send_chunk)
                self._fail_chunk(chunk, "every worker died")
                continue
            try:
                self._send_chunk(chunk, requeue_from=w.id)
            except AllWorkersFailed as e:
                fleet_gone = e
        if fleet_gone is not None:
            raise fleet_gone

    def _fail_chunk(self, chunk: _Chunk, detail: str):
        for rid in chunk.rids:
            self._failures[rid] = MeshRequestError(rid, detail)
        self._completed_total += len(chunk.rids)

    def _handle_reply(self, w: _WorkerHandle, frame):
        op, tag, _aux, _count, payload = frame
        chunk = self._inflight.pop(tag, None)
        if chunk is None:
            # a retried chunk's ORIGINAL worker may still answer after
            # its replacement already did — but its socket is closed the
            # moment it is marked dead, so an unknown tag here is a
            # protocol violation, not a late duplicate
            raise MeshError(f"worker {w.id} answered unknown chunk {tag}")
        w.outstanding -= 1
        t = now()
        if w.t_first_reply is None:
            w.t_first_reply = t
        dt = t - chunk.t_sent
        self.monitor.heartbeat(w.id)
        self.monitor.report_step_time(w.id, dt)
        if op == OP_ERROR:
            self.telemetry.on_frame(w.id, "ctl", "recv", len(payload))
            self._fail_chunk(chunk, payload.decode("utf-8", "replace"))
            return
        if op != OP_RESULT:
            raise MeshError(f"worker {w.id} sent unexpected op {op} for "
                            f"chunk {tag}")
        try:
            tid, p, inner = wire.deserialize_tenant_envelope(payload)
            want_tid, want_p = lane_wire_identity(chunk.lane, self.params)
            if tid != want_tid or p != want_p:
                raise MeshError(
                    f"reply lane mismatch: chunk {tag} belongs to lane "
                    f"{want_tid!r} but worker {w.id} answered for {tid!r}")
            kind = wire.payload_kind(inner)
            self.telemetry.on_frame(w.id, kind, "recv", len(payload))
            if chunk.kind == "enc":
                batch = wire.deserialize_ciphertext_batch(
                    inner, device=self.device)
                if int(batch.c0.shape[0]) != len(chunk.rids):
                    raise MeshError(
                        f"enc chunk {tag}: expected {len(chunk.rids)} "
                        f"result rows, got {int(batch.c0.shape[0])}")
                for i, rid in enumerate(chunk.rids):
                    self._results[rid] = Ciphertext(
                        c0=batch.c0[i], c1=batch.c1[i],
                        n_limbs=batch.n_limbs, scale=batch.scale)
            else:
                z = wire.deserialize_result(inner)
                self._results[chunk.rids[0]] = z[0]
            self._completed_total += len(chunk.rids)
        except (ValueError, MeshError) as e:
            self._fail_chunk(chunk, f"malformed reply: {e}")

    def _service_conn(self, w: _WorkerHandle):
        try:
            frame = recv_frame(w.conn)
        except OSError as e:
            self._worker_died(w, f"recv failed: {e!r}")
            return
        if frame is None:
            self._worker_died(w, "connection closed (EOF)")
            return
        self._handle_reply(w, frame)

    def _wait_inflight(self, timeout_s: float | None):
        deadline = now() + (timeout_s if timeout_s is not None
                            else self.flush_timeout_s)
        while self._inflight:
            if not self.alive_workers:
                for chunk in list(self._inflight.values()):
                    del self._inflight[chunk.tag]
                    self._fail_chunk(chunk, "every worker died")
                raise AllWorkersFailed("every worker died with chunks in "
                                       "flight")
            for key, _ev in self._sel.select(timeout=0.25):
                self._service_conn(key.data)
            # liveness bookkeeping: idle workers are not suspects; a
            # worker sitting on chunks past the heartbeat budget is.
            # Straggler streaks are polled every iteration — many polls
            # per completed chunk, which the idempotent accounting makes
            # exact instead of patience-defeating.
            for w in self.workers.values():
                if w.alive and w.outstanding == 0:
                    self.monitor.heartbeat(w.id)
            for wid in self.monitor.check_failures():
                w = self.workers[wid]
                if w.alive:
                    self._worker_died(w, "heartbeat timeout")
            for wid in self.monitor.stragglers():
                self.events.record("straggler", stream=wid,
                                   detail="fleet-monitor straggler policy")
            if now() > deadline:
                raise TimeoutError(
                    f"mesh flush did not complete within "
                    f"{timeout_s if timeout_s is not None else self.flush_timeout_s}s "
                    f"({len(self._inflight)} chunks in flight)")

    def flush(self, timeout_s: float | None = None) -> int:
        """Dispatch everything queued and wait for all replies; returns
        how many requests completed (failures included)."""
        self._check_open()
        done0 = self._completed_total
        self._pump()
        self._wait_inflight(timeout_s)
        return self._completed_total - done0

    def result(self, rid: int):
        """Result for a request id (consumed on retrieval); flushes if
        the request is still queued. Raises ``MeshRequestError`` for
        requests that failed worker-side."""
        self._check_open()
        if rid in self._failures:
            raise self._failures[rid]
        if rid in self._results:
            return self._results.pop(rid)
        if rid >= self._next_rid:
            raise KeyError(f"unknown request id {rid}")
        queued = any(r == rid for q in self._queues.values() for r, _ in q)
        inflight = any(rid in c.rids for c in self._inflight.values())
        if not queued and not inflight:
            raise KeyError(f"request {rid} has no stored result and is "
                           f"not queued (already retrieved?)")
        self.flush()
        if rid in self._failures:
            raise self._failures[rid]
        if rid not in self._results:
            raise KeyError(f"request {rid} did not complete in flush")
        return self._results.pop(rid)

    # -- key distribution ---------------------------------------------------

    def evaluation_keys(self, rotations=(), include_relin: bool = True, *,
                        tenant=None, params=None):
        """Broadcast an evaluation-key request for one lane to EVERY live
        worker and require byte-identical kind-4 replies — the
        cross-process determinism pin on key derivation (same lane =>
        same derived seed => same keys on every worker). Only evaluation
        material crosses the wire; returns the deserialized
        ``EvaluationKeys`` on the router's device."""
        self._check_open()
        if self._inflight:
            raise MeshError("evaluation_keys needs an idle mesh "
                            "(flush first)")
        lane, p = self._resolve_lane(tenant, params)
        tid, p = lane_wire_identity(lane, self.params)
        csv = ",".join(str(int(r)) for r in rotations).encode("ascii")
        payload = wire.serialize_tenant_envelope(tid, p, csv)
        replies = {}
        for w in self.workers.values():
            if not w.alive:
                continue
            tag = next(self._tags)
            n = send_frame(w.conn, OP_EVAL_KEYS, payload, tag=tag,
                           aux=1 if include_relin else 0)
            self.telemetry.on_frame(w.id, "ctl", "send", n)
            frame = recv_frame(w.conn)
            if frame is None:
                self._worker_died(w, "connection closed during eval-key "
                                     "broadcast")
                continue
            op, rtag, _aux, _count, reply = frame
            if op == OP_ERROR:
                raise MeshError(f"worker {w.id} failed the eval-key "
                                f"request: {reply.decode('utf-8', 'replace')}")
            if op != OP_EVAL_KEYS or rtag != tag:
                raise MeshError(f"worker {w.id} sent unexpected reply "
                                f"(op={op}, tag={rtag}) to eval-key "
                                f"request {tag}")
            self.telemetry.on_frame(w.id, wire.KIND_EVAL_KEYS, "recv",
                                    len(reply))
            replies[w.id] = reply
        if not replies:
            raise AllWorkersFailed("no live worker answered the eval-key "
                                   "broadcast")
        first = next(iter(replies.values()))
        if any(reply != first for reply in replies.values()):
            raise MeshError(
                f"evaluation keys diverged across workers "
                f"{sorted(replies)} — key derivation is not deterministic")
        rtid, rp, inner = wire.deserialize_tenant_envelope(first)
        if rtid != tid or rp != p:
            raise MeshError("eval-key reply lane mismatch")
        return wire.deserialize_evaluation_keys(inner, device=self.device)

    # -- introspection ------------------------------------------------------

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def stats(self) -> dict:
        return {
            "workers": len(self.workers),
            "alive_workers": self.alive_workers,
            "inflight_chunks": len(self._inflight),
            "queued": self.pending(),
            "completed": self._completed_total,
            "failed_requests": len(self._failures),
            "requeues": self.requeues_total,
            "leases_granted": self.ledger.leases_granted,
            "events": len(self.events),
            "wire": self.telemetry.wire_report(),
            # host seconds from each worker's spawn to its HELLO and to
            # its first answered chunk (None before one)
            "startup_s": {
                w.id: {"hello": w.t_hello - w.t_spawn,
                       "first_reply": None if w.t_first_reply is None
                       else w.t_first_reply - w.t_spawn}
                for w in self.workers.values()},
        }
