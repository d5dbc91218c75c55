"""Mesh worker: one process, one device, one full ``ClientService``.

Port of ``repro.fhe_client.service.worker``. Spawned by
``mesh.MeshRouter`` as ``python -m repro_torch.fhe_client.service.worker``;
connects back over localhost TCP, says HELLO, then serves SUBMIT /
EVAL_KEYS / SHUTDOWN frames one at a time (a worker is a single execution
lane — concurrency lives in the ROUTER fanning chunks across workers). A
reader thread takes frames off the socket as they arrive, so a router
sending a round of large chunks never waits on a worker busy replying.

Everything a worker needs to serve any lane it is handed derives
deterministically: the default lane's client is built from the exact
parameter set the router ships on the command line (seed included), and
named/anonymous lanes resolve through the service's own
``KeyContextRegistry`` (derived seeds from the full parameter
fingerprint + tenant id) — so no key material ever crosses the wire, in
either direction, yet every worker produces bit-identical ciphertexts
for the same (lane, nonce).

Nonce discipline: the worker's service runs under a ``LeaseAuthority``
nonce hook. The router grants each enc chunk a (base, count) range from
its central ledger and ships it in the frame; the authority hands that
base to the service's coalesce step and never touches the local client
counter — so a chunk retried on a different worker (after a mid-round
death) encrypts under the SAME lease, bit-identically.

Device: ``--device`` (default ``cuda``) is where the client, its tenant
lanes and every deserialized payload live. The service runs one stream on
that one device, so its batcher pads to the router's buckets and never to
a device multiple: each chunk is one job of exactly the leased count.
"""

from __future__ import annotations

import argparse
import os
import queue
import socket
import threading

import torch

from repro_torch.core.context import CKKSParams
from repro_torch.core.encryptor import CiphertextBatch, expand_seeded
from repro_torch.fhe_client.service import wire
from repro_torch.fhe_client.service.mesh import (ANON_LANE_ID,
                                                 DEFAULT_LANE_ID, OP_ERROR,
                                                 OP_EVAL_KEYS, OP_HELLO,
                                                 OP_RESULT, OP_SHUTDOWN,
                                                 OP_SUBMIT, recv_frame,
                                                 send_frame)


class LeaseAuthority:
    """Single-use router-granted nonce authority for a worker service.

    ``grant(base, count)`` arms the range the router leased for the next
    enc chunk; the service's ``_take_nonces`` consumes it exactly once.
    A flush that asks for a different count (bucket-config skew between
    router and worker) or leases without a pending grant is a protocol
    bug and raises loudly — silently inventing a base would break the
    never-reuse contract.
    """

    def __init__(self):
        self._grant = None

    def grant(self, base: int, count: int) -> None:
        if self._grant is not None:
            raise RuntimeError("nonce grant already pending — one enc "
                               "chunk must consume one grant")
        self._grant = (int(base), int(count))

    def clear(self) -> None:
        self._grant = None

    def __call__(self, lane, count: int) -> int:
        if self._grant is None:
            raise RuntimeError(
                f"no nonce grant pending for lane {lane!r} (count "
                f"{count}) — enc work must arrive as router chunks")
        base, expected = self._grant
        self._grant = None
        if int(count) != expected:
            raise RuntimeError(
                f"nonce grant mismatch for lane {lane!r}: router leased "
                f"{expected} nonces, local coalesce wants {count} — "
                f"router and worker bucket configs diverged")
        return base


def _read_frames(conn, frames: queue.Queue) -> None:
    """Reader thread: every frame off the socket into ``frames``, in order,
    then None at the end of the stream. The router sends every chunk of a
    round before it reads a reply; once frames outgrow the socket buffers
    (a chunk of 16 fresh ``paper`` ciphertexts is 201 MB), a worker that
    read only between chunks would block in its reply's ``sendall`` while
    the router blocks in a ``sendall`` to it. Reading here keeps the
    router's sends flowing while the worker computes or replies."""
    try:
        while True:
            frame = recv_frame(conn)
            if frame is None:
                return
            frames.put(frame)
            if frame[0] == OP_SHUTDOWN:
                return
    finally:
        frames.put(None)


class MeshWorker:
    """Frame loop + lane resolution over a local ``ClientService``."""

    def __init__(self, conn, worker_id: int, params: CKKSParams,
                 buckets, registry_capacity: int = 4,
                 die_after_submits: int | None = None, device=None):
        from repro_torch.fhe_client.client import FHEClient
        from repro_torch.fhe_client.service.service import ClientService
        self.conn = conn
        self.worker_id = worker_id
        self.authority = LeaseAuthority()
        client = FHEClient(profile=params, device=device)
        self.device = client.device
        # telemetry off: the ROUTER measures the transport; the worker's
        # job is to be a deterministic execution lane. One stream on the
        # client's one device: no device-multiple padding of the buckets.
        self.svc = ClientService(
            client=client, buckets=buckets, devices=[client.device],
            n_streams=1, telemetry=False,
            tenant_capacity=registry_capacity,
            nonce_authority=self.authority)
        self.die_after_submits = die_after_submits
        self._submits_seen = 0

    # -- lane resolution ----------------------------------------------------

    def _resolve(self, tid: str, params: CKKSParams):
        """Envelope identity -> (tenant, params) submit kwargs. The
        params-fingerprint check happens at this boundary: an envelope
        claiming the default lane under a different parameter set is a
        routing error, never a silent re-key."""
        if tid == DEFAULT_LANE_ID:
            if params != self.svc.client.ctx.params:
                raise ValueError(
                    f"default-lane envelope carries a different parameter "
                    f"fingerprint than this worker's default client "
                    f"(got {params}, serving "
                    f"{self.svc.client.ctx.params})")
            return None, None
        if tid == ANON_LANE_ID:
            return None, params
        return tid, params

    def _client_for(self, tenant, params):
        lane, _p = self.svc._resolve_lane(tenant, params)
        return self.svc._client_for(lane)

    # -- handlers -----------------------------------------------------------

    def _handle_submit(self, tag, aux, count, payload):
        tid, p, inner = wire.deserialize_tenant_envelope(payload)
        tenant, sp = self._resolve(tid, p)
        kind = wire.payload_kind(inner)
        if kind == wire.KIND_RESULT:
            # enc chunk: a (k, n_slots) complex message batch + the
            # router's nonce grant for its padded bucket
            msgs = wire.deserialize_result(inner)
            self.authority.grant(aux, count)
            rids = [self.svc.submit_encrypt(m, tenant=tenant, params=sp)
                    for m in msgs]
            self.svc.flush()
            rows = [self.svc.result(r) for r in rids]
            batch = CiphertextBatch(
                c0=torch.stack([r.c0 for r in rows]),
                c1=torch.stack([r.c1 for r in rows]),
                n_limbs=rows[0].n_limbs, scale=rows[0].scale)
            reply = wire.serialize_ciphertext_batch(batch)
        elif kind in (wire.KIND_CT_BATCH, wire.KIND_CT_SEEDED):
            if kind == wire.KIND_CT_SEEDED:
                ct = wire.deserialize_ciphertext_seeded(inner,
                                                        device=self.device)
                client = self._client_for(tenant, sp)
                # the paper's receiver-side a-regeneration: c1 never
                # crossed the wire; rebuild it from the lane's stream
                ct = expand_seeded(ct, client.ctx, seed=client.seed)
                triple = (ct.c0, ct.c1, float(ct.scale))
            else:
                batch = wire.deserialize_ciphertext_batch(inner,
                                                          device=self.device)
                if int(batch.c0.shape[0]) != 1:
                    raise ValueError(
                        f"dec chunks carry one ciphertext per frame, got "
                        f"a batch of {int(batch.c0.shape[0])}")
                triple = (batch.c0[0], batch.c1[0], float(batch.scale))
            rid = self.svc.submit_decrypt(triple, tenant=tenant, params=sp)
            self.svc.flush()
            reply = wire.serialize_result(self.svc.result(rid))
        else:
            raise ValueError(f"unsupported submit payload kind {kind}")
        send_frame(self.conn, OP_RESULT,
                   wire.serialize_tenant_envelope(tid, p, reply), tag=tag)

    def _handle_eval_keys(self, tag, aux, payload):
        tid, p, inner = wire.deserialize_tenant_envelope(payload)
        tenant, sp = self._resolve(tid, p)
        client = self._client_for(tenant, sp)
        rotations = tuple(int(x) for x in inner.decode("ascii").split(",")
                          if x)
        # seed pinned to the lane client's: every worker derives the
        # identical key-switching material (the router byte-compares)
        keys = client.make_evaluation_keys(
            rotations, include_relin=bool(aux & 1), seed=client.seed)
        send_frame(self.conn, OP_EVAL_KEYS,
                   wire.serialize_tenant_envelope(
                       tid, p, wire.serialize_evaluation_keys(keys)),
                   tag=tag)

    # -- frame loop ---------------------------------------------------------

    def serve(self):
        """Start the frame reader (``_read_frames`` on a thread), then
        handle the frames it queues, one at a time."""
        frames = queue.Queue()
        threading.Thread(target=_read_frames, args=(self.conn, frames),
                         name="mesh-frames", daemon=True).start()
        while True:
            frame = frames.get()
            if frame is None:
                return                      # router went away
            op, tag, aux, count, payload = frame
            if op == OP_SHUTDOWN:
                return
            if op == OP_SUBMIT:
                self._submits_seen += 1
                if self.die_after_submits is not None \
                        and self._submits_seen > self.die_after_submits:
                    # deterministic mid-round death: the chunk was read
                    # off the socket but never processed — the router
                    # sees EOF and must requeue it under the same lease
                    os._exit(17)
            try:
                if op == OP_SUBMIT:
                    self._handle_submit(tag, aux, count, payload)
                elif op == OP_EVAL_KEYS:
                    self._handle_eval_keys(tag, aux, payload)
                else:
                    raise ValueError(f"unknown frame op {op}")
            except Exception as e:  # noqa: BLE001 — reply, don't die
                self.authority.clear()
                send_frame(self.conn, OP_ERROR, repr(e).encode("utf-8"),
                           tag=tag)


def main(argv=None):
    ap = argparse.ArgumentParser(description="FHE client mesh worker")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--worker-id", type=int, required=True)
    ap.add_argument("--logn", type=int, required=True)
    ap.add_argument("--n-limbs", type=int, required=True)
    ap.add_argument("--decrypt-limbs", type=int, required=True)
    ap.add_argument("--delta-bits", type=int, required=True)
    ap.add_argument("--p-bw", type=int, required=True)
    ap.add_argument("--seed", type=lambda s: int(s, 0), required=True)
    ap.add_argument("--buckets", type=str, default="1,2,4,8,16")
    ap.add_argument("--registry-capacity", type=int, default=4)
    ap.add_argument("--die-after-submits", type=int, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of the worker's clients (default: "
                         "cuda)")
    args = ap.parse_args(argv)

    params = CKKSParams(logn=args.logn, n_limbs=args.n_limbs,
                        decrypt_limbs=args.decrypt_limbs,
                        delta_bits=args.delta_bits, p_bw=args.p_bw,
                        seed=args.seed)
    buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    conn = socket.create_connection(("127.0.0.1", args.port))
    try:
        # HELLO first: the router's startup wait ends here; the client
        # build (keygen, tables) below is paid before the first chunk
        # (a router send meanwhile waits in the socket until ``serve``
        # starts the reader)
        send_frame(conn, OP_HELLO, aux=args.worker_id)
        MeshWorker(conn, args.worker_id, params, buckets,
                   registry_capacity=args.registry_capacity,
                   die_after_submits=args.die_after_submits,
                   device=args.device).serve()
    finally:
        conn.close()


if __name__ == "__main__":
    main()
