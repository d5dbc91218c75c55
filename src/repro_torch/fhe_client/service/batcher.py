"""Request queue + coalescing batcher for the FHE client service.

Port of ``repro.fhe_client.service.batcher``. Decrypt jobs stack their
rows with ``torch.stack`` on the lane client's device (rows that sit on
another device move there with ``.to``; a CUDA row is first recorded on
the stream that reads it, so the caching allocator never hands its memory
to the stream that wrote it while the stack is still pending).

Per-message encode/encrypt and decrypt/decode requests arrive one at a
time (the paper's client serves a stream of activations, not pre-formed
batches). The batcher coalesces each FIFO queue into batch *jobs* padded
to a small fixed set of bucketed batch shapes, so the client kernels
only ever see a handful of (B, ...) input shapes — after the buckets are
warm, no job ever builds a table or a kernel again (the GPU analogue of
the ASIC's fixed streaming datapath configuration).

Job payloads are the batched client containers: encrypt jobs carry the
padded slot-domain message batch (the pre-encode ``PlaintextBatch``
source), decrypt jobs carry a 2-limb ``CiphertextBatch`` (int32 words)
plus a per-row scale stack. Padding is appended at the tail only and the
fused kernels
are row-independent, so padded rows never perturb real rows.

Nonce discipline: every row of a padded encrypt batch — real or padding —
consumes one nonce (row r of a job encrypts under ``job.nonce0 + r``,
exactly the fused kernel's layout). The service reserves the whole padded
range from the client's counter, which makes each message's ciphertext a
pure function of (seed, its assigned nonce): bit-identical to a direct
``encode_encrypt_batch`` call from the same base, whatever bucket or
padding it rode in.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.encryptor import CiphertextBatch

DEFAULT_BUCKETS = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class Request:
    """One queued client op. ``payload``: (n_slots,) complex message for
    'enc'; (c0 (>=2, N), c1 (>=2, N), scale) for 'dec', c0 / c1 int32
    tensors or uint32 / int32 arrays of words. ``tenant`` is the
    lane key — ``(tenant_id, CKKSParams)`` under a multi-tenant service,
    None for the anonymous single-tenant default — and is an isolation
    boundary: coalescing refuses to mix lanes in one bucket."""
    rid: int
    kind: str                    # 'enc' | 'dec'
    payload: object
    t_submit: float
    tenant: object = None        # lane key; None = default tenant
    span: object = None          # telemetry span context (None when the
                                 # request is unsampled or tracing is off)


@dataclasses.dataclass(frozen=True)
class EncJob:
    """Padded encode+encrypt batch job (slot-domain plaintext batch)."""
    messages: np.ndarray         # (bucket, n_slots) complex128, tail-padded
    nonce0: int                  # row r encrypts under nonce0 + r
    rids: tuple                  # request ids of the len(rids) real rows
    t_submits: tuple             # submit timestamp per real row
    kind: str = "enc"
    tenant: object = None        # lane key this whole bucket belongs to
    spans: tuple = ()            # telemetry span per real row (Nones ok)
    t_coalesce: float = 0.0      # when this job was coalesced (0 = unset)

    @property
    def bucket(self) -> int:
        return self.messages.shape[0]

    @property
    def n_real(self) -> int:
        return len(self.rids)


@dataclasses.dataclass(frozen=True)
class DecJob:
    """Padded decrypt+decode batch job over a 2-limb ciphertext batch."""
    cts: CiphertextBatch         # (bucket, 2, N) int32 stacks, tail-padded
    scales: np.ndarray           # (bucket, 1) f64 per-row scales
    rids: tuple
    t_submits: tuple
    kind: str = "dec"
    tenant: object = None        # lane key this whole bucket belongs to
    spans: tuple = ()            # telemetry span per real row (Nones ok)
    t_coalesce: float = 0.0      # when this job was coalesced (0 = unset)

    @property
    def bucket(self) -> int:
        return int(self.cts.c0.shape[0])

    @property
    def n_real(self) -> int:
        return len(self.rids)


class CoalescingBatcher:
    """FIFO coalescing into bucketed batch shapes.

    ``pad_multiple`` is the stream shard count (devices per stream group):
    every bucket is rounded up to a multiple of it so batch axes always
    divide the device group the scheduler splits rows over.
    """

    def __init__(self, buckets=DEFAULT_BUCKETS, pad_multiple: int = 1):
        if pad_multiple < 1:
            raise ValueError("pad_multiple must be >= 1")
        rounded = sorted({
            -(-int(b) // pad_multiple) * pad_multiple for b in buckets
            if int(b) > 0
        })
        if not rounded:
            raise ValueError(f"no usable buckets in {buckets!r}")
        self.buckets = tuple(rounded)
        self.pad_multiple = pad_multiple

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, k: int) -> int:
        """Smallest bucket holding k requests (k <= max_bucket)."""
        for b in self.buckets:
            if b >= k:
                return b
        raise ValueError(f"{k} requests exceed max bucket {self.max_bucket}")

    def _drain(self, queue: deque, allow_partial: bool = True, tenant=None):
        """FIFO groups of at most max_bucket requests. With
        ``allow_partial=False`` a trailing group smaller than max_bucket
        is left queued (the dispatch loop's 'full buckets fire
        immediately, partial tails wait for their deadline' split).

        Lane membership is validated BEFORE a group is popped: a raise
        must leave the queue intact, so the requests stay reachable by
        the service's queued-failure handling (``flush``/crash paths
        fail what is *in* a queue — requests popped and then abandoned
        would strand their waiters)."""
        while queue:
            if len(queue) < self.max_bucket and not allow_partial:
                break
            take = min(len(queue), self.max_bucket)
            group = [queue[i] for i in range(take)]
            self._check_lane(group, tenant)
            for _ in range(take):
                queue.popleft()
            yield group

    @staticmethod
    def _check_lane(reqs, tenant):
        """Every request drained into one bucket must belong to the lane
        being coalesced — a bucket is one kernel launch under ONE tenant's
        keys and nonce lease, so cross-tenant mixing is an isolation
        violation, not a batching inefficiency. Raises instead of
        splitting: a mixed queue means the admission layer is broken."""
        for r in reqs:
            if r.tenant != tenant:
                raise ValueError(
                    f"cross-tenant coalesce: request {r.rid} belongs to "
                    f"lane {r.tenant!r} but this queue drains lane "
                    f"{tenant!r} — buckets never mix tenants or parameter "
                    f"sets")

    def coalesce_enc(self, queue: deque, nonce0: int, n_slots: int,
                     allow_partial: bool = True, tenant=None):
        """Drain an encrypt queue into EncJobs. Returns (jobs, n_nonces):
        the caller reserves ``n_nonces`` consecutive nonces at ``nonce0``
        from the LANE's client (padded rows included)."""
        jobs, used = [], 0
        for reqs in self._drain(queue, allow_partial, tenant):
            b = self.bucket_for(len(reqs))
            msgs = np.zeros((b, n_slots), np.complex128)
            for i, r in enumerate(reqs):
                msgs[i] = r.payload
            jobs.append(EncJob(
                messages=msgs, nonce0=nonce0 + used,
                rids=tuple(r.rid for r in reqs),
                t_submits=tuple(r.t_submit for r in reqs),
                tenant=tenant,
                spans=tuple(r.span for r in reqs), t_coalesce=now()))
            used += b
        return jobs, used

    def coalesce_dec(self, queue: deque, allow_partial: bool = True,
                     tenant=None, device=None):
        """Drain a decrypt queue into DecJobs stacked on ``device`` (default:
        the first row's device). Tail padding repeats the first real row
        (any valid ciphertext row works — padded outputs are dropped at
        demux)."""
        jobs = []
        for reqs in self._drain(queue, allow_partial, tenant):
            b = self.bucket_for(len(reqs))
            rows = [r.payload for r in reqs]
            rows += [rows[0]] * (b - len(rows))
            # payload rows may sit on different devices (encrypt results
            # fed straight back for decryption): each moves to the target
            c0 = stack_rows([r[0] for r in rows], device)
            c1 = stack_rows([r[1] for r in rows], device)
            scales = np.asarray([[float(r[2])] for r in rows])
            jobs.append(DecJob(
                cts=CiphertextBatch(c0=c0, c1=c1, n_limbs=2,
                                    scale=float(rows[0][2])),
                scales=scales,
                rids=tuple(r.rid for r in reqs),
                t_submits=tuple(r.t_submit for r in reqs),
                tenant=tenant,
                spans=tuple(r.span for r in reqs), t_coalesce=now()))
        return jobs


def now() -> float:
    """Submit/latency timestamp source: ``time.monotonic`` so deadline
    math (max-wait firing, job timeouts, latency percentiles) survives
    wall-clock jumps — NTP steps must never fire or starve a bucket."""
    return time.monotonic()


def oldest_age(queue: deque, t_now: float) -> float:
    """Seconds the queue's oldest (FIFO head) request has been waiting;
    0.0 for an empty queue. Input to the partial-round firing policy."""
    if not queue:
        return 0.0
    return t_now - queue[0].t_submit


def row_words(x, n_limbs: int = 2):
    """The first ``n_limbs`` limbs of one ciphertext row as an int32 tensor
    (a view of a tensor; uint32 / int32 arrays are reinterpreted)."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise TypeError(f"ciphertext words must be int32, got {x.dtype}")
        return x[:n_limbs]
    a = np.ascontiguousarray(np.asarray(x)[:n_limbs])
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"ciphertext words must be uint32 or int32, got "
                        f"{a.dtype}")
    return torch.from_numpy(a.view(np.int32))


def stack_rows(rows, device=None, n_limbs: int = 2) -> torch.Tensor:
    """Stack ciphertext rows (their first ``n_limbs`` limbs) into one
    (len(rows), n_limbs, N) int32 tensor on ``device`` (default: the first
    row's). A CUDA row is recorded on the stream the stack (or the copy
    off its device) runs on: the row's memory belongs to the stream that
    wrote it, and must not be reused there while this read is pending."""
    words = [row_words(r, n_limbs) for r in rows]
    device = words[0].device if device is None else torch.device(device)
    moved = []
    for w in words:
        if w.is_cuda:
            w.record_stream(torch.cuda.current_stream(w.device))
        moved.append(w if w.device == device else w.to(device))
    return torch.stack(moved)
