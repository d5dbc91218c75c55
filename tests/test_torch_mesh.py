"""The port's service mesh on the CPU: ``MeshRouter`` and its worker
processes (``repro_torch.fhe_client.service.{mesh,worker}``).

Mirrors ``tests/test_service_mesh.py`` at ``tiny`` with buckets (1, 2, 4),
every router built with ``device='cpu'`` (each worker runs its client on
the CPU: the plain versions):

* **bit-transparency across the process boundary** — mesh encrypts are
  bit-identical to the port's single-process ``ClientService`` from the
  same base nonce (central ledger lease == solo batcher accounting), per
  lane and for a chunk of every bucket size;
* **tenant routing over kind-5 envelopes**, the default-lane fingerprint
  check at the worker boundary, submit validation;
* **mid-round worker death** — the router re-sends the same bytes under
  the same nonce grant to a survivor, and the results stay bit-identical;
* **key distribution** — evaluation keys broadcast to every worker come
  back byte-identical and equal the local client's;
* ``LeaseAuthority`` and ``ClientService(nonce_authority=...)``;
* **a mixed fleet**: worker 0 runs the port, worker 1 the JAX package's
  worker (``python -m repro.fhe_client.service.worker``, without FMA
  contraction: ``XLA_FLAGS=--xla_cpu_max_isa=AVX``), behind the port's
  router. Encrypts spread over both equal the port's solo service, the
  two workers' evaluation keys are byte-identical (the router compares
  them), and after worker 0 is killed mid-round the JAX worker re-runs its
  chunk under the same lease, bit-identically. That worker is the file's
  one JAX process; the port's package names no JAX module, only this
  test does.

The port's solo service is itself held against the JAX ``ClientService``
word for word in ``tests/test_torch_slice.py``. Tolerance: 0 (decoded
slots against their messages: 1e-6, as the reference's tests).

Ordering note: the module-scoped router and solo service share per-lane
nonce accounting only when each lane's first encrypt goes through both
in the same test, so the bit-identity tests run first for their lane
(pytest runs a file in definition order).
"""

import dataclasses
import os
import queue
import signal
import socket
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.context import PROFILES
from repro_torch.core.encoder import encode
from repro_torch.core.encryptor import (Ciphertext, encrypt_symmetric_seeded,
                                        expand_seeded)
from repro_torch.fhe_client.client import FHEClient
from repro_torch.fhe_client.service import (AllWorkersFailed, ClientService,
                                            MeshRequestError, MeshRouter,
                                            wire)
from repro_torch.fhe_client.service.mesh import (ANON_LANE_ID,
                                                 DEFAULT_LANE_ID, OP_SHUTDOWN,
                                                 OP_SUBMIT, _Chunk,
                                                 lane_wire_identity,
                                                 send_frame)
from repro_torch.fhe_client.service.worker import (LeaseAuthority,
                                                   _read_frames)

TINY = PROFILES["tiny"]
BUCKETS = (1, 2, 4)
CPU = "cpu"
# the JAX worker's environment: no FMA contraction in its df32 code, no
# accelerator
JAX_WORKER_ENV = {"XLA_FLAGS": "--xla_cpu_max_isa=AVX",
                  "JAX_PLATFORMS": "cpu"}


def _msgs(b, seed=0):
    rng = np.random.default_rng(seed)
    n = TINY.n_slots
    return (rng.standard_normal((b, n))
            + 1j * rng.standard_normal((b, n))) * 0.5


def _ct_equal(a, b) -> bool:
    return (torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)
            and a.n_limbs == b.n_limbs and a.scale == b.scale)


def _solo_from(base, msgs):
    """The port's single-process service on a same-seed client whose
    counter starts at ``base``: the mesh's rows from that lease base."""
    client = FHEClient("tiny", device=CPU)
    client.nonce = base
    return ClientService(client=client, buckets=BUCKETS,
                         n_streams=1).encrypt_many(msgs)


def _assert_rows_equal(got, solo):
    for i, ct in enumerate(got):
        assert torch.equal(ct.c0, solo.c0[i]), i
        assert torch.equal(ct.c1, solo.c1[i]), i
        assert ct.n_limbs == solo.n_limbs and ct.scale == solo.scale


@pytest.fixture(scope="module")
def mesh():
    """2-worker mesh, module-scoped: every routing/identity test shares
    one fleet."""
    with MeshRouter(n_workers=2, profile="tiny", buckets=BUCKETS,
                    device=CPU) as m:
        yield m


@pytest.fixture(scope="module")
def local():
    """In-process client under the SAME params the workers run — the
    solo side of every bit-identity comparison."""
    return FHEClient(profile="tiny", device=CPU)


@pytest.fixture(scope="module")
def solo_svc(local):
    """Single-process service sharing the mesh's bucket config; its
    per-lane nonce accounting starts at 0 exactly like the router's
    central ledger."""
    return ClientService(client=local, buckets=BUCKETS, n_streams=1)


# ---------------------------------------------------------------------------
# bit-transparency across the process boundary
# ---------------------------------------------------------------------------


def test_mesh_encrypt_bit_identical_to_solo(mesh, local, solo_svc):
    """5 messages -> FIFO groups of (4, 1) -> central leases (0..3, 4):
    the mesh ciphertexts must equal the single-process service's bit for
    bit, whichever worker encrypted each chunk, and land on the router's
    device."""
    msgs = _msgs(5, seed=1)
    rids = [mesh.submit_encrypt(m) for m in msgs]
    assert mesh.flush() == 5
    got = [mesh.result(r) for r in rids]
    assert all(ct.c0.device.type == CPU for ct in got)
    _assert_rows_equal(got, solo_svc.encrypt_many(msgs))
    st = mesh.stats()
    assert st["failed_requests"] == 0 and st["leases_granted"] >= 2


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_mesh_chunk_of_every_bucket_matches_solo(mesh, solo_svc, k):
    """One chunk of k messages (buckets 1, 2, 4, 4 — padded for k=3) is
    one worker job of exactly the leased count, == the solo service."""
    msgs = _msgs(k, seed=30 + k)
    base = mesh.ledger.watermark(mesh.params.seed)
    rids = [mesh.submit_encrypt(m) for m in msgs]
    mesh.flush()
    assert mesh.ledger.watermark(mesh.params.seed) == \
        base + mesh.batcher.bucket_for(k)
    _assert_rows_equal([mesh.result(r) for r in rids],
                       solo_svc.encrypt_many(msgs))


def test_mesh_decrypt_full_and_seeded_bit_identical(mesh, local):
    """The seeded kind-2 path (c1 regenerated worker-side from the lane
    stream) must decode identically to the same ciphertext shipped full
    as kind-1 — and at measurably fewer wire bytes."""
    z = _msgs(1, seed=2)[0]
    pt = encode(z, local.ctx, device=CPU)
    sct = encrypt_symmetric_seeded(pt, local.keys.sk, local.ctx, nonce=123)
    fct = expand_seeded(sct, local.ctx)

    rid_s = mesh.submit_decrypt(sct)
    rid_f = mesh.submit_decrypt((fct.c0, fct.c1, fct.scale))
    mesh.flush()
    zs, zf = mesh.result(rid_s), mesh.result(rid_f)
    np.testing.assert_array_equal(zs, zf)      # bit-identical decode
    np.testing.assert_allclose(zs, z, atol=1e-6)

    # the compression is visible on the measured transport: kind-2
    # submit bytes < kind-1 submit bytes for the same ciphertext
    wb = mesh.telemetry.wire_bytes
    seeded = sum(wb.value(worker=w, kind=wire.KIND_CT_SEEDED, dir="send")
                 for w in mesh.workers)
    full = sum(wb.value(worker=w, kind=wire.KIND_CT_BATCH, dir="send")
               for w in mesh.workers)
    assert 0 < seeded < full


def test_mesh_decrypt_uint32_words_match_solo(mesh, local, solo_svc):
    """A (c0, c1, scale) triple of uint32 arrays decrypts through the
    mesh exactly as through the solo service."""
    z = _msgs(1, seed=11)[0]
    ct = FHEClient("tiny", device=CPU).encode_encrypt_batch(z[None])[0]
    words = [t.numpy().view(np.uint32) for t in (ct.c0, ct.c1)]
    rid = mesh.submit_decrypt((words[0], words[1], ct.scale))
    srid = solo_svc.submit_decrypt((words[0], words[1], ct.scale))
    solo_svc.flush()
    np.testing.assert_array_equal(mesh.result(rid), solo_svc.result(srid))


def test_mesh_seeded_rejects_missing_stream(mesh, local):
    bare = Ciphertext(c0=torch.zeros((3, TINY.n), dtype=torch.int32),
                      c1=None, n_limbs=3, scale=2.0 ** 40, a_stream=None)
    with pytest.raises(ValueError, match="a_stream"):
        mesh.submit_decrypt(bare)


# ---------------------------------------------------------------------------
# tenant routing over kind-5 envelopes
# ---------------------------------------------------------------------------


def test_mesh_tenant_coresident_matches_solo(mesh, solo_svc):
    """Interleaved tenants through the mesh == each tenant alone through
    a single-process service: the kind-5 lane identity reaches the right
    worker-side key context and the per-lane leases stay independent of
    the cross-lane interleave."""
    alice, bob = _msgs(3, seed=3), _msgs(2, seed=4)
    rids_a = [mesh.submit_encrypt(m, tenant="alice") for m in alice]
    rids_b = [mesh.submit_encrypt(m, tenant="bob") for m in bob]
    mesh.flush()
    got_a = [mesh.result(r) for r in rids_a]
    got_b = [mesh.result(r) for r in rids_b]

    solo_a = [solo_svc.submit_encrypt(m, tenant="alice") for m in alice]
    solo_b = [solo_svc.submit_encrypt(m, tenant="bob") for m in bob]
    solo_svc.flush()
    for got, solo in ((got_a, solo_a), (got_b, solo_b)):
        for ct, rid in zip(got, solo):
            assert _ct_equal(ct, solo_svc.result(rid))
    # distinct lanes, distinct key streams: alice's first ct != bob's
    assert not torch.equal(got_a[0].c0, got_b[0].c0)


def test_mesh_reserved_lane_ids_rejected(mesh):
    for tid in (DEFAULT_LANE_ID, ANON_LANE_ID):
        with pytest.raises(ValueError, match="reserved"):
            mesh.submit_encrypt(_msgs(1)[0], tenant=tid)


def test_mesh_submit_validation_matches_service(mesh):
    with pytest.raises(ValueError, match="1-D"):
        mesh.submit_encrypt(_msgs(2, seed=5))            # 2-D batch
    with pytest.raises(ValueError, match="slots"):
        mesh.submit_encrypt(np.zeros(TINY.n_slots + 1, complex))
    with pytest.raises(ValueError, match="non-finite"):
        bad = np.zeros(TINY.n_slots, complex)
        bad[0] = np.nan
        mesh.submit_encrypt(bad)
    with pytest.raises(ValueError, match="not numeric"):
        mesh.submit_encrypt(np.array(["x"] * TINY.n_slots))
    with pytest.raises(ValueError, match="Ciphertext"):
        mesh.submit_decrypt("not a ciphertext")
    with pytest.raises(ValueError, match="limb stack"):
        mesh.submit_decrypt((np.zeros((2, TINY.n + 1), np.uint32),
                             np.zeros((2, TINY.n), np.uint32), 2.0 ** 40))
    with pytest.raises(TypeError, match="uint32"):
        mesh.submit_decrypt((np.zeros((2, TINY.n)), np.zeros((2, TINY.n)),
                             2.0 ** 40))
    with pytest.raises(ValueError, match="scale"):
        words = np.zeros((2, TINY.n), np.uint32)
        mesh.submit_decrypt((words, words, -1.0))
    with pytest.raises(KeyError):
        mesh.result(10_000_000)


def test_mesh_result_consumed_once(mesh):
    rid = mesh.submit_encrypt(_msgs(1, seed=6)[0])
    mesh.result(rid)                           # flushes + retrieves
    with pytest.raises(KeyError, match="already retrieved"):
        mesh.result(rid)


def test_mesh_fingerprint_mismatch_rejected_at_worker_boundary(mesh):
    """A kind-5 envelope claiming the DEFAULT lane under a different
    parameter fingerprint must come back as an error reply from the
    worker (never silently served under the worker's own keys). The
    router never emits such an envelope, so this dispatches a crafted
    chunk through its transport seam."""
    bad_p = dataclasses.replace(mesh.params, seed=mesh.params.seed + 1)
    inner = wire.serialize_result(_msgs(1, seed=7))
    rid = mesh._next_rid
    mesh._next_rid += 1
    mesh._send_chunk(_Chunk(
        tag=next(mesh._tags), lane=None, kind="enc",
        wire_kind=wire.KIND_RESULT, rids=(rid,),
        payload=wire.serialize_tenant_envelope(DEFAULT_LANE_ID, bad_p,
                                               inner),
        aux=0, count=1))
    mesh.flush()
    with pytest.raises(MeshRequestError, match="parameter"):
        mesh.result(rid)
    # the worker survives the rejection and keeps serving
    rid2 = mesh.submit_encrypt(_msgs(1, seed=8)[0])
    mesh.flush()
    mesh.result(rid2)


def test_lane_wire_identity_mapping(mesh):
    p = mesh.params
    assert lane_wire_identity(None, p) == (DEFAULT_LANE_ID, p)
    assert lane_wire_identity((None, p), p) == (ANON_LANE_ID, p)
    assert lane_wire_identity(("alice", p), p) == ("alice", p)


# ---------------------------------------------------------------------------
# key distribution
# ---------------------------------------------------------------------------


def test_mesh_eval_keys_consensus_and_local_match(mesh, local):
    """The broadcast requires byte-identical kind-4 replies from every
    worker, and the consensus keys equal the local client's derivation —
    same lane => same derived material on every process."""
    keys = mesh.evaluation_keys(rotations=(1, 2), include_relin=True)
    assert keys.relin is not None and sorted(keys.rot) == [1, 2]
    assert keys.relin.b_mont.device.type == CPU
    ours = local.make_evaluation_keys((1, 2), include_relin=True,
                                      seed=local.seed)
    assert wire.serialize_evaluation_keys(keys) == \
        wire.serialize_evaluation_keys(ours)


def test_mesh_startup_times_reported(mesh):
    """Each worker's host seconds from spawn to HELLO and to its first
    answered chunk are in ``stats()``."""
    st = mesh.stats()["startup_s"]
    assert sorted(st) == [0, 1]
    for t in st.values():
        assert 0 < t["hello"] <= t["first_reply"]


# ---------------------------------------------------------------------------
# mid-round worker death
# ---------------------------------------------------------------------------


def test_mesh_worker_kill_recovery_bit_identical(local):
    """Worker 0 exits after READING its first submit frame (before
    handling): the router must detect the EOF, re-send the orphaned
    chunks verbatim to the survivor, and the results must still be
    bit-identical to a single-process service — the same nonce grant
    travels with the re-sent chunk."""
    with MeshRouter(n_workers=2, profile="tiny", buckets=BUCKETS,
                    worker_faults={0: 0}, device=CPU) as m:
        msgs = _msgs(5, seed=9)
        rids = [m.submit_encrypt(x) for x in msgs]
        assert m.flush() == 5
        got = [m.result(r) for r in rids]

        assert m.alive_workers == [1]
        st = m.stats()
        assert st["requeues"] >= 1 and st["failed_requests"] == 0
        assert [e.kind for e in m.events.replay(kind="worker_failed")] \
            == ["worker_failed"]
        assert len(m.events.replay(kind="requeue")) == st["requeues"]
        _assert_rows_equal(got, _solo_from(0, msgs))

        # the surviving single-worker mesh still serves decrypts
        rid = m.submit_decrypt((got[0].c0, got[0].c1, got[0].scale))
        np.testing.assert_allclose(m.result(rid), msgs[0], atol=1e-6)


def test_mesh_all_workers_dead_fails_loudly(local):
    with MeshRouter(n_workers=1, profile="tiny", buckets=BUCKETS,
                    worker_faults={0: 0}, device=CPU) as m:
        rid = m.submit_encrypt(_msgs(1, seed=10)[0])
        with pytest.raises(AllWorkersFailed):
            m.flush()
        with pytest.raises(MeshRequestError):
            m.result(rid)
        assert m.stats()["alive_workers"] == []


def test_worker_reader_takes_frames_while_the_worker_is_busy():
    """The worker's reader thread takes every frame off the socket while
    nothing handles them (the worker computing or blocked in its own
    reply): a router sending a round of frames far larger than the socket
    buffers is never blocked by it. Then SHUTDOWN ends the stream."""
    router, worker = socket.socketpair()
    frames = queue.Queue()
    reader = threading.Thread(target=_read_frames, args=(worker, frames),
                              daemon=True)
    reader.start()
    try:
        router.settimeout(30)
        payloads = [bytes([i]) * (8 << 20) for i in range(3)]
        for tag, payload in enumerate(payloads):
            send_frame(router, OP_SUBMIT, payload, tag=tag, aux=7, count=16)
        send_frame(router, OP_SHUTDOWN)
        reader.join(timeout=30)
        assert not reader.is_alive()
        got = [frames.get_nowait() for _ in range(5)]
    finally:
        router.close()
        worker.close()
    assert [g[:4] for g in got[:3]] == [(OP_SUBMIT, t, 7, 16)
                                        for t in range(3)]
    assert [bytes(g[4]) for g in got[:3]] == payloads
    assert got[3][0] == OP_SHUTDOWN and got[4] is None


# ---------------------------------------------------------------------------
# the nonce authority
# ---------------------------------------------------------------------------


def test_lease_authority_grant_is_used_once():
    auth = LeaseAuthority()
    auth.grant(40, 4)
    assert auth(None, 4) == 40
    with pytest.raises(RuntimeError, match="no nonce grant pending"):
        auth(None, 4)


def test_lease_authority_count_mismatch_raises():
    auth = LeaseAuthority()
    auth.grant(8, 4)
    with pytest.raises(RuntimeError, match="grant mismatch"):
        auth(("alice", TINY), 2)
    with pytest.raises(RuntimeError, match="no nonce grant pending"):
        auth(None, 4)                 # a mismatched grant is consumed


def test_lease_authority_lease_without_grant_raises():
    with pytest.raises(RuntimeError, match="no nonce grant pending"):
        LeaseAuthority()(None, 1)


def test_lease_authority_second_pending_grant_raises():
    auth = LeaseAuthority()
    auth.grant(0, 1)
    with pytest.raises(RuntimeError, match="already pending"):
        auth.grant(1, 1)
    auth.clear()
    auth.grant(1, 1)
    assert auth(None, 1) == 1


def test_service_nonce_authority_is_the_only_lease_source():
    """``ClientService(nonce_authority=f)`` leases every job's base from
    ``f`` (the lane client's counter and the ledger stay put, tenant
    lanes included), and ``warm_up()`` / ``start()`` never call it."""
    calls = []

    def authority(lane, count):
        calls.append((lane, count))
        return 1000 * len(calls)

    client = FHEClient("tiny", device=CPU)
    svc = ClientService(client=client, buckets=BUCKETS, n_streams=1,
                        nonce_authority=authority)
    svc.registry.get("alice", TINY)
    assert svc.warm_up() > 0 and calls == []
    msgs = _msgs(3, seed=12)
    rids = [svc.submit_encrypt(m) for m in msgs]
    arid = svc.submit_encrypt(msgs[0], tenant="alice")
    svc.flush()
    assert calls == [(None, 4), (("alice", TINY), 1)]
    assert client.nonce == 0
    assert svc.registry.ledger.leases_granted == 0
    assert svc.registry.get("alice", TINY).client.nonce == 0
    _assert_rows_equal([svc.result(r) for r in rids], _solo_from(1000, msgs))
    alice = FHEClient(TINY, seed=svc.registry.get("alice", TINY).seed,
                      device=CPU)
    alice.nonce = 2000
    assert _ct_equal(svc.result(arid),
                     alice.encode_encrypt_batch(msgs[:1])[0])
    svc.start()
    svc.stop()
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# a mixed fleet: a port worker and a JAX worker behind the port's router
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed():
    """Worker 0 is the port's; worker 1 is the JAX package's, started
    with the reference's arguments (no ``--device``) and without FMA
    contraction."""
    orig = MeshRouter._worker_cmd

    def worker_cmd(self, wid, port, registry_capacity, die_after):
        cmd = orig(self, wid, port, registry_capacity, die_after)
        if wid != 1:
            return cmd
        i = cmd.index("--device")
        del cmd[i:i + 2]
        cmd[cmd.index("repro_torch.fhe_client.service.worker")] = \
            "repro.fhe_client.service.worker"
        return cmd

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MeshRouter, "_worker_cmd", worker_cmd)
        for k, v in JAX_WORKER_ENV.items():
            mp.setenv(k, v)
        router = MeshRouter(n_workers=2, profile="tiny", buckets=BUCKETS,
                            device=CPU)
    assert [router.workers[i].proc.args[2] for i in (0, 1)] == [
        "repro_torch.fhe_client.service.worker",
        "repro.fhe_client.service.worker"]
    with router:
        yield router


def test_mixed_fleet_encrypts_match_solo(mixed):
    """12 messages -> three chunks of 4, sent to the least-loaded worker:
    both the port's and the JAX worker encrypt, and every row equals the
    port's solo service from the same lease base."""
    msgs = _msgs(12, seed=40)
    rids = [mixed.submit_encrypt(m) for m in msgs]
    assert mixed.flush() == 12
    chunks = mixed.telemetry.chunks
    assert chunks.value(worker=0, kind="enc") >= 1
    assert chunks.value(worker=1, kind="enc") >= 1
    _assert_rows_equal([mixed.result(r) for r in rids], _solo_from(0, msgs))


def test_mixed_fleet_eval_keys_byte_identical(mixed, local):
    """The router requires byte-identical kind-4 replies: the JAX worker's
    keys == the port worker's == the local port client's."""
    keys = mixed.evaluation_keys(rotations=(1,), include_relin=True)
    ours = local.make_evaluation_keys((1,), include_relin=True,
                                      seed=local.seed)
    assert wire.serialize_evaluation_keys(keys) == \
        wire.serialize_evaluation_keys(ours)


def test_mixed_fleet_jax_worker_reruns_killed_chunk(mixed):
    """Worker 0 (the port's) is stopped, handed chunks, then killed: the
    JAX worker re-runs them under the same leases, bit-identically, and
    then decrypts for the degraded fleet."""
    base = mixed.ledger.watermark(mixed.params.seed)
    msgs = _msgs(8, seed=41)
    rids = [mixed.submit_encrypt(m) for m in msgs]
    # stopped before the round: it cannot answer any chunk it is sent
    os.kill(mixed.workers[0].proc.pid, signal.SIGSTOP)
    mixed._pump()
    assert mixed.workers[0].outstanding >= 1
    mixed.kill_worker(0)
    assert mixed.flush() == 8
    st = mixed.stats()
    assert mixed.alive_workers == [1]
    assert st["requeues"] >= 1 and st["failed_requests"] == 0
    assert [e.kind for e in mixed.events.replay(kind="worker_failed")] \
        == ["worker_failed"]
    got = [mixed.result(r) for r in rids]
    _assert_rows_equal(got, _solo_from(base, msgs))
    rid = mixed.submit_decrypt((got[0].c0, got[0].c1, got[0].scale))
    np.testing.assert_allclose(mixed.result(rid), msgs[0], atol=1e-6)


# ---------------------------------------------------------------------------
# scaling soak
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_mesh_multi_worker_soak_with_midround_kill():
    """3 workers, three lanes, a hard kill while chunks are in flight,
    then the full loop: every ciphertext encrypted by the (degraded)
    mesh decrypts back through the mesh to its message."""
    with MeshRouter(n_workers=3, profile="tiny", buckets=BUCKETS,
                    device=CPU) as m:
        lanes = {None: _msgs(6, seed=20), "alice": _msgs(6, seed=21),
                 "bob": _msgs(6, seed=22)}
        rids = {lane: [m.submit_encrypt(x, tenant=lane) for x in zs]
                for lane, zs in lanes.items()}
        m._pump()                          # dispatch: chunks now in flight
        victim = next(w.id for w in m.workers.values()
                      if w.alive and w.outstanding)
        m.kill_worker(victim)
        m.flush()
        assert victim not in m.alive_workers
        assert len(m.alive_workers) == 2
        cts = {lane: [m.result(r) for r in rs]
               for lane, rs in rids.items()}

        drids = {lane: [m.submit_decrypt((ct.c0, ct.c1, ct.scale),
                                         tenant=lane) for ct in row]
                 for lane, row in cts.items()}
        m.flush()
        for lane, zs in lanes.items():
            for i, dr in enumerate(drids[lane]):
                np.testing.assert_allclose(m.result(dr), zs[i], atol=1e-6)

        st = m.stats()
        assert st["failed_requests"] == 0
        assert st["wire"]["requests"] == 36
        assert st["wire"]["send_bytes"] > 0 and st["wire"]["recv_bytes"] > 0
