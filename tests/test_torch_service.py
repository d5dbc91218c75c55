"""The port's client service on the CPU: batcher/bucketing invariants,
scheduler policy/execution agreement, the sharded entry points, and the
determinism contract — anything encrypted or decrypted through the service
(any bucket, padding, stream, 2-device group, or nonce base across the
2^32 wrap) is bit-identical to the port's direct batched client.

Mirrors ``tests/test_client_service.py``. Its two-device subprocess cases
run here in-process on logical CPU devices: ``[torch.device('cpu')] * 2``
as two streams of one device each, or as one stream whose rows split over
both. Clients run on the CPU (``device='cpu'``: the plain versions).
Tolerance: 0.
"""

from collections import deque

import numpy as np
import pytest
import torch

from repro_torch.core import scheduler as policy
from repro_torch.core.encryptor import CiphertextBatch
from repro_torch.distributed import sharding as shd
from repro_torch.fhe_client.client import FHEClient
from repro_torch.fhe_client.service import (DEFAULT_BUCKETS, ClientService,
                                            CoalescingBatcher, Request)
from repro_torch.fhe_client.service.batcher import stack_rows
from repro_torch.kernels import ops as kops
from repro_torch.telemetry import table_cache_entries

CPU = torch.device("cpu")
WRAP = 2 ** 32 - 5


def _msgs(client, b, seed=0):
    rng = np.random.default_rng(seed)
    n = client.ctx.params.n_slots
    return (rng.standard_normal((b, n))
            + 1j * rng.standard_normal((b, n))) * 0.5


@pytest.fixture(scope="module")
def svc_client():
    return FHEClient("tiny", device="cpu")


@pytest.fixture(scope="module")
def twin():
    """A second client with the same seed: the direct path from a pinned
    nonce base without touching the service client's counter."""
    return FHEClient("tiny", device="cpu")


def _direct(twin, msgs, base):
    twin.nonce = base
    return twin.encode_encrypt_batch(msgs)


def _assert_cts(rows_c0, rows_c1, direct):
    assert torch.equal(rows_c0, direct.c0) and torch.equal(rows_c1, direct.c1)


# ---------------------------------------------------------------------------
# batcher units
# ---------------------------------------------------------------------------


def test_batcher_buckets_nonces_and_fifo():
    b = CoalescingBatcher(buckets=(2, 4))
    assert b.bucket_for(1) == 2 and b.bucket_for(3) == 4
    with pytest.raises(ValueError):
        b.bucket_for(5)
    q = deque(Request(rid=i, kind="enc", payload=np.full(4, i + 0j),
                      t_submit=float(i)) for i in range(6))
    jobs, used = b.coalesce_enc(q, nonce0=100, n_slots=4)
    assert not q and used == 6
    assert [j.bucket for j in jobs] == [4, 2]
    assert jobs[0].rids == (0, 1, 2, 3) and jobs[1].rids == (4, 5)
    assert jobs[0].nonce0 == 100 and jobs[1].nonce0 == 104
    q2 = deque([Request(rid=9, kind="enc", payload=np.full(4, 7 + 0j),
                        t_submit=0.0)])
    (job,), used2 = b.coalesce_enc(q2, nonce0=0, n_slots=4)
    assert used2 == 2 and job.bucket == 2 and job.n_real == 1
    np.testing.assert_array_equal(job.messages[1], np.zeros(4, complex))
    assert CoalescingBatcher(buckets=(1, 2, 3), pad_multiple=2).buckets \
        == (2, 4)
    assert DEFAULT_BUCKETS == (1, 2, 4, 8, 16)


def test_batcher_dec_stacks_rows_and_pads_with_row_zero():
    """Decrypt rows (int32 tensors of >= 2 limbs, or uint32 arrays) stack
    into a (bucket, 2, N) int32 batch with ``torch.stack``; tail padding
    repeats row 0; per-row scales follow."""
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2 ** 32, (3, 3, 8), dtype=np.uint32)
    rows = [(torch.from_numpy(words[0].view(np.int32)),
             torch.from_numpy(words[1].view(np.int32)), 4.0),
            (words[1], words[2], 8.0),
            (words[2][:2], words[0][:2], 2.0)]
    q = deque(Request(rid=i, kind="dec", payload=r, t_submit=0.0)
              for i, r in enumerate(rows))
    (job,) = CoalescingBatcher(buckets=(4,)).coalesce_dec(q, device=CPU)
    assert job.bucket == 4 and job.n_real == 3
    assert job.cts.c0.dtype == torch.int32
    got = job.cts.c0.numpy().view(np.uint32)
    np.testing.assert_array_equal(got[:3], words[[0, 1, 2], :2])
    np.testing.assert_array_equal(got[3], words[0, :2])
    np.testing.assert_array_equal(job.scales[:, 0], [4.0, 8.0, 2.0, 4.0])
    with pytest.raises(TypeError, match="uint32"):
        stack_rows([np.zeros((2, 8), np.float64)])


# ---------------------------------------------------------------------------
# service <-> direct bit-identity
# ---------------------------------------------------------------------------


def test_service_encrypt_bit_identical_any_bucket(svc_client):
    """3 messages through bucket-2 jobs (one padded) == one direct B=3
    call from the same nonce base, bit for bit."""
    cl = svc_client
    msgs = _msgs(cl, 3, seed=1)
    base = cl.nonce
    direct = cl.encode_encrypt_batch(msgs)
    cl.nonce = base
    svc = ClientService(client=cl, buckets=(2,))
    cts = svc.encrypt_many(msgs)
    _assert_cts(cts.c0, cts.c1, direct)
    assert [r.bucket for r in svc.dispatch_log] == [2, 2]
    assert [r.kind for r in svc.dispatch_log] == ["enc", "enc"]


def test_service_decrypt_bit_identical(svc_client):
    cl = svc_client
    direct = cl.encode_encrypt_batch(_msgs(cl, 5, seed=2))
    ref = cl.decrypt_decode_batch(direct.truncated(2))
    svc = ClientService(client=cl, buckets=(2, 4))
    got = svc.decrypt_many(direct.truncated(2))   # jobs: bucket 4 + 2(pad)
    np.testing.assert_array_equal(got, ref)
    assert [r.bucket for r in svc.dispatch_log] == [4, 2]
    n = cl.ctx.params.n
    with pytest.raises(ValueError, match="limb stack"):
        svc.submit_decrypt((np.zeros((1, n), np.uint32),
                            np.zeros((1, n), np.uint32), 1.0))


def test_e2e_mixed_requests_and_policy_agreement(svc_client):
    """Mixed enc/dec requests return bit-identical results, and the
    dispatch log replays exactly ``core.scheduler.plan_rounds`` (one stream
    on the client's one device)."""
    cl = svc_client
    msgs = _msgs(cl, 5, seed=3)
    base = cl.nonce
    direct = cl.encode_encrypt_batch(msgs)
    ref_dec = cl.decrypt_decode_batch(direct.truncated(2))
    cl.nonce = base
    svc = ClientService(client=cl, buckets=(2,))
    enc_rids = [svc.submit_encrypt(m) for m in msgs]
    dec_rids = [svc.submit_decrypt(row) for row in direct.truncated(2)]
    assert svc.pending() == {"enc": 5, "dec": 5}
    assert svc.flush() == 10 and svc.pending() == {"enc": 0, "dec": 0}
    for i, rid in enumerate(enc_rids):
        row = svc.result(rid)
        assert torch.equal(row.c0, direct.c0[i])
        assert torch.equal(row.c1, direct.c1[i])
    got_dec = np.stack([svc.result(r) for r in dec_rids])
    np.testing.assert_array_equal(got_dec, ref_dec)
    assert svc.scheduler.modes_executed() == policy.plan_rounds(3, 3, 1)
    assert svc.scheduler.n_streams == 1
    assert {r.stream for r in svc.dispatch_log} == {0}
    assert all(svc.latency(r) > 0 for r in enc_rids + dec_rids)
    stats = svc.stats()
    assert stats["jobs_dispatched"] == 6 and stats["rounds"] == 6
    with pytest.raises(KeyError, match="already retrieved"):
        svc.result(enc_rids[0])
    with pytest.raises(KeyError, match="unknown"):
        svc.result(10 ** 6)
    svc.reset_telemetry()
    assert svc.stats()["jobs_dispatched"] == 0


def test_no_rebuild_across_same_bucket_jobs(svc_client):
    """Bucketed coalescing means a warm service does no new build work:
    after warm-up, jobs of the same buckets (any real/padded composition)
    leave the table-cache odometer where it was, and on the CPU no CUDA
    wrapper counts a launch (the plain versions ran)."""
    cl = svc_client
    svc = ClientService(client=cl, buckets=(2,))
    assert svc.warm_up() == 2                 # (enc, dec) x bucket 2
    assert svc.warm_up() == 0                 # idempotent per lane
    kops.reset_launches()
    warm = table_cache_entries(svc.lane_clients())
    cts = svc.encrypt_many(_msgs(cl, 3, seed=5))      # 2 jobs, one padded
    svc.decrypt_many(cts.truncated(2))                # 2 jobs, one padded
    assert table_cache_entries(svc.lane_clients()) == warm
    assert not any(kops.launches().values())


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 16, 17])
def test_multi_bucket_identity_sweep(svc_client, twin, k):
    """Every request count over the default buckets (1, 2, 4, 8, 16),
    padding included, reproduces the direct batched ciphertexts and
    decodes bit for bit from the same nonce base."""
    cl = svc_client
    svc = ClientService(client=cl)
    msgs = _msgs(cl, k, seed=100 + k)
    base = cl.nonce
    direct = _direct(twin, msgs, base)
    ref_dec = twin.decrypt_decode_batch(direct.truncated(2))
    cts = svc.encrypt_many(msgs)
    _assert_cts(cts.c0, cts.c1, direct)
    np.testing.assert_array_equal(svc.decrypt_many(direct.truncated(2)),
                                  ref_dec)
    want = []
    rest = k
    while rest:
        take = min(rest, 16)
        want.append(next(b for b in DEFAULT_BUCKETS if b >= take))
        rest -= take
    assert [r.bucket for r in svc.dispatch_log if r.kind == "enc"] == want
    assert cl.nonce == base + sum(want)       # padding rows take nonces


# ---------------------------------------------------------------------------
# sharded entry points and logical 2-device groups
# ---------------------------------------------------------------------------


def test_shard_nonce_base_wraps_mod_2_32():
    assert kops.shard_nonce_base(7, 0, 4) == 7
    assert kops.shard_nonce_base(7, 3, 4) == 19
    assert kops.shard_nonce_base(2 ** 32 - 2, 1, 4) == 2
    assert kops.shard_nonce_base(2 ** 33 + 1, 2, 3) == 7
    assert kops.shard_rows(6, 3) == 2
    with pytest.raises(ValueError, match="does not divide"):
        kops.shard_rows(5, 2)


@pytest.mark.parametrize("nonce0", [7, WRAP])
def test_sharded_ops_bit_identical_two_devices(svc_client, nonce0):
    ctx, keys = svc_client.ctx, svc_client.keys
    rng = np.random.default_rng(0)
    pt = torch.from_numpy(rng.integers(
        0, ctx.q_list[0], (4, ctx.params.n_limbs, ctx.params.n),
        dtype=np.uint32).view(np.int32))
    devices = [CPU] * 2
    c0s, c1s = kops.encrypt_fused_sharded(pt, keys.pk.b_mont, keys.pk.a_mont,
                                          ctx, devices, nonce0=nonce0)
    c0r, c1r = kops.encrypt_fused(pt, keys.pk.b_mont, keys.pk.a_mont, ctx,
                                  nonce0=nonce0)
    assert torch.equal(c0s, c0r) and torch.equal(c1s, c1r)
    ms = kops.decrypt_fused_sharded(c0s[:, :2], c1s[:, :2], keys.sk.s_mont,
                                    ctx, devices)
    mr = kops.decrypt_fused(c0r[:, :2], c1r[:, :2], keys.sk.s_mont, ctx)
    assert torch.equal(ms, mr)
    with pytest.raises(ValueError, match="does not divide"):
        kops.encrypt_fused_sharded(pt[:3], keys.pk.b_mont, keys.pk.a_mont,
                                   ctx, devices)
    with pytest.raises(ValueError):
        shd.stream_groups(devices, n_streams=3)


def test_dual_stream_two_logical_devices(svc_client, twin):
    """Two streams over two logical devices: 2xENC / 2xDEC rounds use both
    streams, results stay bit-identical, and encrypt results fed straight
    back for decryption round-trip."""
    cl = svc_client
    msgs = _msgs(cl, 4, seed=6)
    svc = ClientService(client=cl, buckets=(2,), devices=[CPU] * 2,
                        n_streams=2)
    assert svc.scheduler.n_streams == 2 and svc.scheduler.pad_multiple == 1
    base = cl.nonce
    direct = _direct(twin, msgs, base)
    ref_dec = twin.decrypt_decode_batch(direct.truncated(2))
    cts = svc.encrypt_many(msgs)                       # 2 enc jobs: 2xENC
    _assert_cts(cts.c0, cts.c1, direct)
    np.testing.assert_array_equal(svc.decrypt_many(direct.truncated(2)),
                                  ref_dec)             # 2xDEC
    rounds = {}
    for rec in svc.dispatch_log:
        rounds.setdefault(rec.round, set()).add(rec.stream)
    assert any(len(s) >= 2 for s in rounds.values())
    modes = svc.stats()["modes"]
    assert "2xENC" in modes and "2xDEC" in modes, modes
    rids = [svc.submit_encrypt(m) for m in msgs]
    svc.flush()
    rows = [svc.result(r) for r in rids]
    drids = [svc.submit_decrypt(row) for row in rows]
    svc.flush()
    out = np.stack([svc.result(r) for r in drids])
    assert np.max(np.abs(out - msgs)) < 1e-3


@pytest.mark.parametrize("nonce0", [None, WRAP])
def test_sharded_stream_two_logical_devices(svc_client, twin, nonce0):
    """One stream whose rows split over two logical devices (buckets padded
    to a multiple of 2; shard s under ``nonce0 + s*rows``) == the unsharded
    direct path, also across the 2^32 nonce wrap."""
    cl = svc_client
    if nonce0 is not None:
        cl.nonce = nonce0
    msgs = _msgs(cl, 5, seed=7)
    svc = ClientService(client=cl, buckets=(1, 4), devices=[CPU] * 2,
                        n_streams=1)
    assert svc.scheduler.pad_multiple == 2
    assert svc.batcher.buckets == (2, 4)
    base = cl.nonce
    direct = _direct(twin, msgs, base)
    ref_dec = twin.decrypt_decode_batch(direct.truncated(2))
    cts = svc.encrypt_many(msgs)
    _assert_cts(cts.c0, cts.c1, direct)
    np.testing.assert_array_equal(svc.decrypt_many(direct.truncated(2)),
                                  ref_dec)
    assert [r.bucket for r in svc.dispatch_log] == [4, 2, 4, 2]


def test_service_across_nonce_wrap(svc_client, twin):
    """A job whose rows straddle 2^32: row r under (nonce0 + r) mod 2^32,
    as the direct path and the JAX client's uint32 nonces."""
    cl = svc_client
    cl.nonce = WRAP
    msgs = _msgs(cl, 8, seed=8)
    svc = ClientService(client=cl, buckets=(8,), devices=[CPU] * 2,
                        n_streams=2, oversubscribe=True)
    direct = _direct(twin, msgs, WRAP)
    cts = svc.encrypt_many(msgs)
    _assert_cts(cts.c0, cts.c1, direct)
    assert cl.nonce == WRAP + 8


def test_encrypt_many_gathers_on_the_client_device(svc_client):
    cl = svc_client
    svc = ClientService(client=cl, buckets=(2,))
    cts = svc.encrypt_many(_msgs(cl, 2, seed=9))
    assert isinstance(cts, CiphertextBatch)
    assert cts.c0.device == cl.device and cts.c0.dtype == torch.int32
    assert tuple(cts.c0.shape) == (2, cl.ctx.params.n_limbs,
                                   cl.ctx.params.n)
