"""The port's client path against the JAX client, bit for bit.

The JAX reference runs ONCE per session, in one subprocess, under
``XLA_FLAGS=--xla_cpu_max_isa=AVX``: jitted XLA on a CPU with FMA contracts
the df32 error-free transforms' multiply-adds (``dfloat.two_prod`` /
``df_mul`` assume every product is rounded on its own), which changes the
low words and, at Delta >= 2^50, the rounded plaintext integers. Without
FMA instructions XLA computes what the IEEE-strict port computes. The flag
must be set before jax starts, hence the subprocess; its outputs are cached
as .npz under the session's tmp dir. The reference is
``repro.fhe_client.client.FHEClient`` on its default megakernel path in
interpret mode, as the JAX tests run it.

Cases: ``tiny`` at B=3 (odd batch, nonce base wrapping past 2^32), B=1
and B=16 (a full bucket of the client service, its nonce base 8 below the
wrap), a toy ring at the paper's Delta = 2^55 (the third digit d2 is only
non-zero at such Delta) at B=2, and ``test`` at B=2. Ciphertexts and the
four decoded planes must be identical words; the port decodes the
reference's own ciphertexts, so each direction is held on its own. The
port's ``ClientService`` (a CPU client, two logical streams) encrypts the
B=16 case's messages from its nonce base to the JAX client's words too,
and so does the port's staged pipeline (encrypt and decode), and a
request sequence (a closed loop, then an always-on run) to the JAX
``ClientService``'s words on the same sequence. Tolerance: 0.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.context import CKKSParams
from repro_torch.core.encoder import boot_precision_bits
from repro_torch.core.encryptor import CiphertextBatch
from repro_torch.fhe_client.client import FHEClient

SRC = str(Path(__file__).resolve().parents[1] / "src")

TOY55 = dict(logn=6, n_limbs=4, decrypt_limbs=2, delta_bits=55)
SEED_B = 0x0123456789ABCDEF_FEDCBA9876543210

# (case id, profile, batch, client seed or None, nonce base, message seed)
CASES = [
    ("tiny_b3", "tiny", 3, None, 0xFFFFFFFE, 11),
    ("tiny_b1", "tiny", 1, None, 7, 12),
    ("toy55_b2", "toy55", 2, SEED_B, 5, 13),
    ("test_b2", "test", 2, SEED_B, 40, 14),
    ("tiny_b16", "tiny", 16, None, 0xFFFFFFF8, 15),
]
# the service sequence: (profile, nonce base, message seed, encrypts per
# mode, decrypts), in 16-row buckets (the shapes the B=16 case compiled)
SERVICE = ("tiny", 1000, 16, 16, 3)

_REFERENCE = r'''
import json, sys
import numpy as np
from repro.core.context import CKKSParams
from repro.fhe_client.client import FHEClient

cases, toy55, out_dir = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
clients = {}
for cid, profile, batch, seed, nonce0, mseed in cases:
    key = (profile, seed)
    if key not in clients:
        clients[key] = FHEClient(CKKSParams(**toy55) if profile == "toy55"
                                 else profile, seed=seed)
    client = clients[key]
    ns = client.ctx.params.n_slots
    rng = np.random.default_rng(mseed)
    msgs = (rng.standard_normal((batch, ns))
            + 1j * rng.standard_normal((batch, ns))) * 0.5
    client.nonce = nonce0
    cts = client.encode_encrypt_batch(msgs)
    planes = client.decrypt_core(*client.decrypt_operands(cts.truncated(2)))
    keys = client.keys
    np.savez(f"{out_dir}/{cid}.npz", msgs=msgs, c0=np.asarray(cts.c0),
             c1=np.asarray(cts.c1),
             planes=np.stack([np.asarray(p) for p in planes]),
             s_mont=np.asarray(keys.sk.s_mont),
             s_coeffs=np.asarray(keys.sk.s_coeffs),
             b_mont=np.asarray(keys.pk.b_mont),
             a_mont=np.asarray(keys.pk.a_mont))
    print(cid, "done", flush=True)

# the reference service on one request sequence: a closed loop (encrypts,
# flush, then decrypts of its first rows), then an always-on run (the
# encrypts queued before start, drained by stop)
from repro.fhe_client.service import ClientService
profile, nonce0, mseed, n_enc, n_dec = json.loads(sys.argv[4])
client = clients[(profile, None)]
client.nonce = nonce0
ns = client.ctx.params.n_slots
rng = np.random.default_rng(mseed)
msgs = (rng.standard_normal((2 * n_enc, ns))
        + 1j * rng.standard_normal((2 * n_enc, ns))) * 0.5
svc = ClientService(client, buckets=(16,), n_streams=2, oversubscribe=True)
rids = [svc.submit_encrypt(m) for m in msgs[:n_enc]]
svc.flush()
cts = [svc.result(r) for r in rids]
drids = [svc.submit_decrypt(ct) for ct in cts[:n_dec]]
svc.flush()
dec = np.stack([svc.result(r) for r in drids])
rids = [svc.submit_encrypt(m) for m in msgs[n_enc:]]
svc.start()
svc.stop(drain=True)
cts += [svc.result(r) for r in rids]
np.savez(f"{out_dir}/service.npz", msgs=msgs, dec=dec,
         c0=np.stack([np.asarray(ct.c0) for ct in cts]),
         c1=np.stack([np.asarray(ct.c1) for ct in cts]))
print("service done", flush=True)
'''


@pytest.fixture(scope="session")
def jax_reference(tmp_path_factory):
    """{case id: npz} from one no-FMA JAX subprocess."""
    out = tmp_path_factory.mktemp("jax_reference")
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE,
         json.dumps([list(c) for c in CASES]), json.dumps(TOY55), str(out),
         json.dumps(SERVICE)],
        env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX reference failed:\n{proc.stdout}\n"
                           f"{proc.stderr[-4000:]}")
    ref = {c[0]: np.load(out / f"{c[0]}.npz") for c in CASES}
    ref["service"] = np.load(out / "service.npz")
    return ref


@pytest.fixture(scope="module")
def port_client():
    """Port clients on the CPU, one per (profile, seed), built on first
    use; tests pin the nonce base they need."""
    clients = {}

    def get(profile, seed):
        if (profile, seed) not in clients:
            clients[profile, seed] = FHEClient(
                CKKSParams(**TOY55) if profile == "toy55" else profile,
                seed=seed, device="cpu")
        return clients[profile, seed]

    return get


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _case(cid):
    return next(c for c in CASES if c[0] == cid)


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_keygen_matches_reference(jax_reference, port_client, cid):
    _, profile, _, seed, _, _ = _case(cid)
    ref = jax_reference[cid]
    keys = port_client(profile, seed).keys
    np.testing.assert_array_equal(_u32(keys.sk.s_mont), ref["s_mont"])
    np.testing.assert_array_equal(_u32(keys.pk.b_mont), ref["b_mont"])
    np.testing.assert_array_equal(_u32(keys.pk.a_mont), ref["a_mont"])
    np.testing.assert_array_equal(keys.sk.s_coeffs.numpy(), ref["s_coeffs"])


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_ciphertexts_bit_identical(jax_reference, port_client, cid):
    _, profile, batch, seed, nonce0, _ = _case(cid)
    ref = jax_reference[cid]
    client = port_client(profile, seed)
    client.nonce = nonce0
    cts = client.encode_encrypt_batch(ref["msgs"])
    assert client.nonce == nonce0 + batch
    assert cts.c0.dtype == torch.int32 and tuple(cts.c0.shape) == \
        ref["c0"].shape
    np.testing.assert_array_equal(_u32(cts.c0), ref["c0"])
    np.testing.assert_array_equal(_u32(cts.c1), ref["c1"])


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_decoded_planes_bit_identical(jax_reference, port_client, cid):
    """The port decrypts the reference's ciphertexts (2-limb view)."""
    _, profile, _, seed, _, _ = _case(cid)
    ref = jax_reference[cid]
    client = port_client(profile, seed)
    cts = CiphertextBatch(
        c0=torch.tensor(ref["c0"].view(np.int32)),
        c1=torch.tensor(ref["c1"].view(np.int32)),
        n_limbs=ref["c0"].shape[1], scale=client.ctx.params.delta)
    planes = client.decrypt_planes(cts.truncated(2))
    got = np.stack([p.numpy() for p in planes])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32),
                                  ref["planes"].view(np.uint32))


@pytest.mark.parametrize("cid", ["toy55_b2", "test_b2"])
def test_round_trip_precision(jax_reference, port_client, cid):
    """The whole slice (port encrypt -> port decrypt) recovers the message
    within the reference's bootstrapping-precision bar (19.29 bits)."""
    _, profile, _, seed, nonce0, _ = _case(cid)
    ref = jax_reference[cid]
    client = port_client(profile, seed)
    client.nonce = nonce0 + 1000
    out = client.decrypt_decode_batch(
        client.encode_encrypt_batch(ref["msgs"]).truncated(2))
    assert boot_precision_bits(ref["msgs"], out) >= 19.29


def test_service_full_bucket_matches_reference(jax_reference):
    """The B=16 case through the port's client service: one 16-row bucket
    (``DEFAULT_BUCKETS``' largest) on two logical CPU streams, leased from
    the case's nonce base (8 below 2^32), == the JAX client's words; the
    service then decodes its own ciphertexts to the JAX planes' values."""
    from repro_torch.fhe_client.service import ClientService
    _, profile, batch, seed, nonce0, _ = _case("tiny_b16")
    ref = jax_reference["tiny_b16"]
    client = FHEClient(profile, seed=seed, device="cpu")
    client.nonce = nonce0
    svc = ClientService(client, n_streams=2, oversubscribe=True)
    cts = svc.encrypt_many(ref["msgs"])
    assert [(r.bucket, r.nonce0) for r in svc.dispatch_log] == [
        (batch, nonce0)]
    np.testing.assert_array_equal(_u32(cts.c0), ref["c0"])
    np.testing.assert_array_equal(_u32(cts.c1), ref["c1"])
    out = svc.decrypt_many(cts.truncated(2))
    planes = ref["planes"].astype(np.float64)
    np.testing.assert_array_equal(out, (planes[0] + planes[1])
                                  + 1j * (planes[2] + planes[3]))


def test_staged_full_bucket_matches_reference(jax_reference):
    """The B=16 case through the staged pipeline (``pipeline='staged'``:
    K4, K1, K2 and K3, K4 again, as their plain versions on the CPU): its
    ciphertexts are the JAX client's words from the same nonce base (8
    below 2^32), and it decodes the JAX ciphertexts to the JAX planes'
    words (the JAX package holds its staged and megakernel paths to the
    same words)."""
    _, profile, batch, seed, nonce0, _ = _case("tiny_b16")
    ref = jax_reference["tiny_b16"]
    client = FHEClient(profile, seed=seed, device="cpu", pipeline="staged")
    client.nonce = nonce0
    cts = client.encode_encrypt_batch(ref["msgs"])
    assert client.nonce == nonce0 + batch
    np.testing.assert_array_equal(_u32(cts.c0), ref["c0"])
    np.testing.assert_array_equal(_u32(cts.c1), ref["c1"])
    jcts = CiphertextBatch(
        c0=torch.tensor(ref["c0"].view(np.int32)),
        c1=torch.tensor(ref["c1"].view(np.int32)),
        n_limbs=ref["c0"].shape[1], scale=client.ctx.params.delta)
    got = np.stack([p.numpy() for p in client.decrypt_planes(
        jcts.truncated(2))])
    np.testing.assert_array_equal(got.view(np.uint32),
                                  ref["planes"].view(np.uint32))


@pytest.mark.parametrize("always_on", [False, True],
                         ids=["closed_loop", "always_on"])
def test_service_sequence_matches_reference_service(jax_reference,
                                                    always_on):
    """One request sequence through the port's ``ClientService`` and the
    JAX ``ClientService`` (same seed, same nonce base, two streams on one
    device, 16-row buckets): a closed loop of 16 encrypts and 3 decrypts,
    then 16 encrypts queued before ``start()`` and drained by
    ``stop()``. Every ciphertext is the reference service's words, and
    every decrypt its values: ``start()`` takes no nonce of its own."""
    from repro_torch.fhe_client.service import ClientService
    profile, nonce0, _, n_enc, n_dec = SERVICE
    ref = jax_reference["service"]
    client = FHEClient(profile, device="cpu")
    client.nonce = nonce0
    svc = ClientService(client, buckets=(16,), n_streams=2,
                        oversubscribe=True)
    rids = [svc.submit_encrypt(m) for m in ref["msgs"][:n_enc]]
    svc.flush()
    cts = [svc.result(r) for r in rids]
    drids = [svc.submit_decrypt(ct) for ct in cts[:n_dec]]
    svc.flush()
    np.testing.assert_array_equal(np.stack([svc.result(r) for r in drids]),
                                  ref["dec"])
    if always_on:
        rids = [svc.submit_encrypt(m) for m in ref["msgs"][n_enc:]]
        svc.start()
        svc.stop(drain=True)
        cts += [svc.result(r) for r in rids]
    assert [r.nonce0 for r in svc.dispatch_log if r.kind == "enc"] == [
        nonce0, nonce0 + 16][:1 + always_on]
    n = len(cts)
    np.testing.assert_array_equal(
        np.stack([_u32(ct.c0) for ct in cts]), ref["c0"][:n])
    np.testing.assert_array_equal(
        np.stack([_u32(ct.c1) for ct in cts]), ref["c1"][:n])
