"""The streaming-client checks of the reference's
``tests/test_client_stream.py`` that no other port test holds, on the
port's plain path at ``tiny`` on the CPU, with the reference's inputs and
bounds:

  * ``decrypt_batch`` of a list of 2-limb ciphertexts drives the
    megakernel core with a per-row (B,) scale operand: within 1e-4 of the
    messages (``test_client_stream.py:204``);
  * the nonce layout: 16 B=1 ``encode_encrypt_batch`` calls from nonce
    base 0 give one B=16 call's words, on the staged f64 client, the
    megakernel client and (the port's staged default) the staged df32
    client (``:222``);
  * the staged and the megakernel clients walked from nonce base 300 give
    the same words, batch after batch, and both end at 303 (``:239``);
  * ``pipeline`` validation with the reference's ``match=`` regexes
    (``:259``);
  * the ops-level stream entries called as ``:118-130`` calls them
    (``nonce0=0``, the profile's seed, the reference's default datapath):
    each entry runs its plain version once per call, and on the CPU no
    CUDA counter moves (the card's one launch per call is what
    ``kernels/client_stream.py``'s ``LAUNCHES`` counts in
    ``chip_smoke.py``).

No JAX process runs: each bound is a property of the port alone (the
port's ciphertexts are held word for word against the JAX clients in
``test_torch_slice.py`` and ``test_torch_staged.py``).

Left out, with no PyTorch counterpart: ``:45`` and ``:81`` count
``pallas_call`` lowerings in traced jaxprs (the port traces nothing;
its launch counts are the ``LAUNCHES`` counters of
``kernels/client_stream.py:45``, ``client_pointwise.py:42`` and
``server_eval.py:52``, read by ``chip_smoke.py`` on the card), and the
slow ``:163`` builds the ``test`` clients the port's word-for-word tests
already cover.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core import encryptor
from repro_torch.fhe_client.client import FHEClient
from repro_torch.kernels import client_stream
from repro_torch.kernels import ops as kops

CLIENTS = {"staged": {"pipeline": "staged", "datapath": "f64"},
           "megakernel": {"pipeline": "megakernel"},
           "staged_df32": {"pipeline": "staged", "datapath": "df32"}}


def _messages(ctx, batch, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, ctx.params.n_slots))
            + 1j * rng.standard_normal((batch, ctx.params.n_slots))) * 0.5


@pytest.fixture(scope="module")
def clients():
    return {name: FHEClient("tiny", device="cpu", **kw)
            for name, kw in CLIENTS.items()}


def test_megakernel_per_row_scales(clients):
    client = clients["megakernel"]
    msgs = _messages(client.ctx, 2, seed=5)
    cts = [client.encode_encrypt_batch(msgs[i:i + 1])[0] for i in range(2)]
    two = [encryptor.Ciphertext(c0=ct.c0[:2], c1=ct.c1[:2], n_limbs=2,
                                scale=ct.scale) for ct in cts]
    got = client.decrypt_batch(two)
    np.testing.assert_allclose(got, msgs, atol=1e-4)
    # the scale operand is per row: a row of twice the message at twice the
    # scale decodes to the message (powers of two, as df32 takes them)
    twice = client.encode_encrypt_batch(2 * msgs[1:2])[0]
    two[1] = encryptor.Ciphertext(c0=twice.c0[:2], c1=twice.c1[:2],
                                  n_limbs=2, scale=2 * twice.scale)
    np.testing.assert_allclose(client.decrypt_batch(two), msgs, atol=1e-4)


@pytest.mark.parametrize("pipeline", sorted(CLIENTS))
def test_nonce_layout_b1_vs_b16_bit_identical(pipeline, clients):
    client = clients[pipeline]
    msgs = _messages(client.ctx, 16, seed=11)
    client._nonce = 0
    rows = [client.encode_encrypt_batch(msgs[i:i + 1]) for i in range(16)]
    client._nonce = 0
    full = client.encode_encrypt_batch(msgs)
    assert torch.equal(torch.cat([r.c0 for r in rows]), full.c0)
    assert torch.equal(torch.cat([r.c1 for r in rows]), full.c1)


def test_same_nonce_base_across_pipelines_bit_identical(clients):
    staged, mega = clients["staged"], clients["megakernel"]
    staged._nonce = mega._nonce = 300
    for k in range(3):
        msgs = _messages(staged.ctx, 1, seed=20 + k)
        bs = staged.encode_encrypt_batch(msgs)
        bm = mega.encode_encrypt_batch(msgs)
        assert torch.equal(bs.c0, bm.c0) and torch.equal(bs.c1, bm.c1)
    assert staged._nonce == mega._nonce == 303


def test_pipeline_arg_validated():
    with pytest.raises(ValueError, match="staged.*megakernel"):
        FHEClient(profile="tiny", pipeline="fused", device="cpu")
    with pytest.raises(ValueError, match="requires fourier='device'"):
        FHEClient(profile="tiny", fourier="host", pipeline="megakernel",
                  device="cpu")


def test_eager_stream_entry_points_single_call(clients, monkeypatch):
    """``ops.encode_encrypt_stream`` / ``decrypt_decode_stream`` as the
    reference's test calls them: one run of the megakernel's plain version
    per call, no CUDA counter moved on the CPU."""
    client = clients["megakernel"]
    ctx = client.ctx
    runs = {"enc": 0, "dec": 0}
    enc_plain = client_stream.encode_encrypt_stream_plain
    dec_plain = client_stream.decrypt_decode_stream_plain

    def enc(*a, **k):
        runs["enc"] += 1
        return enc_plain(*a, **k)

    def dec(*a, **k):
        runs["dec"] += 1
        return dec_plain(*a, **k)

    monkeypatch.setattr(client_stream, "encode_encrypt_stream_plain", enc)
    monkeypatch.setattr(client_stream, "decrypt_decode_stream_plain", dec)
    msgs = _messages(ctx, 2, seed=3)
    z = dfl.dfc_from_parts(torch.from_numpy(msgs.real.copy()),
                           torch.from_numpy(msgs.imag.copy()))
    kops.reset_launches()
    c0, c1 = kops.encode_encrypt_stream(
        dfl.dfc_to_planes(z), client.keys.pk.b_mont, client.keys.pk.a_mont,
        ctx, nonce0=0)
    assert runs == {"enc": 1, "dec": 0}
    assert tuple(c0.shape) == tuple(c1.shape) == (2, ctx.params.n_limbs,
                                                  ctx.params.n)
    zero = torch.zeros((2, 2, ctx.params.n), dtype=torch.int32)
    kops.decrypt_decode_stream(zero, zero, client.keys.sk.s_mont, ctx,
                               torch.tensor(ctx.params.delta,
                                            dtype=torch.float64))
    assert runs == {"enc": 1, "dec": 1}
    assert not any(kops.launches().values())
