"""The round-trip properties of the reference's
``tests/test_property_roundtrip.py``, on the port's plain path on the CPU,
with the reference's grids, hypothesis settings, markers and the paper's
19.29-bit budget:

  * encode -> decode over the (logN, Delta, L) grid x {host, device}
    Fourier engines (``test_property_roundtrip.py:48``);
  * hypothesis on ``tiny`` (8 derandomized examples each): a random
    message batch round-trips through the megakernel within
    max(1, scale) 2^-19.29 (``:73``); the staged f64 and the megakernel
    clients give the same words for any message and nonce base (``:89``);
  * ``slow``, as in the reference: the encrypt round trip over the
    (logN, Delta, L, B) grid on both pipelines (``:110``), and staged ==
    megakernel words off ``tiny`` (``:124``).

No JAX process runs: each bound is a property of the port alone.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch.core import boot_precision_bits, encoder
from repro_torch.core.context import CKKSParams, get_context
from repro_torch.fhe_client.client import FHEClient

BOOT_PREC_BITS = 19.29


def _msgs(ctx, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, ctx.params.n_slots))
            + 1j * rng.standard_normal((batch, ctx.params.n_slots))) * 0.5


@pytest.mark.parametrize("logn,delta_bits,n_limbs", [
    (5, 30, 2), (5, 45, 3), (6, 30, 3), (6, 45, 2),
])
@pytest.mark.parametrize("fourier", ["host", "device"])
def test_encode_decode_grid_within_budget(logn, delta_bits, n_limbs,
                                          fourier):
    ctx = get_context(CKKSParams(logn=logn, n_limbs=n_limbs,
                                 delta_bits=delta_bits))
    z = _msgs(ctx, 1, seed=logn * 1000 + delta_bits)[0]
    pt = encoder.encode(z, ctx, fourier=fourier, device="cpu")
    back = encoder.decode(pt.data, ctx, fourier=fourier)
    assert boot_precision_bits(z, back) >= BOOT_PREC_BITS


@pytest.fixture(scope="module")
def tiny_mega_client():
    return FHEClient("tiny", pipeline="megakernel", device="cpu")


@pytest.fixture(scope="module")
def tiny_device_client():
    return FHEClient("tiny", pipeline="staged", datapath="f64", device="cpu")


_SETTINGS = dict(
    deadline=None, max_examples=8, derandomize=True,
    suppress_health_check=[HealthCheck.function_scoped_fixture],
)


@settings(**_SETTINGS)
@given(seed=st.integers(0, 2**32 - 1), scale=st.floats(0.01, 10.0))
def test_roundtrip_recovers_random_messages(tiny_mega_client, seed, scale):
    client = tiny_mega_client
    msgs = _msgs(client.ctx, 1, seed) * scale
    got = client.decrypt_decode_batch(
        client.encode_encrypt_batch(msgs).truncated(2))
    assert np.max(np.abs(got - msgs)) < max(1.0, scale) \
        * 2.0 ** -BOOT_PREC_BITS


@settings(**_SETTINGS)
@given(seed=st.integers(0, 2**32 - 1), nonce0=st.integers(0, 1 << 16))
def test_staged_megakernel_bit_identity_property(tiny_device_client,
                                                 tiny_mega_client, seed,
                                                 nonce0):
    staged, mega = tiny_device_client, tiny_mega_client
    msgs = _msgs(staged.ctx, 1, seed)
    staged._nonce = mega._nonce = nonce0
    bs = staged.encode_encrypt_batch(msgs)
    bm = mega.encode_encrypt_batch(msgs)
    assert torch.equal(bs.c0, bm.c0) and torch.equal(bs.c1, bm.c1)


@pytest.mark.slow
@pytest.mark.parametrize("pipeline", ["staged", "megakernel"])
@pytest.mark.parametrize("logn,delta_bits,n_limbs,batch", [
    (5, 30, 2, 1), (6, 40, 3, 4), (8, 45, 3, 2),
])
def test_encrypt_roundtrip_grid(pipeline, logn, delta_bits, n_limbs, batch):
    params = CKKSParams(logn=logn, n_limbs=n_limbs, delta_bits=delta_bits)
    client = FHEClient(profile=params, pipeline=pipeline, device="cpu")
    msgs = _msgs(client.ctx, batch, seed=logn + delta_bits)
    got = client.decrypt_decode_batch(
        client.encode_encrypt_batch(msgs).truncated(2))
    assert boot_precision_bits(msgs, got) >= BOOT_PREC_BITS


@pytest.mark.slow
@pytest.mark.parametrize("logn,delta_bits", [(5, 30), (6, 40)])
def test_staged_megakernel_bit_identity_grid(logn, delta_bits):
    params = CKKSParams(logn=logn, n_limbs=3, delta_bits=delta_bits)
    staged = FHEClient(profile=params, pipeline="staged", datapath="f64",
                       device="cpu")
    mega = FHEClient(profile=params, pipeline="megakernel", device="cpu")
    msgs = _msgs(staged.ctx, 2, seed=13)
    bs = staged.encode_encrypt_batch(msgs)
    bm = mega.encode_encrypt_batch(msgs)
    assert torch.equal(bs.c0, bm.c0) and torch.equal(bs.c1, bm.c1)
