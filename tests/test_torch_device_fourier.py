"""The device-Fourier checks of the reference's
``tests/test_device_fourier.py`` that no other port test holds, on the
port's plain path on the CPU, with the reference's inputs and bounds:

  * a round trip on a device-Fourier client makes zero calls of the host
    complex128 SpecialFFT / SpecialIFFT (``core/fft.py``'s
    ``special_fft`` / ``special_ifft``, counted by ``fft_counter`` below,
    the reference's ``conftest.py`` fixture of that name ported) and is
    within 1e-4 of the messages (``test_device_fourier.py:46``; the
    reference's staged f64 client, plus the megakernel and staged df32
    clients); ``fourier='host'`` calls each once (``:64``);
  * ``fourier`` validation (``:74``);
  * the device round trip within 19.29 bits and within 1e-6 of the host
    client at ``tiny`` (``:83``; ``test`` stays ``slow``, as there);
  * precision edges: device SpecialIFFT within 1e-9 of the host one, the
    device encode -> decode >= 19.29 bits and within 1e-8 of the host
    decode, at (logN, Delta) = (6, 30), (6, 40) and, ``slow`` as there,
    (8, 45) (``:114``);
  * ``decrypt_batch`` of a list with per-row scales on the staged device
    path: within 1e-4 (``:138``);
  * the private-inference loop on the device engine: round-trip error
    < 1e-5, outputs within 1e-3 (``:151``).

No JAX process runs: each bound is a property of the port alone (the
``ops.fourier`` dispatch tests of ``:172-210`` are mirrored in
``test_torch_staged.py`` and ``test_torch_rules.py``).
"""

import numpy as np
import pytest

from repro_torch.core import boot_precision_bits, encoder, encryptor
from repro_torch.core import fft as fftmod
from repro_torch.core.context import CKKSContext, CKKSParams
from repro_torch.fhe_client.client import FHEClient, simulate_private_inference

BOOT_PREC_BITS = 19.29

DEVICE_CLIENTS = {"staged_f64": {"pipeline": "staged", "datapath": "f64"},
                  "megakernel": {"pipeline": "megakernel"},
                  "staged_df32": {"pipeline": "staged", "datapath": "df32"}}


def _messages(ctx, batch, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, ctx.params.n_slots))
            + 1j * rng.standard_normal((batch, ctx.params.n_slots))) * 0.5


@pytest.fixture()
def fft_counter(monkeypatch):
    """Counts every call of the port's host complex128 SpecialFFT / IFFT."""
    calls = {"ifft": 0, "fft": 0}
    real_ifft, real_fft = fftmod.special_ifft, fftmod.special_fft

    def counting_ifft(*a, **k):
        calls["ifft"] += 1
        return real_ifft(*a, **k)

    def counting_fft(*a, **k):
        calls["fft"] += 1
        return real_fft(*a, **k)

    monkeypatch.setattr(fftmod, "special_ifft", counting_ifft)
    monkeypatch.setattr(fftmod, "special_fft", counting_fft)
    return calls


@pytest.fixture(scope="module")
def clients():
    out = {name: FHEClient("tiny", device="cpu", **kw)
           for name, kw in DEVICE_CLIENTS.items()}
    out["host"] = FHEClient("tiny", fourier="host", device="cpu")
    return out


@pytest.mark.parametrize("name", sorted(DEVICE_CLIENTS))
def test_device_path_zero_host_fft_calls(fft_counter, clients, name):
    client = clients[name]
    msgs = _messages(client.ctx, 3)
    batch = client.encode_encrypt_batch(msgs)
    got = client.decrypt_decode_batch(batch.truncated(2))
    # the cores called directly too (the reference re-traces them)
    client.encrypt_impl(*client.encrypt_operands(msgs), 0)
    client.decrypt_impl(*client.decrypt_operands(batch.truncated(2)))
    assert fft_counter == {"ifft": 0, "fft": 0}
    np.testing.assert_allclose(got, msgs, atol=1e-4)


def test_host_path_still_uses_oracle(fft_counter, clients):
    client = clients["host"]
    msgs = _messages(client.ctx, 2)
    batch = client.encode_encrypt_batch(msgs)
    client.decrypt_decode_batch(batch.truncated(2))
    assert fft_counter["ifft"] == 1 and fft_counter["fft"] == 1


def test_fourier_arg_validated():
    with pytest.raises(ValueError, match="device.*host"):
        FHEClient(profile="tiny", fourier="numpy", device="cpu")


@pytest.mark.parametrize("profile", [
    "tiny",
    pytest.param("test", marks=pytest.mark.slow),
])
def test_device_roundtrip_within_boot_budget(profile, clients):
    if profile == "tiny":
        dev, host = clients["staged_f64"], clients["host"]
    else:
        dev = FHEClient(profile=profile, device="cpu")
        host = FHEClient(profile=profile, fourier="host", device="cpu")
    msgs = _messages(dev.ctx, 3, seed=1)
    got_dev = dev.decrypt_decode_batch(
        dev.encode_encrypt_batch(msgs).truncated(2))
    got_host = host.decrypt_decode_batch(
        host.encode_encrypt_batch(msgs).truncated(2))
    assert boot_precision_bits(msgs, got_dev) >= BOOT_PREC_BITS
    np.testing.assert_allclose(got_dev, got_host, atol=1e-6)


@pytest.mark.parametrize("logn,delta_bits", [
    (6, 30), (6, 40),
    pytest.param(8, 45, marks=pytest.mark.slow),
])
def test_encode_decode_precision_edges(logn, delta_bits):
    ctx = CKKSContext(CKKSParams(logn=logn, n_limbs=3,
                                 delta_bits=delta_bits))
    rng = np.random.default_rng(logn * 100 + delta_bits)
    z = (rng.standard_normal(ctx.params.n_slots)
         + 1j * rng.standard_normal(ctx.params.n_slots)) * 0.5

    coeffs_host = encoder.slots_to_coeffs(z, ctx)
    coeffs_dev = encoder.slots_to_coeffs(z, ctx, fourier="device",
                                         device="cpu").numpy()
    assert np.max(np.abs(coeffs_host - coeffs_dev)) < 1e-9

    pt = encoder.encode(z, ctx, fourier="device", device="cpu")
    back = encoder.decode(pt.data, ctx, fourier="device")
    assert boot_precision_bits(z, back) >= BOOT_PREC_BITS
    np.testing.assert_allclose(back, encoder.decode(pt.data, ctx), atol=1e-8)


def test_legacy_list_decrypt_per_row_scales_device(clients):
    client = clients["staged_f64"]
    msgs = _messages(client.ctx, 2, seed=5)
    two = [encryptor.Ciphertext(c0=ct.c0[:2], c1=ct.c1[:2], n_limbs=2,
                                scale=ct.scale)
           for ct in client.encrypt_batch(msgs)]
    np.testing.assert_allclose(client.decrypt_batch(two), msgs, atol=1e-4)


def test_private_inference_loop_device(clients):
    client = clients["staged_f64"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16)) * 0.2

    def serve_fn(xin):
        return xin @ np.ones((16, 4), np.float32) * 0.1

    y, stats = simulate_private_inference(client, serve_fn, x, out_features=4)
    assert stats["roundtrip_err"] < 1e-5
    np.testing.assert_allclose(y, serve_fn(x.astype(np.float32)), atol=1e-3)
