"""The CKKS client checks of the reference's ``tests/test_ckks.py`` that no
other port test holds, run on the port alone at ``test`` (N=2^10, 6 limbs,
Delta=2^50) on the CPU, with the reference's inputs and bounds:

  * decrypt at a reduced level (a 2-limb plaintext under a 2-limb public
    key): > 25 bits (``test_ckks.py:84``);
  * the noise of an encryption of 0, by the exact CRT of the two decrypt
    limbs: 0 < |noise| < 2^30 (``:101``);
  * a key of another seed decrypts to garbage: < 5 bits (``:119``);
  * PRNG streams 1 and 2 differ, and a stream repeats itself (``:129``);
  * ``uniform_mod_q``: every draw < q, mean within 0.02 q of q / 2
    (``:139``);
  * ``cbd`` (eta 21): |mean| < 0.1, |std - sqrt(21 / 2)| < 0.1, every
    draw in [-21, 21] (``:148``).

Each bound is a property of the port alone, so no JAX process runs. The
other checks of ``test_ckks.py`` (encode / decode, public and seeded
round trips) are held word for word against the reference in
``test_torch_f64.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (boot_precision_bits, decode, decrypt, encode,
                              encrypt, get_context, keygen, prng)
from repro_torch.core import ntt as nttmod
from repro_torch.core import rns
from repro_torch.core.encoder import Plaintext
from repro_torch.core.encryptor import PublicKey
from repro_torch.core.modmul import u32_to_i64


@pytest.fixture(scope="module")
def ctx():
    return get_context("test")


@pytest.fixture(scope="module")
def keys(ctx):
    return keygen(ctx, device="cpu")


def _msg(ctx, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(ctx.params.n_slots)
            + 1j * rng.standard_normal(ctx.params.n_slots)) * 0.5


def test_decrypt_at_reduced_level(ctx, keys):
    """The server returns 2-limb ciphertexts: encrypt at 2 limbs directly."""
    sk, pk = keys
    z = _msg(ctx, 3)
    pt = encode(z, ctx, n_limbs=2, device="cpu")
    pk2 = PublicKey(b_mont=pk.b_mont[:2], a_mont=pk.a_mont[:2],
                    a_stream=pk.a_stream)
    ct = encrypt(Plaintext(pt.data, 2, pt.scale), pk2, ctx, nonce=4)
    assert ct.n_limbs == 2
    assert boot_precision_bits(z, decode(decrypt(ct, sk, ctx), ctx)) > 25


def test_noise_magnitude(ctx, keys):
    """Decrypting an encryption of 0 leaves only the noise v*e + e0 + e1*s,
    checked in the coefficient domain by the exact CRT."""
    sk, pk = keys
    pt = encode(np.zeros(ctx.params.n_slots, np.complex128), ctx,
                device="cpu")
    dec = decrypt(encrypt(pt, pk, ctx, nonce=5), sk, ctx)
    c0 = nttmod.intt(u32_to_i64(dec[0]), ctx.plans[0]).numpy()
    c1 = nttmod.intt(u32_to_i64(dec[1]), ctx.plans[1]).numpy()
    noise = max(abs(v) for v in rns.crt_exact(np.stack([c0, c1]),
                                              ctx.q_list[:2]))
    assert 0 < noise < 2 ** 30, f"noise {noise}"


def test_wrong_key_fails(ctx, keys):
    sk, pk = keys
    z = _msg(ctx, 4)
    ct = encrypt(encode(z, ctx, device="cpu"), pk, ctx, nonce=6)
    sk2, _ = keygen(ctx, seed=0xDEADBEEF, device="cpu")
    assert boot_precision_bits(z, decode(decrypt(ct, sk2, ctx), ctx)) < 5
    # the right key recovers it (the bound above is the key's doing)
    assert boot_precision_bits(z, decode(decrypt(ct, sk, ctx), ctx)) > 25


def test_prng_streams_disjoint(ctx):
    a = prng.random_u32(ctx.params.seed, 1, 4096)
    b = prng.random_u32(ctx.params.seed, 2, 4096)
    assert not torch.equal(a, b)
    assert torch.equal(a, prng.random_u32(ctx.params.seed, 1, 4096))


def test_uniform_mod_q_range_and_bias(ctx):
    q = ctx.q_list[0]
    u = prng.uniform_mod_q(ctx.params.seed, 77, 1 << 15, q).numpy()
    assert u.max() < q
    assert abs(u.mean() / q - 0.5) < 0.02


def test_cbd_statistics(ctx):
    e = prng.cbd(ctx.params.seed, 88, 1 << 16).numpy()
    assert abs(e.mean()) < 0.1
    assert abs(e.std() - np.sqrt(21 / 2)) < 0.1
    assert e.max() <= 21 and e.min() >= -21
