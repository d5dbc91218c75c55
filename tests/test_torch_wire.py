"""The port's wire format (``repro_torch.fhe_client.service.wire``) against
the JAX package's, byte for byte, and its strict validation.

  * every case of ``tests/test_wire_validation.py`` (truncation at every
    layer, trailing garbage, wrong magic or kind, the tenant-id hazard),
    on the port's module and the port's objects;
  * for each of the five kinds, the port's bytes == the JAX bytes for the
    same content, and each package parses the other's payload to the same
    words (the JAX side built in this process from numpy arrays: no client
    or kernel runs);
  * a ``tiny`` round trip on the CPU: client -> kind 1 -> server op ->
    kind 1 -> ``decrypt_batch`` with the server's scale.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.context import PROFILES as JAX_PROFILES
from repro.core.encryptor import Ciphertext as JCiphertext
from repro.core.encryptor import CiphertextBatch as JCiphertextBatch
from repro.fhe_client.service import wire as jwire
from repro.fhe_server.keys import EvaluationKeys as JEvaluationKeys
from repro.fhe_server.keys import KeySwitchKey as JKeySwitchKey

from repro_torch.core.context import PROFILES
from repro_torch.core.encryptor import Ciphertext, CiphertextBatch
from repro_torch.fhe_client.client import FHEClient
from repro_torch.fhe_client.service import wire
from repro_torch.fhe_server.ct import ServerCiphertext
from repro_torch.fhe_server.eval_ops import ServerEvaluator
from repro_torch.fhe_server.keys import EvaluationKeys, KeySwitchKey

TINY = PROFILES["tiny"]


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 words -> the port's int32 tensor of the same words."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# minimal valid buffers, one per kind (the validation suite's contents)
# ---------------------------------------------------------------------------


def _ct_words():
    return np.arange(2 * 3 * 4, dtype=np.uint32).reshape(2, 3, 4)


def _ct_batch_buf():
    c = _ct_words()
    return wire.serialize_ciphertext_batch(CiphertextBatch(
        c0=_t(c), c1=_t(c + 1), n_limbs=3, scale=2.0 ** 40))


def _seeded_buf():
    c0 = np.arange(3 * 4, dtype=np.uint32).reshape(3, 4)
    return wire.serialize_ciphertext_seeded(Ciphertext(
        c0=_t(c0), c1=None, n_limbs=3, scale=2.0 ** 40, a_stream=0x10017))


def _result_z():
    return (np.arange(10, dtype=float) + 1j).reshape(2, 5)


def _result_buf():
    return wire.serialize_result(_result_z())


def _key_plane():
    l, n = 2, 4
    return np.arange(l * (l + 1) * n, dtype=np.uint32).reshape(l, l + 1, n)


def _eval_keys_buf():
    plane = _key_plane()

    def ksk(k):
        return KeySwitchKey(_t(plane + k), _t(plane + k + 1))

    return wire.serialize_evaluation_keys(EvaluationKeys(
        n=4, n_limbs=2, special_q=0xFFF1, relin=ksk(0),
        rot={1: ksk(2), 3: ksk(4)}))


def _tenant_buf(tid="alice-tenant", inner=None):
    if inner is None:
        inner = _result_buf()
    return wire.serialize_tenant_envelope(tid, TINY, inner)


_KINDS = [
    ("ct_batch", _ct_batch_buf,
     lambda b: wire.deserialize_ciphertext_batch(b, device="cpu")),
    ("ct_seeded", _seeded_buf,
     lambda b: wire.deserialize_ciphertext_seeded(b, device="cpu")),
    ("result", _result_buf, wire.deserialize_result),
    ("eval_keys", _eval_keys_buf,
     lambda b: wire.deserialize_evaluation_keys(b, device="cpu")),
    ("tenant", _tenant_buf, wire.deserialize_tenant_envelope),
]


@pytest.fixture(params=_KINDS, ids=[k[0] for k in _KINDS])
def kind(request):
    name, make, de = request.param
    return name, make(), de


# ---------------------------------------------------------------------------
# the validation suite, on the port's module
# ---------------------------------------------------------------------------


def test_valid_buffers_still_parse(kind):
    _name, buf, de = kind
    de(buf)
    assert wire.payload_kind(buf) in (
        wire.KIND_CT_BATCH, wire.KIND_CT_SEEDED, wire.KIND_RESULT,
        wire.KIND_EVAL_KEYS, wire.KIND_TENANT)


def test_truncated_header_rejected(kind):
    _name, buf, de = kind
    for cut in (0, 1, wire._HDR.size - 1):
        with pytest.raises(ValueError, match="truncated"):
            de(buf[:cut])


def test_truncated_body_header_rejected(kind):
    _name, buf, de = kind
    with pytest.raises(ValueError, match="truncated"):
        de(buf[:wire._HDR.size + 2])


def test_truncated_plane_rejected(kind):
    _name, buf, de = kind
    with pytest.raises(ValueError, match="truncated"):
        de(buf[:-1])


def test_trailing_garbage_rejected(kind):
    _name, buf, de = kind
    with pytest.raises(ValueError, match="trailing"):
        de(buf + b"\x00")
    with pytest.raises(ValueError, match="trailing"):
        de(buf + buf)


def test_wrong_kind_and_magic_still_rejected(kind):
    name, buf, de = kind
    with pytest.raises(ValueError, match="magic"):
        de(b"XXXX" + buf[4:])
    others = [mk() for n, mk, _d in _KINDS if n != name]
    with pytest.raises(ValueError, match="kind"):
        de(others[0])


def test_tenant_id_truncation_is_never_silent():
    """With an empty inner payload, a buffer cut inside the tenant id must
    fail the exact-total check, never decode to a shorter id."""
    buf = wire.serialize_tenant_envelope("alice-tenant", TINY, b"")
    tid, _p, inner = wire.deserialize_tenant_envelope(buf)
    assert tid == "alice-tenant" and inner == b""
    with pytest.raises(ValueError, match="truncated"):
        wire.deserialize_tenant_envelope(buf[:-7])


def test_tenant_envelope_trailing_bytes_past_inner_rejected():
    buf = _tenant_buf()
    with pytest.raises(ValueError, match="trailing"):
        wire.deserialize_tenant_envelope(buf + b"extra")


def test_eval_keys_total_checked_before_rot_id_read():
    buf = _eval_keys_buf()
    body_end = wire._HDR.size + wire._EVAL_KEYS.size
    with pytest.raises(ValueError, match="truncated"):
        wire.deserialize_evaluation_keys(buf[:body_end + 2], device="cpu")


def test_payload_kind_docstring_names_all_kinds():
    doc = wire.payload_kind.__doc__
    for name in ("KIND_CT_BATCH", "KIND_CT_SEEDED", "KIND_RESULT",
                 "KIND_EVAL_KEYS", "KIND_TENANT"):
        assert name in doc


# ---------------------------------------------------------------------------
# byte identity with the JAX package, both directions
# ---------------------------------------------------------------------------


def _jax_payload(name: str) -> bytes:
    """The JAX package's payload of the same content as ``_KINDS[name]``."""
    if name == "ct_batch":
        c = _ct_words()
        return jwire.serialize_ciphertext_batch(JCiphertextBatch(
            c0=jnp.asarray(c), c1=jnp.asarray(c + 1), n_limbs=3,
            scale=2.0 ** 40))
    if name == "ct_seeded":
        c0 = np.arange(3 * 4, dtype=np.uint32).reshape(3, 4)
        return jwire.serialize_ciphertext_seeded(JCiphertext(
            c0=jnp.asarray(c0), c1=None, n_limbs=3, scale=2.0 ** 40,
            a_stream=0x10017))
    if name == "result":
        return jwire.serialize_result(_result_z())
    if name == "eval_keys":
        plane = _key_plane()

        def ksk(k):
            return JKeySwitchKey(jnp.asarray(plane + k),
                                 jnp.asarray(plane + k + 1))

        return jwire.serialize_evaluation_keys(JEvaluationKeys(
            n=4, n_limbs=2, special_q=0xFFF1, relin=ksk(0),
            rot={1: ksk(2), 3: ksk(4)}))
    return jwire.serialize_tenant_envelope("alice-tenant",
                                           JAX_PROFILES["tiny"],
                                           jwire.serialize_result(
                                               _result_z()))


def _words_of(obj) -> list:
    """Every word plane and scalar of a deserialized object, as numpy /
    Python values (port tensors and JAX arrays alike)."""
    def arr(x):
        if isinstance(x, torch.Tensor):
            return x.numpy().view(np.uint32)
        return np.asarray(x)

    if hasattr(obj, "relin"):                     # evaluation keys
        ksks = [obj.relin] + [obj.rot[r] for r in sorted(obj.rot)]
        return ([obj.n, obj.n_limbs, obj.special_q, sorted(obj.rot)]
                + [arr(p) for k in ksks for p in (k.b_mont, k.a_mont)])
    if hasattr(obj, "c0"):                        # ciphertexts
        return [arr(obj.c0), None if obj.c1 is None else arr(obj.c1),
                obj.n_limbs, obj.scale, getattr(obj, "a_stream", None)]
    if isinstance(obj, tuple):                    # tenant envelope
        tid, params, inner = obj
        return [tid, (params.logn, params.n_limbs, params.decrypt_limbs,
                      params.delta_bits, params.p_bw, params.seed), inner]
    return [np.asarray(obj)]                      # result


def _same(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("name", [k[0] for k in _KINDS])
def test_port_bytes_equal_jax_bytes(name):
    port = dict((k[0], k[1]) for k in _KINDS)[name]()
    assert port == _jax_payload(name)


@pytest.mark.parametrize("name", [k[0] for k in _KINDS])
def test_each_package_parses_the_others_payload(name):
    port_de = dict((k[0], k[2]) for k in _KINDS)[name]
    jax_de = {"ct_batch": jwire.deserialize_ciphertext_batch,
              "ct_seeded": jwire.deserialize_ciphertext_seeded,
              "result": jwire.deserialize_result,
              "eval_keys": jwire.deserialize_evaluation_keys,
              "tenant": jwire.deserialize_tenant_envelope}[name]
    port_buf = dict((k[0], k[1]) for k in _KINDS)[name]()
    jax_buf = _jax_payload(name)
    from_jax, from_port = port_de(jax_buf), jax_de(port_buf)
    _same(_words_of(from_jax), _words_of(port_de(port_buf)))
    _same(_words_of(from_port), _words_of(jax_de(jax_buf)))
    _same(_words_of(from_jax), _words_of(from_port))


def test_deserialized_tensors_are_the_ports_layout():
    """int32 tensors holding the uint32 words, on the device asked for
    (words above 2^31 included)."""
    c = _ct_words() + np.uint32(0xFFFFFF00)
    buf = wire.serialize_ciphertext_batch(CiphertextBatch(
        c0=_t(c), c1=_t(c), n_limbs=3, scale=3.5))
    got = wire.deserialize_ciphertext_batch(buf, device="cpu")
    assert got.c0.dtype == torch.int32 and got.c0.device.type == "cpu"
    np.testing.assert_array_equal(_u(got.c0), c)
    assert got.scale == 3.5 and got.n_limbs == 3


def test_serializing_a_seeded_ciphertext_needs_one():
    c = _t(np.zeros((3, 4), np.uint32))
    with pytest.raises(ValueError, match="seeded"):
        wire.serialize_ciphertext_seeded(Ciphertext(c, c, 3, 1.0))


# ---------------------------------------------------------------------------
# a round trip over the wire on the CPU
# ---------------------------------------------------------------------------


def test_tiny_round_trip_over_the_wire():
    """client -> kind 1 -> server (ct x pt with rescale: a scale that is
    not a power of two) -> kind 1 -> decrypt_batch, and the seeded upload
    (kind 2) at half a full ciphertext's words."""
    from repro_torch.core import encoder, encryptor
    from repro_torch.fhe_server import encoding
    client = FHEClient("tinyboot", device="cpu", pipeline="staged",
                       datapath="f64")
    ctx = client.ctx
    ns = ctx.params.n_slots
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, ns)) * 0.5
    up = wire.serialize_ciphertext_batch(client.encode_encrypt_batch(z))
    assert len(up) == 2 * client.ciphertext_bytes() + 28
    x = ServerCiphertext.from_batch(
        wire.deserialize_ciphertext_batch(up, device="cpu")).drop_to(4)
    w = rng.standard_normal(ns) * 0.5
    pt = encoding.encode_plaintext(w, ctx, 4, float(ctx.q_list[3]),
                                   device="cpu")
    y = ServerEvaluator(ctx, datapath="f64").mul_pt(x, pt)
    down = wire.serialize_ciphertext_batch(y.to_batch())
    back = wire.deserialize_ciphertext_batch(down, device="cpu")
    assert back.scale == y.scale and torch.equal(back.c0, y.c0)
    got = client.decrypt_batch(list(back))
    assert np.max(np.abs(got.real - z * w)) < 2.0 ** -12

    pt0 = encoder.encode(z[0], ctx, device="cpu")
    sct = encryptor.encrypt_symmetric_seeded(pt0, client.keys.sk, ctx,
                                             seed=client.seed, nonce=9)
    buf = wire.serialize_ciphertext_seeded(sct)
    assert len(buf) == client.ciphertext_bytes(seeded=True) + 16
    got = wire.deserialize_ciphertext_seeded(buf, device="cpu")
    full = encryptor.expand_seeded(got, ctx, seed=client.seed)
    dec = encryptor.decrypt(full, client.keys.sk, ctx)
    assert torch.equal(dec, encryptor.decrypt(
        encryptor.expand_seeded(sct, ctx, seed=client.seed),
        client.keys.sk, ctx))
    assert np.max(np.abs(encoder.decode(dec, ctx) - z[0])) < 2.0 ** -19


@pytest.mark.parametrize("profile,batch", [("tiny", 3), ("paper", 16)])
def test_upload_report_matches_jax(profile, batch):
    """FHEClient.upload_report and ciphertext_bytes equal the JAX
    client's (its report read from the same parameters, no key generation)
    and the lengths of the wire bodies they describe."""
    from repro.core.context import get_context as jget_context
    from repro.fhe_client.client import FHEClient as JFHEClient
    from repro_torch.core.context import get_context
    ref = object.__new__(JFHEClient)
    ref.ctx = jget_context(profile)
    mine = object.__new__(FHEClient)
    mine.ctx = get_context(profile)
    got = mine.upload_report(batch)
    assert got == ref.upload_report(batch)
    p = mine.ctx.params
    words = np.zeros((batch, p.n_limbs, p.n), np.uint32)
    full = wire.serialize_ciphertext_batch(
        CiphertextBatch(_t(words), _t(words), p.n_limbs, p.delta))
    head = wire._HDR.size
    assert len(full) - head - wire._CT_BATCH.size == batch * got["ct_bytes"]
    seeded = wire.serialize_ciphertext_seeded(
        Ciphertext(_t(words[0]), None, p.n_limbs, p.delta, a_stream=7))
    # the report counts c0 and a 128-bit stream id
    assert len(seeded) - head - wire._CT_SEEDED.size == (
        got["ct_bytes_seeded"] - 16)
