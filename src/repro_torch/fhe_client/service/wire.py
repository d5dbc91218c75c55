"""Wire layer: deterministic serialization of what crosses the client /
server boundary.

Port of ``repro.fhe_client.service.wire``, byte for byte: the same five
payload kinds, the same fixed struct layouts (magic, version and kind
header; little-endian scalars) and the same C-order little-endian uint32 /
float64 planes, so a payload either package writes, the other parses to
the same words.

  * full ciphertext batches: (B, L, N) residue stacks (c0, c1);
  * seeded ciphertexts: c0 plus the PRNG stream id that regenerates ``a``
    on the receiver (half the upload);
  * decoded results: (B, n_slots) complex message batches;
  * evaluation keys: relinearization and rotation key-switch keys (RLWE
    pairs under the secret key, never the key itself);
  * tenant envelopes: a payload wrapped with its lane identity (tenant id
    and CKKS parameter fingerprint).

Serializers take the port's objects (int32 tensors holding uint32 words, on
any device); deserializers return them, their tensors on ``device``
(default ``cuda``). Every deserializer checks the exact total length before
it reads a plane: a short buffer is a truncation, a long one trailing
garbage, and both raise ``ValueError``. No pickle: the format is a fixed
struct layout, safe to parse from an untrusted peer.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from repro_torch.core.encryptor import Ciphertext, CiphertextBatch

MAGIC = b"ABCW"
VERSION = 1

KIND_CT_BATCH = 1
KIND_CT_SEEDED = 2
KIND_RESULT = 3
KIND_EVAL_KEYS = 4
KIND_TENANT = 5

_HDR = struct.Struct("<4sBBxx")          # magic, version, kind, pad
_CT_BATCH = struct.Struct("<IIId")       # B, L, N, scale
_CT_SEEDED = struct.Struct("<IIdQ")      # L, N, scale, a_stream
_RESULT = struct.Struct("<II")           # B, n_slots
_EVAL_KEYS = struct.Struct("<IIIBxxxI")  # N, L, special_q, has_relin, n_rot
_TENANT = struct.Struct("<BHHHH16sII")   # logn, L, dec_L, delta_bits,
#                                          p_bw, base seed, tid_len, n_inner
# the seed travels masked to the 128-bit Philox width
_SEED128 = (1 << 128) - 1


def _u32_bytes(t) -> bytes:
    """An int32 tensor of uint32 words (or a uint32 array) -> its
    little-endian uint32 plane."""
    if isinstance(t, torch.Tensor):
        t = t.detach().contiguous().cpu().numpy().view(np.uint32)
    return np.ascontiguousarray(np.asarray(t), dtype="<u4").tobytes()


def _f64_bytes(x) -> bytes:
    return np.ascontiguousarray(np.asarray(x), dtype="<f8").tobytes()


def _words(buf: bytes, count: int, offset: int, shape, device
           ) -> torch.Tensor:
    """A uint32 plane of `buf` as an int32 tensor of the same words on
    `device`."""
    a = np.frombuffer(buf, dtype="<u4", count=count, offset=offset)
    t = torch.from_numpy(a.astype(np.uint32).view(np.int32).reshape(shape))
    return t.to(torch.device("cuda" if device is None else device))


def _header(kind: int) -> bytes:
    return _HDR.pack(MAGIC, VERSION, kind)


def _parse_header(buf: bytes, expect_kind: int | None = None) -> int:
    if len(buf) < _HDR.size:
        raise ValueError(f"wire payload truncated: {len(buf)} bytes is "
                         f"shorter than the {_HDR.size}-byte header")
    magic, version, kind = _HDR.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError(f"bad wire magic {magic!r}")
    if version != VERSION:
        raise ValueError(f"unsupported wire version {version}")
    if expect_kind is not None and kind != expect_kind:
        raise ValueError(f"expected wire kind {expect_kind}, got {kind}")
    return kind


def _unpack_at(st: struct.Struct, buf: bytes, off: int, what: str):
    """Unpack a body-header struct, with a truncation error in place of a
    raw ``struct.error``."""
    if len(buf) < off + st.size:
        raise ValueError(
            f"{what} payload truncated inside its body header: need "
            f"{off + st.size} bytes, got {len(buf)}")
    return st.unpack_from(buf, off)


def _check_total(buf: bytes, expected: int, what: str) -> None:
    """The exact-total-length contract of every deserializer: a short
    buffer is a truncation, a long one trailing garbage; both raise."""
    if len(buf) < expected:
        raise ValueError(f"{what} payload truncated: expected {expected} "
                         f"bytes, got {len(buf)}")
    if len(buf) > expected:
        raise ValueError(f"{what} payload carries {len(buf) - expected} "
                         f"trailing bytes past its {expected}-byte "
                         f"encoding (trailing garbage rejected)")


def serialize_ciphertext_batch(cts: CiphertextBatch) -> bytes:
    """(B, L, N) ciphertext batch -> bytes (c0 plane then c1 plane)."""
    b, l, n = tuple(cts.c0.shape)
    return b"".join([
        _header(KIND_CT_BATCH),
        _CT_BATCH.pack(b, l, n, float(cts.scale)),
        _u32_bytes(cts.c0),
        _u32_bytes(cts.c1),
    ])


def deserialize_ciphertext_batch(buf: bytes, device=None) -> CiphertextBatch:
    _parse_header(buf, KIND_CT_BATCH)
    off = _HDR.size
    b, l, n, scale = _unpack_at(_CT_BATCH, buf, off, "ciphertext batch")
    off += _CT_BATCH.size
    plane = b * l * n * 4
    _check_total(buf, off + 2 * plane, "ciphertext batch")
    c0 = _words(buf, b * l * n, off, (b, l, n), device)
    c1 = _words(buf, b * l * n, off + plane, (b, l, n), device)
    return CiphertextBatch(c0=c0, c1=c1, n_limbs=l, scale=scale)


def serialize_ciphertext_seeded(ct: Ciphertext) -> bytes:
    """Seeded ciphertext: c0 and the stream id that regenerates a; half
    the upload of a full (c0, c1) pair."""
    if ct.c1 is not None or ct.a_stream is None:
        raise ValueError("not a seeded ciphertext (c1 must be None with an "
                         "a_stream id); use serialize_ciphertext_batch for "
                         "full ciphertexts")
    l, n = tuple(ct.c0.shape)
    return b"".join([
        _header(KIND_CT_SEEDED),
        _CT_SEEDED.pack(l, n, float(ct.scale), int(ct.a_stream)),
        _u32_bytes(ct.c0),
    ])


def deserialize_ciphertext_seeded(buf: bytes, device=None) -> Ciphertext:
    _parse_header(buf, KIND_CT_SEEDED)
    off = _HDR.size
    l, n, scale, a_stream = _unpack_at(_CT_SEEDED, buf, off,
                                       "seeded ciphertext")
    off += _CT_SEEDED.size
    _check_total(buf, off + l * n * 4, "seeded ciphertext")
    return Ciphertext(c0=_words(buf, l * n, off, (l, n), device), c1=None,
                      n_limbs=l, scale=scale, a_stream=a_stream)


def serialize_result(z) -> bytes:
    """(B, n_slots) complex message batch -> bytes (re plane, im plane)."""
    z = np.asarray(z, np.complex128)
    if z.ndim == 1:
        z = z[None]
    b, n = z.shape
    return b"".join([
        _header(KIND_RESULT),
        _RESULT.pack(b, n),
        _f64_bytes(z.real),
        _f64_bytes(z.imag),
    ])


def deserialize_result(buf: bytes) -> np.ndarray:
    """-> (B, n_slots) complex128 numpy array (host data: no device)."""
    _parse_header(buf, KIND_RESULT)
    off = _HDR.size
    b, n = _unpack_at(_RESULT, buf, off, "result batch")
    off += _RESULT.size
    plane = b * n * 8
    _check_total(buf, off + 2 * plane, "result batch")
    re = np.frombuffer(buf, dtype="<f8", count=b * n, offset=off)
    im = np.frombuffer(buf, dtype="<f8", count=b * n, offset=off + plane)
    return (re + 1j * im).reshape(b, n)


def serialize_evaluation_keys(keys) -> bytes:
    """``fhe_server.keys.EvaluationKeys`` -> bytes: counts and sorted
    rotation ids, then per key (relin first, rotations in id order) the b
    plane then the a plane, each an (L, L+1, N) uint32 stack in C order."""
    rot_ids = sorted(keys.rot)
    parts = [
        _header(KIND_EVAL_KEYS),
        _EVAL_KEYS.pack(keys.n, keys.n_limbs, keys.special_q,
                        1 if keys.relin is not None else 0, len(rot_ids)),
        np.asarray(rot_ids, dtype="<u4").tobytes(),
    ]
    ksks = ([keys.relin] if keys.relin is not None else []) + \
        [keys.rot[r] for r in rot_ids]
    for ksk in ksks:
        parts.append(_u32_bytes(ksk.b_mont))
        parts.append(_u32_bytes(ksk.a_mont))
    return b"".join(parts)


def deserialize_evaluation_keys(buf: bytes, device=None):
    from repro_torch.fhe_server.keys import EvaluationKeys, KeySwitchKey
    _parse_header(buf, KIND_EVAL_KEYS)
    off = _HDR.size
    n, l, special_q, has_relin, n_rot = _unpack_at(
        _EVAL_KEYS, buf, off, "evaluation keys")
    off += _EVAL_KEYS.size
    count = l * (l + 1) * n
    _check_total(buf, off + 4 * n_rot + (has_relin + n_rot) * 2 * 4 * count,
                 "evaluation keys")
    rot_ids = np.frombuffer(buf, dtype="<u4", count=n_rot, offset=off)
    off += 4 * n_rot

    def plane():
        nonlocal off
        t = _words(buf, count, off, (l, l + 1, n), device)
        off += 4 * count
        return t

    relin = KeySwitchKey(plane(), plane()) if has_relin else None
    rot = {int(r): KeySwitchKey(plane(), plane()) for r in rot_ids}
    return EvaluationKeys(n=n, n_limbs=l, special_q=special_q, relin=relin,
                          rot=rot)


def serialize_tenant_envelope(tenant_id, params, payload: bytes) -> bytes:
    """Wrap a serialized payload with its lane identity (the tenant id and
    the CKKS parameter fingerprint), so a gateway can route it without
    decoding the body. The seed travels masked to its 128-bit width."""
    tid = str(tenant_id).encode("utf-8")
    return b"".join([
        _header(KIND_TENANT),
        _TENANT.pack(params.logn, params.n_limbs, params.decrypt_limbs,
                     params.delta_bits, params.p_bw,
                     (int(params.seed) & _SEED128).to_bytes(16, "little"),
                     len(tid), len(payload)),
        tid,
        payload,
    ])


def deserialize_tenant_envelope(buf: bytes):
    """-> (tenant_id: str, params: CKKSParams, inner payload bytes)."""
    from repro_torch.core.context import CKKSParams
    _parse_header(buf, KIND_TENANT)
    off = _HDR.size
    (logn, l, dec_l, delta_bits, p_bw, seed,
     tid_len, n_inner) = _unpack_at(_TENANT, buf, off, "tenant envelope")
    off += _TENANT.size
    # the exact total before any slice: a short buffer must never yield a
    # shorter tenant id
    _check_total(buf, off + tid_len + n_inner, "tenant envelope")
    tid = buf[off:off + tid_len].decode("utf-8")
    off += tid_len
    inner = bytes(buf[off:off + n_inner])
    params = CKKSParams(logn=logn, n_limbs=l, decrypt_limbs=dec_l,
                        delta_bits=delta_bits, p_bw=p_bw,
                        seed=int.from_bytes(seed, "little"))
    return tid, params, inner


def payload_kind(buf: bytes) -> int:
    """Peek a payload's kind tag (KIND_CT_BATCH / KIND_CT_SEEDED /
    KIND_RESULT / KIND_EVAL_KEYS / KIND_TENANT) without decoding the
    body."""
    return _parse_header(buf)
