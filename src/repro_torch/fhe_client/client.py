"""FHE client: batched CKKS encode+encrypt and decrypt+decode on the card.

Port of ``repro.fhe_client.client.FHEClient`` with ``fourier='device'``
and ``datapath='df32'``, in both of the reference's pipelines:

  * ``pipeline='megakernel'`` (the default): each direction is one CUDA
    megakernel launch (K5, K6);
  * ``pipeline='staged'``: the same client operation split into separate
    launches, with plain eager torch glue between them on the card.
    encode: SpecialIFFT (K4) -> Delta-scale digits and RNS -> limb-folded
    NTT (K1) -> folded encrypt (K2); decode: folded decrypt + INTT (K3) ->
    CRT and /Delta -> SpecialFFT (K4).

``kernels.ops`` sends CUDA tensors to the kernels and CPU tensors to their
plain PyTorch versions. Messages are packed as in the reference;
ciphertexts from the same seed and nonce base are bit-identical to the JAX
client's, and the two pipelines give the same ciphertexts.

The client runs on ``device`` (default ``cuda``; no silent CPU fall-back:
the tests pass ``device='cpu'`` explicitly).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core import encoder, encryptor, modmul, rns
from repro_torch.core.context import CKKSContext, get_context
from repro_torch.core.encryptor import CiphertextBatch
from repro_torch.kernels import ops as kops

PIPELINES = ("staged", "megakernel")

# configurations of the reference client that the port has not ported yet,
# and the ROADMAP.md item that will port each
_NOT_PORTED = {
    "fourier": ("device", "fourier='host' (ROADMAP.md queue 1, item 6)"),
    "datapath": ("df32", "datapath='f64' (ROADMAP.md queue 1, item 6; "
                 "queue 2, the f64 branches of K5/K6)"),
}


@dataclasses.dataclass
class ClientKeys:
    sk: encryptor.SecretKey
    pk: encryptor.PublicKey


def keys_from_numpy(s_mont, b_mont, a_mont, s_coeffs, device) -> ClientKeys:
    """Client keys from numpy arrays (e.g. the JAX client's ``ClientKeys``:
    (L, N) uint32 ``s_mont``/``b_mont``/``a_mont``, (N,) int32 ternary
    ``s_coeffs``) as the port's int32 tensors on `device`."""
    def words(a):
        a = np.ascontiguousarray(a)
        if a.dtype not in (np.uint32, np.int32) or a.ndim != 2:
            raise ValueError(f"expected an (L, N) uint32 array, got "
                             f"{a.dtype} {a.shape}")
        return torch.tensor(a.view(np.int32), device=device)

    sk = encryptor.SecretKey(
        s_mont=words(s_mont),
        s_coeffs=torch.tensor(np.asarray(s_coeffs, np.int32), device=device))
    pk = encryptor.PublicKey(b_mont=words(b_mont), a_mont=words(a_mont))
    return ClientKeys(sk, pk)


class FHEClient:
    """Client-side encode/encrypt + decode/decrypt over model activations.

    ``profile`` is a profile name or a ``CKKSParams``. ``pipeline`` is
    ``'megakernel'`` (default) or ``'staged'``; ``fourier='host'`` and
    ``datapath='f64'`` are not ported yet and raise ``NotImplementedError``
    naming the ROADMAP item that will port them.
    """

    def __init__(self, profile="test", seed: int | None = None, device=None,
                 fourier: str = "device", pipeline: str | None = None,
                 datapath: str | None = None):
        for name, value in (("fourier", fourier), ("datapath", datapath)):
            ported, todo = _NOT_PORTED[name]
            if value is not None and value != ported:
                raise NotImplementedError(f"{name}={value!r} is not ported "
                                          f"yet: {todo}")
        pipeline = "megakernel" if pipeline is None else pipeline
        if pipeline not in PIPELINES:
            raise ValueError(f"pipeline must be one of {PIPELINES}, got "
                             f"{pipeline!r}")
        self.pipeline = pipeline
        if device is None:
            device = torch.device("cuda")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FHEClient runs on the card by default and "
                               "CUDA is not available; pass device='cpu' "
                               "for the plain PyTorch path")
        self.ctx: CKKSContext = get_context(profile)
        encoder._check_pow2_delta(self.ctx.params.delta)
        # keys both keygen and every encryption's (v, e0, e1) streams
        self.seed = int(seed) if seed is not None else self.ctx.params.seed
        self.keys = ClientKeys(*encryptor.keygen(self.ctx, seed=self.seed,
                                                 device=self.device))
        self._nonce = 0

    def load_keys(self, s_mont, b_mont, a_mont, s_coeffs) -> None:
        """Replace the keys with numpy arrays (``keys_from_numpy``)."""
        self.keys = keys_from_numpy(s_mont, b_mont, a_mont, s_coeffs,
                                    self.device)

    # --- message packing ----------------------------------------------------

    def slot_capacity(self) -> int:
        """Real values per ciphertext (real/imag interleaving)."""
        return 2 * self.ctx.params.n_slots

    def pack(self, x: np.ndarray) -> np.ndarray:
        """Activation rows (B, F) -> complex slot rows (B*k, n_slots)."""
        b, f = x.shape
        cap = self.slot_capacity()
        k = -(-f // cap)
        buf = np.zeros((b, k * cap), np.float64)
        buf[:, :f] = x
        buf = buf.reshape(b * k, cap)
        n_slots = self.ctx.params.n_slots
        return buf[:, :n_slots] + 1j * buf[:, n_slots:]

    def unpack(self, z: np.ndarray, f: int) -> np.ndarray:
        cap = self.slot_capacity()
        k = -(-f // cap)
        b = z.shape[0] // k
        buf = np.concatenate([z.real, z.imag], axis=-1)
        return buf.reshape(b, k * cap)[:, :f]

    # --- operands and results -----------------------------------------------

    def encrypt_operands(self, messages) -> tuple:
        """(B, n_slots) complex -> four float32 df planes (re_hi, re_lo,
        im_hi, im_lo) on the client's device; the split is host numpy, as
        in the reference."""
        msgs = np.asarray(messages, np.complex128)
        rh = msgs.real.astype(np.float32)
        ih = msgs.imag.astype(np.float32)
        rl = (msgs.real - rh).astype(np.float32)
        il = (msgs.imag - ih).astype(np.float32)
        return tuple(torch.from_numpy(p).to(self.device)
                     for p in (rh, rl, ih, il))

    def _scale_operand(self, scale, batch: int) -> torch.Tensor:
        """(B,) float32 scales; only powers of two (exact in float32)."""
        s = np.asarray(scale, np.float64)
        for v in np.atleast_1d(s).ravel():
            encoder._check_pow2_delta(v)
        s = np.broadcast_to(s.reshape(-1), (batch,)).astype(np.float32)
        return torch.tensor(s, device=self.device)

    def decrypt_operands(self, cts: CiphertextBatch) -> tuple:
        """(c0, c1, scale): the 2-limb views and (B,) float32 scales."""
        return (cts.c0[:, :2], cts.c1[:, :2],
                self._scale_operand(cts.scale, len(cts)))

    def decrypt_results(self, parts) -> np.ndarray:
        """Four float32 planes -> (B, n_slots) complex128 (f64 collapse)."""
        rh, rl, ih, il = (p.cpu().numpy().astype(np.float64) for p in parts)
        return (rh + rl) + 1j * (ih + il)

    # --- nonce discipline ----------------------------------------------------

    @property
    def nonce(self) -> int:
        """Next unused PRNG nonce (settable to pin a base in tests; never
        rewind in production: (seed, nonce) reuse breaks RLWE security)."""
        return self._nonce

    @nonce.setter
    def nonce(self, value: int):
        self._nonce = int(value)

    def take_nonces(self, count: int) -> int:
        """Reserve ``count`` consecutive nonces and return the base; row r
        of a batch encrypts under base + r."""
        base = self._nonce
        self._nonce += int(count)
        return base

    # --- the cores of the two pipelines ---------------------------------------

    def _encrypt_core_mega32_impl(self, rh, rl, ih, il, nonce0: int):
        """Four (B, n_slots) float32 slot planes -> (c0, c1) (B, L, N): one
        megakernel launch (K5)."""
        return kops.encode_encrypt_stream(
            (rh, rl, ih, il), self.keys.pk.b_mont, self.keys.pk.a_mont,
            self.ctx, self.seed, nonce0)

    def _decrypt_core_mega32_impl(self, c0, c1, scale):
        """(B, 2, N) ciphertext views -> four (B, n_slots) float32 decoded
        planes: one megakernel launch (K6)."""
        return kops.decrypt_decode_stream(c0, c1, self.keys.sk.s_mont,
                                          self.ctx, scale)

    def _encrypt_core_dev32_impl(self, rh, rl, ih, il, nonce0: int):
        """The staged encode+encrypt: SpecialIFFT (K4), df32 Delta-scale
        digits, RNS reduction of every limb, limb-folded NTT (K1), fused
        encrypt (K2). The glue between the kernels is eager torch."""
        ctx = self.ctx
        p = ctx.params
        w = dfl.dfc_from_planes(kops.special_ifft_planes((rh, rl, ih, il),
                                                         p.m))
        digits = encoder.delta_scale_digits(encoder.planes_to_coeff_df(w),
                                            p.delta)
        residues = rns.digits_to_residues_stacked(
            *digits, ctx.q_list[:p.n_limbs])                  # (L, B, N)
        pt = kops.ntt_limbs(modmul.i64_to_u32(residues), ctx)
        return kops.encrypt_fused(pt.transpose(0, 1), self.keys.pk.b_mont,
                                  self.keys.pk.a_mont, ctx, seed=self.seed,
                                  nonce0=nonce0)              # (B, L, N)

    def _decrypt_core_dev32_impl(self, c0, c1, scale):
        """The staged decrypt+decode: fused decrypt + INTT (K3), uint32
        two-limb CRT and exact /scale pair, SpecialFFT (K4)."""
        ctx = self.ctx
        ns = ctx.params.n_slots
        m = kops.decrypt_fused(c0, c1, self.keys.sk.s_mont, ctx)
        sign, vh, vl = rns.crt2_centered_u32(
            modmul.u32_to_i64(m[:, 0]), modmul.u32_to_i64(m[:, 1]),
            ctx.q_list[0], ctx.q_list[1])
        x = rns.centered_to_df(sign, vh, vl, 1.0 / scale.reshape(-1, 1))
        planes = (x.hi[:, :ns], x.lo[:, :ns], x.hi[:, ns:], x.lo[:, ns:])
        return kops.special_fft_planes(planes, ctx.params.m)

    @property
    def encrypt_impl(self):
        """Encrypt core ``f(rh, rl, ih, il, nonce0) -> (c0, c1)`` of the
        configured pipeline (row-independent over the batch)."""
        if self.pipeline == "megakernel":
            return self._encrypt_core_mega32_impl
        return self._encrypt_core_dev32_impl

    @property
    def decrypt_impl(self):
        """Decrypt core ``f(c0, c1, scale) -> four planes`` of the
        configured pipeline."""
        if self.pipeline == "megakernel":
            return self._decrypt_core_mega32_impl
        return self._decrypt_core_dev32_impl

    # --- the two client operations -------------------------------------------

    def encode_encrypt_batch(self, messages: np.ndarray) -> CiphertextBatch:
        """(B, n_slots) complex messages -> CiphertextBatch (B, L, N)."""
        p = self.ctx.params
        if np.shape(messages)[0] == 0:
            raise ValueError("encode_encrypt_batch needs a non-empty batch")
        nonce0 = self.take_nonces(np.shape(messages)[0])
        c0, c1 = self.encrypt_impl(*self.encrypt_operands(messages), nonce0)
        return CiphertextBatch(c0=c0, c1=c1, n_limbs=p.n_limbs,
                               scale=p.delta)

    def decrypt_planes(self, cts: CiphertextBatch) -> tuple:
        """CiphertextBatch (first 2 limbs used) -> four (B, n_slots)
        float32 decoded planes on the device."""
        return self.decrypt_impl(*self.decrypt_operands(cts))

    def decrypt_decode_batch(self, cts: CiphertextBatch) -> np.ndarray:
        """CiphertextBatch -> (B, n_slots) complex messages."""
        return self.decrypt_results(self.decrypt_planes(cts))

    def ciphertext_bytes(self, seeded: bool = False) -> int:
        p = self.ctx.params
        polys = 1 if seeded else 2
        return polys * p.n_limbs * p.n * 4 + (16 if seeded else 0)


def simulate_private_inference(client: FHEClient, serve_fn, x: np.ndarray,
                               out_features: int):
    """encrypt -> (trust boundary) -> serve -> encrypt result -> decrypt;
    `serve_fn`: (B, F) -> (B, out_features) plaintext stand-in server."""
    msgs = client.pack(x)
    cts = client.encode_encrypt_batch(msgs)
    served_inputs = client.decrypt_decode_batch(cts.truncated(2))
    x_rec = client.unpack(served_inputs, x.shape[1])
    y = serve_fn(x_rec.astype(np.float32))
    y_cts = client.encode_encrypt_batch(client.pack(y.astype(np.float64)))
    y_dec = client.decrypt_decode_batch(y_cts.truncated(2))
    return client.unpack(y_dec, out_features), {
        "roundtrip_err": float(np.max(np.abs(x_rec - x))),
    }
