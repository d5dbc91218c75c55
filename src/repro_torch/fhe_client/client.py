"""FHE client: batched CKKS encode+encrypt and decrypt+decode on the card,
and the evaluation keys a server evaluates with.

Port of ``repro.fhe_client.client.FHEClient``, in every configuration of
the reference:

  * ``fourier='device'`` (the default) keeps the whole chain on the card,
    in one of two pipelines:

      - ``pipeline='megakernel'`` (the default): each direction is one
        CUDA megakernel launch (K5, K6);
      - ``pipeline='staged'``: the same client operation split into
        separate launches, with plain eager torch glue between them on the
        card: SpecialIFFT (K4) -> Delta-scale and RNS -> limb-folded NTT
        (K1) -> folded encrypt (K2), and folded decrypt + INTT (K3) -> CRT
        and /scale -> SpecialFFT (K4);

    and one of two datapaths: ``'df32'`` (the default) carries the
    Delta-scale and the CRT in float32 pairs and uint32 words and takes
    power-of-two scales only; ``'f64'`` carries them in float64 and 64-bit
    integers (df64 Delta-scale, fmod RNS, df64 CRT, float64 /scale) and
    takes any scale, which a server's ct x ct rescales produce. Both give
    the same ciphertext words (at Delta = 2^55 up to a rare coefficient
    that the f64 datapath's float64 collapse rounds to its neighbour, as
    the reference's does).
  * ``fourier='host'``: the reference's complex128 oracle client. The
    SpecialIFFT / SpecialFFT are numpy complex128 transforms on the host
    (that is this configuration's definition, not a fall-back); between
    them the card runs the f64 Delta-scale and RNS, the limb-folded NTT
    (K1) and encrypt (K2), and the decrypt + INTT (K3) and the df64 CRT.
    It is ``pipeline='staged'``, ``datapath='f64'`` by construction.

``kernels.ops`` sends CUDA tensors to the kernels and CPU tensors to their
plain PyTorch versions. Messages are packed as in the reference;
ciphertexts from the same seed and nonce base are bit-identical to the JAX
client's, whatever the configuration. ``make_evaluation_keys`` makes the
relinearization and rotation keys of ``fhe_server.ServerEvaluator``.

The client runs on ``device``, a keyword-only parameter after the
reference's ``(profile, seed, fourier, pipeline, datapath)`` (default
``cuda``; no silent CPU fall-back: the tests pass ``device='cpu'``
explicitly).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core import encoder, encryptor, modmul, rns
from repro_torch.core.context import CKKSContext, get_context
from repro_torch.core.encryptor import CiphertextBatch
from repro_torch.fhe_server import keys as server_keys
from repro_torch.fhe_server.ct import ServerPlaintext
from repro_torch.kernels import common as kcommon
from repro_torch.kernels import ops as kops

FOURIERS = ("device", "host")
PIPELINES = ("staged", "megakernel")


@dataclasses.dataclass
class ClientKeys:
    sk: encryptor.SecretKey
    pk: encryptor.PublicKey


def _words(a, ndim: int, what: str, device) -> torch.Tensor:
    """A uint32 (or int32) numpy array of `ndim` dimensions as the int32
    tensor of the same words on `device`."""
    a = np.ascontiguousarray(a)
    if a.dtype not in (np.uint32, np.int32) or a.ndim != ndim:
        raise ValueError(f"expected {what} uint32 array, got {a.dtype} "
                         f"{a.shape}")
    return torch.tensor(a.view(np.int32), device=device)


def keys_from_numpy(s_mont, b_mont, a_mont, s_coeffs, device) -> ClientKeys:
    """Client keys from numpy arrays (e.g. the JAX client's ``ClientKeys``:
    (L, N) uint32 ``s_mont``/``b_mont``/``a_mont``, (N,) int32 ternary
    ``s_coeffs``) as the port's int32 tensors on `device`."""
    def words(a):
        return _words(a, 2, "an (L, N)", device)

    sk = encryptor.SecretKey(
        s_mont=words(s_mont),
        s_coeffs=torch.tensor(np.asarray(s_coeffs, np.int32), device=device))
    pk = encryptor.PublicKey(b_mont=words(b_mont), a_mont=words(a_mont))
    return ClientKeys(sk, pk)


def evaluation_keys_from_numpy(n: int, n_limbs: int, special_q: int, relin,
                               rot: dict,
                               device) -> server_keys.EvaluationKeys:
    """Evaluation keys from numpy arrays (e.g. the JAX client's
    ``EvaluationKeys``): `relin` a (b_mont, a_mont) pair or None, `rot`
    {r: (b_mont, a_mont)}, each (L, L+1, N) uint32, as the port's int32
    tensors on `device`."""
    def ksk(pair):
        b, a = (_words(x, 3, "an (L, L+1, N)", device) for x in pair)
        return server_keys.KeySwitchKey(b_mont=b, a_mont=a)

    return server_keys.EvaluationKeys(
        n=int(n), n_limbs=int(n_limbs), special_q=int(special_q),
        relin=None if relin is None else ksk(relin),
        rot={int(r): ksk(pair) for r, pair in rot.items()})


def server_plaintext_from_numpy(data, data_mont, level: int, scale: float,
                                device) -> ServerPlaintext:
    """A server plaintext from numpy arrays (e.g. the JAX package's
    ``ServerPlaintext``: (level, N) uint32 ``data`` / ``data_mont``)."""
    return ServerPlaintext(
        data=_words(data, 2, "a (level, N)", device),
        data_mont=_words(data_mont, 2, "a (level, N)", device),
        level=int(level), scale=float(scale))


class FHEClient:
    """Client-side encode/encrypt + decode/decrypt over model activations.

    ``profile`` is a profile name or a ``CKKSParams``. ``fourier`` is
    ``'device'`` (default) or ``'host'``; ``pipeline`` is ``'megakernel'``
    (the default for the device Fourier engine) or ``'staged'`` (the
    default, and the only pipeline, for the host one); ``datapath`` is
    ``'df32'`` (the device default, power-of-two scales) or ``'f64'`` (the
    host default and only datapath). Any other combination raises
    ``ValueError``, as in the reference.
    """

    def __init__(self, profile="test", seed: int | None = None,
                 fourier: str = "device", pipeline: str | None = None,
                 datapath: str | None = None, *, device=None):
        if fourier not in FOURIERS:
            raise ValueError(f"fourier must be one of {FOURIERS}, got "
                             f"{fourier!r}")
        if pipeline is None:
            pipeline = "megakernel" if fourier == "device" else "staged"
        if pipeline not in PIPELINES:
            raise ValueError(f"pipeline must be one of {PIPELINES}, got "
                             f"{pipeline!r}")
        if pipeline == "megakernel" and fourier != "device":
            raise ValueError("pipeline='megakernel' runs the df32 Fourier "
                             "stages inside the kernel and requires "
                             "fourier='device'")
        if datapath is None:
            datapath = "df32" if fourier == "device" else "f64"
        kcommon.check_datapath(datapath)
        if datapath == "df32" and fourier != "device":
            raise ValueError("datapath='df32' is the device kernels' datapath "
                             "and requires fourier='device' (the host "
                             "oracle is f64 by construction)")
        self.fourier = fourier
        self.pipeline = pipeline
        self.datapath = datapath
        if device is None:
            device = torch.device("cuda")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FHEClient runs on the card by default and "
                               "CUDA is not available; pass device='cpu' "
                               "for the plain PyTorch path")
        self.ctx: CKKSContext = get_context(profile)
        if datapath == "df32":
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

    def make_evaluation_keys(self, rotations=(), include_relin: bool = True,
                             seed: int | None = None):
        """Relinearization and rotation keys for a
        ``fhe_server.ServerEvaluator`` (hybrid key switching, one special
        prime), on the client's device. Only RLWE-encrypted key pairs leave
        this method. ``rotations``: the slot left-rotations the server may
        apply (e.g. ``fhe_server.inference.matvec_rotations(d)``);
        ``include_relin=False`` leaves out the relinearization key; the key
        stream is seeded by ``seed``, the profile's seed when None, as in
        the reference."""
        return server_keys.make_evaluation_keys(
            self.ctx, self.keys.sk, rotations=rotations,
            include_relin=include_relin, seed=seed)

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

    @property
    def n_encrypt_operands(self) -> int:
        """The number of tensors ``encrypt_operands`` returns."""
        if self.fourier != "device":
            return 1
        return 4 if self.datapath == "df32" else 2

    def encrypt_operands(self, messages) -> tuple:
        """(B, n_slots) complex -> the encrypt core's operands on the
        client's device: four float32 df planes (re_hi, re_lo, im_hi,
        im_lo), split in host numpy as in the reference, on the df32
        datapath; the float64 (re, im) parts on the f64 datapath; the
        (B, N) float64 coefficients of the host SpecialIFFT for
        ``fourier='host'``."""
        msgs = np.asarray(messages, np.complex128)
        if self.fourier == "host":
            coeffs = encoder.slots_to_coeffs(msgs, self.ctx)
            return (torch.from_numpy(coeffs).to(self.device),)
        if self.datapath == "f64":
            return (torch.from_numpy(msgs.real.copy()).to(self.device),
                    torch.from_numpy(msgs.imag.copy()).to(self.device))
        rh = msgs.real.astype(np.float32)
        ih = msgs.imag.astype(np.float32)
        rl = (msgs.real - rh).astype(np.float32)
        il = (msgs.imag - ih).astype(np.float32)
        return tuple(torch.from_numpy(p).to(self.device)
                     for p in (rh, rl, ih, il))

    def _scale_operand(self, scale, batch: int) -> torch.Tensor:
        """Per-row scales: (B,) float32 on the df32 datapath (powers of two
        only, exact in float32), (B, 1) float64 on the f64 datapath."""
        s = np.asarray(scale, np.float64)
        if self.datapath == "f64":
            s = np.broadcast_to(s.reshape(-1), (batch,)).reshape(batch, 1)
            return torch.tensor(s, dtype=torch.float64, device=self.device)
        for v in np.atleast_1d(s).ravel():
            encoder._check_pow2_delta(v)
        s = np.broadcast_to(s.reshape(-1), (batch,)).astype(np.float32)
        return torch.tensor(s, device=self.device)

    def decrypt_operands(self, cts: CiphertextBatch) -> tuple:
        """(c0, c1, scale): the 2-limb views and the datapath's scale
        operand (``_scale_operand``)."""
        return (cts.c0[:, :2], cts.c1[:, :2],
                self._scale_operand(cts.scale, len(cts)))

    def decrypt_results(self, parts, scale=None) -> np.ndarray:
        """The decrypt core's parts -> (B, n_slots) complex128: four float32
        planes collapsed in float64 (df32), or the float64 (re, im) parts
        (f64); for ``fourier='host'`` the df64 CRT pair, finished here by
        the host /scale (`scale`: a scalar or a (B, 1) array) and
        SpecialFFT."""
        if self.fourier == "host":
            hi, lo = (p.cpu().numpy() for p in parts)
            return encoder.coeffs_to_slots(hi + lo, self.ctx, scale)
        if self.datapath == "f64":
            re, im = (p.cpu().numpy() for p in parts)
            return re + 1j * im
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

    # --- the cores of the configurations -------------------------------------

    def _encrypt_core_mega32_impl(self, rh, rl, ih, il, nonce0: int):
        """Four (B, n_slots) float32 slot planes -> (c0, c1) (B, L, N): one
        megakernel launch (K5)."""
        return kops.encode_encrypt_stream(
            (rh, rl, ih, il), self.keys.pk.b_mont, self.keys.pk.a_mont,
            self.ctx, self.seed, nonce0, datapath="df32")

    def _decrypt_core_mega32_impl(self, c0, c1, scale):
        """(B, 2, N) ciphertext views -> four (B, n_slots) float32 decoded
        planes: one megakernel launch (K6)."""
        return kops.decrypt_decode_stream(c0, c1, self.keys.sk.s_mont,
                                          self.ctx, scale, datapath="df32")

    def _encrypt_core_mega_impl(self, re, im, nonce0: int):
        """(B, n_slots) float64 slot parts -> (c0, c1) (B, L, N): the df32
        split on the card, then one megakernel launch on the f64 datapath
        (K5's f64 branch)."""
        z = dfl.dfc_from_parts(re, im)
        return kops.encode_encrypt_stream(
            dfl.dfc_to_planes(z), self.keys.pk.b_mont, self.keys.pk.a_mont,
            self.ctx, self.seed, nonce0, datapath="f64")

    def _decrypt_core_mega_impl(self, c0, c1, scale):
        """(B, 2, N) ciphertext views, (B, 1) float64 scales of any value ->
        (B, n_slots) float64 (re, im) slot parts: one megakernel launch on
        the f64 datapath (K6's f64 branch), then the float64 collapse."""
        planes = kops.decrypt_decode_stream(
            c0, c1, self.keys.sk.s_mont, self.ctx,
            scale.reshape(-1).contiguous(), datapath="f64")
        w = dfl.dfc_from_planes(planes)
        return dfl.df_to_float(w.re), dfl.df_to_float(w.im)

    def _encrypt_core_impl(self, coeffs, nonce0: int):
        """The host oracle's device part: (B, N) float64 coefficients of the
        host SpecialIFFT -> (c0, c1) (B, L, N): df64 Delta-scale and fmod
        RNS, limb-folded NTT (K1), fused encrypt (K2)."""
        ctx = self.ctx
        pt = encoder.coeffs_to_plaintext_data(coeffs, ctx,
                                              ctx.params.n_limbs)
        return kops.encrypt_fused(pt.transpose(0, 1), self.keys.pk.b_mont,
                                  self.keys.pk.a_mont, ctx, seed=self.seed,
                                  nonce0=nonce0)              # (B, L, N)

    def _decrypt_core_impl(self, c0, c1):
        """The host oracle's device part: (B, 2, N) ciphertext views -> the
        centered df64 CRT pair (hi, lo), (B, N) each: fused decrypt + INTT
        (K3), df64 two-limb CRT. ``decrypt_results`` finishes on the
        host."""
        ctx = self.ctx
        m = kops.decrypt_fused(c0, c1, self.keys.sk.s_mont, ctx)
        v = rns.crt2_to_df(modmul.u32_to_i64(m[:, 0]),
                           modmul.u32_to_i64(m[:, 1]), ctx.q_list[0],
                           ctx.q_list[1])
        return v.hi, v.lo

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

    def _encrypt_core_dev_impl(self, re, im, nonce0: int):
        """The staged encode+encrypt on the f64 datapath: SpecialIFFT (K4)
        between float64 and df32, exact df64 Delta-scale and fmod RNS,
        limb-folded NTT (K1), fused encrypt (K2)."""
        return self._encrypt_core_impl(
            encoder.slots_to_coeffs_device(re, im, self.ctx), nonce0)

    def _decrypt_core_dev_impl(self, c0, c1, scale):
        """The staged decrypt+decode on the f64 datapath: fused decrypt +
        INTT (K3), df64 two-limb CRT, float64 /scale, SpecialFFT (K4).
        `scale`: (B, 1) float64, any value."""
        hi, lo = self._decrypt_core_impl(c0, c1)
        return encoder.coeffs_to_slots_device(hi, lo, self.ctx, scale)

    @property
    def encrypt_impl(self):
        """Encrypt core ``f(*operands, nonce0) -> (c0, c1)`` of the
        configured Fourier engine, pipeline and datapath (row-independent
        over the batch)."""
        if self.fourier != "device":
            return self._encrypt_core_impl
        if self.pipeline == "megakernel":
            return (self._encrypt_core_mega32_impl if self.datapath == "df32"
                    else self._encrypt_core_mega_impl)
        return (self._encrypt_core_dev32_impl if self.datapath == "df32"
                else self._encrypt_core_dev_impl)

    @property
    def decrypt_impl(self):
        """Decrypt core ``f(c0, c1, scale) -> parts`` of the configured
        Fourier engine, pipeline and datapath (the host oracle applies its
        scale on the host, in ``decrypt_results``)."""
        if self.fourier != "device":
            return lambda c0, c1, scale: self._decrypt_core_impl(c0, c1)
        if self.pipeline == "megakernel":
            return (self._decrypt_core_mega32_impl if self.datapath == "df32"
                    else self._decrypt_core_mega_impl)
        return (self._decrypt_core_dev32_impl if self.datapath == "df32"
                else self._decrypt_core_dev_impl)

    @property
    def encrypt_core(self):
        """The reference's name of the encrypt core (there a jitted
        ``encrypt_impl``); the port runs eagerly, so it is ``encrypt_impl``.
        """
        return self.encrypt_impl

    @property
    def decrypt_core(self):
        """The reference's name of the decrypt core: ``decrypt_impl``."""
        return self.decrypt_impl

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
        """CiphertextBatch (first 2 limbs used) -> the decoded parts on the
        device: four (B, n_slots) float32 planes (df32), or the float64
        (re, im) parts (f64)."""
        return self.decrypt_impl(*self.decrypt_operands(cts))

    def decrypt_decode_batch(self, cts: CiphertextBatch) -> np.ndarray:
        """CiphertextBatch -> (B, n_slots) complex messages."""
        return self.decrypt_results(self.decrypt_planes(cts), cts.scale)

    # --- list[Ciphertext] interop --------------------------------------------

    def encrypt_batch(self, messages: np.ndarray) -> list:
        """(B, n_slots) complex -> list of per-row ciphertext views."""
        return list(self.encode_encrypt_batch(messages))

    def decrypt_batch(self, cts) -> np.ndarray:
        """Server-returned ciphertexts -> (B, n_slots) complex. Takes a
        CiphertextBatch or a list of Ciphertexts, whose rows may carry
        scales of their own (e.g. different rescale depths)."""
        if isinstance(cts, CiphertextBatch):
            return self.decrypt_decode_batch(cts)
        cts = list(cts)
        c0 = torch.stack([ct.c0[:2] for ct in cts])
        c1 = torch.stack([ct.c1[:2] for ct in cts])
        scales = np.array([ct.scale for ct in cts], np.float64)[:, None]
        parts = self.decrypt_impl(c0, c1,
                                  self._scale_operand(scales, len(cts)))
        return self.decrypt_results(parts, scales)

    # --- traffic accounting ---------------------------------------------------

    def ciphertext_bytes(self, seeded: bool = False) -> int:
        """Words of one fresh ciphertext in bytes (seeded: c0 and the
        128-bit stream id of a)."""
        p = self.ctx.params
        polys = 1 if seeded else 2
        return polys * p.n_limbs * p.n * 4 + (16 if seeded else 0)

    def upload_report(self, batch: int) -> dict:
        return {
            "batch": batch,
            "ct_bytes": self.ciphertext_bytes(),
            "ct_bytes_seeded": self.ciphertext_bytes(seeded=True),
            "compression": self.ciphertext_bytes()
            / self.ciphertext_bytes(seeded=True),
        }


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
