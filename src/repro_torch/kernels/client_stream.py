"""The client megakernels: CUDA wrappers and their plain PyTorch versions.

Port of ``repro.kernels.client_stream``, both datapaths:

  * ``encode_encrypt_stream_cuda`` launches ``csrc/encode_encrypt.cu``
    (replaces the TPU kernel ``_encode_encrypt_kernel``);
    ``encode_encrypt_stream_plain`` is the same function as eager PyTorch;
  * ``decrypt_decode_stream_cuda`` launches ``csrc/decrypt_decode.cu``
    (replaces ``_decrypt_decode_kernel``); ``decrypt_decode_stream_plain``
    is its plain version.

``datapath='df32'`` carries the Delta-scale and the CRT in float32 pairs
and uint32 words (exact base-2^22 digits, word-pair CRT; power-of-two
scales only); ``datapath='f64'`` in float64 and 64-bit integers (the df64
Delta-scale round and fmod RNS reduction, the df64 CRT and a float64
/scale, any scale). Both give the same ciphertext words wherever the
df32 pair collapses to float64 exactly; at Delta = 2^55 a rare
coefficient rounds to the neighbouring integer on the f64 datapath, as in
the reference. Each branch counts its launches under its own name.

The plain versions run the same stage functions in the same order as the
reference kernel bodies, so on the CPU they are held bit for bit against
the JAX package; on the card ``chip_smoke.py`` holds each kernel bit for
bit against its plain version. The routed entries under the reference's
names, ``encode_encrypt_stream`` / ``decrypt_decode_stream``, pick one by
the tensors' device (``ops`` calls them).

Layouts are the reference's: slot planes four (B, N/2) float32, keys
(L, N) and ciphertexts (B, L, N) int32 tensors holding uint32 words.
Each CUDA wrapper counts its launches in ``LAUNCHES``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core import encoder, modmul, prng, rns
from repro_torch.core.context import CKKSContext, get_context
from repro_torch.core.modmul import MASK32
from repro_torch.core.ntt import bitrev_indices
from repro_torch.kernels import client_pointwise, common, fft_df

LAUNCHES = {"encode_encrypt_stream": 0, "decrypt_decode_stream": 0,
            "encode_encrypt_stream_f64": 0, "decrypt_decode_stream_f64": 0}


def _counter(name: str, datapath: str) -> str:
    return name + ("_f64" if datapath == "f64" else "")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stream_consts(ctx: CKKSContext, n_limbs: int, inverse: bool):
    """(kc, tw, offsets, rev): the (L, K) seed table, the (4, n_slots)
    packed df32 twiddle planes of the direction, their stage offsets, and
    the (n_slots,) bit-reversal permutation."""
    p = ctx.params
    kc = common.stacked_kernel_consts(ctx.plans[:n_limbs])
    tw, offsets = fft_df.packed_twiddles(p.n_slots, p.m, inverse)
    return kc, tw, offsets, _bitrev(p.n_slots)


@functools.lru_cache(maxsize=16)
def _bitrev(n: int) -> np.ndarray:
    rev = bitrev_indices(n)
    rev.setflags(write=False)
    return rev


@functools.lru_cache(maxsize=32)
def _device_tables(params, n_limbs: int, inverse: bool, device: str):
    ctx = get_context(params)
    p = ctx.params
    kc = common.stacked_kernel_consts(ctx.plans[:n_limbs])
    dm = np.asarray(common.stacked_digit_consts(ctx.q_list[:n_limbs]),
                    np.uint32)
    return (fft_df.device_twiddles(p.n_slots, p.m, inverse, device),
            fft_df.device_bitrev(p.n_slots, device).to(torch.int32),
            common.device_seed_table(kc, device),
            common.host_table(dm.view(np.int32), device))


def device_tables(ctx: CKKSContext, n_limbs: int, inverse: bool, device):
    """(tw, rev int32, seed table int32, digit consts int32) of one
    direction as tensors on `device`, uploaded once per device."""
    return _device_tables(ctx.params, n_limbs, inverse, str(device))


# ---------------------------------------------------------------------------
# encode+encrypt
# ---------------------------------------------------------------------------


def encode_encrypt_stream_plain(planes, pk_b_mont, pk_a_mont,
                                ctx: CKKSContext, seed: int, nonce0: int,
                                datapath: str = "df32"):
    """Four (B, n_slots) float32 slot planes -> (c0, c1), each (B, L, N)
    int32: SpecialIFFT, bit-reversal, the exact Delta-scale (df32: base-2^22
    digits; f64: float64 collapse, then the df64 round), then per limb RNS
    (digits, or fmod), NTT and the Philox encrypt pointwise (row r under
    nonce nonce0 + r)."""
    common.check_datapath(datapath)
    p = ctx.params
    dev = planes[0].device
    batch = planes[0].shape[0]
    L, n = p.n_limbs, p.n
    kc = stream_consts(ctx, L, inverse=True)[0]
    w = dfl.dfc_from_planes(fft_df.bitrev_planes(
        fft_df.fft_rows_plain(planes, p.m, inverse=True)))
    if datapath == "df32":
        digits = encoder.delta_scale_digits(encoder.planes_to_coeff_df(w),
                                            p.delta)
        digit_mont = common.stacked_digit_consts(ctx.q_list[:L])
    else:
        coeffs = torch.cat([dfl.df_to_float(w.re), dfl.df_to_float(w.im)],
                           dim=-1)
        scaled = encoder.delta_scale_round(coeffs, p.delta)
    vee = client_pointwise.sample_vee_k(
        seed, client_pointwise.nonce_column(nonce0, batch, dev), n)
    b_mont = modmul.u32_to_i64(pk_b_mont)
    a_mont = modmul.u32_to_i64(pk_a_mont)
    c0 = torch.empty((batch, L, n), dtype=torch.int32, device=dev)
    c1 = torch.empty_like(c0)
    for l in range(L):
        if datapath == "df32":
            pt_l = client_pointwise.rns_digit_stage(digits, kc, l,
                                                    *digit_mont[l])
        else:
            pt_l = rns.to_rns_limb_t(scaled, float(ctx.q_list[l]))
        pt_l = common.ntt_stages_t(pt_l, kc, l)
        c0_l, c1_l = client_pointwise.encrypt_limb_stage(
            vee, pt_l, b_mont[l], a_mont[l], kc, l)
        c0[:, l] = modmul.i64_to_u32(c0_l)
        c1[:, l] = modmul.i64_to_u32(c1_l)
    return c0, c1


def encode_encrypt_stream_cuda(planes, pk_b_mont, pk_a_mont,
                               ctx: CKKSContext, seed: int, nonce0: int,
                               datapath: str = "df32"):
    """CUDA launch of ``encode_encrypt.cu`` on the current stream; same
    inputs and outputs as ``encode_encrypt_stream_plain``."""
    common.check_datapath(datapath)
    p = ctx.params
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError("encode_encrypt_stream_cuda needs CUDA tensors")
    batch = planes[0].shape[0]
    L, n, ns = p.n_limbs, p.n, p.n_slots
    for i, t in enumerate(planes):
        common.check_tensor(t, f"planes[{i}]", torch.float32, (batch, ns), dev)
    common.check_tensor(pk_b_mont, "pk_b_mont", torch.int32, (L, n), dev)
    common.check_tensor(pk_a_mont, "pk_a_mont", torch.int32, (L, n), dev)
    kc = stream_consts(ctx, L, inverse=True)[0]
    if datapath == "df32":
        encoder._check_pow2_delta(p.delta)
    tw_t, rev_t, table_t, dm_t = device_tables(ctx, L, True, dev)
    c0 = torch.empty((batch, L, n), dtype=torch.int32, device=dev)
    c1 = torch.empty_like(c0)
    # scratch of the device kernels: the limbs' NTT twiddle heaps, the
    # noise (v, e0, e1), the FFT's points between its two passes, the
    # Delta-scaled digits, and NTT(v) between the NTT's two passes
    scratch = (torch.empty((L, n), dtype=torch.int32, device=dev),
               torch.empty((batch, 3, n), dtype=torch.int8, device=dev),
               torch.empty((batch, 4, ns), dtype=torch.float32, device=dev),
               torch.empty((batch, 3, n), dtype=torch.int32, device=dev),
               torch.empty((batch, L, n), dtype=torch.int32, device=dev))
    sw = prng.seed_words(seed)
    common.launch("encode_encrypt_stream_launch", dev,
                  *(t.data_ptr() for t in planes), tw_t.data_ptr(),
                  rev_t.data_ptr(), table_t.data_ptr(), dm_t.data_ptr(),
                  pk_b_mont.data_ptr(), pk_a_mont.data_ptr(), c0.data_ptr(),
                  c1.data_ptr(), *(t.data_ptr() for t in scratch), batch, L,
                  p.logn, kc.n_scalars, int(datapath == "f64"),
                  float(p.delta), *sw, int(nonce0) & MASK32)
    LAUNCHES[_counter("encode_encrypt_stream", datapath)] += 1
    return c0, c1


# ---------------------------------------------------------------------------
# decrypt+decode
# ---------------------------------------------------------------------------


def decrypt_decode_stream_plain(c0, c1, s_mont, ctx: CKKSContext, scale,
                                datapath: str = "df32"):
    """(B, >=2, N) int32 ciphertext stacks, (L, N) secret key, (B,) scales
    (float32 powers of two on the df32 datapath, any float64 on the f64
    datapath) -> four (B, n_slots) float32 slot planes."""
    common.check_datapath(datapath)
    p = ctx.params
    ns = p.n_slots
    kc = stream_consts(ctx, 2, inverse=False)[0]
    m = [client_pointwise.decrypt_limb_stage(
            modmul.u32_to_i64(c0[:, l]), modmul.u32_to_i64(c1[:, l]),
            modmul.u32_to_i64(s_mont[l]), kc, l)
         for l in range(2)]
    if datapath == "f64":
        v = rns.crt2_to_df(m[0], m[1], ctx.q_list[0], ctx.q_list[1])
        sc = scale.reshape(-1, 1)
        coeffs = v.hi / sc + v.lo / sc
        z = dfl.dfc_from_parts(coeffs[:, :ns], coeffs[:, ns:])
        return fft_df.fft_rows_plain(
            fft_df.bitrev_planes(dfl.dfc_to_planes(z)), p.m, inverse=False)
    sign, vh, vl = rns.crt2_centered_u32(m[0], m[1], ctx.q_list[0],
                                         ctx.q_list[1])
    inv = 1.0 / scale.reshape(-1, 1)
    x = rns.centered_to_df(sign, vh, vl, inv)
    planes = (x.hi[:, :ns], x.lo[:, :ns], x.hi[:, ns:], x.lo[:, ns:])
    return fft_df.fft_rows_plain(fft_df.bitrev_planes(planes), p.m,
                                 inverse=False)


def decrypt_decode_stream_cuda(c0, c1, s_mont, ctx: CKKSContext, scale,
                               datapath: str = "df32"):
    """CUDA launch of ``decrypt_decode.cu``; same inputs and outputs as
    ``decrypt_decode_stream_plain`` (`scale` a contiguous (B,) float32 or,
    f64, float64 tensor). c0/c1 may be the 2-limb view of a (B, L, N)
    batch (rows of any stride, each row's limbs contiguous)."""
    common.check_datapath(datapath)
    p = ctx.params
    dev = c0.device
    if dev.type != "cuda":
        raise ValueError("decrypt_decode_stream_cuda needs CUDA tensors")
    n, ns = p.n, p.n_slots
    batch = c0.shape[0]
    common.check_limb_views(c0, c1, 2, n, dev)
    common.check_key_rows(s_mont, "s_mont", 2, n, dev)
    common.check_tensor(scale, "scale", torch.float32 if datapath == "df32"
                        else torch.float64, (batch,), dev)
    kc = stream_consts(ctx, 2, inverse=False)[0]
    tw_t, rev_t, table_t, _ = device_tables(ctx, 2, False, dev)
    outs = [torch.empty((batch, ns), dtype=torch.float32, device=dev)
            for _ in range(4)]
    m_scratch = torch.empty((batch, 2, n), dtype=torch.int32, device=dev)
    ntt_tw = torch.empty((2, n), dtype=torch.int32, device=dev)
    q0, q1 = ctx.q_list[0], ctx.q_list[1]
    k = rns.crt2_consts(q0, q1)
    qq = (k["q_w"][0] << 32) | k["q_w"][1]
    half = (k["half_w"][0] << 32) | k["half_w"][1]
    common.launch("decrypt_decode_stream_launch", dev, c0.data_ptr(),
                  c1.data_ptr(), c0.stride(0), s_mont.data_ptr(),
                  scale.data_ptr(), tw_t.data_ptr(), rev_t.data_ptr(),
                  table_t.data_ptr(), *(o.data_ptr() for o in outs),
                  m_scratch.data_ptr(), ntt_tw.data_ptr(), batch, p.logn,
                  kc.n_scalars, int(datapath == "f64"), q0, q1,
                  k["g0_mont"], k["g1_mont"], k["qinv0"], k["qinv1"],
                  *rns.crt2_inverses(q0, q1), qq, half)
    LAUNCHES[_counter("decrypt_decode_stream", datapath)] += 1
    return tuple(outs)


# ---------------------------------------------------------------------------
# Routed entries: the reference's names and parameters
# ---------------------------------------------------------------------------


def encode_encrypt_stream(planes, pk_b_mont, pk_a_mont, ctx: CKKSContext,
                          seed: int, nonce0: int = 0, datapath: str = "f64"):
    """The whole encode+encrypt chain in one launch: K5 on CUDA tensors,
    the plain version on CPU tensors. Four (B, n_slots) float32 slot
    planes -> (c0, c1), each (B, L, N) int32, row r under nonce nonce0 + r.
    The reference's parameters without its Pallas-only ``batch_block`` /
    ``interpret``; ``datapath`` defaults to 'f64' as there."""
    f = (encode_encrypt_stream_cuda if common.route(planes[0].device)
         == "cuda" else encode_encrypt_stream_plain)
    return f(planes, pk_b_mont, pk_a_mont, ctx, seed, nonce0, datapath)


def decrypt_decode_stream(c0, c1, s_mont, ctx: CKKSContext, scale,
                          datapath: str = "f64"):
    """The whole decrypt+decode chain in one launch: K6 on CUDA tensors,
    the plain version on CPU tensors. (B, >=2, N) int32 ciphertext stacks,
    (B,) scales (float32 on the df32 datapath, float64 on the f64 one) ->
    four (B, n_slots) float32 planes."""
    f = (decrypt_decode_stream_cuda if common.route(c0.device) == "cuda"
         else decrypt_decode_stream_plain)
    return f(c0, c1, s_mont, ctx, scale, datapath)
