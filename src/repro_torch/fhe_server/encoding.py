"""Plaintext encoding for the server evaluator.

Port of ``repro.fhe_server.encoding``. The client encoder fixes the scale
at Delta; server-side plaintexts (weight diagonals, polynomial coefficients,
biases) need any scale:

  * a multiplicand encoded at the prime the following rescale drops returns
    the ciphertext scale to exactly its value before the multiply;
  * an addend must be encoded at exactly the ciphertext's current scale.

Encoding is exact host arithmetic: the complex128 SpecialIFFT, float64
coefficient values times scale rounded once, reduced per limb in int64;
then the limb-folded NTT (K1, the reference's stacked NTT: the same words)
and the Montgomery form on `device`. It runs once per (weights, level) at
set-up time.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import encoder, modmul
from repro_torch.core.context import CKKSContext
from repro_torch.fhe_server.ct import ServerPlaintext


def encode_plaintext(z, ctx: CKKSContext, level: int, scale: float,
                     device="cuda") -> ServerPlaintext:
    """(n_slots,) complex slot values -> ServerPlaintext at `scale` with
    `level` limbs, on `device` (the card unless the caller asks for the
    CPU)."""
    from repro_torch.kernels import ops as kops      # kernels import core
    coeffs = np.asarray(encoder.slots_to_coeffs(z, ctx), dtype=np.float64)
    scaled = np.rint(coeffs * scale)
    assert np.all(np.abs(scaled) < 2 ** 62), "encoded value overflows int64"
    iv = scaled.astype(np.int64)
    res = np.stack([(iv % np.int64(q)).astype(np.uint32)
                    for q in ctx.q_list[:level]])        # (level, ..., N)
    words = torch.from_numpy(res.view(np.int32)).to(device)
    data = kops.ntt_limbs(words.reshape(level, -1, ctx.n).contiguous(), ctx,
                          n_limbs=level).reshape(words.shape)
    sp = ctx.stacked_plans(level)
    nd = data.dim()
    data_mont = modmul.i64_to_u32(modmul.mulmod_montgomery_limb_t(
        modmul.u32_to_i64(data), sp.rows(sp.r2, nd, data.device),
        sp.rows(sp.q, nd, data.device), sp.rows(sp.qinv_neg, nd,
                                                 data.device)))
    return ServerPlaintext(data=data, data_mont=data_mont, level=level,
                           scale=float(scale))


def encode_scalar(c: float, ctx: CKKSContext, level: int, scale: float,
                  device="cuda") -> ServerPlaintext:
    """Constant plaintext: every slot holds the real value c."""
    z = np.full((ctx.params.n_slots,), complex(c), dtype=np.complex128)
    return encode_plaintext(z, ctx, level, scale, device=device)
