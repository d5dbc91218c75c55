"""Dispatch seam between the CUDA kernels and their plain versions.

Port of ``repro.kernels.ops`` under the reference's names and shapes. A
CUDA tensor goes to the CUDA kernel, a CPU tensor to the plain PyTorch
version; any other device raises. There is no fall-back: a CUDA input whose
kernel cannot be built or launched raises.

  * ``fourier``: the reconfigurable Fourier engine's mode switch between
    the limb-folded NTT (K1, ``ntt_limbs`` / ``intt_limbs``), the df32
    SpecialFFT (K4, ``special_fft_planes`` / ``special_ifft_planes``;
    ``special_fft`` / ``special_ifft`` on complex rows) and
    the complex128 numpy oracle (``core.fft``, on the host);
  * ``ntt_limbs`` / ``intt_limbs`` with ``path='matmul'``: the four-step
    NTT (K14, ``ntt_matmul``), natural-order output;
  * ``encrypt_fused`` / ``decrypt_fused``: the limb-folded encrypt (K2) and
    decrypt (K3);
  * ``encode_encrypt_stream`` / ``decrypt_decode_stream``: the megakernels
    (K5, K6), on either datapath;
  * ``encrypt_fused_sharded`` / ``decrypt_fused_sharded``: K2 / K3 with
    the batch axis split in equal row slices over a device list (one
    launch per device, on that device's current stream); row r keeps
    nonce ``nonce0 + r`` (``shard_nonce_base``);
  * ``server_*``: the server-side CKKS op set (K7-K11, ``server_eval``);
    ``datapath`` picks the plain versions' REDC engine.

Each module's CUDA wrappers count their launches; ``launches()`` reads all
counters and ``reset_launches()`` sets them to 0.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fft as fftmod
from repro_torch.core.context import CKKSContext
from repro_torch.core.modmul import MASK32
from repro_torch.kernels import (client_pointwise, client_stream, common,
                                 fft_df, ntt_butterfly, ntt_matmul,
                                 server_eval)

_COUNTED = (client_stream, ntt_butterfly, client_pointwise, fft_df,
            server_eval, ntt_matmul)

NTT_PATHS = ("butterfly", "matmul")


def launches() -> dict[str, int]:
    """Launches of every CUDA wrapper since the last reset, by kernel."""
    out = {}
    for mod in _COUNTED:
        out.update(mod.LAUNCHES)
    return out


def reset_launches() -> None:
    for mod in _COUNTED:
        mod.reset_launches()


# ---------------------------------------------------------------------------
# Unified Fourier engine dispatch (the paper's NTT/FFT mode switch)
# ---------------------------------------------------------------------------


def fourier(x, ctx: CKKSContext, cfg: common.FourierConfig | None = None,
            *, inverse: bool = False, n_limbs: int | None = None):
    """Single entry point for the reconfigurable Fourier engine:

      * ``'ntt'``: x is an (L, ..., N) int32 residue stack -> limb-folded
        NTT/INTT (K1, one launch for the stack);
      * ``'fft'``: x is a four-plane df32 tuple of (rows, n) float32 ->
        SpecialFFT/IFFT (K4);
      * ``'host'``: x is (rows, n) complex128 -> the numpy oracle
        SpecialFFT / SpecialIFFT on the host.
    """
    cfg = common.FourierConfig() if cfg is None else cfg
    if cfg.mode == "ntt":
        f = intt_limbs if inverse else ntt_limbs
        return f(x, ctx, n_limbs=n_limbs)
    if cfg.mode == "fft":
        f = special_ifft_planes if inverse else special_fft_planes
        return f(x, ctx.params.m)
    if cfg.mode == "host":
        # through the module attribute, so a test can count the calls
        f = fftmod.special_ifft if inverse else fftmod.special_fft
        return f(np.asarray(x), ctx.params.m)
    raise ValueError(f"unknown Fourier mode {cfg.mode!r}; expected one of "
                     f"{common.FOURIER_MODES}")


# ---------------------------------------------------------------------------
# NTT / INTT over RNS limb stacks (K1 butterfly, K14 four-step)
# ---------------------------------------------------------------------------

_LIMB_KERNELS = {
    ("butterfly", "cuda"): ntt_butterfly.limb_rows_cuda,
    ("butterfly", "plain"): ntt_butterfly.limb_rows_plain,
    ("matmul", "cuda"): ntt_matmul.limb_rows_mm_cuda,
    ("matmul", "plain"): ntt_matmul.limb_rows_mm_plain,
}


def _limbs(x, ctx: CKKSContext, n_limbs: int | None, inverse: bool,
           path: str):
    if path not in NTT_PATHS:
        raise ValueError(f"unknown NTT path {path!r}; expected one of "
                         f"{NTT_PATHS}")
    n_limbs = x.shape[0] if n_limbs is None else n_limbs
    x2 = x[:n_limbs].reshape(n_limbs, -1, x.shape[-1]).contiguous()
    f = _LIMB_KERNELS[path, common.route(x.device)]
    return f(x2, ctx.plans[:n_limbs], inverse).reshape(x[:n_limbs].shape)


def ntt_limbs(x, ctx: CKKSContext, n_limbs: int | None = None,
              path: str = "butterfly"):
    """x: (L, ..., N) int32 residue words -> forward negacyclic NTT per
    limb, one launch for the whole stack. path: 'butterfly' (K1,
    bit-reversed out) or 'matmul' (K14, the four-step NTT, natural order
    out: out[k] = x(psi^(2k+1)))."""
    return _limbs(x, ctx, n_limbs, False, path)


def intt_limbs(x, ctx: CKKSContext, n_limbs: int | None = None,
               path: str = "butterfly"):
    """Inverse of ``ntt_limbs`` on the same path (bit-reversed in for
    'butterfly', natural order in for 'matmul'; N^-1 folded in)."""
    return _limbs(x, ctx, n_limbs, True, path)


# ---------------------------------------------------------------------------
# Limb-folded client ops (K2, K3)
# ---------------------------------------------------------------------------


def encrypt_fused(pt_data, pk_b_mont, pk_a_mont, ctx: CKKSContext,
                  seed: int | None = None, nonce0: int = 0):
    """pt_data: (L, N) or (B, L, N) int32 NTT-domain plaintext words ->
    (c0, c1) of the same shape; row r encrypts under nonce0 + r (mod 2^32).
    One launch for every limb and row."""
    seed = ctx.params.seed if seed is None else seed
    squeeze = pt_data.dim() == 2
    pt = pt_data[None] if squeeze else pt_data
    # K2 reads a strided view (the staged client's transpose) in place
    c0, c1 = client_pointwise.encrypt_limbs(pt, pk_b_mont, pk_a_mont, ctx,
                                            seed, nonce0)
    if squeeze:
        return c0[0], c1[0]
    return c0, c1


def decrypt_fused(c0, c1, s_mont, ctx: CKKSContext, n_limbs: int = 2):
    """(…, L, N) int32 ciphertext words -> coefficient-domain residues
    (…, n_limbs, N): m = INTT(c0 + c1*s) on the first n_limbs limbs, one
    launch for the whole batch."""
    squeeze = c0.dim() == 2
    c0b = c0[None] if squeeze else c0
    c1b = c1[None] if squeeze else c1
    out = client_pointwise.decrypt_limbs(c0b[:, :n_limbs], c1b[:, :n_limbs],
                                         s_mont, ctx)
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# Sharded entry points: the batch axis split over a device list
# ---------------------------------------------------------------------------
#
# Each shard runs the SAME limb-folded kernel on its row slice of the batch
# axis (one launch per device, on that device's current stream), so a
# b-device group issues b launches for one batch. Nonce bases are offset
# per shard so row r of the batch always encrypts under ``nonce0 + r`` —
# bit-identical to the single-device launch.


def shard_rows(batch: int, n_shards: int) -> int:
    """Rows per device when a ``batch``-row stack splits over ``n_shards``
    devices; raises unless it divides."""
    if batch % n_shards:
        raise ValueError(
            f"batch axis {batch} does not divide the {n_shards}-device "
            f"'batch' mesh axis; pad to a multiple (the service batcher's "
            f"buckets are forced to multiples of the shard count)")
    return batch // n_shards


def shard_nonce_base(nonce0: int, shard: int, shard_rows: int) -> int:
    """Nonce base of shard ``shard`` (holding rows [shard*shard_rows,
    (shard+1)*shard_rows) of the batch): ``nonce0 + shard*shard_rows``,
    wrapped mod 2^32 as the kernels' uint32 nonces are. The ONE place the
    sharded row<->nonce convention lives — both the sharded kernel entries
    below and the service's stream executors use it (nonce reuse across
    shards would break RLWE security)."""
    return (int(nonce0) + int(shard) * int(shard_rows)) & MASK32


def _to(t, device):
    return t if t.device == device else t.to(device)


def gather_rows(parts, device):
    """Shard outputs -> one stack on ``device`` (rows in shard order)."""
    return torch.cat([_to(p, device) for p in parts])


def split_rows(batch: int, devices, launch, streams=None) -> list:
    """The one row split of a batch over a device group: calls
    ``launch(shard, device, rows_slice, shard_rows)`` for each device's row
    slice, inside ``streams[shard]``'s context when a stream is given (on
    the device's current stream otherwise), and returns the per-shard
    outputs in shard order. Raises unless ``batch`` divides."""
    rows = shard_rows(batch, len(devices))
    outs = []
    for s, dev in enumerate(devices):
        sl = slice(s * rows, (s + 1) * rows)
        st = streams[s] if streams is not None else None
        if st is None:
            outs.append(launch(s, dev, sl, rows))
            continue
        with torch.cuda.stream(st):
            outs.append(launch(s, dev, sl, rows))
    return outs


def encrypt_fused_sharded(pt_data, pk_b_mont, pk_a_mont, ctx: CKKSContext,
                          devices, seed: int | None = None, nonce0: int = 0):
    """``encrypt_fused`` with the (B, L, N) batch axis split over
    ``devices`` (the reference's mesh), one launch per device; keys are
    copied to each device. Returns (c0, c1) on ``devices[0]``."""
    devices = [torch.device(d) for d in devices]

    def launch(s, dev, sl, rows):
        return encrypt_fused(
            _to(pt_data[sl], dev), _to(pk_b_mont, dev), _to(pk_a_mont, dev),
            ctx, seed=seed, nonce0=shard_nonce_base(nonce0, s, rows))

    c0s, c1s = zip(*split_rows(pt_data.shape[0], devices, launch))
    return gather_rows(c0s, devices[0]), gather_rows(c1s, devices[0])


def decrypt_fused_sharded(c0, c1, s_mont, ctx: CKKSContext, devices,
                          n_limbs: int = 2):
    """``decrypt_fused`` with the (B, L, N) batch axis split over
    ``devices`` (secret key copied to each); returns the (B, n_limbs, N)
    residues on ``devices[0]``."""
    devices = [torch.device(d) for d in devices]

    def launch(s, dev, sl, rows):
        return decrypt_fused(_to(c0[sl], dev), _to(c1[sl], dev),
                             _to(s_mont, dev), ctx, n_limbs=n_limbs)

    return gather_rows(split_rows(c0.shape[0], devices, launch), devices[0])


# ---------------------------------------------------------------------------
# df32 Fourier transforms (K4)
# ---------------------------------------------------------------------------


def special_fft_planes(planes, m: int):
    """df32 SpecialFFT (decode direction) on four (rows, n) float32
    planes. Needs no lone-row padding: the kernel takes any number of
    rows."""
    return fft_df.special_fft_planes(planes, m)


def special_ifft_planes(planes, m: int):
    """df32 SpecialIFFT (encode direction, 1/n folded in)."""
    return fft_df.special_ifft_planes(planes, m)


def special_fft(z, m: int, device=None):
    """(rows, n) or (n,) complex -> slots, through K4 (``fft_df``)."""
    z = np.asarray(z)
    squeeze = z.ndim == 1
    out = fft_df.special_fft_rows(z[None] if squeeze else z, m, device)
    return out[0] if squeeze else out


def special_ifft(z, m: int, device=None):
    """(rows, n) or (n,) slots -> coefficient side (1/n included)."""
    z = np.asarray(z)
    squeeze = z.ndim == 1
    out = fft_df.special_ifft_rows(z[None] if squeeze else z, m, device)
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# Streaming megakernels: the whole client op in one launch (K5, K6)
# ---------------------------------------------------------------------------


def encode_encrypt_stream(planes, pk_b_mont, pk_a_mont, ctx: CKKSContext,
                          seed: int | None = None, nonce0: int = 0,
                          datapath: str = "f64"):
    """Four (B, n_slots) float32 slot planes -> (c0, c1) (B, L, N) int32.
    ``seed`` None is the profile's seed."""
    seed = ctx.params.seed if seed is None else seed
    return client_stream.encode_encrypt_stream(planes, pk_b_mont, pk_a_mont,
                                               ctx, seed, nonce0, datapath)


def decrypt_decode_stream(c0, c1, s_mont, ctx: CKKSContext, scale,
                          datapath: str = "f64"):
    """(B, >=2, N) int32 ciphertext stacks, (B,) scales (float32 on the
    df32 datapath, float64 on the f64 one) -> four (B, n_slots) planes."""
    return client_stream.decrypt_decode_stream(c0, c1, s_mont, ctx, scale,
                                               datapath)


# ---------------------------------------------------------------------------
# Server-side eval ops (K7-K11)
# ---------------------------------------------------------------------------
# Ciphertexts (B, l, N), plaintexts (l, N), keys (l, l+1, N), permutations
# (1, N) int32. A CUDA call takes contiguous operands: a non-contiguous view
# (``ServerCiphertext.drop_to`` of a batch, a key slice) is copied first.
# ``datapath`` picks the pointwise REDC engine of the plain versions of the
# ops that multiply: 'df32' the uint32 REDC, 'f64' the u64 REDC (the same
# words). The kernels run the u64 REDC on both and take no datapath.


def server_add_ct(c0a, c1a, c0b, c1b, ctx: CKKSContext):
    return server_eval.add_ct(c0a, c1a, c0b, c1b, ctx)


def server_add_pt(c0, c1, pt, ctx: CKKSContext):
    return server_eval.add_pt(c0, c1, pt, ctx)


def server_mul_pt(c0, c1, pt_mont, ctx: CKKSContext, datapath: str = "f64",
                  rescale: bool = False):
    """ct x pt (K7), or fused with the rescale that follows (K8b)."""
    f = server_eval.mul_pt_rescale if rescale else server_eval.mul_pt
    return f(c0, c1, pt_mont, ctx, datapath)


def server_rescale(c0, c1, ctx: CKKSContext, datapath: str = "f64"):
    return server_eval.rescale(c0, c1, ctx, datapath)


def server_mul_ct(a0, a1, b0, b1, ksk_b, ksk_a, ctx: CKKSContext,
                  datapath: str = "f64"):
    return server_eval.mul_ct_relin(a0, a1, b0, b1, ksk_b, ksk_a, ctx,
                                    datapath)


def server_rotate(c0, c1, perm, ksk_b, ksk_a, ctx: CKKSContext,
                  datapath: str = "f64"):
    return server_eval.rotate(c0, c1, perm, ksk_b, ksk_a, ctx, datapath)


def server_ks_decompose(c1, ctx: CKKSContext):
    return server_eval.ks_decompose(c1, ctx)


def server_ks_apply_rot(c0, h, perm, ksk_b, ksk_a, ctx: CKKSContext,
                        datapath: str = "f64"):
    return server_eval.ks_apply_rot(c0, h, perm, ksk_b, ksk_a, ctx,
                                    datapath)
