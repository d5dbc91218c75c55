"""Server-side CKKS eval kernels (K7-K11): constants, plain versions and
CUDA wrappers.

Port of ``repro.kernels.server_eval``:

  * ``ServerConsts`` / ``server_consts`` — the (l+1, K+3) uint32 constant
    table of one (context, level): the client seed table over the l
    ciphertext primes and the special prime P (last row), then per row R^2,
    P^-1 R and q_drop^-1 R (Montgomery form). Built once per (context,
    level) and kept on each device it is used on;
  * the plain versions (``*_plain``): the reference's kernel bodies in its
    order of operations, on int64 tensors holding uint32 words, with the
    pointwise REDC engine of the datapath (``'df32'``:
    ``modmul.mulmod_montgomery_limb_t``; ``'f64'``: the u64 REDC
    ``modmul.mulmod_montgomery_u64_t``, the same words) and the plain NTT /
    INTT stage loops (``common.ntt_stages_t`` / ``intt_stages_t``, the
    same on both datapaths, as in the reference);
  * the CUDA wrappers (``*_cuda``): ``csrc/server_eval.cu``, one C entry
    point per op (a fixed sequence of launches on the current stream: the
    op's twiddle heaps, then its stages, each transform on the tiled NTT
    block of ``csrc/ntt_tiled.cuh``), each counting its calls in
    ``LAUNCHES``. Their pointwise REDC is the u64 one on both datapaths (it
    gives the words of either engine), so they take no ``datapath``.

Inputs and outputs are int32 tensors holding uint32 words: ciphertexts (B,
l, N) in the NTT domain, plaintexts (l, N), key-switch keys (l, l+1, N)
(rows [0:l] + [L] of a full key), Galois permutations (1, N) int32, the
hoisted digit stack (B, l+1, l, N). The routed entries under the
reference's names (``add_ct``, ``add_pt``, ``mul_pt``, ``rescale``,
``mul_pt_rescale``, ``mul_ct_relin``, ``rotate``, ``ks_decompose``,
``ks_apply_rot``; ``ops.server_*`` calls them) pick the kernel or the plain
version by the tensors' device.

  K7   add_ct / add_pt / mul_pt          _add_ct/_add_pt/_mul_pt_kernel
  K8   rescale                           _rescale_kernel
  K8b  mul_pt_rescale                    _mul_pt_rescale_kernel
  K9   mul_ct_relin                      _mul_ct_relin_kernel
  K10  rotate                            _rotate_kernel
  K11a ks_decompose                      _ks_decompose_kernel
  K11b ks_apply_rot                      _ks_apply_rot_kernel
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import modmul, rns
from repro_torch.core.context import CKKSContext
from repro_torch.kernels import common

LAUNCHES = {name: 0 for name in (
    "add_ct", "add_pt", "mul_pt", "rescale", "mul_pt_rescale", "mul_ct",
    "rotate", "ks_decompose", "ks_apply_rot")}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# constants: the client (l+1, K) table + server columns
# ---------------------------------------------------------------------------

SERVER_EXTRA_SCALARS = 3     # per row: R^2, (P^-1)*R, (q_drop^-1)*R


@dataclasses.dataclass(frozen=True, eq=False)
class ServerConsts:
    """Stacked constants of one (context, level): the seed table over
    level + 1 rows (ciphertext primes, then the special prime) extended by
    the server columns. The ``kc`` offsets stay valid (columns appended)."""

    kc: common.StackedKernelConsts
    table: np.ndarray            # (level+1, kc.n_scalars + 3) uint32
    level: int
    n: int
    off_r2: int                  # enter the Montgomery domain
    off_pinv: int                # mod-down by the special prime
    off_qdinv: int               # rescale by the dropped prime (rows < l-1)

    @property
    def ncols(self) -> int:
        return int(self.table.shape[1])


@functools.lru_cache(maxsize=64)
def server_consts(ctx: CKKSContext, level: int) -> ServerConsts:
    plans = ctx.plans[:level] + (ctx.special_plan(),)
    kc = common.stacked_kernel_consts(plans)
    qs = [int(p.prime.q) for p in plans]
    p_special, q_drop = qs[-1], qs[level - 1]
    r = 1 << 32
    extra = np.zeros((level + 1, SERVER_EXTRA_SCALARS), np.uint32)
    for i, q in enumerate(qs):
        extra[i, 0] = (r * r) % q
        if q != p_special:
            extra[i, 1] = (pow(p_special % q, -1, q) * r) % q
        if i < level - 1:
            extra[i, 2] = (pow(q_drop % q, -1, q) * r) % q
    table = np.concatenate([kc.table, extra], axis=1)
    table.setflags(write=False)
    return ServerConsts(kc=kc, table=table, level=level, n=kc.n,
                        off_r2=kc.n_scalars, off_pinv=kc.n_scalars + 1,
                        off_qdinv=kc.n_scalars + 2)


@functools.lru_cache(maxsize=64)
def _device_table(sc: ServerConsts, device: str) -> torch.Tensor:
    return common.host_table(sc.table.view(np.int32), device)


# ---------------------------------------------------------------------------
# plain versions: the reference's stage helpers on int64 words
# ---------------------------------------------------------------------------


def _u(t: torch.Tensor) -> torch.Tensor:
    return modmul.u32_to_i64(t)


def _w(t: torch.Tensor) -> torch.Tensor:
    return modmul.i64_to_u32(t)


def _rc(sc: ServerConsts, i: int) -> tuple[int, int]:
    return (int(sc.table[i, common.OFF_Q]),
            int(sc.table[i, common.OFF_QINV]))


def _mm(a, b_mont, q, qi, dp: str):
    """The pointwise REDC engine of datapath `dp` (both give the same
    words)."""
    if dp == "f64":
        return modmul.mulmod_montgomery_u64_t(a, b_mont, q, qi)
    return modmul.mulmod_montgomery_limb_t(a, b_mont, q, qi)


def _rows_op(f, x: torch.Tensor, sc: ServerConsts, row: int):
    """An (rows, N) stage loop over the trailing axis of any (..., N)."""
    return f(x.reshape(-1, sc.n), sc.kc, row).reshape(x.shape)


def _to_digit(x, sc: ServerConsts, j: int):
    """NTT rows (..., N) of prime j -> centered coefficient digits."""
    q, _ = _rc(sc, j)
    return rns.ks_center_t(_rows_op(common.intt_stages_t, x, sc, j), q)


def _digit_to_row(w, sc: ServerConsts, i: int):
    """Centered digits -> NTT-domain residues on row i (exact: |w| < 2^30
    <= q_i)."""
    q, _ = _rc(sc, i)
    return _rows_op(common.ntt_stages_t, rns.ks_residue_t(w, q), sc, i)


def _ks_digits(x, sc: ServerConsts):
    """(B, l, N) NTT rows -> digit-NTT stack h[i] = (B, l, N) over the l+1
    modulus rows."""
    l = sc.level
    w = torch.stack([_to_digit(x[:, j], sc, j) for j in range(l)], dim=1)
    return [_digit_to_row(w, sc, i) for i in range(l + 1)]


def _sum_rows(t, q):
    """(B, rows, N) -> (B, N) addmod reduction, row 0 first."""
    s = t[:, 0]
    for j in range(1, t.shape[1]):
        s = modmul.addmod(s, t[:, j], q)
    return s


def _ks_accumulate(h, kb, ka, sc: ServerConsts, dp: str):
    """acc[i] = (B, 2, N): sum_j REDC(h[i][j] * ksk_b[j][i]), then the same
    against ksk_a."""
    out = []
    for i in range(sc.level + 1):
        q, qi = _rc(sc, i)
        s0 = _sum_rows(_mm(h[i], kb[:, i], q, qi, dp), q)
        s1 = _sum_rows(_mm(h[i], ka[:, i], q, qi, dp), q)
        out.append(torch.stack([s0, s1], dim=1))
    return out


def _ks_moddown(acc, sc: ServerConsts, dp: str):
    """Divide the accumulated extended stack by P with rounding: lists of
    (B, N) rows (ks0, ks1)."""
    l = sc.level
    qp, _ = _rc(sc, l)
    wp = rns.ks_center_t(_rows_op(common.intt_stages_t, acc[l], sc, l), qp)
    ks0, ks1 = [], []
    for i in range(l):
        q, qi = _rc(sc, i)
        diff = modmul.submod(acc[i], _digit_to_row(wp, sc, i), q)
        r = _mm(diff, int(sc.table[i, sc.off_pinv]), q, qi, dp)
        ks0.append(r[:, 0])
        ks1.append(r[:, 1])
    return ks0, ks1


def _keyswitch(x, kb, ka, sc: ServerConsts, dp: str):
    return _ks_moddown(_ks_accumulate(_ks_digits(x, sc), kb, ka, sc, dp),
                       sc, dp)


def _rescale2(rows0, rows1, sc: ServerConsts, dp: str):
    """Drop limb l-1 of both polys: x_i' = (x_i - [x_{l-1}]) q_drop^-1 mod
    q_i, the correction term the centered lift of the dropped limb."""
    l = sc.level
    qd, _ = _rc(sc, l - 1)
    top = torch.stack([rows0[l - 1], rows1[l - 1]], dim=1)
    w = rns.ks_center_t(_rows_op(common.intt_stages_t, top, sc, l - 1), qd)
    out0, out1 = [], []
    for i in range(l - 1):
        q, qi = _rc(sc, i)
        x = torch.stack([rows0[i], rows1[i]], dim=1)
        diff = modmul.submod(x, _digit_to_row(w, sc, i), q)
        r = _mm(diff, int(sc.table[i, sc.off_qdinv]), q, qi, dp)
        out0.append(r[:, 0])
        out1.append(r[:, 1])
    return out0, out1


def _pack(rows) -> torch.Tensor:
    return _w(torch.stack(rows, dim=1))


def _q_col(sc: ServerConsts, rows: int, device) -> tuple:
    q = torch.tensor([_rc(sc, i)[0] for i in range(rows)],
                     dtype=torch.int64, device=device).reshape(rows, 1)
    qi = torch.tensor([_rc(sc, i)[1] for i in range(rows)],
                      dtype=torch.int64, device=device).reshape(rows, 1)
    return q, qi


def _gather(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x[..., perm] with the (1, N) int32 permutation."""
    return torch.index_select(x, -1, perm.reshape(-1))


def add_ct_plain(c0a, c1a, c0b, c1b, ctx: CKKSContext):
    sc = server_consts(ctx, c0a.shape[1])
    q, _ = _q_col(sc, sc.level, c0a.device)
    return (_w(modmul.addmod(_u(c0a), _u(c0b), q)),
            _w(modmul.addmod(_u(c1a), _u(c1b), q)))


def add_pt_plain(c0, c1, pt, ctx: CKKSContext):
    sc = server_consts(ctx, c0.shape[1])
    q, _ = _q_col(sc, sc.level, c0.device)
    return _w(modmul.addmod(_u(c0), _u(pt), q)), c1.clone()


def mul_pt_plain(c0, c1, pt_mont, ctx: CKKSContext, datapath: str = "df32"):
    common.check_datapath(datapath)
    sc = server_consts(ctx, c0.shape[1])
    q, qi = _q_col(sc, sc.level, c0.device)
    pm = _u(pt_mont)
    return (_w(_mm(_u(c0), pm, q, qi, datapath)),
            _w(_mm(_u(c1), pm, q, qi, datapath)))


def rescale_plain(c0, c1, ctx: CKKSContext, datapath: str = "df32"):
    common.check_datapath(datapath)
    sc = server_consts(ctx, c0.shape[1])
    x0, x1 = _u(c0), _u(c1)
    out0, out1 = _rescale2([x0[:, j] for j in range(sc.level)],
                           [x1[:, j] for j in range(sc.level)], sc,
                           datapath)
    return _pack(out0), _pack(out1)


def mul_pt_rescale_plain(c0, c1, pt_mont, ctx: CKKSContext,
                         datapath: str = "df32"):
    common.check_datapath(datapath)
    sc = server_consts(ctx, c0.shape[1])
    x0, x1, pm = _u(c0), _u(c1), _u(pt_mont)
    rows0, rows1 = [], []
    for j in range(sc.level):
        q, qi = _rc(sc, j)
        rows0.append(_mm(x0[:, j], pm[j], q, qi, datapath))
        rows1.append(_mm(x1[:, j], pm[j], q, qi, datapath))
    out0, out1 = _rescale2(rows0, rows1, sc, datapath)
    return _pack(out0), _pack(out1)


def mul_ct_relin_plain(a0, a1, b0, b1, ksk_b, ksk_a, ctx: CKKSContext,
                       datapath: str = "df32"):
    """Tensor (d0, d1, d2) -> relinearize d2 with the s^2 key -> rescale."""
    common.check_datapath(datapath)
    dp = datapath
    sc = server_consts(ctx, a0.shape[1])
    l = sc.level
    a0, a1, b0, b1 = _u(a0), _u(a1), _u(b0), _u(b1)
    d0, d1, d2 = [], [], []
    for j in range(l):
        q, qi = _rc(sc, j)
        r2 = int(sc.table[j, sc.off_r2])
        b0m = _mm(b0[:, j], r2, q, qi, dp)       # enter Montgomery once
        b1m = _mm(b1[:, j], r2, q, qi, dp)
        d0.append(_mm(a0[:, j], b0m, q, qi, dp))
        d1.append(modmul.addmod(_mm(a0[:, j], b1m, q, qi, dp),
                                _mm(a1[:, j], b0m, q, qi, dp), q))
        d2.append(_mm(a1[:, j], b1m, q, qi, dp))
    ks0, ks1 = _keyswitch(torch.stack(d2, dim=1), _u(ksk_b), _u(ksk_a), sc,
                          dp)
    rows0 = [modmul.addmod(d0[i], ks0[i], _rc(sc, i)[0]) for i in range(l)]
    rows1 = [modmul.addmod(d1[i], ks1[i], _rc(sc, i)[0]) for i in range(l)]
    out0, out1 = _rescale2(rows0, rows1, sc, dp)
    return _pack(out0), _pack(out1)


def rotate_plain(c0, c1, perm, ksk_b, ksk_a, ctx: CKKSContext,
                 datapath: str = "df32"):
    """sigma_g(ct), then the key switch sigma_g(s) -> s."""
    common.check_datapath(datapath)
    sc = server_consts(ctx, c0.shape[1])
    l = sc.level
    ks0, ks1 = _keyswitch(_gather(_u(c1), perm), _u(ksk_b), _u(ksk_a), sc,
                          datapath)
    a0p = _gather(_u(c0), perm)
    rows0 = [modmul.addmod(a0p[:, i], ks0[i], _rc(sc, i)[0])
             for i in range(l)]
    return _pack(rows0), _pack(ks1)


def ks_decompose_plain(c1, ctx: CKKSContext):
    """Hoisting, half 1: the rotation-independent digit-NTT stack of c1,
    (B, l+1, l, N)."""
    sc = server_consts(ctx, c1.shape[1])
    return _w(torch.stack(_ks_digits(_u(c1), sc), dim=1))


def ks_apply_rot_plain(c0, h, perm, ksk_b, ksk_a, ctx: CKKSContext,
                       datapath: str = "df32"):
    """Hoisting, half 2: permute the digits, multiply-accumulate, mod-down.
    The same words as ``rotate_plain``."""
    common.check_datapath(datapath)
    sc = server_consts(ctx, c0.shape[1])
    l = sc.level
    hp = _gather(_u(h), perm)
    acc = _ks_accumulate([hp[:, i] for i in range(l + 1)], _u(ksk_b),
                         _u(ksk_a), sc, datapath)
    ks0, ks1 = _ks_moddown(acc, sc, datapath)
    a0p = _gather(_u(c0), perm)
    rows0 = [modmul.addmod(a0p[:, i], ks0[i], _rc(sc, i)[0])
             for i in range(l)]
    return _pack(rows0), _pack(ks1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _geo(x: torch.Tensor, ctx: CKKSContext, name: str):
    """(sc, device table, batch, level) after the checks every entry point
    shares: a contiguous int32 (B, l, N) ciphertext on a CUDA device."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors")
    batch, level, n = x.shape
    if level < 1 or n != ctx.n:
        raise ValueError(f"{name}: ciphertext shape {tuple(x.shape)}")
    common.check_grid_rows(batch)
    sc = server_consts(ctx, level)
    return sc, _device_table(sc, str(dev)), batch, level


def _check_ct(sc: ServerConsts, batch: int, dev, **tensors) -> None:
    for name, t in tensors.items():
        common.check_tensor(t, name, torch.int32, (batch, sc.level, sc.n),
                            dev)


def _check_key(sc: ServerConsts, dev, kb, ka) -> None:
    shape = (sc.level, sc.level + 1, sc.n)
    common.check_tensor(kb, "ksk_b", torch.int32, shape, dev)
    common.check_tensor(ka, "ksk_a", torch.int32, shape, dev)


def _check_perm(sc: ServerConsts, dev, perm) -> None:
    common.check_tensor(perm, "perm", torch.int32, (1, sc.n), dev)


def _pointwise_cuda(mode: int, name: str, c0, c1, b0, b1, ctx):
    sc, table, batch, level = _geo(c0, ctx, name)
    dev = c0.device
    _check_ct(sc, batch, dev, c0=c0, c1=c1)
    if mode == 0:
        _check_ct(sc, batch, dev, c0b=b0, c1b=b1)
    else:
        common.check_tensor(b0, "pt", torch.int32, (level, sc.n), dev)
        b1 = b0
    o0, o1 = torch.empty_like(c0), torch.empty_like(c1)
    common.launch("server_pointwise_launch", dev, mode, c0.data_ptr(),
                  c1.data_ptr(), b0.data_ptr(), b1.data_ptr(),
                  table.data_ptr(), o0.data_ptr(), o1.data_ptr(), batch,
                  level, sc.kc.logn, sc.ncols)
    LAUNCHES[name] += 1
    return o0, o1


def add_ct_cuda(c0a, c1a, c0b, c1b, ctx: CKKSContext):
    return _pointwise_cuda(0, "add_ct", c0a, c1a, c0b, c1b, ctx)


def add_pt_cuda(c0, c1, pt, ctx: CKKSContext):
    return _pointwise_cuda(1, "add_pt", c0, c1, pt, None, ctx)


def mul_pt_cuda(c0, c1, pt_mont, ctx: CKKSContext):
    return _pointwise_cuda(2, "mul_pt", c0, c1, pt_mont, None, ctx)


def _rescale_cuda(name: str, c0, c1, pt_mont, ctx):
    sc, table, batch, level = _geo(c0, ctx, name)
    dev = c0.device
    if level < 2:
        raise ValueError(f"{name} needs at least 2 limbs")
    _check_ct(sc, batch, dev, c0=c0, c1=c1)
    if pt_mont is not None:
        common.check_tensor(pt_mont, "pt_mont", torch.int32, (level, sc.n),
                            dev)
    tw = _heaps(sc, dev)
    w = torch.empty((batch, 2, sc.n), dtype=torch.int32, device=dev)
    o0 = torch.empty((batch, level - 1, sc.n), dtype=torch.int32, device=dev)
    o1 = torch.empty_like(o0)
    common.launch("server_rescale_launch", dev, c0.data_ptr(), c1.data_ptr(),
                  None if pt_mont is None else pt_mont.data_ptr(),
                  table.data_ptr(), tw.data_ptr(), w.data_ptr(),
                  o0.data_ptr(), o1.data_ptr(), batch, level, sc.kc.logn,
                  sc.ncols, sc.off_qdinv)
    LAUNCHES[name] += 1
    return o0, o1


def rescale_cuda(c0, c1, ctx: CKKSContext):
    return _rescale_cuda("rescale", c0, c1, None, ctx)


def mul_pt_rescale_cuda(c0, c1, pt_mont, ctx: CKKSContext):
    return _rescale_cuda("mul_pt_rescale", c0, c1, pt_mont, ctx)


def _heaps(sc: ServerConsts, dev) -> torch.Tensor:
    """The twiddle-heap scratch of one call, (2, l+1, N): the forward and
    inverse heaps of each table row, made by the call for the rows and
    directions its op transforms with."""
    return torch.empty((2, sc.level + 1, sc.n), dtype=torch.int32,
                       device=dev)


def _ks_scratch(sc: ServerConsts, batch: int, dev) -> dict:
    """The key switch's device intermediates: the twiddle heaps, centered
    digits (B, l, N), the digit-NTT stack h (B, l+1, l, N), the
    accumulators (B, 2, l+1, N) and the centered special row (B, 2, N)."""
    l, n = sc.level, sc.n
    return {
        "tw": _heaps(sc, dev),
        "digits": torch.empty((batch, l, n), dtype=torch.int32, device=dev),
        "h": torch.empty((batch, l + 1, l, n), dtype=torch.int32,
                         device=dev),
        "acc": torch.empty((batch, 2, l + 1, n), dtype=torch.int32,
                           device=dev),
        "w": torch.empty((batch, 2, n), dtype=torch.int32, device=dev),
    }


def mul_ct_relin_cuda(a0, a1, b0, b1, ksk_b, ksk_a, ctx: CKKSContext):
    sc, table, batch, level = _geo(a0, ctx, "mul_ct")
    dev = a0.device
    if level < 2:
        raise ValueError("mul_ct needs at least 2 limbs")
    _check_ct(sc, batch, dev, a0=a0, a1=a1, b0=b0, b1=b1)
    _check_key(sc, dev, ksk_b, ksk_a)
    s = _ks_scratch(sc, batch, dev)
    d0, d1, d2, t0, t1 = (torch.empty_like(a0) for _ in range(5))
    o0 = torch.empty((batch, level - 1, sc.n), dtype=torch.int32, device=dev)
    o1 = torch.empty_like(o0)
    common.launch("server_mul_ct_launch", dev, a0.data_ptr(), a1.data_ptr(),
                  b0.data_ptr(), b1.data_ptr(), ksk_b.data_ptr(),
                  ksk_a.data_ptr(), table.data_ptr(), s["tw"].data_ptr(),
                  d0.data_ptr(), d1.data_ptr(), d2.data_ptr(),
                  s["digits"].data_ptr(), s["h"].data_ptr(),
                  s["acc"].data_ptr(), s["w"].data_ptr(),
                  t0.data_ptr(), t1.data_ptr(), o0.data_ptr(), o1.data_ptr(),
                  batch, level, sc.kc.logn, sc.ncols, sc.off_r2,
                  sc.off_pinv, sc.off_qdinv)
    LAUNCHES["mul_ct"] += 1
    return o0, o1


def rotate_cuda(c0, c1, perm, ksk_b, ksk_a, ctx: CKKSContext):
    sc, table, batch, level = _geo(c0, ctx, "rotate")
    dev = c0.device
    _check_ct(sc, batch, dev, c0=c0, c1=c1)
    _check_perm(sc, dev, perm)
    _check_key(sc, dev, ksk_b, ksk_a)
    s = _ks_scratch(sc, batch, dev)
    o0, o1 = torch.empty_like(c0), torch.empty_like(c1)
    common.launch("server_rotate_launch", dev, c0.data_ptr(), c1.data_ptr(),
                  perm.data_ptr(), ksk_b.data_ptr(), ksk_a.data_ptr(),
                  table.data_ptr(), s["tw"].data_ptr(),
                  s["digits"].data_ptr(), s["h"].data_ptr(), s["acc"].data_ptr(), s["w"].data_ptr(),
                  o0.data_ptr(), o1.data_ptr(), batch, level,
                  sc.kc.logn, sc.ncols, sc.off_pinv)
    LAUNCHES["rotate"] += 1
    return o0, o1


def ks_decompose_cuda(c1, ctx: CKKSContext):
    sc, table, batch, level = _geo(c1, ctx, "ks_decompose")
    dev = c1.device
    _check_ct(sc, batch, dev, c1=c1)
    tw, digits = _heaps(sc, dev), torch.empty_like(c1)
    h = torch.empty((batch, level + 1, level, sc.n), dtype=torch.int32,
                    device=dev)
    common.launch("server_ks_decompose_launch", dev, c1.data_ptr(),
                  table.data_ptr(), tw.data_ptr(),
                  digits.data_ptr(), h.data_ptr(), batch, level, sc.kc.logn,
                  sc.ncols)
    LAUNCHES["ks_decompose"] += 1
    return h


def ks_apply_rot_cuda(c0, h, perm, ksk_b, ksk_a, ctx: CKKSContext):
    sc, table, batch, level = _geo(c0, ctx, "ks_apply_rot")
    dev = c0.device
    _check_ct(sc, batch, dev, c0=c0)
    common.check_tensor(h, "h", torch.int32, (batch, level + 1, level, sc.n),
                        dev)
    _check_perm(sc, dev, perm)
    _check_key(sc, dev, ksk_b, ksk_a)
    tw = _heaps(sc, dev)
    acc = torch.empty((batch, 2, level + 1, sc.n), dtype=torch.int32,
                      device=dev)
    w = torch.empty((batch, 2, sc.n), dtype=torch.int32, device=dev)
    o0, o1 = torch.empty_like(c0), torch.empty_like(c0)
    common.launch("server_ks_apply_rot_launch", dev, c0.data_ptr(),
                  h.data_ptr(), perm.data_ptr(), ksk_b.data_ptr(),
                  ksk_a.data_ptr(), table.data_ptr(), tw.data_ptr(),
                  acc.data_ptr(), w.data_ptr(), o0.data_ptr(), o1.data_ptr(),
                  batch, level, sc.kc.logn, sc.ncols, sc.off_pinv)
    LAUNCHES["ks_apply_rot"] += 1
    return o0, o1


# ---------------------------------------------------------------------------
# Routed entries: the reference's names and parameters
# ---------------------------------------------------------------------------
# Each takes the reference's positional parameters (without its Pallas-only
# ``interpret``) and runs the kernel on CUDA tensors, the plain version on
# CPU tensors. ``datapath`` defaults to 'f64' as in the reference and is
# validated on both routes; the kernels run the u64 REDC for both.


def _routed(cuda_fn, plain_fn, args, datapath: str | None = None):
    """``cuda_fn`` on CUDA tensors (operands made contiguous: a
    ``drop_to`` view or a key slice is copied), ``plain_fn`` on the CPU."""
    if datapath is not None:
        common.check_datapath(datapath)
    if common.route(args[0].device) == "cuda":
        return cuda_fn(*(a.contiguous() if isinstance(a, torch.Tensor) else a
                         for a in args))
    return plain_fn(*args) if datapath is None else plain_fn(*args, datapath)


def add_ct(c0a, c1a, c0b, c1b, ctx: CKKSContext):
    return _routed(add_ct_cuda, add_ct_plain, (c0a, c1a, c0b, c1b, ctx))


def add_pt(c0, c1, pt, ctx: CKKSContext):
    return _routed(add_pt_cuda, add_pt_plain, (c0, c1, pt, ctx))


def mul_pt(c0, c1, pt_mont, ctx: CKKSContext, datapath: str = "f64"):
    """ct x pt WITHOUT rescale (accumulation-friendly: sum products first,
    rescale once)."""
    return _routed(mul_pt_cuda, mul_pt_plain, (c0, c1, pt_mont, ctx),
                   datapath)


def rescale(c0, c1, ctx: CKKSContext, datapath: str = "f64"):
    return _routed(rescale_cuda, rescale_plain, (c0, c1, ctx), datapath)


def mul_pt_rescale(c0, c1, pt_mont, ctx: CKKSContext,
                   datapath: str = "f64"):
    return _routed(mul_pt_rescale_cuda, mul_pt_rescale_plain,
                   (c0, c1, pt_mont, ctx), datapath)


def mul_ct_relin(a0, a1, b0, b1, ksk_b, ksk_a, ctx: CKKSContext,
                 datapath: str = "f64"):
    return _routed(mul_ct_relin_cuda, mul_ct_relin_plain,
                   (a0, a1, b0, b1, ksk_b, ksk_a, ctx), datapath)


def rotate(c0, c1, perm, ksk_b, ksk_a, ctx: CKKSContext,
           datapath: str = "f64"):
    return _routed(rotate_cuda, rotate_plain,
                   (c0, c1, perm, ksk_b, ksk_a, ctx), datapath)


def ks_decompose(c1, ctx: CKKSContext):
    return _routed(ks_decompose_cuda, ks_decompose_plain, (c1, ctx))


def ks_apply_rot(c0, h, perm, ksk_b, ksk_a, ctx: CKKSContext,
                 datapath: str = "f64"):
    return _routed(ks_apply_rot_cuda, ks_apply_rot_plain,
                   (c0, h, perm, ksk_b, ksk_a, ctx), datapath)
