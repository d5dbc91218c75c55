"""Four-step negacyclic NTT / INTT as modular matrix products of int8
digits (K14): host tables, CUDA wrapper and plain version.

Port of ``repro.kernels.ntt_matmul`` (the TPU kernels ``_kernel_fwd`` /
``_kernel_inv``, ``ntt_rows_mm`` / ``intt_rows_mm``). Bailey's four-step
algorithm with N = N1 x N2 (``split_n``; 256 x 256 at N = 2^16, 256 x 128
at 2^15), W = psi^2:

    p[n] = a[n] psi^n;  P[n1, n2] = p[n2 N1 + n1];  B = P F2
    C = B o T, T[n1, k2] = W^(n1 k2);  D^T = C^T F1;  out[k1 N2 + k2] = D

Forward output is in natural order, out[k] = a(psi^(2k+1)), against the
butterfly kernels' bit-reversed order; the inverse runs mirrored with the
N1^-1 / N2^-1-carrying inverse tables. Each modular matmul splits both
operands into four balanced base-256 digits and sums the 16 digit products
(each product's entries |.| <= K * 128 * 128 <= 2^22; the sum of a digit
weight g = i + j, up to four products, reaches 2^24), recombined mod q with
one Barrett multiply per digit weight
(``common.recombine_digit_matmuls``).

  * ``tables(plan)``: F1, F2 and their inverses as (4, K, K) int8 digit
    planes, memoised by (q, N); ``packed`` lays a table out for the kernel
    (per digit and column, four consecutive k in one int32: the word an
    int8 mma fragment register holds);
  * ``limb_rows_mm_cuda`` launches ``csrc/ntt_matmul.cu`` (K14: the digit
    products on the tensor cores, int8 ``mma.sync``) once for an
    (L, rows, N) stack (the reference launches once per limb) and counts
    ``ntt_rows_mm`` / ``intt_rows_mm``;
  * ``rows_mm_plain`` / ``limb_rows_mm_plain`` follow the reference's order
    of operations on int64 words;
  * ``ntt_rows_mm`` / ``intt_rows_mm`` pick one by the tensor's device;
    ``ops.ntt_limbs(..., path='matmul')`` runs the stack.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import modmul
from repro_torch.core.ntt import make_plan
from repro_torch.kernels import common

LAUNCHES = {"ntt_rows_mm": 0, "intt_rows_mm": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def split_n(n: int) -> tuple[int, int]:
    logn = n.bit_length() - 1
    n1 = 1 << ((logn + 1) // 2)
    return n1, n // n1


# ---------------------------------------------------------------------------
# host tables (per prime, memoised)
# ---------------------------------------------------------------------------


def _pow_matrix(base: int, rows: int, cols: int, q: int,
                scale: int = 1) -> np.ndarray:
    """M[i, j] = scale * base^(i*j) mod q as uint32, one column step over
    all rows at a time (int64 products < 2^62)."""
    row_base = np.array([pow(base, i, q) for i in range(rows)], np.int64)
    out = np.empty((rows, cols), np.uint32)
    v = np.full(rows, scale % q, np.int64)
    for c in range(cols):
        out[:, c] = v
        v = v * row_base % q
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class FourStepTables:
    """One prime's four-step tables: F2 (N2 x N2), F1 (N1 x N1) and their
    inverses (carrying N2^-1, N1^-1) as (4, K, K) int8 digit planes."""

    f2d: np.ndarray
    f1d: np.ndarray
    f2id: np.ndarray
    f1id: np.ndarray
    w: int
    w_inv: int
    n1: int
    n2: int


def tables(plan) -> FourStepTables:
    """Memoised by (q, N), which determine psi and every table."""
    return _tables(plan.prime.q, plan.n, plan.psi)


@functools.lru_cache(maxsize=128)
def _tables(q: int, n: int, psi: int) -> FourStepTables:
    n1, n2 = split_n(n)
    w = pow(psi, 2, q)
    w1, w2 = pow(w, n2, q), pow(w, n1, q)
    w1i, w2i = pow(w1, -1, q), pow(w2, -1, q)
    digits = common.balanced_digits_np
    t = FourStepTables(
        f2d=digits(_pow_matrix(w2, n2, n2, q)),
        f1d=digits(_pow_matrix(w1, n1, n1, q)),
        f2id=digits(_pow_matrix(w2i, n2, n2, q, scale=pow(n2, -1, q))),
        f1id=digits(_pow_matrix(w1i, n1, n1, q, scale=pow(n1, -1, q))),
        w=w, w_inv=pow(w, -1, q), n1=n1, n2=n2)
    for a in (t.f2d, t.f1d, t.f2id, t.f1id):
        a.setflags(write=False)
    return t


def packed(fd: np.ndarray) -> np.ndarray:
    """(4, K, Nc) int8 digit planes -> (4, Nc, K/4) int32 whose word [j, n,
    kw] holds fd[j, 4kw + t, n] in byte t: a B fragment register of the
    kernel's int8 mma (column n, four consecutive k)."""
    d, k, nc = fd.shape
    return np.ascontiguousarray(fd.transpose(0, 2, 1)).view(
        np.int32).reshape(d, nc, k // 4)


# per-limb constant rows of the kernel (csrc/ntt_matmul.cu: MM_*): the
# shift-add REDC row, then -q^-1 mod 2^32, R mod q, 2^(8g+32) mod q for the
# seven digit weights (the epilogue's one Montgomery reduction of their
# 64-bit combination), and mont(psi^(2^j)) for j = 0..logN
MM_QINV = common.SA_COLS
MM_R = MM_QINV + 1
MM_C = MM_R + 1
MM_PW = MM_C + 2 * common.N_DIGITS - 1


@functools.lru_cache(maxsize=64)
def _mm_consts(primes, n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    t = np.zeros((len(primes), MM_PW + logn + 1), np.int64)
    t[:, :common.SA_COLS] = common.sa_rows(primes)
    for i, prime in enumerate(primes):
        pc = common.plan_consts(make_plan(prime, n))
        q = pc.q
        t[i, MM_QINV] = -pow(q, -1, 1 << 32) % (1 << 32)
        t[i, MM_R] = pc.r_mod_q
        t[i, MM_C:MM_PW] = [pow(2, 8 * g + 32, q)
                            for g in range(MM_PW - MM_C)]
        t[i, MM_PW:] = [pow(pc.psi, 1 << j, q) * pc.r_mod_q % q
                        for j in range(logn + 1)]
    out = (t & modmul.MASK32).astype(np.uint32).view(np.int32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=32)
def _device_tables(primes, n: int, inverse: bool, device: str):
    """(consts, stage-1 table, stage-2 table) on `device`, uploaded once:
    forward F2 then F1, inverse F1^-1 then F2^-1, stacked over limbs as
    (L, 4, K, K/4) int32."""
    ts = [tables(make_plan(p, n)) for p in primes]
    names = ("f1id", "f2id") if inverse else ("f2d", "f1d")
    fa, fb = (np.stack([packed(getattr(t, name)) for t in ts])
              for name in names)
    return tuple(common.host_table(a, device)
                 for a in (_mm_consts(primes, n), fa, fb))


@functools.lru_cache(maxsize=32)
def _device_pow_table(primes, n: int, device: str) -> torch.Tensor:
    """(L, 2N) int32 psi^k R mod q, k < 2N, of each limb's prime: built once
    on the card from the constant rows and shared by both directions."""
    consts = _device_tables(primes, n, False, device)[0]
    tab = torch.empty((len(primes), 2 * n), dtype=torch.int32, device=device)
    common.launch("ntt_mm_pow_table", torch.device(device), tab.data_ptr(),
                  consts.data_ptr(), len(primes), n.bit_length() - 1,
                  consts.shape[1])
    return tab


# ---------------------------------------------------------------------------
# plain version (int64 words, the reference's order of operations)
# ---------------------------------------------------------------------------


def gen_t_matrix(pc: common.PlanConsts, ratio: int, n1: int, n2: int,
                 device) -> torch.Tensor:
    """T[n1, k2] = ratio^(n1 k2) (Montgomery form) by column doubling."""
    wcol = common.gen_geometric(pc.r_mod_q, ratio, n1, pc, device)[:, None]
    t = torch.full((n1, 1), pc.r_mod_q, dtype=torch.int64, device=device)
    wpow = wcol
    c = 1
    while c < n2:
        t = torch.cat([t, modmul.mulmod_montgomery_sa_limb(t, wpow, pc.mont)],
                      dim=1)
        wpow = modmul.mulmod_montgomery_sa_limb(wpow, wpow, pc.mont)
        c *= 2
    return t[:, :n2]


def _mod_matmul(x: torch.Tensor, fd: np.ndarray,
                pc: common.PlanConsts) -> torch.Tensor:
    """Exact (rows, K) @ table (K, K) mod q: x int64 residues, fd the
    table's (4, K, K) int8 digit planes. The 16 digit products run as
    float64 matmuls (torch has no integer matmul on CUDA) and are rounded
    to int64: exact, since every partial and every partial sum is an
    integer below 2^22 in absolute value, far inside float64's 2^53, in
    any order of summation."""
    xd = [d.to(torch.float64) for d in common.balanced_digits(x)]
    fdd = torch.as_tensor(fd.astype(np.float64), device=x.device)
    partials = {}
    for i in range(common.N_DIGITS):
        for j in range(common.N_DIGITS):
            partials[(i, j)] = torch.round(xd[i] @ fdd[j]).to(torch.int64)
    return common.recombine_digit_matmuls(partials, pc)


def rows_mm_plain(x: torch.Tensor, plan, inverse: bool) -> torch.Tensor:
    """(rows, N) int32 words of one prime -> four-step NTT (natural order
    out) or its inverse (natural order in), int32."""
    pc = common.plan_consts(plan)
    t = tables(plan)
    n, n1, n2 = pc.n, t.n1, t.n2
    dev = x.device
    rb = x.shape[0]
    x = modmul.u32_to_i64(x)
    sa = modmul.mulmod_montgomery_sa_limb
    if not inverse:
        psin = common.gen_geometric(pc.r_mod_q, pc.psi, n, pc, dev)
        p = sa(x, psin[None, :], pc.mont)
        pm = p.reshape(rb, n2, n1).transpose(1, 2)           # (rb, n1, n2)
        b = _mod_matmul(pm.reshape(rb * n1, n2), t.f2d, pc)
        c = sa(b.reshape(rb, n1, n2),
               gen_t_matrix(pc, t.w, n1, n2, dev)[None], pc.mont)
        ct = c.transpose(1, 2).reshape(rb * n2, n1)
        dt = _mod_matmul(ct, t.f1d, pc).reshape(rb, n2, n1)
        out = dt.transpose(1, 2).reshape(rb, n)
    else:
        dt = x.reshape(rb, n1, n2).transpose(1, 2).reshape(rb * n2, n1)
        ct = _mod_matmul(dt, t.f1id, pc).reshape(rb, n2, n1)
        b = sa(ct.transpose(1, 2),
               gen_t_matrix(pc, t.w_inv, n1, n2, dev)[None], pc.mont)
        p = _mod_matmul(b.reshape(rb * n1, n2), t.f2id, pc)
        p = p.reshape(rb, n1, n2).transpose(1, 2).reshape(rb, n)
        psin_inv = common.gen_geometric(pc.r_mod_q, pc.psi_inv, n, pc, dev)
        out = sa(p, psin_inv[None, :], pc.mont)
    return modmul.i64_to_u32(out)


def limb_rows_mm_plain(x: torch.Tensor, plans, inverse: bool
                       ) -> torch.Tensor:
    """(L, rows, N) int32 words, limb l of prime l -> the four-step
    transform of every limb."""
    return torch.stack([rows_mm_plain(x[l], plans[l], inverse)
                        for l in range(x.shape[0])])


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------


def limb_rows_mm_cuda(x: torch.Tensor, plans, inverse: bool) -> torch.Tensor:
    """CUDA launch of ``ntt_matmul.cu`` over an (L, rows, N) stack; same
    function as ``limb_rows_mm_plain``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("limb_rows_mm_cuda needs a CUDA tensor")
    if x.dim() != 3 or x.shape[0] != len(plans) or x.shape[1] == 0:
        raise ValueError(f"x must be ({len(plans)}, rows >= 1, N), got "
                         f"{tuple(x.shape)}")
    L, rows, n = x.shape
    if not 16 <= n <= 1 << 16 or any(p.n != n for p in plans):
        raise ValueError(f"N={n} must be the plans' N, in [16, 2^16]")
    common.check_tensor(x, "x", torch.int32, (L, rows, n), dev)
    n1, n2 = split_n(n)
    primes = tuple(p.prime for p in plans)
    consts, fa, fb = _device_tables(primes, n, bool(inverse), str(dev))
    tab = _device_pow_table(primes, n, str(dev))
    out = torch.empty_like(x)
    y = torch.empty_like(x)
    common.launch("ntt_mm_launch", dev, x.data_ptr(), out.data_ptr(),
                  y.data_ptr(), tab.data_ptr(), fa.data_ptr(), fb.data_ptr(),
                  consts.data_ptr(), L, rows, n1.bit_length() - 1,
                  n2.bit_length() - 1, consts.shape[1], int(inverse))
    LAUNCHES["intt_rows_mm" if inverse else "ntt_rows_mm"] += 1
    return out


def ntt_rows_mm(x: torch.Tensor, plan) -> torch.Tensor:
    """Forward negacyclic NTT of (rows, N) int32 words, natural order:
    out[k] = a(psi^(2k+1)). K14 on a CUDA tensor, the plain version on the
    CPU."""
    if common.route(x.device) == "cuda":
        return limb_rows_mm_cuda(x[None], [plan], False)[0]
    return rows_mm_plain(x, plan, False)


def intt_rows_mm(x: torch.Tensor, plan) -> torch.Tensor:
    """Inverse of ``ntt_rows_mm`` (natural-order input)."""
    if common.route(x.device) == "cuda":
        return limb_rows_mm_cuda(x[None], [plan], True)[0]
    return rows_mm_plain(x, plan, True)
