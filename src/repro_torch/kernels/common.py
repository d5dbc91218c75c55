"""Per-limb kernel constants and the plain OTF-twiddle NTT/INTT stage loops.

Port of the client half of ``repro.kernels.common``:

  * ``FourierConfig`` / ``FOURIER_MODES`` — the mode switch of the
    reconfigurable Fourier engine (``ops.fourier``);
  * ``plan_consts`` — per-(prime, N) OTF twiddle seeds and doubling
    factors, psi, psi^-1 and R mod q;
  * ``stacked_kernel_consts`` — the (L, K) uint32 seed table, same layout
    as the reference (``OFF_Q``/``OFF_QINV``/``OFF_NINV``, then per forward
    stage [base, factors...], then per inverse stage). The CUDA kernels
    read exactly this table (``device_seed_table``: its int32 copy on a
    device);
  * ``stacked_digit_consts`` — per-limb (2^22, 2^44) radix constants;
  * ``gen_twiddles_t`` / ``ntt_stages_t`` / ``intt_stages_t`` — the plain
    PyTorch stage loops (int64 residues), the schedule the CUDA stage loops
    in ``csrc/client_common.cuh`` follow;
  * ``gen_twiddles`` / ``gen_geometric`` / ``ntt_stages`` / ``intt_stages``
    — the same loops with one prime's constants and the shift-add REDC
    (the per-limb kernels K12, K13, K14); ``sa_table`` — the per-limb
    (q, p_bw, n+1, k-terms) rows from which the CUDA kernels run that REDC;
  * ``N_DIGITS`` / ``balanced_digits_np`` / ``balanced_digits`` /
    ``recombine_digit_matmuls`` — the int8 balanced-digit split of the
    four-step NTT's modular matmuls (K14);
  * what every CUDA wrapper shares: ``route`` (kernel or plain version by
    device), the argument checks, and ``launch`` (the C entry point on the
    current stream, raising on a CUDA error).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import modmul, rns
from repro_torch.core.modmul import MontgomeryConstants
from repro_torch.core.ntt import NTTPlan, make_plan
from repro_torch.kernels import build


@dataclasses.dataclass(frozen=True)
class FourierConfig:
    """Launch configuration of the reconfigurable Fourier engine.

    mode:
      * ``'ntt'``  — modular negacyclic NTT over RNS limb stacks (K1);
      * ``'fft'``  — df32 complex canonical-embedding SpecialFFT (K4);
      * ``'host'`` — complex128 numpy oracle on the host.

    The reference's ``block_rows`` / ``interpret`` are TPU grid knobs; on
    the card every kernel runs one block per row, so only ``mode`` is kept.
    """

    mode: str = "fft"


FOURIER_MODES = ("ntt", "fft", "host")

# the dtype paths of the Delta-scale / RNS / CRT interior (client) and of
# the pointwise REDC (server)
DATAPATHS = ("df32", "f64")


def check_datapath(datapath: str) -> None:
    if datapath not in DATAPATHS:
        raise ValueError(f"datapath must be one of {DATAPATHS}, got "
                         f"{datapath!r}")


@dataclasses.dataclass(frozen=True)
class PlanConsts:
    """Per-(prime, N) constants for in-kernel NTT/INTT: per-stage seeds and
    the doubling factors A_{k+1} = [A_k, A_k * f_k] (Montgomery form)."""

    q: int
    n: int
    logn: int
    mont: MontgomeryConstants
    fwd_base_mont: tuple[int, ...]
    fwd_factors: tuple[tuple[int, ...], ...]
    inv_base_mont: tuple[int, ...]
    inv_factors: tuple[tuple[int, ...], ...]
    n_inv_mont: int
    psi: int
    psi_inv: int
    r_mod_q: int                            # R mod q = Montgomery form of 1

    def seed_scalar_count(self) -> int:
        """Scalars of the OTF seed state: the per-stage seeds and
        doubling factors of both directions, q and N^-1 (~log^2(N) per
        prime, the paper's unified OTF TF Gen state)."""
        return (len(self.fwd_base_mont) + len(self.inv_base_mont)
                + sum(len(f) for f in self.fwd_factors)
                + sum(len(f) for f in self.inv_factors) + 2)


def plan_consts(plan: NTTPlan) -> PlanConsts:
    """Memoised by plan content: (prime, N) determines every constant."""
    return _plan_consts(plan.prime, plan.n)


@functools.lru_cache(maxsize=256)
def _plan_consts(prime, n: int) -> PlanConsts:
    return _build_plan_consts(make_plan(prime, n))


def _build_plan_consts(plan: NTTPlan) -> PlanConsts:
    q = plan.prime.q
    n = plan.n
    logn = n.bit_length() - 1
    r = (1 << 32) % q
    s = plan.seeds

    def factors(step: int, m: int) -> tuple[int, ...]:
        # step^(m/2), step^(m/4), ..., step^1 (Montgomery form)
        out = []
        e = m // 2
        while e >= 1:
            out.append((pow(step, e, q) * r) % q)
            e //= 2
        return tuple(out)

    fwd_base, fwd_f, inv_base, inv_f = [], [], [], []
    for st in range(logn):
        fwd_base.append((s.fwd_base[st] * r) % q)
        fwd_f.append(factors(s.fwd_step[st], 1 << st))
    for st in range(logn):
        inv_base.append((s.inv_base[st] * r) % q)
        inv_f.append(factors(s.inv_step[st], n >> (st + 1)))
    return PlanConsts(q=q, n=n, logn=logn, mont=plan.mont,
                      fwd_base_mont=tuple(fwd_base), fwd_factors=tuple(fwd_f),
                      inv_base_mont=tuple(inv_base), inv_factors=tuple(inv_f),
                      n_inv_mont=plan.n_inv_mont, psi=plan.psi,
                      psi_inv=pow(plan.psi, -1, q), r_mod_q=r)


# (L, K) table layout per limb row:
#   [0] q   [1] -q^{-1} mod 2^32   [2] N^{-1} (Montgomery form)
#   then per forward stage s = 0..logn-1:  base_s, f_0..f_{s-1}
#   then per inverse stage t = 0..logn-1:  base_t, f_0..f_{logn-2-t}
OFF_Q = 0
OFF_QINV = 1
OFF_NINV = 2
_OFF_STAGES = 3


@dataclasses.dataclass(frozen=True, eq=False)
class StackedKernelConsts:
    """(L, K) uint32 table of per-limb kernel constants + column offsets."""

    n: int
    logn: int
    n_limbs: int
    fwd_off: tuple[int, ...]
    inv_off: tuple[int, ...]
    n_scalars: int
    table: np.ndarray            # (L, n_scalars) uint32

    def fwd_nfac(self, s: int) -> int:
        return s

    def inv_nfac(self, st: int) -> int:
        return self.logn - 1 - st


def stacked_kernel_consts(plans) -> StackedKernelConsts:
    """Memoised by plan content ((prime, N) per limb)."""
    assert all(p.n == plans[0].n for p in plans)
    return _stacked_kc(tuple((p.prime, p.n) for p in plans))


@functools.lru_cache(maxsize=64)
def _stacked_kc(keys) -> StackedKernelConsts:
    pcs = [_plan_consts(prime, n) for prime, n in keys]
    n, logn = pcs[0].n, pcs[0].logn
    fwd_off, inv_off = [], []
    cur = _OFF_STAGES
    for s in range(logn):
        fwd_off.append(cur)
        cur += 1 + s
    for st in range(logn):
        inv_off.append(cur)
        cur += 1 + (logn - 1 - st)
    table = np.zeros((len(pcs), cur), np.uint32)
    for i, pc in enumerate(pcs):
        table[i, OFF_Q] = pc.q
        table[i, OFF_QINV] = pc.mont.qinv_neg
        table[i, OFF_NINV] = pc.n_inv_mont
        for s in range(logn):
            o = fwd_off[s]
            table[i, o] = pc.fwd_base_mont[s]
            table[i, o + 1:o + 1 + s] = pc.fwd_factors[s]
        for st in range(logn):
            o = inv_off[st]
            nf = logn - 1 - st
            table[i, o] = pc.inv_base_mont[st]
            table[i, o + 1:o + 1 + nf] = pc.inv_factors[st]
    table.setflags(write=False)
    return StackedKernelConsts(n=n, logn=logn, n_limbs=len(pcs),
                               fwd_off=tuple(fwd_off), inv_off=tuple(inv_off),
                               n_scalars=cur, table=table)


def host_table(a: np.ndarray, device) -> torch.Tensor:
    """Copy of a (read-only, memoised) host table as a tensor on `device`."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


def device_seed_table(kc: StackedKernelConsts, device) -> torch.Tensor:
    """kc.table as an (L, K) int32 tensor on `device`, uploaded once."""
    return _device_seed_table(kc, str(device))


@functools.lru_cache(maxsize=64)
def _device_seed_table(kc: StackedKernelConsts, device: str) -> torch.Tensor:
    return host_table(kc.table.view(np.int32), device)


def stacked_digit_consts(q_list) -> tuple:
    """((c22, c44), ...) Montgomery-form radix constants per limb."""
    return tuple(rns.digit_consts(int(q)) for q in q_list)


# ---------------------------------------------------------------------------
# plain stage loops (int64 residues; per-limb scalars read from the table)
# ---------------------------------------------------------------------------


def gen_twiddles_t(table: np.ndarray, off: int, nfac: int, q: int,
                   qinv_neg: int, row: int, device) -> torch.Tensor:
    """[base * step^bitrev(i)]_{i < 2^nfac} by nfac Montgomery doublings,
    base/factors read from columns [off, off + nfac] of limb row `row`."""
    a = torch.tensor([int(table[row, off])], dtype=torch.int64,
                     device=device)
    for j in range(nfac):
        prod = modmul.mulmod_montgomery_limb_t(
            a, int(table[row, off + 1 + j]), q, qinv_neg)
        a = torch.cat([a, prod])
    return a


def ntt_stages_t(x: torch.Tensor, kc: StackedKernelConsts, row: int
                 ) -> torch.Tensor:
    """Forward negacyclic NTT on (rows, N) int64 residues with limb `row`'s
    constants: CT DIT, merged psi, natural order in, bit-reversed out."""
    n = kc.n
    q = int(kc.table[row, OFF_Q])
    qinv = int(kc.table[row, OFF_QINV])
    rows = x.shape[0]
    m, t = 1, n
    while m < n:
        t //= 2
        s = m.bit_length() - 1
        tw = gen_twiddles_t(kc.table, kc.fwd_off[s], kc.fwd_nfac(s), q, qinv,
                            row, x.device)
        x = x.reshape(rows, m, 2, t)
        u = x[:, :, 0, :]
        v = modmul.mulmod_montgomery_limb_t(x[:, :, 1, :], tw[None, :, None],
                                            q, qinv)
        x = torch.stack([modmul.addmod(u, v, q), modmul.submod(u, v, q)],
                        dim=2).reshape(rows, n)
        m *= 2
    return x


def intt_stages_t(x: torch.Tensor, kc: StackedKernelConsts, row: int
                  ) -> torch.Tensor:
    """Inverse negacyclic NTT on (rows, N): GS, bit-reversed in, natural
    order out, N^-1 folded in at the end."""
    n = kc.n
    q = int(kc.table[row, OFF_Q])
    qinv = int(kc.table[row, OFF_QINV])
    rows = x.shape[0]
    h, t = n // 2, 1
    st = 0
    while h >= 1:
        tw = gen_twiddles_t(kc.table, kc.inv_off[st], kc.inv_nfac(st), q,
                            qinv, row, x.device)
        x = x.reshape(rows, h, 2, t)
        u, v = x[:, :, 0, :], x[:, :, 1, :]
        even = modmul.addmod(u, v, q)
        odd = modmul.mulmod_montgomery_limb_t(
            modmul.submod(u, v, q), tw[None, :, None], q, qinv)
        x = torch.cat([even, odd], dim=-1).reshape(rows, h * 2 * t)
        t *= 2
        h //= 2
        st += 1
    return modmul.mulmod_montgomery_limb_t(
        x.reshape(rows, n), int(kc.table[row, OFF_NINV]), q, qinv)


# ---------------------------------------------------------------------------
# plain stage loops with one prime's constants and the shift-add REDC
# (paper eq. 9-11): the per-limb kernels K12, K13 and K14
# ---------------------------------------------------------------------------


def gen_twiddles(base_mont: int, factor_list, pc: PlanConsts,
                 device) -> torch.Tensor:
    """[base * step^bitrev_m(i)]_{i<m} (Montgomery form) by log2(m)
    shift-add Montgomery doublings."""
    a = torch.tensor([base_mont], dtype=torch.int64, device=device)
    for f in factor_list:
        a = torch.cat([a, modmul.mulmod_montgomery_sa_limb(a, f, pc.mont)])
    return a


def gen_geometric(base_mont: int, ratio: int, length: int, pc: PlanConsts,
                  device) -> torch.Tensor:
    """[base * ratio^i]_{i<length} (Montgomery form) by doubling: the
    psi^n twist vectors of the four-step NTT."""
    q, r = pc.q, pc.r_mod_q
    a = torch.tensor([base_mont], dtype=torch.int64, device=device)
    while a.shape[0] < length:
        f = (pow(ratio % q, a.shape[0], q) * r) % q
        a = torch.cat([a, modmul.mulmod_montgomery_sa_limb(a, f, pc.mont)])
    return a[:length]


def ntt_stages(x: torch.Tensor, pc: PlanConsts) -> torch.Tensor:
    """Forward negacyclic NTT on (rows, N) int64 residues, merged-psi CT
    DIT, natural order in, bit-reversed out; twiddles generated per
    stage."""
    q, c, n = pc.q, pc.mont, pc.n
    rows = x.shape[0]
    m, t = 1, n
    while m < n:
        t //= 2
        s = m.bit_length() - 1
        tw = gen_twiddles(pc.fwd_base_mont[s], pc.fwd_factors[s], pc,
                          x.device)
        x = x.reshape(rows, m, 2, t)
        u = x[:, :, 0, :]
        v = modmul.mulmod_montgomery_sa_limb(x[:, :, 1, :],
                                             tw[None, :, None], c)
        x = torch.stack([modmul.addmod(u, v, q), modmul.submod(u, v, q)],
                        dim=2).reshape(rows, n)
        m *= 2
    return x


def intt_stages(x: torch.Tensor, pc: PlanConsts) -> torch.Tensor:
    """Inverse negacyclic NTT on (rows, N): bit-reversed in, natural order
    out, N^-1 folded in at the end."""
    q, c, n = pc.q, pc.mont, pc.n
    rows = x.shape[0]
    h, t = n // 2, 1
    s = 0
    while h >= 1:
        tw = gen_twiddles(pc.inv_base_mont[s], pc.inv_factors[s], pc,
                          x.device)
        x = x.reshape(rows, h, 2, t)
        u, v = x[:, :, 0, :], x[:, :, 1, :]
        even = modmul.addmod(u, v, q)
        odd = modmul.mulmod_montgomery_sa_limb(modmul.submod(u, v, q),
                                               tw[None, :, None], c)
        x = torch.cat([even, odd], dim=-1).reshape(rows, h * 2 * t)
        t *= 2
        h //= 2
        s += 1
    return modmul.mulmod_montgomery_sa_limb(x.reshape(rows, n),
                                            pc.n_inv_mont, c)


# (L, SA_COLS) int32 rows of the shift-add REDC constants the CUDA kernels
# read (csrc/client_common.cuh: SaRedc):
#   [0] q  [1] p_bw  [2] n+1  [3] number of k-terms  [4..6] the k-terms,
#   each its exponent e for +2^e and ~e (= -e-1) for -2^e  [7] unused
SA_COLS = 8
MAX_K_TERMS = 3


def sa_table(plans) -> np.ndarray:
    """Memoised by plan content."""
    return sa_rows(tuple(p.prime for p in plans))


@functools.lru_cache(maxsize=64)
def sa_rows(primes) -> np.ndarray:
    """``sa_table`` of a tuple of primes."""
    t = np.zeros((len(primes), SA_COLS), np.int32)
    for i, pr in enumerate(primes):
        if len(pr.k_terms) > MAX_K_TERMS or not (pr.p_bw < 32
                                                 and 0 < pr.n_plus_1 < 32):
            raise ValueError(f"prime {pr.q} has no shift-add REDC here")
        t[i, :4] = (np.uint32(pr.q).view(np.int32), pr.p_bw, pr.n_plus_1,
                    len(pr.k_terms))
        for j, (sign, e) in enumerate(pr.k_terms):
            t[i, 4 + j] = e if sign > 0 else ~e
    t.setflags(write=False)
    return t


def device_sa_table(plans, device) -> torch.Tensor:
    """sa_table(plans) as an int32 tensor on `device`, uploaded once."""
    return _device_sa_table(tuple(p.prime for p in plans), str(device))


@functools.lru_cache(maxsize=64)
def _device_sa_table(primes, device: str) -> torch.Tensor:
    return host_table(sa_rows(primes), device)


# ---------------------------------------------------------------------------
# balanced base-256 digits (the int8 products of the four-step NTT, K14)
# ---------------------------------------------------------------------------

N_DIGITS = 4


def balanced_digits_np(v: np.ndarray) -> np.ndarray:
    """Residues (< 2^31) -> (4, *v.shape) int8 balanced digits with
    v == sum d_i 256^i."""
    out = np.zeros((N_DIGITS,) + v.shape, dtype=np.int8)
    x = v.astype(np.int64)
    for i in range(N_DIGITS):
        d = x & 255
        over = d >= 128
        out[i] = np.where(over, d - 256, d).astype(np.int8)
        x = (x >> 8) + over.astype(np.int64)
    assert np.all(x == 0), "value exceeded 4 balanced digits"
    return out


def balanced_digits(v: torch.Tensor) -> list[torch.Tensor]:
    """int64 residues (< 2^31) -> 4 int64 tensors of balanced digits in
    [-128, 128) with v == sum d_i 256^i (``balanced_digits_jnp``)."""
    digs = []
    x = v
    for _ in range(N_DIGITS):
        d = x & 255
        over = d >= 128
        digs.append(torch.where(over, d - 256, d))
        x = (x >> 8) + over.to(torch.int64)
    return digs


def recombine_digit_matmuls(partials, pc: PlanConsts) -> torch.Tensor:
    """Digit-product sums S_ij = A_i @ B_j (int64, |S| < 2^22) -> residues
    sum_ij S_ij 2^(8(i+j)) mod q. Grouped by g = i + j (7 groups, |group
    sum| < 2^24, so sg + q > 0), then one Barrett multiply by 2^(8g) mod q
    per group and a modular sum."""
    q = pc.q
    groups: dict[int, torch.Tensor] = {}
    for (i, j), s in partials.items():
        g = i + j
        groups[g] = s if g not in groups else groups[g] + s
    acc = None
    for g, sg in groups.items():
        r = modmul.mulmod_barrett_limb(sg + q, pow(2, 8 * g, q), pc.mont)
        acc = r if acc is None else modmul.addmod(acc, r, q)
    return acc


# ---------------------------------------------------------------------------
# CUDA wrappers: routing, argument checks and the launch
# ---------------------------------------------------------------------------


def route(device) -> str:
    """'cuda' for a CUDA device (the kernel), 'plain' for the CPU (the
    plain PyTorch version); any other device raises. No fall-back: a CUDA
    input whose kernel cannot be built or launched raises."""
    if device.type == "cuda":
        return "cuda"
    if device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel for device {device}")


def resolve_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``: the card when None. Raises when
    the card is asked for and CUDA is absent (no hidden CPU fall-back)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on the card by default and CUDA is "
                           f"not available; pass device='cpu' for the CPU")
    return dev


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` (what every kernel entry point takes)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_key_rows(t: torch.Tensor, name: str, n_limbs: int, n: int,
                   device) -> None:
    """Raise unless `t` is a contiguous int32 (L >= n_limbs, N) key on
    `device` (the kernels read its first n_limbs rows)."""
    if t.dim() != 2 or t.shape[0] < n_limbs:
        raise ValueError(f"{name} must be (L >= {n_limbs}, {n}), got "
                         f"{tuple(t.shape)}")
    check_tensor(t, name, torch.int32, (t.shape[0], n), device)


# the CUDA grid's y extent: the rows of a (limb, row) grid
MAX_GRID_Y = 65535


def check_grid_rows(rows: int) -> None:
    if not 0 < rows <= MAX_GRID_Y:
        raise ValueError(f"the kernel's grid takes 1 to {MAX_GRID_Y} rows, "
                         f"got {rows}")


def check_limb_views(c0, c1, min_limbs: int, n: int, device) -> None:
    """Raise unless c0/c1 are int32 (B, >= min_limbs, N) views on `device`
    whose rows share one stride and hold their limbs contiguously (the
    first limbs of a (B, L, N) batch), as the decrypt kernels read them."""
    for name, t in (("c0", c0), ("c1", c1)):
        if t.device != device or t.dtype != torch.int32:
            raise TypeError(f"{name} must be an int32 tensor on {device}")
        if t.dim() != 3 or t.shape[0] != c0.shape[0] \
                or t.shape[1] < min_limbs or t.shape[2] != n:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"({c0.shape[0]}, >={min_limbs}, {n})")
        if t.stride(2) != 1 or t.stride(1) != n:
            raise ValueError(f"{name}: each row's limbs must be contiguous")
    if c0.stride(0) != c1.stride(0):
        raise ValueError("c0 and c1 must share their row stride")


def launch(entry: str, device, *args) -> None:
    """Call the C entry point `entry` (built on first use) with `args` and
    the device's current stream; raise on a non-zero CUDA error."""
    fn = build.load()[entry]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
