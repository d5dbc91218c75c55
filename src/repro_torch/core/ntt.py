"""Negacyclic NTT plans (host tables) and the exact reference transforms.

Port of ``repro.core.ntt``: ``bitrev_indices``, ``TwiddleSeeds``,
``NTTPlan``/``make_plan`` (the per-stage OTF seed+step scalars and the
Montgomery-form psi / psi^-1 tables), the exact transforms ``ntt`` /
``intt`` (table twiddles, the u64 REDC oracle carried as int64),
``negacyclic_polymul`` through the transform domain and
``negacyclic_polymul_schoolbook`` (the O(N^2) oracle), ``stage_twiddles_np``
(the OTF doubling generator), ``ntt_stacked`` / ``intt_stacked``, the
table-twiddle transforms of a whole limb stack (keygen runs the forward),
``NTTPlan.table_nbytes`` and the paper's Fig. 4 multiplier models
(``flowgraph_multiply_count``, ``mdc_multiplier_count``). The reference's u64 REDC
and the 16-bit-limb REDC used in ``ntt_stacked`` return the same words (the
reference itself switches to the limb engine without x64), so keys are
bit-identical.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import modmul
from repro_torch.core.modmul import MontgomeryConstants
from repro_torch.core.primes import NTTPrime, primitive_2nth_root


def bitrev_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _pow_table(base: int, n: int, q: int) -> np.ndarray:
    """[base^0, ..., base^(n-1)] mod q via doubling."""
    t = np.array([1], dtype=np.uint64)
    step = base % q
    while len(t) < n:
        t = np.concatenate([t, (t * np.uint64(step)) % np.uint64(q)])
        step = step * step % q
    return t[:n]


@dataclasses.dataclass(frozen=True)
class TwiddleSeeds:
    """Per-stage (seed, step) scalars of the OTF twiddle generator."""

    q: int
    logn: int
    fwd_base: tuple[int, ...]   # B_s = psi^{N/(2m)}, m = 2^s
    fwd_step: tuple[int, ...]   # W_s = psi^{N/m}
    inv_base: tuple[int, ...]   # GS stage h = N >> (s+1): psi^{-N/(2h)}
    inv_step: tuple[int, ...]
    n_inv: int

    def nbytes(self) -> int:
        """Bytes of the seed state as uint32 words."""
        return 4 * (len(self.fwd_base) + len(self.fwd_step)
                    + len(self.inv_base) + len(self.inv_step) + 1)


@dataclasses.dataclass(frozen=True, eq=False)
class NTTPlan:
    """Everything one prime needs for a negacyclic NTT/INTT of size N."""

    prime: NTTPrime
    mont: MontgomeryConstants
    n: int
    psi: int
    seeds: TwiddleSeeds
    psi_brv_mont: np.ndarray       # Psi[j] = psi^{bitrev(j)} * R mod q
    psi_inv_brv_mont: np.ndarray   # the same for psi^-1
    n_inv_mont: int

    def table_nbytes(self) -> int:
        """Bytes of the full psi / psi^-1 tables: what the "fetch from
        memory" baseline (ABC-FHE_Base, Fig. 6b) stores per prime."""
        return self.psi_brv_mont.nbytes + self.psi_inv_brv_mont.nbytes


@functools.lru_cache(maxsize=128)
def make_plan(prime: NTTPrime, n: int) -> NTTPlan:
    q = prime.q
    logn = n.bit_length() - 1
    psi = primitive_2nth_root(q, 2 * n)
    psi_inv = pow(psi, -1, q)
    r = (1 << 32) % q

    brv = bitrev_indices(n)
    psi_brv = _pow_table(psi, n, q)[brv]
    psi_inv_brv = _pow_table(psi_inv, n, q)[brv]

    def to_mont(t):
        return (t * np.uint64(r)) % np.uint64(q)

    fwd_base, fwd_step, inv_base, inv_step = [], [], [], []
    for s in range(logn):
        m = 1 << s
        fwd_base.append(pow(psi, n // (2 * m), q))
        fwd_step.append(pow(psi, n // m, q))
    for s in range(logn):
        h = n >> (s + 1)
        inv_base.append(pow(psi_inv, n // (2 * h), q))
        inv_step.append(pow(psi_inv, n // h, q))

    seeds = TwiddleSeeds(q=q, logn=logn, fwd_base=tuple(fwd_base),
                         fwd_step=tuple(fwd_step), inv_base=tuple(inv_base),
                         inv_step=tuple(inv_step), n_inv=pow(n, -1, q))
    return NTTPlan(prime=prime, mont=MontgomeryConstants.make(prime), n=n,
                   psi=psi, seeds=seeds, psi_brv_mont=to_mont(psi_brv),
                   psi_inv_brv_mont=to_mont(psi_inv_brv),
                   n_inv_mont=(seeds.n_inv * r) % q)


def stage_twiddles_np(base: int, step: int, m: int, q: int) -> np.ndarray:
    """OTF generation of [base * step^{bitrev_m(i)}]_{i<m} via doubling."""
    a = np.array([base % q], dtype=np.uint64)
    w = step % q
    # A_{k+1} = [A_k, A_k * W^{m/2^{k+1}}]: precompute W^{m/2}, W^{m/4}, ...
    exps = []
    e = m // 2
    while e >= 1:
        exps.append(pow(w, e, q))
        e //= 2
    for f in exps:
        a = np.concatenate([a, (a * np.uint64(f)) % np.uint64(q)])
    return a[:m]


# ---------------------------------------------------------------------------
# exact reference transforms (u64 REDC oracle as int64, table twiddles)
# ---------------------------------------------------------------------------


def ntt(a: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Forward negacyclic NTT. a: (..., N) int64 residues < q. In-order
    input -> bit-reversed-order output (CT DIT, merged psi)."""
    n, q, c = plan.n, plan.prime.q, plan.mont
    psi = torch.as_tensor(plan.psi_brv_mont.astype(np.int64),
                          device=a.device)
    batch = tuple(a.shape[:-1])
    x = a.reshape(batch + (1, n))
    m, t = 1, n
    while m < n:
        t //= 2
        x = x.reshape(batch + (m, 2, t))
        s = psi[m:2 * m].reshape((1,) * len(batch) + (m, 1))
        u = x[..., 0, :]
        v = modmul.mulmod_montgomery_u64(x[..., 1, :], s, c)
        x = torch.stack([modmul.addmod(u, v, q), modmul.submod(u, v, q)],
                        dim=-2)
        x = x.reshape(batch + (2 * m, t))
        m *= 2
    return x.reshape(batch + (n,))


def intt(a: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """Inverse negacyclic NTT: bit-reversed input -> in-order output (GS
    DIF, merged psi^-1, folded N^-1)."""
    n, q, c = plan.n, plan.prime.q, plan.mont
    psi_inv = torch.as_tensor(plan.psi_inv_brv_mont.astype(np.int64),
                              device=a.device)
    batch = tuple(a.shape[:-1])
    x = a.reshape(batch + (n, 1))
    h, t = n // 2, 1
    while h >= 1:
        x = x.reshape(batch + (h, 2, t))
        s = psi_inv[h:2 * h].reshape((1,) * len(batch) + (h, 1))
        u, v = x[..., 0, :], x[..., 1, :]
        even = modmul.addmod(u, v, q)
        odd = modmul.mulmod_montgomery_u64(modmul.submod(u, v, q), s, c)
        x = torch.cat([even, odd], dim=-1).reshape(batch + (h, 2 * t))
        t *= 2
        h //= 2
    x = x.reshape(batch + (n,))
    return modmul.mulmod_montgomery_u64(x, plan.n_inv_mont, c)


def negacyclic_polymul(a: torch.Tensor, b: torch.Tensor,
                       plan: NTTPlan) -> torch.Tensor:
    """(a * b) mod (X^N + 1, q) through the transform domain."""
    c = plan.mont
    ah, bh = ntt(a, plan), ntt(b, plan)
    bh_mont = modmul.mulmod_montgomery_u64(bh, c.r2, c)
    return intt(modmul.mulmod_montgomery_u64(ah, bh_mont, c), plan)


def negacyclic_polymul_schoolbook(a: np.ndarray, b: np.ndarray, q: int):
    """O(N^2) oracle: c_k = sum_{i+j=k} a_i b_j - sum_{i+j=k+N} a_i b_j."""
    n = a.shape[-1]
    full = np.zeros(2 * n, dtype=object)
    ao, bo = a.astype(object), b.astype(object)
    for i in range(n):
        full[i:i + n] += ao[i] * bo
    res = (full[:n] - full[n:]) % q
    return res.astype(np.uint64)


@dataclasses.dataclass(frozen=True, eq=False)
class StackedPlans:
    """Per-limb constants of same-N plans stacked along a limb axis."""

    n: int
    n_limbs: int
    q: np.ndarray                   # (L,) int64
    qinv_neg: np.ndarray            # (L,) int64
    r2: np.ndarray                  # (L,) int64
    psi_brv_mont: np.ndarray        # (L, N) int64
    psi_inv_brv_mont: np.ndarray    # (L, N) int64
    n_inv_mont: np.ndarray          # (L,) int64

    def bcast(self, arr_1d: np.ndarray, ndim: int) -> np.ndarray:
        """(L,) -> (L, 1, ..., 1) for broadcasting against (L, ..., N)."""
        return arr_1d.reshape((self.n_limbs,) + (1,) * (ndim - 1))

    def rows(self, arr: np.ndarray, ndim: int, device) -> torch.Tensor:
        """(L,) -> (L, 1, ..., 1) int64 tensor broadcasting against an
        (L, ..., N) residue stack."""
        return torch.as_tensor(arr, device=device).reshape(
            (self.n_limbs,) + (1,) * (ndim - 1))


def stack_plans(plans) -> StackedPlans:
    n = plans[0].n
    assert all(p.n == n for p in plans)
    return StackedPlans(
        n=n, n_limbs=len(plans),
        q=np.array([p.prime.q for p in plans], np.int64),
        qinv_neg=np.array([p.mont.qinv_neg for p in plans], np.int64),
        r2=np.array([p.mont.r2 for p in plans], np.int64),
        psi_brv_mont=np.stack([p.psi_brv_mont for p in plans]).astype(
            np.int64),
        psi_inv_brv_mont=np.stack(
            [p.psi_inv_brv_mont for p in plans]).astype(np.int64),
        n_inv_mont=np.array([p.n_inv_mont for p in plans], np.int64))


def ntt_stacked(a: torch.Tensor, sp: StackedPlans) -> torch.Tensor:
    """Forward negacyclic NTT of all limbs at once: a (L, ..., N) int64
    residues -> same shape, bit-reversed order per limb (CT DIT, merged
    psi, table twiddles) — the schedule of the reference ``ntt_stacked``."""
    n = sp.n
    batch = tuple(a.shape[1:-1])
    L = sp.n_limbs
    dev = a.device
    psi = torch.as_tensor(sp.psi_brv_mont, device=dev)
    bshape = (L,) + (1,) * (len(batch) + 2)
    q = torch.as_tensor(sp.q, device=dev).reshape(bshape)
    qinv = torch.as_tensor(sp.qinv_neg, device=dev).reshape(bshape)
    x = a.reshape((L,) + batch + (1, n))
    m, t = 1, n
    while m < n:
        t //= 2
        x = x.reshape((L,) + batch + (m, 2, t))
        s = psi[:, m:2 * m].reshape((L,) + (1,) * len(batch) + (m, 1))
        u = x[..., 0, :]
        v = modmul.mulmod_montgomery_limb_t(x[..., 1, :], s, q, qinv)
        x = torch.stack([modmul.addmod(u, v, q), modmul.submod(u, v, q)],
                        dim=-2)
        x = x.reshape((L,) + batch + (2 * m, t))
        m *= 2
    return x.reshape((L,) + batch + (n,))


def intt_stacked(a: torch.Tensor, sp: StackedPlans) -> torch.Tensor:
    """Inverse negacyclic NTT of all limbs at once (bit-reversed input,
    in-order output, N^-1 folded in): the schedule of the reference
    ``intt_stacked``; bit-identical per limb to ``intt``."""
    n = sp.n
    batch = tuple(a.shape[1:-1])
    L = sp.n_limbs
    dev = a.device
    psi_inv = torch.as_tensor(sp.psi_inv_brv_mont, device=dev)
    bshape = (L,) + (1,) * (len(batch) + 2)
    q = torch.as_tensor(sp.q, device=dev).reshape(bshape)
    qinv = torch.as_tensor(sp.qinv_neg, device=dev).reshape(bshape)
    x = a.reshape((L,) + batch + (n, 1))
    h, t = n // 2, 1
    while h >= 1:
        x = x.reshape((L,) + batch + (h, 2, t))
        s = psi_inv[:, h:2 * h].reshape((L,) + (1,) * len(batch) + (h, 1))
        u, v = x[..., 0, :], x[..., 1, :]
        even = modmul.addmod(u, v, q)
        odd = modmul.mulmod_montgomery_limb_t(modmul.submod(u, v, q), s, q,
                                              qinv)
        x = torch.cat([even, odd], dim=-1).reshape((L,) + batch + (h, 2 * t))
        t *= 2
        h //= 2
    x = x.reshape((L,) + batch + (n,))
    fshape = (L,) + (1,) * (len(batch) + 1)
    return modmul.mulmod_montgomery_limb_t(
        x, sp.rows(sp.n_inv_mont, len(fshape), dev),
        q.reshape(fshape), qinv.reshape(fshape))


# ---------------------------------------------------------------------------
# Multiplier-count analysis (paper Fig. 4): design-space model
# ---------------------------------------------------------------------------


def flowgraph_multiply_count(logn: int, merged: bool) -> int:
    """Total twiddle multiplications in one N-point negacyclic transform.

    Merged (Roy/Poppelmann scheduling): every butterfly carries a non-unity
    Psi twiddle -> (N/2)*log2(N) exactly (the paper's Fig. 4a '12' for N=8).
    Unmerged: separate psi^i pre-processing pass (N-1 non-trivial) plus the
    cyclic NTT whose W^0 positions are free: (N/2)*log2(N) - (N-1) + (N-1).
    The totals coincide; what differs is the *hardware column* structure
    (``mdc_multiplier_count``) — merging removes an entire multiplier column.
    """
    n = 1 << logn
    if merged:
        return (n // 2) * logn
    return (n // 2) * logn - (n - 1) + (n - 1)


def mdc_multiplier_count(logn: int, p_lanes: int, radix_log2: int,
                         merged: bool = True) -> float:
    """Modular-multiplier *units* in a P-lane MDC pipelined negacyclic NTT.

    Model (stated assumptions):
      * each pipeline stage column owns P/2 butterflies; a stage whose
        twiddles vary per-cycle needs P/2 general modular multipliers;
      * within a radix-2^r group, only the first stage carries general
        multipliers; the remaining r-1 stages carry *resident-constant*
        multipliers (twiddle fixed over long bursts — the paper's consistent
        radix-2^n pattern), which the shift-add Montgomery datapath realises
        at ~half a general multiplier;
      * an unmerged design spends one extra full column (P units) on the
        nega-cyclic psi pre-processing.

    The paper reports 29.7% / 22.3% reductions for its radix-2^n vs radix-2 /
    radix-2^2; this transparent model lands in the same regime (exact
    figures depend on proprietary design details).
    """
    half = p_lanes / 2
    full_stages = -(-logn // radix_log2)          # first stage of each group
    const_stages = logn - full_stages
    units = half * full_stages + 0.5 * half * const_stages
    if not merged:
        units += p_lanes
    return units
