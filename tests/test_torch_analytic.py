"""The paper's analytic models in the port's ``core`` against the
reference's, on the CPU, in-process (host code only: no kernel, no JAX
subprocess).

  * ``modmul.OP_COSTS`` (Table I's analogue) equals the reference's dict,
    keeps its ordering (``tests/test_modmul.py:97``), and its "mul" column
    is what the port's three 16-bit-limb engines run: a
    ``TorchDispatchMode`` counts 12 / 11 / 4 ``aten.mul`` ops in
    ``mulmod_barrett_limb`` / ``mulmod_montgomery_limb`` /
    ``mulmod_montgomery_sa_limb``;
  * ``primes.census_paper_claim`` (§IV-A) equals the reference's dict;
  * ``ntt.flowgraph_multiply_count`` / ``mdc_multiplier_count`` (Fig. 4)
    equal the reference's over a grid and keep its model's ordering
    (``tests/test_ntt.py:98``); ``NTTPlan.table_nbytes`` and the OTF seeds
    keep the >99.9 % twiddle-store reduction (``tests/test_ntt.py:74``);
  * ``CKKSContext``'s four memory terms (§IV-B / Fig. 6b) and every plan's
    ``table_nbytes`` equal the reference's at every profile; at ``paper``
    the seed table the megakernel keeps on its device is under 0.5 % of
    the tables;
  * ``fft.special_fft_quantized`` (Fig. 3c) equals the reference's bit for
    bit, both directions, at the sweep's n = 2^12 and seven mantissas;
  * ``dfloat.effective_mantissa_bits`` gives the reference's 49 / 107.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import context as ref_context
from repro.core import dfloat as ref_dfloat
from repro.core import fft as ref_fft
from repro.core import modmul as ref_modmul
from repro.core import ntt as ref_ntt
from repro.core import primes as ref_primes
from repro_torch.core import context, dfloat, fft, modmul, ntt, primes
from repro_torch.core.encoder import boot_precision_bits
from repro_torch.kernels import client_stream

PRIMES = primes.find_ntt_friendly_primes(p_bw=30, n_plus_1=17, count=8)
SWEEP_N = 1 << 12                               # bench_precision.py's n
SWEEP_MBITS = (30, 35, 40, 43, 45, 48, 52)
PAPER_SEED_SHARE = 5e-3


# --- Table I: the modmul engines' multiply counts ---------------------------


def test_op_costs_equal_reference():
    assert modmul.OP_COSTS == ref_modmul.OP_COSTS


def test_op_cost_ordering():
    oc = modmul.OP_COSTS
    assert (oc["ntt_friendly"]["mul"] < oc["montgomery"]["mul"]
            < oc["barrett"]["mul"])
    # paper Table I: NTT-friendly saves 41.2% vs Montgomery, 67.7% vs Barrett
    # (area). Multiplier-count analogue: 4/11 = 64% and 4/12 = 67% reductions.
    assert oc["ntt_friendly"]["mul"] / oc["montgomery"]["mul"] < 0.6
    assert oc["ntt_friendly"]["mul"] / oc["barrett"]["mul"] < 0.4


class _OpCounter(TorchDispatchMode):
    """Counts the aten ops run while it is open, by overload packet."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("engine,fn", [
    ("barrett", "mulmod_barrett_limb"),
    ("montgomery", "mulmod_montgomery_limb"),
    ("ntt_friendly", "mulmod_montgomery_sa_limb")])
def test_op_costs_match_trace(engine, fn):
    """The engine runs exactly OP_COSTS[engine]['mul'] multiplies (each a
    16x16 limb product of a 32x32 one), and still gives a*b mod q."""
    p = PRIMES[0]
    c = modmul.MontgomeryConstants.make(p)
    rng = np.random.default_rng(5)
    a = torch.tensor(rng.integers(0, p.q, 64), dtype=torch.int64)
    b = torch.tensor(rng.integers(0, p.q, 64), dtype=torch.int64)
    b_in = b if engine == "barrett" else b * c.r1 % p.q
    with _OpCounter() as ops:
        got = getattr(modmul, fn)(a, b_in, c)
    assert ops.counts.get("mul", 0) == modmul.OP_COSTS[engine]["mul"]
    assert torch.equal(got, a * b % p.q)


# --- §IV-A: the prime census ------------------------------------------------


def test_census_equals_reference():
    got = primes.census_paper_claim()
    assert got == ref_primes.census_paper_claim(17)
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    assert set(got) - {"total"} <= set(range(32, 37))


# --- Fig. 4: the multiplier models; the twiddle store -----------------------


def test_multiplier_count_model():
    # merging removes a column; higher radix reduces units monotonically
    r2_unmerged = ntt.mdc_multiplier_count(16, 8, 1, merged=False)
    r2 = ntt.mdc_multiplier_count(16, 8, 1, merged=True)
    r4 = ntt.mdc_multiplier_count(16, 8, 2, merged=True)
    r2n = ntt.mdc_multiplier_count(16, 8, 4, merged=True)
    assert r2_unmerged > r2 >= r4 > r2n
    assert ntt.flowgraph_multiply_count(3, merged=True) == 12  # Fig. 4a


@pytest.mark.parametrize("merged", [True, False])
def test_multiplier_counts_equal_reference(merged):
    for logn in range(10, 17):
        assert ntt.flowgraph_multiply_count(logn, merged) == \
            ref_ntt.flowgraph_multiply_count(logn, merged)
        for p_lanes in range(2, 17):
            for radix in range(1, 5):
                got = ntt.mdc_multiplier_count(logn, p_lanes, radix, merged)
                want = ref_ntt.mdc_multiplier_count(logn, p_lanes, radix,
                                                    merged)
                assert got == want and type(got) is type(want)
    assert ntt.mdc_multiplier_count(16, 8, 2) == \
        ref_ntt.mdc_multiplier_count(16, 8, 2)          # merged by default


def test_seed_memory_reduction():
    """>99.9% on-chip memory reduction claim for the twiddle store."""
    plan = ntt.make_plan(PRIMES[0], 1 << 16)
    assert plan.seeds.nbytes() / plan.table_nbytes() < 1e-3


# --- §IV-B / Fig. 6b: the memory terms ---------------------------------------


@pytest.mark.parametrize("profile", sorted(context.PROFILES))
def test_memory_terms_equal_reference(profile):
    ctx = context.get_context(profile)
    ref = ref_context.get_context(profile)
    for term in ("twiddle_table_bytes", "twiddle_seed_bytes",
                 "key_material_bytes", "mask_error_bytes"):
        assert getattr(ctx, term)() == getattr(ref, term)(), term
    assert [p.table_nbytes() for p in ctx.plans] == [
        p.table_nbytes() for p in ref.plans]


def test_paper_memory_terms_against_device_tables():
    """At ``paper`` the terms are the ones the chip run prints, and the
    megakernel's seed table (what K5 keeps in place of the twiddle
    tables) is its host table's bytes and under 0.5 % of the tables."""
    ctx = context.get_context("paper")
    assert (ctx.twiddle_table_bytes(), ctx.twiddle_seed_bytes(),
            ctx.key_material_bytes(), ctx.mask_error_bytes()) == (
        25_165_824, 6_240, 12_582_912, 18_874_368)
    L = ctx.params.n_limbs
    tables = client_stream.device_tables(ctx, L, True, "cpu")
    seed = tables[2]
    assert seed.nbytes == client_stream.stream_consts(ctx, L, True)[
        0].table.nbytes
    assert seed.nbytes / ctx.twiddle_table_bytes() < PAPER_SEED_SHARE
    assert [t.nbytes for t in tables] == [524_288, 131_072, 26_400, 192]
    assert sum(t.nbytes for t in client_stream.device_tables(
        ctx, 2, False, "cpu")) == 657_576


# --- Fig. 3c: the quantized FFT; the df pair's mantissa ---------------------


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype == np.complex128 and np.array_equal(
        a.view(np.int64), b.view(np.int64))


@pytest.mark.parametrize("mbits", SWEEP_MBITS)
def test_special_fft_quantized_equals_reference(mbits):
    """bench_precision.py's round trip (seed 7): both directions bit for
    bit, and the same precision."""
    m = 4 * SWEEP_N
    rng = np.random.default_rng(7)
    z = rng.standard_normal(SWEEP_N) + 1j * rng.standard_normal(SWEEP_N)
    w = fft.special_fft_quantized(z, m, mbits, inverse=True)
    assert _bits_equal(w, ref_fft.special_fft_quantized(z, m, mbits,
                                                        inverse=True))
    back = fft.special_fft_quantized(w, m, mbits)
    assert _bits_equal(back, ref_fft.special_fft_quantized(w, m, mbits))
    bits = boot_precision_bits(z, back)
    if mbits >= 43:
        assert bits >= 19.29


@pytest.mark.parametrize("dtype,want", [
    (torch.float32, 49), (torch.float64, 107), (np.float32, 49),
    (np.float64, 107)])
def test_effective_mantissa_bits(dtype, want):
    assert dfloat.effective_mantissa_bits(dtype) == want
    if not isinstance(dtype, torch.dtype):
        assert ref_dfloat.effective_mantissa_bits(dtype) == want
