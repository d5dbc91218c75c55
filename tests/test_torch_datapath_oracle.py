"""The df32 datapath's stage oracles of the reference's
``tests/test_datapath_oracle.py``, on the port's plain path on the CPU,
with the reference's ``GRID``, named per-stage budgets (``STAGE_BUDGETS``)
and hypothesis settings:

  * ``delta_scale_round``: the df32^2 Delta-scale + RNE digits rebuild the
    integer the df64 oracle rounds to, 0 ULP, every digit below 2^23
    (``test_datapath_oracle.py:90``);
  * ``rns_reduce``: the uint32 digit reduction == the exact fmod residues,
    0 ULP (``:112``);
  * ``crt_center``: the word-pair CRT == the df64 CRT's centered
    integers, 0 ULP (``:132``);
  * ``div_delta_pair``: the /Delta pair collapse within 2^-48 of the exact
    rational, relative (``:155``);
  * hypothesis, 50 derandomized examples each: ``two_sum`` and
    ``two_prod`` are error-free, ``df_round_rne`` is round-half-even of
    the exact pair value (ties included), ``expansion3_digits`` rebuilds
    the integer with every digit below 2^23 (``:201-253``);
  * the df32 pipelines round-trip bit-identically to their f64 twins over
    the (logN, Delta, L, B) grid (``:267``; the two larger points
    ``slow``, as there), and a plain ``FHEClient`` is megakernel + df32
    (``:292``).

Each budget is a property of the port alone, so no JAX process runs.

Left out, with no PyTorch counterpart: the jaxpr scans for float64 /
64-bit integer equations and the ``JAX_ENABLE_X64=0`` lane
(``:306-505``): the port traces nothing; its df32 kernels are CUDA C++
held bit for bit against the plain versions by ``chip_smoke.py``.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch.core import dfloat as dfl
from repro_torch.core import encoder, rns
from repro_torch.core.context import CKKSParams, get_context
from repro_torch.fhe_client.client import FHEClient

STAGE_BUDGETS = {
    "delta_scale_round": 0,
    "rns_reduce": 0,
    "crt_center": 0,
    "div_delta_pair": 2.0 ** -48,
}

GRID = [(5, 30, 2), (6, 45, 3), (6, 40, 3)]


def _msgs(ctx, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, ctx.params.n_slots))
            + 1j * rng.standard_normal((batch, ctx.params.n_slots))) * 0.5


def _coeff_pairs(n, seed, scale_exp=0):
    """Synthetic df32 coefficient pairs (hi, lo) like the IFFT emits."""
    rng = np.random.default_rng(seed)
    hi = (rng.standard_normal(n) * 2.0 ** scale_exp).astype(np.float32)
    lo = (rng.standard_normal(n) * np.abs(hi) * 2.0 ** -25).astype(np.float32)
    return hi, lo


def _exact_int(*comps):
    return [sum(int(c[i]) for c in comps) for i in range(len(comps[0]))]


def _u32(t: torch.Tensor) -> np.ndarray:
    return (t.to(torch.int64) & 0xFFFFFFFF).numpy()


@pytest.mark.parametrize("logn,delta_bits,n_limbs", GRID)
def test_delta_scale_round_stage_zero_ulp(logn, delta_bits, n_limbs):
    delta = float(2 ** delta_bits)
    hi, lo = _coeff_pairs(1 << logn, seed=logn * 7 + delta_bits)
    d0, d1, d2 = (x.to(torch.int64).numpy() for x in encoder.delta_scale_digits(
        dfl.DF(torch.from_numpy(hi), torch.from_numpy(lo)), delta))
    got = [int(d0[i]) + int(d1[i]) * 2 ** 22 + int(d2[i]) * 2 ** 44
           for i in range(len(hi))]
    coeffs = torch.from_numpy(hi.astype(np.float64) + lo.astype(np.float64))
    o = encoder.delta_scale_round(coeffs, delta)
    want = _exact_int(o.hi.numpy(), o.lo.numpy())
    assert got == want, "delta_scale_round stage exceeded its 0-ULP budget"
    for d in (d0, d1, d2):
        assert np.max(np.abs(d)) < 2 ** 23


@pytest.mark.parametrize("logn,delta_bits,n_limbs", GRID)
def test_rns_reduce_stage_zero_ulp(logn, delta_bits, n_limbs):
    ctx = get_context(CKKSParams(logn=logn, n_limbs=n_limbs,
                                 delta_bits=delta_bits))
    delta = ctx.params.delta
    hi, lo = _coeff_pairs(ctx.params.n, seed=3 * logn + delta_bits)
    digits = encoder.delta_scale_digits(
        dfl.DF(torch.from_numpy(hi), torch.from_numpy(lo)), delta)
    got = rns.digits_to_residues_stacked(*digits, ctx.q_list[:n_limbs])
    coeffs = torch.from_numpy(hi.astype(np.float64) + lo.astype(np.float64))
    want = rns.to_rns_df(encoder.delta_scale_round(coeffs, delta),
                         ctx.q_list[:n_limbs])
    np.testing.assert_array_equal(
        _u32(got), _u32(want),
        err_msg="rns_reduce stage exceeded its 0-ULP budget")


@pytest.mark.parametrize("logn,delta_bits,n_limbs", GRID)
def test_crt_center_stage_zero_ulp(logn, delta_bits, n_limbs):
    ctx = get_context(CKKSParams(logn=logn, n_limbs=n_limbs,
                                 delta_bits=delta_bits))
    q0, q1 = ctx.q_list[0], ctx.q_list[1]
    rng = np.random.default_rng(logn + delta_bits)
    m0 = rng.integers(0, q0, 1 << logn).astype(np.uint32)
    m1 = rng.integers(0, q1, 1 << logn).astype(np.uint32)
    t0 = torch.from_numpy(m0.astype(np.int64))
    t1 = torch.from_numpy(m1.astype(np.int64))
    sign, hi, lo = rns.crt2_centered_u32(t0, t1, q0, q1)
    sign, hi, lo = sign.numpy(), hi.numpy(), lo.numpy()
    got = [int(sign[i]) * (int(hi[i]) << 32 | int(lo[i]))
           for i in range(len(m0))]
    v = rns.crt2_to_df(t0, t1, q0, q1)
    want = _exact_int(v.hi.numpy(), v.lo.numpy())
    assert got == want, "crt_center stage exceeded its 0-ULP budget"


@pytest.mark.parametrize("logn,delta_bits,n_limbs", GRID)
def test_div_delta_pair_stage_budget(logn, delta_bits, n_limbs):
    ctx = get_context(CKKSParams(logn=logn, n_limbs=n_limbs,
                                 delta_bits=delta_bits))
    q0, q1 = ctx.q_list[0], ctx.q_list[1]
    rng = np.random.default_rng(2 * logn + delta_bits)
    m0 = rng.integers(0, q0, 256).astype(np.uint32)
    m1 = rng.integers(0, q1, 256).astype(np.uint32)
    sign, hi, lo = rns.crt2_centered_u32(
        torch.from_numpy(m0.astype(np.int64)),
        torch.from_numpy(m1.astype(np.int64)), q0, q1)
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        ctx.params.delta, dtype=torch.float32)
    x = rns.centered_to_df(sign, hi, lo, inv)
    xh, xl = x.hi.numpy().astype(np.float64), x.lo.numpy().astype(np.float64)
    signN, hiN, loN = sign.numpy(), hi.numpy(), lo.numpy()
    budget = STAGE_BUDGETS["div_delta_pair"]
    for i in range(len(m0)):
        exact = Fraction(int(signN[i]) * (int(hiN[i]) << 32 | int(loN[i])),
                         int(ctx.params.delta))
        got = Fraction(float(xh[i])) + Fraction(float(xl[i]))
        if exact == 0:
            assert got == 0
            continue
        rel = abs((got - exact) / exact)
        assert rel <= budget, (
            f"div_delta_pair stage exceeded its {budget} relative budget: "
            f"{float(rel)} at element {i}")


# ---------------------------------------------------------------------------
# hypothesis: the error-free transform identities (core/dfloat.py)
# ---------------------------------------------------------------------------

_SETTINGS = dict(
    deadline=None, max_examples=50, derandomize=True,
    suppress_health_check=[HealthCheck.function_scoped_fixture],
)
finite_f32 = st.floats(allow_nan=False, allow_infinity=False,
                       min_value=-2.0 ** 60, max_value=2.0 ** 60, width=32)
_mag_f32 = st.floats(min_value=2.0 ** -30, max_value=2.0 ** 30, width=32)


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


@settings(**_SETTINGS)
@given(a=finite_f32, b=finite_f32)
def test_two_sum_error_free(a, b):
    """two_sum(a, b) = (s, e): s + e == a + b exactly, s == fl(a + b)."""
    s, e = dfl.two_sum(_f32(a), _f32(b))
    s, e = float(s), float(e)
    assert Fraction(s) + Fraction(e) == Fraction(a) + Fraction(b)
    assert np.float32(s) == np.float32(a) + np.float32(b)


@settings(**_SETTINGS)
@given(am=_mag_f32, bm=_mag_f32, sa=st.booleans(), sb=st.booleans())
def test_two_prod_error_free(am, bm, sa, sb):
    """two_prod(a, b) = (p, e): p + e == a * b exactly (Veltkamp, no FMA)."""
    a = -am if sa else am
    b = -bm if sb else bm
    p, e = dfl.two_prod(_f32(a), _f32(b))
    assert Fraction(float(p)) + Fraction(float(e)) == \
        Fraction(a) * Fraction(b)


def _exact_rne(v: Fraction) -> int:
    f = math.floor(v)
    r = v - f
    if r > Fraction(1, 2):
        return f + 1
    if r < Fraction(1, 2):
        return f
    return f if f % 2 == 0 else f + 1


@settings(**_SETTINGS)
@given(hi=finite_f32, rel=st.floats(min_value=-1.0, max_value=1.0, width=32),
       tie=st.booleans())
def test_df_round_rne_exact(hi, rel, tie):
    """df_round_rne == round-half-even of the exact pair value, exact ties
    (lo = 1/2) included."""
    hi32 = np.float32(hi)
    lo32 = (np.float32(0.5) if tie
            else np.float32(rel * abs(hi) * 2.0 ** -25))
    s, c, b = dfl.df_round_rne(dfl.DF(_f32(hi32), _f32(lo32)))
    got = int(float(s)) + int(float(c)) + int(float(b))
    assert got == _exact_rne(Fraction(float(hi32)) + Fraction(float(lo32)))


@settings(**_SETTINGS)
@given(hi=finite_f32, rel=st.floats(min_value=-1.0, max_value=1.0, width=32))
def test_expansion3_digits_identity(hi, rel):
    hi32 = np.float32(hi)
    lo32 = np.float32(rel * abs(hi) * 2.0 ** -25)
    s, c, b = dfl.df_round_rne(dfl.DF(_f32(hi32), _f32(lo32)))
    d0, d1, d2 = (int(float(x)) for x in dfl.expansion3_digits(s, c, b))
    assert d0 + d1 * 2 ** 22 + d2 * 2 ** 44 == \
        int(float(s)) + int(float(c)) + int(float(b))
    assert all(abs(d) < 2 ** 23 for d in (d0, d1, d2))


# ---------------------------------------------------------------------------
# client level: the df32 pipelines against their f64 twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pipeline", ["staged", "megakernel"])
@pytest.mark.parametrize("logn,delta_bits,n_limbs,batch", [
    (5, 30, 2, 1),
    pytest.param(6, 40, 3, 3, marks=pytest.mark.slow),
    pytest.param(8, 45, 3, 2, marks=pytest.mark.slow),
])
def test_df32_bit_identical_to_f64_grid(pipeline, logn, delta_bits,
                                        n_limbs, batch):
    params = CKKSParams(logn=logn, n_limbs=n_limbs, delta_bits=delta_bits)
    f64 = FHEClient(profile=params, pipeline=pipeline, datapath="f64",
                    device="cpu")
    d32 = FHEClient(profile=params, pipeline=pipeline, datapath="df32",
                    device="cpu")
    msgs = _msgs(f64.ctx, batch, seed=10 * logn + delta_bits)
    f64._nonce = d32._nonce = 50
    bf = f64.encode_encrypt_batch(msgs)
    bd = d32.encode_encrypt_batch(msgs)
    assert torch.equal(bf.c0, bd.c0) and torch.equal(bf.c1, bd.c1)
    gf = f64.decrypt_decode_batch(bf.truncated(2))
    gd = d32.decrypt_decode_batch(bd.truncated(2))
    np.testing.assert_array_equal(gf, gd)
    assert encoder.boot_precision_bits(msgs, gd) >= 19.29


def test_default_client_is_megakernel_df32():
    cl = FHEClient(profile="tiny", device="cpu")
    assert (cl.fourier, cl.pipeline, cl.datapath) == \
        ("device", "megakernel", "df32")
    host = FHEClient(profile="tiny", fourier="host", device="cpu")
    assert (host.pipeline, host.datapath) == ("staged", "f64")
    with pytest.raises(ValueError, match="datapath"):
        FHEClient(profile="tiny", datapath="fp55", device="cpu")
    with pytest.raises(ValueError, match="requires fourier='device'"):
        FHEClient(profile="tiny", fourier="host", datapath="df32",
                  device="cpu")
