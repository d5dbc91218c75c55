"""The server op checks of the reference's ``tests/test_server_ops.py``
that no other port test holds, on the port's plain path at ``tiny`` on
the CPU, with the reference's ``NOISE_BUDGET``, seeds and rotations:

  * homomorphisms: add_ct, add_pt, mul_pt (+ rescale), mul_ct, rotate by
    1, 2 and 5, each within its budget, with the exact level and scale
    bookkeeping; the df32 and f64 evaluators bit-identical
    (``test_server_ops.py:126-301``); level alignment of add_ct; mul_pt
    with the multiplicand at the dropped prime gives exactly Delta; a raw
    mul_pt then rescale == the fused op, bit for bit; square-then-add
    within twice the mul_ct budget; rotate(rotate(x, 1), 1) within twice
    the rotate budget; hoisted == fused rotations;
  * the reference's guards (``:232``, ``:241``): rescale at level 2,
    ``drop_to(1)`` and a plaintext of another scale raise
    ``AssertionError``; a rotation without its key raises ``KeyError``
    (``:272``);
  * hypothesis (10 examples each, the reference's settings): mul_ct and
    rotate within budget for random messages (``:313-341``);
  * the /Delta pair collapse pins (``:469``, ``:502``): the adversarial
    double-rounding pattern and the dense differential over the shipped
    prime pairs; these are deterministic words, so the port's pairs are
    also held equal to the reference's (its ``rns.centered_to_df`` /
    ``crt2_centered_u32``, called in-process: host code, no kernel);
  * the evaluation keys are evaluation material only: uint32 words
    (int32 tensors holding them), < 1 % of them below 1024 (``:586``);
  * ``slow``, as in the reference: the ``server`` preset (N=2^10, 8 limbs)
    at level 4: add_ct < 2^-15, mul_ct < 2^-13, rotate(1) < 2^-14
    (``:669``).

Except for the pair-collapse words, each bound is a property of the port
alone, so no JAX subprocess runs.

Left out: the ``pallas_call`` launch pins (``:349``, ``:390``) and the
jaxpr x64 scan (``:412``) have no PyTorch counterpart (the port's
launches are the ``LAUNCHES`` counter of ``kernels/server_eval.py:52``,
read on the card by ``chip_smoke.py``); the Galois permutation pin, the
evaluation-key wire round trip and the ``tinyboot`` flow (``:95``,
``:569``, ``:604``, ``:644``) are held against the JAX package in
``test_torch_server.py`` and ``test_torch_wire.py``; the ``slow``
``test_boot_preset_drop_to_eval`` (``:691``) is a known failure of the
reference at N=2^16, and ``chip_smoke.py``'s ``boot`` flow runs its path
on the card.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch.core import get_context, rns
from repro_torch.fhe_client.client import FHEClient
from repro_torch.fhe_server import (ServerCiphertext, ServerEvaluator,
                                    combined_scale, encode_plaintext)

SRV_ROTATIONS = (1, 2, 5)

NOISE_BUDGET = {
    "add_ct": 2.0 ** -27,
    "add_pt": 2.0 ** -27,
    "mul_pt": 2.0 ** -25,
    "mul_ct": 2.0 ** -26,
    "rescale": 2.0 ** -25,
    "rotate": 2.0 ** -27,
    "e2e_linear_poly3": 2.0 ** -12,
}


@pytest.fixture(scope="module")
def client():
    """The staged f64 client (the reference's ``tiny_device_client``)."""
    return FHEClient("tiny", pipeline="staged", datapath="f64", device="cpu")


@pytest.fixture(scope="module")
def eval_keys(client):
    return client.make_evaluation_keys(rotations=SRV_ROTATIONS)


@pytest.fixture(scope="module")
def ev(client, eval_keys):
    return ServerEvaluator(client.ctx, eval_keys, datapath="df32")


@pytest.fixture(scope="module")
def ev_f64(client, eval_keys):
    return ServerEvaluator(client.ctx, eval_keys, datapath="f64")


def _enc(client, z) -> ServerCiphertext:
    z = np.asarray(z, np.complex128)
    if z.ndim == 1:
        z = z[None]
    return ServerCiphertext.from_batch(client.encode_encrypt_batch(z))


def _dec(client, ct: ServerCiphertext) -> np.ndarray:
    return np.asarray(client.decrypt_batch(list(ct.to_batch())))


def _slots(ctx, seed, scale=0.5):
    return np.random.default_rng(seed).standard_normal(
        ctx.params.n_slots) * scale


def _bit_eq(a: ServerCiphertext, b: ServerCiphertext) -> bool:
    return torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)


def _q_drop(ctx, level: int) -> float:
    return float(ctx.q_list[level - 1])


def _pt(z, ctx, level, scale):
    return encode_plaintext(np.asarray(z).astype(np.complex128), ctx, level,
                            scale, device="cpu")


def test_add_ct_homomorphism(client, ev, ev_f64):
    za, zb = _slots(client.ctx, 1), _slots(client.ctx, 2)
    x, y = _enc(client, za), _enc(client, zb)
    s = ev.add_ct(x, y)
    assert s.level == x.level and s.scale == x.scale
    err = np.max(np.abs(_dec(client, s)[0] - (za + zb)))
    assert err < NOISE_BUDGET["add_ct"], err
    assert _bit_eq(s, ev_f64.add_ct(x, y))


def test_add_pt_homomorphism(client, ev):
    ctx = client.ctx
    za, w = _slots(ctx, 3), _slots(ctx, 4)
    x = _enc(client, za)
    s = ev.add_pt(x, _pt(w, ctx, x.level, x.scale))
    assert s.level == x.level and s.scale == x.scale
    err = np.max(np.abs(_dec(client, s)[0] - (za + w)))
    assert err < NOISE_BUDGET["add_pt"], err
    assert torch.equal(s.c1, x.c1)


def test_add_ct_level_alignment(client, ev):
    za, zb = _slots(client.ctx, 5), _slots(client.ctx, 6)
    x, y = _enc(client, za), _enc(client, zb)
    s = ev.add_ct(x, y.drop_to(x.level - 1))
    assert s.level == x.level - 1
    err = np.max(np.abs(_dec(client, s)[0] - (za + zb)))
    assert err < NOISE_BUDGET["add_ct"], err


def test_mul_pt_rescale_exact_scale(client, ev, ev_f64):
    ctx = client.ctx
    za, w = _slots(ctx, 7), _slots(ctx, 8)
    x = _enc(client, za)
    pt = _pt(w, ctx, x.level, _q_drop(ctx, x.level))
    m = ev.mul_pt(x, pt)
    assert m.level == x.level - 1
    assert m.scale == float(ctx.params.delta)
    err = np.max(np.abs(_dec(client, m)[0] - w * za))
    assert err < NOISE_BUDGET["mul_pt"], err
    assert _bit_eq(m, ev_f64.mul_pt(x, pt))


def test_mul_pt_raw_then_rescale_matches_fused(client, ev):
    ctx = client.ctx
    za, w = _slots(ctx, 9), _slots(ctx, 10)
    x = _enc(client, za)
    pt = _pt(w, ctx, x.level, _q_drop(ctx, x.level))
    raw = ev.mul_pt(x, pt, rescale=False)
    assert raw.level == x.level
    assert raw.scale == combined_scale(x.scale, pt.scale)
    fused = ev.mul_pt(x, pt)
    stepped = ev.rescale(raw)
    assert _bit_eq(fused, stepped)
    assert fused.scale == stepped.scale and fused.level == stepped.level


def test_mul_ct_relin_homomorphism(client, ev, ev_f64):
    ctx = client.ctx
    za, zb = _slots(ctx, 11), _slots(ctx, 12)
    x, y = _enc(client, za), _enc(client, zb)
    m = ev.mul_ct(x, y)
    assert m.level == x.level - 1
    assert m.scale == combined_scale(x.scale, y.scale,
                                     divisor=int(ctx.q_list[x.level - 1]))
    err = np.max(np.abs(_dec(client, m)[0] - za * zb))
    assert err < NOISE_BUDGET["mul_ct"], err
    assert _bit_eq(m, ev_f64.mul_ct(x, y))


def test_mul_ct_square_then_add(client, ev):
    za, zb = _slots(client.ctx, 13), _slots(client.ctx, 14)
    x, y = _enc(client, za), _enc(client, zb)
    s = ev.add_ct(ev.mul_ct(x, x), ev.mul_ct(x, y))
    err = np.max(np.abs(_dec(client, s)[0] - (za * za + za * zb)))
    assert err < NOISE_BUDGET["mul_ct"] * 2, err


def test_rescale_floor_asserts(client, ev):
    x = _enc(client, _slots(client.ctx, 15))
    with pytest.raises(AssertionError):
        ev.rescale(x.drop_to(2))
    with pytest.raises(AssertionError):
        x.drop_to(1)


def test_scale_mismatch_asserts(client, ev):
    ctx = client.ctx
    x = _enc(client, _slots(ctx, 16))
    pt = _pt(np.zeros(ctx.params.n_slots), ctx, x.level, x.scale * 2)
    with pytest.raises(AssertionError):
        ev.add_pt(x, pt)


def test_rotate_homomorphism(client, ev, ev_f64):
    za = _slots(client.ctx, 17)
    x = _enc(client, za)
    for r in SRV_ROTATIONS:
        rot = ev.rotate(x, r)
        assert rot.level == x.level and rot.scale == x.scale
        err = np.max(np.abs(_dec(client, rot)[0] - np.roll(za, -r)))
        assert err < NOISE_BUDGET["rotate"], (r, err)
        assert _bit_eq(rot, ev_f64.rotate(x, r))
    assert ev.rotate(x, 0) is x
    assert ev.rotate(x, client.ctx.params.n_slots) is x


def test_rotate_missing_key_raises(client, ev):
    x = _enc(client, _slots(client.ctx, 18))
    with pytest.raises(KeyError):
        ev.rotate(x, 3)


def test_hoisted_rotations_bit_identical(client, ev):
    za = _slots(client.ctx, 19)
    x = _enc(client, za)
    ns = client.ctx.params.n_slots
    out = ev.hoisted_rotations(x, list(SRV_ROTATIONS) + [0, ns + 1])
    for r in SRV_ROTATIONS:
        assert _bit_eq(out[r], ev.rotate(x, r)), f"r={r}"
    assert out[0] is x
    assert _bit_eq(out[ns + 1], out[1])


def test_rotate_composes(client, ev):
    za = _slots(client.ctx, 20)
    x = _enc(client, za)
    twice = ev.rotate(ev.rotate(x, 1), 1)
    err = np.max(np.abs(_dec(client, twice)[0] - np.roll(za, -2)))
    assert err < 2 * NOISE_BUDGET["rotate"], err


_sets = settings(max_examples=10, deadline=None,
                 suppress_health_check=[HealthCheck.too_slow,
                                        HealthCheck.function_scoped_fixture])
_seed = st.integers(min_value=0, max_value=2 ** 31 - 1)


@_sets
@given(seed=_seed)
def test_prop_add_mul_homomorphism(client, ev, seed):
    rng = np.random.default_rng(seed)
    ns = client.ctx.params.n_slots
    za, zb = rng.uniform(-1, 1, ns), rng.uniform(-1, 1, ns)
    got = _dec(client, ev.mul_ct(_enc(client, za), _enc(client, zb)))[0]
    assert np.max(np.abs(got - za * zb)) < NOISE_BUDGET["mul_ct"]


@_sets
@given(seed=_seed, r=st.integers(min_value=0, max_value=63))
def test_prop_rotate_homomorphism(client, ev, seed, r):
    ns = client.ctx.params.n_slots
    rn = r % ns
    if rn not in (0,) + SRV_ROTATIONS:
        rn = SRV_ROTATIONS[rn % len(SRV_ROTATIONS)]
    za = np.random.default_rng(seed).uniform(-1, 1, ns)
    got = _dec(client, ev.rotate(_enc(client, za), rn))[0]
    assert np.max(np.abs(got - np.roll(za, -rn))) < NOISE_BUDGET["rotate"]


# ---------------------------------------------------------------------------
# decode /Delta pair collapse: the double-rounding pins
# ---------------------------------------------------------------------------


def _words(v: int):
    return (torch.tensor([v >> 32], dtype=torch.int64),
            torch.tensor([v & 0xFFFFFFFF], dtype=torch.int64))


def test_decode_pair_collapse_double_rounding_divergence():
    """A centered value whose tail straddles the fl64 RNE boundary: the
    f64-oracle path (RNE53, then the f32 split) rounds up, the direct df32
    collapse rounds down; both within 2^-48 relative, one bit apart at
    k-48. The port's pair == the reference's."""
    import jax.numpy as jnp
    from repro.core import rns as ref_rns
    for k in range(53, 60):
        v = (1 << k) + (1 << (k - 25)) + (1 << (k - 48)) \
            + (1 << (k - 49)) - (1 << (k - 53))
        hi_w, lo_w = _words(v)
        d = rns.centered_to_df(torch.ones(1, dtype=torch.float32), hi_w,
                               lo_w, np.float32(1.0))
        df32_val = Fraction(float(d.hi[0])) + Fraction(float(d.lo[0]))
        oh = np.float32(float(v))
        ol = np.float32(float(v) - float(oh))
        f64_val = Fraction(float(oh)) + Fraction(float(ol))
        exact = Fraction(v)
        budget = Fraction(2) ** (k - 48)
        assert abs(df32_val - exact) <= budget, k
        assert abs(f64_val - exact) <= budget, k
        assert f64_val - df32_val == Fraction(2) ** (k - 48), k
        r = ref_rns.centered_to_df(
            jnp.asarray([np.float32(1.0)]), jnp.asarray([np.uint32(v >> 32)]),
            jnp.asarray([np.uint32(v & 0xFFFFFFFF)]), np.float32(1.0))
        assert (float(d.hi[0]), float(d.lo[0])) == (float(r.hi[0]),
                                                    float(r.lo[0])), k


def test_decode_pair_collapse_shipped_grids_bounded():
    """Dense differential over the shipped decrypt prime pairs (2^14 pairs
    each at tiny / test / server): hi planes == the f64-oracle path's,
    the path gap < 2^-43 of the magnitude, the worst samples within
    2^-44 of the exact value; the port's planes == the reference's."""
    import jax.numpy as jnp
    from repro.core import rns as ref_rns
    rng = np.random.default_rng(23)
    for profile in ("tiny", "test", "server"):
        ctx = get_context(profile)
        q0, q1 = int(ctx.q_list[0]), int(ctx.q_list[1])
        db = ctx.params.delta_bits
        inv = np.float32(2.0 ** -db)
        m = 1 << 14
        c0 = rng.integers(0, q0, size=m, dtype=np.uint64)
        c1 = rng.integers(0, q1, size=m, dtype=np.uint64)
        s, hi, lo = rns.crt2_centered_u32(
            torch.from_numpy(c0.astype(np.int64)),
            torch.from_numpy(c1.astype(np.int64)), q0, q1)
        d = rns.centered_to_df(s, hi, lo, inv)
        dhi, dlo = d.hi.numpy(), d.lo.numpy()
        rs, rh, rl = ref_rns.crt2_centered_u32(
            jnp.asarray(c0.astype(np.uint32)),
            jnp.asarray(c1.astype(np.uint32)), q0, q1)
        r = ref_rns.centered_to_df(rs, rh, rl, inv)
        assert np.array_equal(dhi.view(np.uint32),
                              np.asarray(r.hi).view(np.uint32)), profile
        assert np.array_equal(dlo.view(np.uint32),
                              np.asarray(r.lo).view(np.uint32)), profile
        Q = q0 * q1
        g0 = pow(Q // q0, -1, q0)
        g1 = pow(Q // q1, -1, q1)
        v = (c0.astype(object) * g0 % q0 * (Q // q0)
             + c1.astype(object) * g1 % q1 * (Q // q1)) % Q
        v = np.where(v > Q // 2, v - Q, v)
        fl = np.array([float(x) for x in v]) * float(inv)
        ohi = fl.astype(np.float32)
        olo = (fl - ohi.astype(np.float64)).astype(np.float32)
        assert np.array_equal(dhi, ohi), profile
        diff = np.abs((dhi.astype(np.float64) + dlo.astype(np.float64))
                      - (ohi.astype(np.float64) + olo.astype(np.float64)))
        mag = np.abs(fl) + 2.0 ** -db
        assert float(np.max(diff / mag)) < 2.0 ** -43, profile
        iv = Fraction(1, 1 << db)
        for i in np.argsort(-diff / mag)[:16]:
            ex = Fraction(int(v[i])) * iv
            err = abs(Fraction(float(dhi[i])) + Fraction(float(dlo[i])) - ex)
            sc = Fraction(2) ** (int(v[i]).bit_length() - db)
            assert err / sc < Fraction(2) ** -44, (profile, int(i))


def test_eval_keys_are_evaluation_material_only(eval_keys):
    """The broadcast holds only (b, a) RLWE pairs: uniform-looking uint32
    NTT residues, never small or ternary data."""
    for ksk in [eval_keys.relin] + list(eval_keys.rot.values()):
        for plane in (ksk.b_mont, ksk.a_mont):
            assert plane.dtype == torch.int32       # uint32 words
            arr = plane.numpy().view(np.uint32)
            assert np.mean(arr < 1024) < 0.01


@pytest.mark.slow
def test_server_preset_ops_sweep():
    """The ``server`` preset (N=2^10, 8 limbs) at level 4: the tiny
    budgets hold at a real ring degree too."""
    client = FHEClient("server", pipeline="staged", datapath="f64",
                       device="cpu")
    ctx = client.ctx
    rng = np.random.default_rng(41)
    za = rng.uniform(-1, 1, ctx.params.n_slots)
    zb = rng.uniform(-1, 1, ctx.params.n_slots)
    ev = ServerEvaluator(ctx, client.make_evaluation_keys(rotations=(1,)))
    x, y = _enc(client, za).drop_to(4), _enc(client, zb).drop_to(4)
    assert np.max(np.abs(_dec(client, ev.add_ct(x, y))[0] - (za + zb))) \
        < 2.0 ** -15
    assert np.max(np.abs(_dec(client, ev.mul_ct(x, y))[0] - za * zb)) \
        < 2.0 ** -13
    assert np.max(np.abs(_dec(client, ev.rotate(x, 1))[0]
                         - np.roll(za, -1))) < 2.0 ** -14
