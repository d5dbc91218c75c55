"""The Fourier engine's single-prime and four-step NTT entry points of the
port (K12, K13, K14) and the exact arithmetic under them, against the JAX
package, word for word.

  * K12 ``ntt_butterfly.ntt_rows`` / ``intt_rows``: one prime, the
    shift-add REDC of paper eq. 9-11;
  * K13 ``client_pointwise.encrypt_limb`` / ``decrypt_limb``: one limb of a
    batch, the same REDC; equal to K2 / K3 on that limb;
  * K14 ``ntt_matmul.ntt_rows_mm`` / ``intt_rows_mm`` and
    ``ops.ntt_limbs(..., path='matmul')``: the four-step NTT with int8 digit
    products, natural-order output; equal to the butterfly output under the
    bit-reversal permutation;
  * the plan constants, the four-step digit tables, the shift-add REDC, the
    u64 oracles and the exact transforms ``core.ntt.ntt`` / ``intt``.

On the CPU every entry point runs its plain version. The JAX kernels run in
interpret mode ONCE per session, in subprocesses started together at the
module's first test (each interpret-mode call costs seconds, whatever its
size) on inputs made here from numpy seeds; the cheap JAX references
(tables, REDC, exact transforms) run in this process meanwhile, and a test
that needs a kernel's words waits for its group. Tolerance everywhere: 0
words.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import modmul as jmodmul
from repro.core import ntt as jntt
from repro.core.context import get_context as jax_context
from repro.kernels import common as jcommon
from repro.kernels import ntt_matmul as jmm

from repro_torch.core import modmul
from repro_torch.core import ntt as nttmod
from repro_torch.core.context import get_context
from repro_torch.core.primes import find_ntt_friendly_primes
from repro_torch.fhe_client.client import FHEClient
from repro_torch.kernels import (client_pointwise, common, ntt_butterfly,
                                 ntt_matmul, ops, ref)

SRC = str(Path(__file__).resolve().parents[1] / "src")

# the reference's kernel-test primes (tests/test_kernels.py)
PRIMES = find_ntt_friendly_primes(p_bw=30, n_plus_1=17, count=6)
K12_N = (256, 1024)
K14_N = (512, 1024)            # N = 64 comes from the ops case (tiny)
ENC_SEED = 0xC0FFEE_0123456789ABCDEF
ENC_NONCE0 = 0xFFFFFFFF        # row 1 wraps to nonce 0
ENC_BATCH = 2

# one subprocess per group, all started together; each writes <group>.npz
_JAX = r'''
import sys
import numpy as np
import jax.numpy as jnp
from repro.core import ntt as jntt
from repro.core.context import get_context
from repro.core.primes import find_ntt_friendly_primes
from repro.kernels import client_pointwise, ntt_butterfly, ntt_matmul, ops

group, inputs, out_dir = sys.argv[1], np.load(sys.argv[2]), sys.argv[3]
primes = find_ntt_friendly_primes(p_bw=30, n_plus_1=17, count=6)
res = {}
if group == "k12":
    for n in (256, 1024):
        plan = jntt.make_plan(primes[0], n)
        y = ntt_butterfly.ntt_rows(jnp.asarray(inputs[f"k12_{n}"]), plan)
        res[f"ntt_{n}"] = np.asarray(y)
        res[f"intt_{n}"] = np.asarray(ntt_butterfly.intt_rows(y, plan))
elif group == "k14":
    for n in (512, 1024):
        plan = jntt.make_plan(primes[0], n)
        y = ntt_matmul.ntt_rows_mm(jnp.asarray(inputs[f"k14_{n}"]), plan)
        res[f"ntt_{n}"] = np.asarray(y)
        res[f"intt_{n}"] = np.asarray(ntt_matmul.intt_rows_mm(y, plan))
elif group == "ops":
    ctx = get_context("tiny")
    y = ops.ntt_limbs(jnp.asarray(inputs["ops_x"]), ctx, path="matmul")
    res["ntt"] = np.asarray(y)
    res["intt"] = np.asarray(ops.intt_limbs(y, ctx, path="matmul"))
else:                                   # "enc" / "dec": K13 at tiny
    ctx = get_context("tiny")
    seed, nonce0 = int(inputs["seed"]), int(inputs["nonce0"])
    for limb in range(ctx.params.n_limbs):
        if group == "enc":
            c0, c1 = client_pointwise.encrypt_limb(
                jnp.asarray(inputs["pt"][:, limb]),
                jnp.asarray(inputs["b"][limb]), jnp.asarray(inputs["a"][limb]),
                ctx, limb, seed, nonce0)
            res[f"c0_{limb}"], res[f"c1_{limb}"] = map(np.asarray, (c0, c1))
        else:
            res[f"m_{limb}"] = np.asarray(client_pointwise.decrypt_limb(
                jnp.asarray(inputs["c0"][:, limb]),
                jnp.asarray(inputs["c1"][:, limb]),
                jnp.asarray(inputs["s"][limb]), ctx, limb))
np.savez(f"{out_dir}/{group}.npz", **res)
'''
GROUPS = ("enc", "dec", "k12", "k14", "ops")


def _residues(rng, q_rows, shape) -> np.ndarray:
    """uint32 residues of `shape`, axis -2 below q_rows (per row)."""
    q = np.asarray(q_rows, np.uint64)[:, None]
    return (rng.integers(0, 1 << 32, shape, dtype=np.uint64) % q
            ).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _inputs() -> dict:
    rng = np.random.default_rng(14)
    q = PRIMES[0].q
    out = {}
    for n in K12_N:                     # rows 0 | 1: random, 2: 0, 3: q-1
        r = rng.integers(0, q, (2, n), dtype=np.uint32)
        out[f"k12_{n}"] = np.concatenate(
            [r, np.zeros((1, n), np.uint32), np.full((1, n), q - 1,
                                                     np.uint32)])
    for n in K14_N:
        out[f"k14_{n}"] = rng.integers(0, q, (2, n), dtype=np.uint32)
    tiny = get_context("tiny")
    qs = tiny.q_list
    out["ops_x"] = _residues(rng, qs, (2, len(qs), tiny.n)).transpose(
        1, 0, 2).copy()                 # (3, 2, 64)
    client = FHEClient("tiny", device="cpu")
    out["pt"] = _residues(rng, qs, (ENC_BATCH, len(qs), tiny.n))
    out["b"], out["a"], out["s"] = (
        _u(k) for k in (client.keys.pk.b_mont, client.keys.pk.a_mont,
                        client.keys.sk.s_mont))
    out["c0"] = _residues(rng, qs, (ENC_BATCH, len(qs), tiny.n))
    out["c1"] = _residues(rng, qs, (ENC_BATCH, len(qs), tiny.n))
    return out


class _JaxRuns:
    """The running JAX subprocesses; ``[group]`` waits for one and loads
    its outputs."""

    def __init__(self, out: Path, procs: dict):
        self.out, self.procs, self.res = out, procs, {}

    def __getitem__(self, group: str) -> dict:
        if group not in self.res:
            log = self.procs[group].communicate(timeout=600)[0]
            assert self.procs[group].returncode == 0, \
                f"{group}:\n{log[-3000:]}"
            self.res[group] = dict(np.load(self.out / f"{group}.npz"))
        return self.res[group]


@pytest.fixture(scope="session")
def jax_ref(tmp_path_factory):
    """(inputs, _JaxRuns) of the interpret-mode JAX kernels."""
    out = tmp_path_factory.mktemp("jax_ntt_engines")
    inputs = _inputs()
    np.savez(out / "inputs.npz", **inputs, seed=np.array(str(ENC_SEED)),
             nonce0=np.array(ENC_NONCE0))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    procs = {g: subprocess.Popen(
        [sys.executable, "-c", _JAX, g, str(out / "inputs.npz"), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for g in GROUPS}
    yield inputs, _JaxRuns(out, procs)
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _start_jax_ref(jax_ref):
    """Start the JAX subprocesses at the module's first test, so they run
    beside the in-process checks."""


# ---------------------------------------------------------------------------
# host constants: plan constants, four-step tables (no kernel)
# ---------------------------------------------------------------------------

_CONST_CASES = [("tiny", 0), ("tiny", 2), ("test", 0), ("test", 5),
                ("paper", 0)]


@pytest.mark.parametrize("profile,limb", _CONST_CASES)
def test_plan_consts_match_jax(profile, limb):
    got = common.plan_consts(get_context(profile).plans[limb])
    want = jcommon.plan_consts(jax_context(profile).plans[limb])
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (got.psi, got.psi_inv, got.r_mod_q) == (want.psi, want.psi_inv,
                                                   want.r_mod_q)


@pytest.mark.parametrize("profile,limb", _CONST_CASES)
def test_fourstep_tables_match_jax(profile, limb):
    got = ntt_matmul.tables(get_context(profile).plans[limb])
    want = jmm.tables(jax_context(profile).plans[limb])
    for name in ("f2d", "f1d", "f2id", "f1id"):
        assert getattr(got, name).dtype == want[name].dtype
        np.testing.assert_array_equal(getattr(got, name), want[name])
    assert (got.w, got.w_inv, got.n1, got.n2) == (
        want["w"], want["w_inv"], want["n1"], want["n2"])


@pytest.mark.parametrize("n", [16, 64, 512, 32768, 65536])
def test_split_n_matches_jax(n):
    assert ntt_matmul.split_n(n) == jmm.split_n(n)


def test_balanced_digits_roundtrip():
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.integers(0, PRIMES[0].q, 64, dtype=np.uint32),
                        np.array([0, 1, 127, 128, 255, PRIMES[0].q - 1],
                                 np.uint32)])
    digs = common.balanced_digits(torch.tensor(v.astype(np.int64)))
    acc = sum(d * (1 << (8 * i)) for i, d in enumerate(digs))
    np.testing.assert_array_equal(acc.numpy(), v.astype(np.int64))
    want = jcommon.balanced_digits_jnp(jnp.asarray(v))
    got_np = common.balanced_digits_np(v)
    for i in range(common.N_DIGITS):
        np.testing.assert_array_equal(digs[i].numpy(), np.asarray(want[i]))
        np.testing.assert_array_equal(got_np[i], np.asarray(want[i]))
        assert digs[i].min() >= -128 and digs[i].max() < 128


# ---------------------------------------------------------------------------
# exact arithmetic: shift-add REDC, u64 oracles, exact transforms
# ---------------------------------------------------------------------------


def _redc_operands(q: int, seed: int):
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, q - 1], np.uint32)
    a = np.concatenate([rng.integers(0, 1 << 32, 512, dtype=np.uint64
                                     ).astype(np.uint32),
                        rng.integers(0, q, 512, dtype=np.uint32),
                        np.repeat(edges, 3)])
    b = np.concatenate([rng.integers(0, q, 1024, dtype=np.uint32),
                        np.tile(edges, 3)])
    return a, b


@pytest.mark.parametrize("limb", range(24))
def test_sa_redc_matches_jax(limb):
    """mulmod_montgomery_sa_limb on random words (any uint32 a, residue b)
    and the edge values 0, 1, q-1, for every `paper` prime; on residues it
    also equals the vanilla limb REDC and the u64 oracle."""
    c = get_context("paper").plans[limb].mont
    jc = jax_context("paper").plans[limb].mont
    a, b = _redc_operands(c.q, limb)
    ta, tb = torch.tensor(a.astype(np.int64)), torch.tensor(b.astype(np.int64))
    got = modmul.mulmod_montgomery_sa_limb(ta, tb, c)
    want = jmodmul.mulmod_montgomery_sa_limb(jnp.asarray(a), jnp.asarray(b),
                                             jc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))
    res = a < c.q
    np.testing.assert_array_equal(
        got[res].numpy(),
        modmul.mulmod_montgomery_limb(ta, tb, c)[res].numpy())
    np.testing.assert_array_equal(
        got[res].numpy(),
        modmul.mulmod_montgomery_u64(ta[res], tb[res], c).numpy())


@pytest.mark.parametrize("limb", [0, 7, 23])
def test_u64_oracles_match_jax(limb):
    c = get_context("paper").plans[limb].mont
    jc = jax_context("paper").plans[limb].mont
    rng = np.random.default_rng(100 + limb)
    a = np.concatenate([rng.integers(0, c.q, 256, dtype=np.uint64),
                        np.array([0, 1, c.q - 1], np.uint64)])
    b = a[::-1].copy()
    ta, tb = torch.tensor(a.astype(np.int64)), torch.tensor(b.astype(np.int64))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pairs = [
        (modmul.mulmod_naive_u64(ta, tb, c.q),
         jmodmul.mulmod_naive_u64(ja, jb, jc.q)),
        (modmul.mulmod_montgomery_u64(ta, tb, c),
         jmodmul.mulmod_montgomery_u64(ja, jb, jc)),
        (modmul.to_mont_u64(ta, c), jmodmul.to_mont_u64(ja, jc)),
        (modmul.from_mont_u64(ta, c), jmodmul.from_mont_u64(ja, jc)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


@pytest.mark.parametrize("n", [64, 256])
def test_exact_transforms_match_jax(n):
    plan = nttmod.make_plan(PRIMES[1], n)
    jplan = jntt.make_plan(PRIMES[1], n)
    rng = np.random.default_rng(n)
    x = rng.integers(0, plan.prime.q, (3, n), dtype=np.uint64)
    y = nttmod.ntt(torch.tensor(x.astype(np.int64)), plan)
    jy = jax.jit(lambda a: jntt.ntt(a, jplan))(jnp.asarray(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy, np.int64))
    back = nttmod.intt(y, plan)
    jback = jax.jit(lambda a: jntt.intt(a, jplan))(jy)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback, np.int64))
    np.testing.assert_array_equal(back.numpy(), x.astype(np.int64))
    np.testing.assert_array_equal(plan.psi_inv_brv_mont,
                                  jplan.psi_inv_brv_mont)


# ---------------------------------------------------------------------------
# K12: single-prime butterfly NTT / INTT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("n", K12_N)
def test_ntt_rows_matches_jax(jax_ref, n, rows):
    """rows=1: a random row; rows=3: a random row and the edge fills 0 and
    q-1 (the JAX call holds all four rows; rows are independent)."""
    inputs, res = jax_ref
    plan = nttmod.make_plan(PRIMES[0], n)
    sl = slice(0, 1) if rows == 1 else slice(1, 4)
    x = _t(inputs[f"k12_{n}"][sl])
    y = ntt_butterfly.ntt_rows(x, plan)
    np.testing.assert_array_equal(_u(y), res["k12"][f"ntt_{n}"][sl])
    np.testing.assert_array_equal(_u(y), _u(ref.ntt_rows(x, plan)))
    back = ntt_butterfly.intt_rows(y, plan)
    np.testing.assert_array_equal(_u(back), res["k12"][f"intt_{n}"][sl])
    assert torch.equal(back, x)


# ---------------------------------------------------------------------------
# K14: four-step NTT / INTT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [64] + list(K14_N),
                         ids=["n64-8x8", "n512-32x16", "n1024-32x32"])
def test_ntt_rows_mm_matches_jax(jax_ref, n):
    inputs, res = jax_ref
    if n == 64:                 # limb 0 of the tiny ops stack: (2, 64)
        plan = get_context("tiny").plans[0]
        x = inputs["ops_x"][0]
        want, want_back = res["ops"]["ntt"][0], res["ops"]["intt"][0]
    else:
        plan = nttmod.make_plan(PRIMES[0], n)
        x = inputs[f"k14_{n}"]
        want, want_back = res["k14"][f"ntt_{n}"], res["k14"][f"intt_{n}"]
    y = ntt_matmul.ntt_rows_mm(_t(x), plan)
    np.testing.assert_array_equal(_u(y), want)
    back = ntt_matmul.intt_rows_mm(y, plan)
    np.testing.assert_array_equal(_u(back), want_back)
    np.testing.assert_array_equal(_u(back), x)


@pytest.mark.parametrize("n", [16, 256, 512, 2048])
def test_fourstep_is_bitreversed_butterfly(n):
    """Natural-order four-step output == the butterfly NTT (K12's plain
    version) re-permuted by bit reversal; odd log N gives N1 != N2."""
    plan = nttmod.make_plan(PRIMES[2], n)
    x = _t(np.random.default_rng(n * 7).integers(0, plan.prime.q, (2, n),
                                                 dtype=np.uint32))
    brv = torch.tensor(nttmod.bitrev_indices(n))
    y = ntt_matmul.ntt_rows_mm(x, plan)
    assert torch.equal(y, ntt_butterfly.ntt_rows(x, plan)[:, brv])
    assert torch.equal(ntt_matmul.intt_rows_mm(y, plan), x)


def test_fourstep_polymul_schoolbook():
    """fwd -> pointwise -> inv == negacyclic schoolbook product (independent
    of the evaluation order)."""
    n = 256
    plan = nttmod.make_plan(PRIMES[1], n)
    q, c = plan.prime.q, plan.mont
    rng = np.random.default_rng(n)
    a = rng.integers(0, q, (1, n), dtype=np.uint32)
    b = rng.integers(0, q, (1, n), dtype=np.uint32)
    ah = modmul.u32_to_i64(ntt_matmul.ntt_rows_mm(_t(a), plan))
    bh = modmul.u32_to_i64(ntt_matmul.ntt_rows_mm(_t(b), plan))
    prod = modmul.mulmod_montgomery_u64(
        ah, modmul.mulmod_montgomery_u64(bh, c.r2, c), c)
    got = ntt_matmul.intt_rows_mm(modmul.i64_to_u32(prod), plan)
    want = nttmod.negacyclic_polymul_schoolbook(
        a[0].astype(np.uint64), b[0].astype(np.uint64), q)
    np.testing.assert_array_equal(_u(got)[0].astype(np.uint64), want)


@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
def test_ops_ntt_limbs_matmul_matches_jax(jax_ref, inverse):
    """ops.ntt_limbs / intt_limbs(path='matmul') on a tiny (3, 2, 64) stack;
    the forward output is the butterfly path's under bit reversal."""
    inputs, res = jax_ref
    ctx = get_context("tiny")
    x = _t(inputs["ops_x"])
    if not inverse:
        y = ops.ntt_limbs(x, ctx, path="matmul")
        np.testing.assert_array_equal(_u(y), res["ops"]["ntt"])
        brv = torch.tensor(nttmod.bitrev_indices(ctx.n))
        assert torch.equal(y, ops.ntt_limbs(x, ctx)[..., brv])
    else:
        back = ops.intt_limbs(_t(res["ops"]["ntt"]), ctx, path="matmul")
        np.testing.assert_array_equal(_u(back), res["ops"]["intt"])
        assert torch.equal(back, x)


# ---------------------------------------------------------------------------
# K13: per-limb encrypt / decrypt
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("limb", range(3))
def test_encrypt_limb_matches_jax(jax_ref, limb):
    inputs, res = jax_ref
    ctx = get_context("tiny")
    c0, c1 = client_pointwise.encrypt_limb(
        _t(inputs["pt"][:, limb]), _t(inputs["b"][limb]),
        _t(inputs["a"][limb]), ctx, limb, ENC_SEED, ENC_NONCE0)
    np.testing.assert_array_equal(_u(c0), res["enc"][f"c0_{limb}"])
    np.testing.assert_array_equal(_u(c1), res["enc"][f"c1_{limb}"])


@pytest.mark.parametrize("limb", range(3))
def test_decrypt_limb_matches_jax(jax_ref, limb):
    inputs, res = jax_ref
    ctx = get_context("tiny")
    m = client_pointwise.decrypt_limb(
        _t(inputs["c0"][:, limb]), _t(inputs["c1"][:, limb]),
        _t(inputs["s"][limb]), ctx, limb)
    np.testing.assert_array_equal(_u(m), res["dec"][f"m_{limb}"])


def test_limb_forms_equal_folded_kernels():
    """At `test` B=2, K13 on each limb gives K2's c0/c1 and K3's residues
    (plain versions; no JAX call): the same words under another REDC."""
    client = FHEClient("test", seed=ENC_SEED, device="cpu")
    ctx = client.ctx
    rng = np.random.default_rng(13)
    pt = _t(_residues(rng, ctx.q_list, (2, ctx.params.n_limbs, ctx.n)))
    pkb, pka = client.keys.pk.b_mont, client.keys.pk.a_mont
    s = client.keys.sk.s_mont
    c0, c1 = client_pointwise.encrypt_limbs_plain(pt, pkb, pka, ctx,
                                                  client.seed, 41)
    m = client_pointwise.decrypt_limbs_plain(c0, c1, s, ctx)
    for limb in range(ctx.params.n_limbs):
        l0, l1 = client_pointwise.encrypt_limb(
            pt[:, limb].contiguous(), pkb[limb], pka[limb], ctx, limb,
            client.seed, 41)
        assert torch.equal(l0, c0[:, limb]) and torch.equal(l1, c1[:, limb])
        ml = client_pointwise.decrypt_limb(c0[:, limb], c1[:, limb],
                                           s[limb], ctx, limb)
        assert torch.equal(ml, m[:, limb])
