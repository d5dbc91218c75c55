"""The f64 datapath of the port, client and server, against the JAX
package, word for word and bit for bit.

  * ``FHEClient(p, datapath='f64')``: the megakernels' f64 branches (K5:
    df64 Delta-scale round and fmod RNS; K6: u64 CRT and a float64 /scale
    of any value), against the JAX ``FHEClient(p, datapath='f64')``: c0,
    c1 and the decoded float64 (re, im) parts, at the profile's Delta and
    at per-row scales that are not powers of two; and against the port's
    df32 megakernel (the same ciphertext words);
  * ``FHEClient(p, fourier='host')``: the complex128 oracle client (host
    SpecialFFTs around the K2 / K3 plain versions): c0, c1 and the decoded
    complex slots, one shared scale and a scale per row;
  * the per-ciphertext entry points ``encoder.encode`` (host and device
    Fourier) / ``encode_batch`` / ``decode``, ``encryptor.encrypt``,
    ``encrypt_symmetric_seeded``, ``expand_seeded`` and ``decrypt``;
  * ``rns.to_rns_limb_t`` / ``to_rns_exact`` / ``crt_exact`` and the u64
    REDC ``modmul.mulmod_montgomery_u64_t`` on every ``tinyboot`` and
    ``boot`` prime (random words and the edges q-1, 0, R mod q);
  * ``ServerEvaluator(datapath='f64')`` against ``datapath='df32'`` for
    every op at ``tinyboot``, in the port alone (the df32 evaluator is held
    against the JAX one by ``tests/test_torch_server.py``, and the
    reference pins df32 == f64 itself).

The JAX side runs ONCE per session, in subprocesses under
``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (no FMA contraction of the df32 / df64
error-free transforms), started together at the module's first test on
inputs made here from numpy seeds; the kernels run in interpret mode, as
the JAX package's own tests run them. The JAX clients take the port's
keys (``tests/test_torch_slice.py`` holds the two keygens equal; eager JAX
keygen would recompile its ops for every ring, ~2 min of CPU here), and
the JAX decode its INTT words from the port. Cheap JAX references (REDC,
RNS oracles) run in this process. Tolerance everywhere: 0 words, 0 bits.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import modmul as jmodmul
from repro.core import rns as jrns

from repro_torch.core import dfloat as dfl
from repro_torch.core import encoder, encryptor, modmul, rns
from repro_torch.core.context import get_context
from repro_torch.fhe_client.client import FHEClient
from repro_torch.fhe_server.ct import ServerCiphertext
from repro_torch.fhe_server import encoding
from repro_torch.fhe_server.eval_ops import ServerEvaluator
from repro_torch.kernels import ops

SRC = str(Path(__file__).resolve().parents[1] / "src")
SEED_B = 0x0123456789ABCDEF_FEDCBA9876543210

# (case id, profile, batch, client seed or None, nonce base, message seed)
CASES = [
    ("tiny_b3", "tiny", 3, None, 0xFFFFFFFE, 21),
    ("test_b2", "test", 2, SEED_B, 40, 22),
]
ENC_PROFILES = ("tiny", "test")
ENC_NONCE, SEEDED_NONCE = 3, 2

_JAX = r'''
import json, sys
import numpy as np
import jax.numpy as jnp
from repro.core import encoder, encryptor
from repro.core.context import get_context
from repro.core.encryptor import Ciphertext
from repro.fhe_client.client import FHEClient

group, cases, out_dir = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
inputs = np.load(f"{out_dir}/inputs.npz")


def keys_from_inputs(ctx, seed=None):
    """The keys of (ctx, seed), made by the port (its keygen is held
    against this one's by tests/test_torch_slice.py): eager JAX keygen
    recompiles its ops for every ring and costs this file ~2 min of CPU."""
    seed = seed if seed is not None else ctx.params.seed
    tag = f"keys_{ctx.params.logn}_{seed}"
    k = {n: jnp.asarray(inputs[f"{tag}_{n}"])
         for n in ("s_mont", "s_coeffs", "b_mont", "a_mont")}
    return (encryptor.SecretKey(k["s_mont"], k["s_coeffs"]),
            encryptor.PublicKey(k["b_mont"], k["a_mont"],
                                encryptor.STREAM_PK_A))


encryptor.keygen = keys_from_inputs
res = {}
if group.startswith("mega_enc_") or group == "host":
    for cid, profile, batch, seed, nonce0, _ in cases:
        if group != "host" and group != "mega_enc_" + cid:
            continue
        kw = {"datapath": "f64"} if group != "host" else {"fourier": "host"}
        client = FHEClient(profile, seed=seed, **kw)
        client.nonce = nonce0
        msgs, scales = inputs[f"{cid}_msgs"], inputs[f"{cid}_scales"]
        cts = client.encode_encrypt_batch(msgs)
        res[f"{cid}_c0"], res[f"{cid}_c1"] = map(np.asarray, (cts.c0, cts.c1))
        if group == "host":
            res[f"{cid}_delta_z"] = client.decrypt_decode_batch(
                cts.truncated(2))
            res[f"{cid}_rows_z"] = client.decrypt_batch([
                Ciphertext(c0=cts.c0[i], c1=cts.c1[i], n_limbs=cts.n_limbs,
                           scale=float(scales[i, 0]))
                for i in range(batch)])
elif group == "mega_dec":               # the port's own ciphertexts
    for cid, profile, batch, seed, nonce0, _ in cases:
        client = FHEClient(profile, seed=seed, datapath="f64")
        c0, c1 = (jnp.asarray(inputs[f"{cid}_port_{k}"]) for k in ("c0", "c1"))
        re, im = client.decrypt_core(c0[:, :2], c1[:, :2],
                                     client._scale_operand(
                                         inputs[f"{cid}_scales"]))
        res[f"{cid}_re"], res[f"{cid}_im"] = np.asarray(re), np.asarray(im)
else:                                   # "enc": the per-ciphertext entries
    for profile in ("tiny", "test"):
        ctx = get_context(profile)
        sk, pk = encryptor.keygen(ctx)
        z = inputs[f"enc_{profile}_z"]
        pt = encoder.encode(z, ctx)
        pre = f"enc_{profile}_"
        res[pre + "pt_host"] = np.asarray(pt.data)
        res[pre + "pt_device"] = np.asarray(
            encoder.encode(z, ctx, fourier="device").data)
        ct = encryptor.encrypt(pt, pk, ctx, nonce=%d)
        sct = encryptor.encrypt_symmetric_seeded(pt, sk, ctx, nonce=%d)
        ect = encryptor.expand_seeded(sct, ctx)
        dec = encryptor.decrypt(ct, sk, ctx)
        res[pre + "c0"], res[pre + "c1"] = map(np.asarray, (ct.c0, ct.c1))
        res[pre + "s_c0"] = np.asarray(sct.c0)
        res[pre + "a_stream"] = np.array(sct.a_stream)
        res[pre + "s_c1"] = np.asarray(ect.c1)
        res[pre + "dec"] = np.asarray(dec)
        res[pre + "s_dec"] = np.asarray(encryptor.decrypt(sct, sk, ctx))
        # decode's INTT words come from the port (K1, held against this
        # package's elsewhere): the eager intt_stacked recompiles per ring
        m = jnp.asarray(inputs[pre + "m_coeff"])
        res[pre + "z_host"] = encoder.decode_coeff(m, ctx)
        res[pre + "z_device"] = encoder.decode_coeff(m, ctx,
                                                     fourier="device")
        c = inputs[pre + "coeffs"]
        for f in ("host", "device"):
            res[pre + "c2s_" + f] = encoder.coeffs_to_slots(
                c, ctx, ctx.params.delta, fourier=f)
np.savez(f"{out_dir}/{group}.npz", **res)
''' % (ENC_NONCE, SEEDED_NONCE)
GROUPS = tuple(f"mega_enc_{c[0]}" for c in CASES) + ("mega_dec", "host",
                                                      "enc")


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float64)).view(np.uint64)


def _port_client(profile, seed, **kw) -> FHEClient:
    return FHEClient(profile, seed=seed, device="cpu", **kw)


def _msgs(ns: int, batch: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, ns))
            + 1j * rng.standard_normal((batch, ns))) * 0.5


def _row_scales(profile: str, batch: int) -> np.ndarray:
    """(B, 1) per-row scales: Delta, then scales that are not powers of two
    (a rescale's q_1, 0.75 Delta)."""
    ctx = get_context(profile)
    d = ctx.params.delta
    return np.array([d, float(ctx.q_list[1]), 0.75 * d][:batch])[:, None]


def _inputs() -> dict:
    """The messages and row scales of each case, the port's f64 megakernel
    ciphertexts of them (which the JAX decrypt takes: the encrypt test
    holds them equal to the JAX ones), and the entry points' slots."""
    out = {}
    for cid, profile, batch, seed, nonce0, mseed in CASES:
        ns = get_context(profile).params.n_slots
        out[f"{cid}_msgs"] = _msgs(ns, batch, mseed)
        out[f"{cid}_scales"] = _row_scales(profile, batch)
        client = _port_client(profile, seed, datapath="f64")
        client.nonce = nonce0
        cts = client.encode_encrypt_batch(out[f"{cid}_msgs"])
        out[f"{cid}_port_c0"], out[f"{cid}_port_c1"] = _u(cts.c0), _u(cts.c1)
        out.update(_keys(profile, seed))
    for i, profile in enumerate(ENC_PROFILES):
        ctx = get_context(profile)
        out[f"enc_{profile}_z"] = _msgs(ctx.params.n_slots, 1, 30 + i)[0]
        out.update(_keys(profile, None))
        run = _enc_run(profile, out[f"enc_{profile}_z"])
        out[f"enc_{profile}_m_coeff"] = _u(ops.intt_limbs(
            run["dec"].contiguous(), ctx, n_limbs=2))
        v = rns.crt2_to_df(*(modmul.u32_to_i64(ops.intt_limbs(
            run["dec"].contiguous(), ctx, n_limbs=2)[i]) for i in (0, 1)),
            ctx.q_list[0], ctx.q_list[1])
        out[f"enc_{profile}_coeffs"] = (v.hi + v.lo).numpy()
    return out


def _keys(profile: str, seed) -> dict:
    """The port's keys of (profile, seed) as numpy arrays, named as the
    JAX subprocess looks them up."""
    ctx = get_context(profile)
    sk, pk = encryptor.keygen(ctx, seed=seed, device="cpu")
    seed = seed if seed is not None else ctx.params.seed
    tag = f"keys_{ctx.params.logn}_{seed}"
    return {f"{tag}_s_mont": _u(sk.s_mont),
            f"{tag}_s_coeffs": sk.s_coeffs.numpy(),
            f"{tag}_b_mont": _u(pk.b_mont), f"{tag}_a_mont": _u(pk.a_mont)}


def _enc_run(profile: str, z: np.ndarray) -> dict:
    """The port's per-ciphertext entry points on slots z at `profile`."""
    ctx = get_context(profile)
    sk, pk = encryptor.keygen(ctx, device="cpu")
    pt = encoder.encode(z, ctx, device="cpu")
    ct = encryptor.encrypt(pt, pk, ctx, nonce=ENC_NONCE)
    sct = encryptor.encrypt_symmetric_seeded(pt, sk, ctx, nonce=SEEDED_NONCE)
    dec = encryptor.decrypt(ct, sk, ctx)
    return {
        "z": z, "pt_host": pt.data,
        "pt_device": encoder.encode(z, ctx, fourier="device",
                                    device="cpu").data,
        "c0": ct.c0, "c1": ct.c1, "s_c0": sct.c0,
        "a_stream": sct.a_stream, "seeded": sct,
        "s_c1": encryptor.expand_seeded(sct, ctx).c1,
        "dec": dec, "s_dec": encryptor.decrypt(sct, sk, ctx),
        "z_host": encoder.decode(dec, ctx),
        "z_device": encoder.decode(dec, ctx, fourier="device"),
    }


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
    """(inputs, _JaxRuns) of the no-FMA JAX reference."""
    out = tmp_path_factory.mktemp("jax_f64")
    inputs = _inputs()
    np.savez(out / "inputs.npz", **inputs)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    cases = json.dumps([list(c) for c in CASES])
    procs = {g: subprocess.Popen(
        [sys.executable, "-c", _JAX, g, cases, str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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
# in-process references: RNS oracles and the u64 REDC (no kernel)
# ---------------------------------------------------------------------------


def test_rns_limb_and_exact_oracles_match_jax():
    """to_rns_limb_t on integer-valued float64 pairs (|value| < 2^80) per
    limb == the JAX per-limb fmod == the exact residues; crt_exact ==
    JAX crt_exact and inverts to_rns_exact."""
    ctx = get_context("test")
    rng = np.random.default_rng(3)
    vals = [int(v) * (1 << 26) + int(w) for v, w in zip(
        rng.integers(-(1 << 54), 1 << 54, 64),
        rng.integers(0, 1 << 26, 64))] + [0, 1, -1, (1 << 79) - 1]
    hi = np.array([float(v) for v in vals])
    lo = np.array([float(v - int(h)) for v, h in zip(vals, hi)])
    x = dfl.DF(torch.tensor(hi), torch.tensor(lo))
    exact = rns.to_rns_exact(vals, ctx.q_list)
    np.testing.assert_array_equal(exact, jrns.to_rns_exact(vals, ctx.q_list))
    jx = jrns.dfl.DF(jnp.asarray(hi), jnp.asarray(lo))
    for l, q in enumerate(ctx.q_list):
        got = rns.to_rns_limb_t(x, float(q)).numpy().astype(np.uint32)
        want = np.asarray(jrns.to_rns_limb_t(jx, jnp.float64(q)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, exact[l])
    small = [v % (1 << 150) - (1 << 149) for v in vals]
    res = rns.to_rns_exact(small, ctx.q_list)
    assert rns.crt_exact(res, ctx.q_list) == jrns.crt_exact(res, ctx.q_list)
    qq = int(np.prod([int(q) for q in ctx.q_list], dtype=object))
    assert rns.crt_exact(res, ctx.q_list) == [
        (v + qq // 2) % qq - qq // 2 for v in small]


@pytest.mark.parametrize("profile", ["tinyboot", "boot"])
def test_u64_redc_matches_jax(profile):
    """The port's plain u64 REDC == JAX mulmod_montgomery_u64_t on every
    ciphertext prime and the special prime: a any uint32 word or a residue,
    b a residue, and the edges q-1, 0, R mod q."""
    ctx = get_context(profile)
    primes = [p.prime for p in ctx.plans] + [ctx.special_plan().prime]
    rng = np.random.default_rng(len(primes))
    for prime in primes:
        q = int(prime.q)
        qinv = (-pow(q, -1, 1 << 32)) % (1 << 32)
        edges = np.array([q - 1, 0, (1 << 32) % q], np.uint32)
        a = np.concatenate([rng.integers(0, 1 << 32, 256, dtype=np.uint64
                                         ).astype(np.uint32),
                            rng.integers(0, q, 256, dtype=np.uint32),
                            np.repeat(edges, 3)])
        b = np.concatenate([rng.integers(0, q, 512, dtype=np.uint32),
                            np.tile(edges, 3)])
        got = modmul.mulmod_montgomery_u64_t(
            torch.tensor(a.astype(np.int64)), torch.tensor(b.astype(np.int64)),
            q, qinv)
        want = np.asarray(jmodmul.mulmod_montgomery_u64_t(
            jnp.asarray(a), jnp.asarray(b), q, qinv))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        lim = modmul.mulmod_montgomery_limb_t(
            torch.tensor(a.astype(np.int64)), torch.tensor(b.astype(np.int64)),
            q, qinv)
        assert torch.equal(got, lim)


# ---------------------------------------------------------------------------
# the f64 megakernel client
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mega_runs(jax_ref):
    """{case id: (client, CiphertextBatch)} of the port's f64 megakernel
    clients on the reference's seeds, nonces and messages."""
    inputs, _ = jax_ref
    out = {}
    for cid, profile, _, seed, nonce0, _ in CASES:
        client = _port_client(profile, seed, datapath="f64")
        client.nonce = nonce0
        out[cid] = (client, client.encode_encrypt_batch(
            inputs[f"{cid}_msgs"]))
    return out


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_f64_megakernel_ciphertexts_match_jax(jax_ref, mega_runs, cid):
    ref = jax_ref[1]["mega_enc_" + cid]
    client, cts = mega_runs[cid]
    assert client.encrypt_impl == client._encrypt_core_mega_impl
    np.testing.assert_array_equal(_u(cts.c0), ref[f"{cid}_c0"])
    np.testing.assert_array_equal(_u(cts.c1), ref[f"{cid}_c1"])


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_f64_megakernel_decode_matches_jax(jax_ref, mega_runs, cid):
    """The decoded float64 (re, im) parts, bit for bit, under a scale per
    row: the profile's Delta, then scales that are not powers of two."""
    inputs, runs = jax_ref
    ref = runs["mega_dec"]
    client, cts = mega_runs[cid]
    assert client.decrypt_impl == client._decrypt_core_mega_impl
    re, im = client.decrypt_impl(
        cts.c0[:, :2], cts.c1[:, :2],
        client._scale_operand(inputs[f"{cid}_scales"], len(cts)))
    np.testing.assert_array_equal(_bits(re), _bits(ref[f"{cid}_re"]))
    np.testing.assert_array_equal(_bits(im), _bits(ref[f"{cid}_im"]))


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_f64_megakernel_equals_df32_megakernel(mega_runs, cid):
    """The f64 megakernel's c0 / c1 == the df32 megakernel's for the same
    seed and nonce base; decoded parts agree to the round trip's
    precision."""
    _, profile, batch, seed, nonce0, mseed = next(c for c in CASES
                                                  if c[0] == cid)
    f64, cts = mega_runs[cid]
    d32 = _port_client(profile, seed)
    d32.nonce = nonce0
    msgs = _msgs(f64.ctx.params.n_slots, batch, mseed)
    want = d32.encode_encrypt_batch(msgs)
    assert torch.equal(cts.c0, want.c0) and torch.equal(cts.c1, want.c1)
    out = f64.decrypt_decode_batch(cts.truncated(2))
    assert encoder.boot_precision_bits(msgs, out) >= 19.29
    assert np.max(np.abs(out - d32.decrypt_decode_batch(
        want.truncated(2)))) < 2.0 ** -30


def test_delta_scale_split_at_paper_matches_jax():
    """At Delta = 2^55 the two datapaths can round a coefficient
    differently: df32 rounds the exact df32 pair times Delta, f64 its
    float64 collapse (a pair spanning more than 53 bits loses its last
    ones). Then the f64 megakernel's ciphertext row differs from the df32
    one's. The port's differing coefficients are the JAX reference's (its
    delta_scale_digits vs delta_scale_round, op by op), on rows 8 and 12
    of the `paper` B=16 messages chip_smoke.py holds the two megakernels
    against (the rows where they differ)."""
    from repro.core import dfloat as jdfl
    from repro.core import encoder as jencoder
    from repro_torch.kernels import fft_df
    ctx = get_context("paper")
    p = ctx.params
    msgs = _msgs(p.n_slots, 16, 106)[[8, 12]]
    planes = dfl.dfc_to_planes(dfl.dfc_from_parts(
        torch.from_numpy(msgs.real.copy()),
        torch.from_numpy(msgs.imag.copy())))
    w = dfl.dfc_from_planes(fft_df.bitrev_planes(
        fft_df.fft_rows_plain(planes, p.m, inverse=True)))
    pair = encoder.planes_to_coeff_df(w)
    d = encoder.delta_scale_digits(pair, p.delta)
    v32 = d[0].long() + (d[1].long() << 22) + (d[2].long() << 44)
    s = encoder.delta_scale_round(torch.cat(
        [dfl.df_to_float(w.re), dfl.df_to_float(w.im)], -1), p.delta)
    got = np.nonzero((v32 != s.hi.long() + s.lo.long()).numpy())

    hi, lo = jnp.asarray(pair.hi.numpy()), jnp.asarray(pair.lo.numpy())
    jd = [np.asarray(x).astype(np.int64) for x in
          jencoder.delta_scale_digits(jdfl.DF(hi, lo), p.delta)]
    js = jencoder.delta_scale_round(hi.astype(jnp.float64)
                                    + lo.astype(jnp.float64), p.delta)
    want = np.nonzero(jd[0] + (jd[1] << 22) + (jd[2] << 44)
                      != np.asarray(js.hi).astype(np.int64)
                      + np.asarray(js.lo).astype(np.int64))
    assert sorted(set(got[0])) == [0, 1]
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


# ---------------------------------------------------------------------------
# the host oracle client
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_host_client_matches_jax(jax_ref, cid):
    inputs, runs = jax_ref
    ref = runs["host"]
    _, profile, batch, seed, nonce0, _ = next(c for c in CASES
                                              if c[0] == cid)
    client = _port_client(profile, seed, fourier="host")
    assert (client.pipeline, client.datapath) == ("staged", "f64")
    assert client.n_encrypt_operands == 1
    client.nonce = nonce0
    cts = client.encode_encrypt_batch(inputs[f"{cid}_msgs"])
    np.testing.assert_array_equal(_u(cts.c0), ref[f"{cid}_c0"])
    np.testing.assert_array_equal(_u(cts.c1), ref[f"{cid}_c1"])
    z = client.decrypt_decode_batch(cts.truncated(2))
    np.testing.assert_array_equal(_bits(z.real), _bits(ref[f"{cid}_delta_z"]
                                                       .real))
    np.testing.assert_array_equal(_bits(z.imag), _bits(ref[f"{cid}_delta_z"]
                                                       .imag))
    scales = inputs[f"{cid}_scales"]
    rows = list(cts)
    for ct, s in zip(rows, scales[:, 0]):
        ct.scale = float(s)
    zr = client.decrypt_batch(rows)
    np.testing.assert_array_equal(_bits(zr.real),
                                  _bits(ref[f"{cid}_rows_z"].real))
    np.testing.assert_array_equal(_bits(zr.imag),
                                  _bits(ref[f"{cid}_rows_z"].imag))


def test_host_client_counts_host_ffts_and_no_launch(monkeypatch):
    """fourier='host' runs one host SpecialIFFT per encrypt and one
    SpecialFFT per decrypt (the oracle, through core.fft), and on the CPU
    no CUDA launch."""
    from repro_torch.core import fft as fftmod
    calls = {"special_fft": 0, "special_ifft": 0}
    for name in calls:
        real = getattr(fftmod, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(fftmod, name, counted)
    client = _port_client("tiny", None, fourier="host")
    ops.reset_launches()
    msgs = _msgs(32, 2, 5)
    out = client.decrypt_decode_batch(
        client.encode_encrypt_batch(msgs).truncated(2))
    assert encoder.boot_precision_bits(msgs, out) >= 19.29
    assert calls == {"special_fft": 1, "special_ifft": 1}
    assert not any(ops.launches().values())


# ---------------------------------------------------------------------------
# the per-ciphertext entry points
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def enc_runs(jax_ref):
    """{profile: dict} of the port's per-ciphertext entry points on the
    reference's inputs."""
    inputs, _ = jax_ref
    return {profile: _enc_run(profile, inputs[f"enc_{profile}_z"])
            for profile in ENC_PROFILES}


@pytest.mark.parametrize("name", ["pt_host", "pt_device"])
@pytest.mark.parametrize("profile", ENC_PROFILES)
def test_encode_matches_jax(jax_ref, enc_runs, profile, name):
    np.testing.assert_array_equal(
        _u(enc_runs[profile][name]),
        jax_ref[1]["enc"][f"enc_{profile}_{name}"])


@pytest.mark.parametrize("profile", ENC_PROFILES)
def test_encode_batch_is_encode_batch_major(profile):
    """encode_batch == encode of the (B, n_slots) slots, batch-major."""
    ctx = get_context(profile)
    z = _msgs(ctx.params.n_slots, 3, 50)
    pt = encoder.encode(z, ctx, device="cpu")
    ptb = encoder.encode_batch(z, ctx, device="cpu")
    assert (ptb.n_limbs, ptb.scale) == (pt.n_limbs, pt.scale)
    assert torch.equal(ptb.data, pt.data.transpose(0, 1))
    for i in range(3):
        assert torch.equal(ptb.data[i],
                           encoder.encode(z[i], ctx, device="cpu").data)


@pytest.mark.parametrize("profile", ENC_PROFILES)
def test_encrypt_decrypt_match_jax(jax_ref, enc_runs, profile):
    ref, got = jax_ref[1]["enc"], enc_runs[profile]
    for name in ("c0", "c1", "dec"):
        np.testing.assert_array_equal(_u(got[name]),
                                      ref[f"enc_{profile}_{name}"])
    for name in ("z_host", "z_device"):
        want = ref[f"enc_{profile}_{name}"]
        np.testing.assert_array_equal(_bits(got[name].real),
                                      _bits(want.real))
        np.testing.assert_array_equal(_bits(got[name].imag),
                                      _bits(want.imag))
    assert encoder.boot_precision_bits(got["z"], got["z_host"]) >= 19.29


@pytest.mark.parametrize("fourier", encoder.FOURIERS)
@pytest.mark.parametrize("profile", ENC_PROFILES)
def test_coeffs_to_slots_matches_jax(jax_ref, profile, fourier):
    """The host / device coefficient-to-slot transform of integer-valued
    float64 coefficients (/Delta, SpecialFFT), bit for bit."""
    inputs, runs = jax_ref
    pre = f"enc_{profile}_"
    ctx = get_context(profile)
    got = encoder.coeffs_to_slots(inputs[pre + "coeffs"], ctx,
                                  ctx.params.delta, fourier=fourier,
                                  device="cpu")
    want = runs["enc"][pre + "c2s_" + fourier]
    np.testing.assert_array_equal(_bits(got.real), _bits(want.real))
    np.testing.assert_array_equal(_bits(got.imag), _bits(want.imag))


@pytest.mark.parametrize("profile", ENC_PROFILES)
def test_seeded_encryption_matches_jax(jax_ref, enc_runs, profile):
    """encrypt_symmetric_seeded -> c0 and the stream id of a (the
    reference's STREAM_ENC_V + 16*nonce + 7); expand_seeded regenerates
    the reference's c1; decrypt expands a seeded ciphertext itself."""
    ref, got = jax_ref[1]["enc"], enc_runs[profile]
    assert got["a_stream"] == int(ref[f"enc_{profile}_a_stream"]) == (
        encryptor.STREAM_ENC_V + 16 * SEEDED_NONCE + 7)
    assert got["seeded"].c1 is None
    for name in ("s_c0", "s_c1", "s_dec"):
        np.testing.assert_array_equal(_u(got[name]),
                                      ref[f"enc_{profile}_{name}"])
    with pytest.raises(AssertionError):        # the reference's assert
        encryptor.expand_seeded(encryptor.Ciphertext(
            got["c0"], got["c1"], got["seeded"].n_limbs, 1.0), get_context(
                profile))


# ---------------------------------------------------------------------------
# the server's f64 datapath (u64 REDC) == its df32 datapath, every op
# ---------------------------------------------------------------------------

_OPS = ("add_ct", "add_pt", "mul_pt", "mul_pt_rescale", "rescale", "mul_ct",
        "rotate", "hoisted")


@pytest.fixture(scope="module")
def tinyboot_pair():
    """A tinyboot f64 staged client's encrypted pair at level 6, a
    plaintext, its evaluation keys (relin, rotations 1 and 3), and the two
    evaluators."""
    client = _port_client("tinyboot", 11, pipeline="staged", datapath="f64")
    ctx = client.ctx
    ns = ctx.params.n_slots
    rng = np.random.default_rng(11)
    z = rng.standard_normal((2, ns)) * 0.5
    x = ServerCiphertext.from_batch(client.encode_encrypt_batch(z)).drop_to(6)
    y = ServerCiphertext.from_batch(
        client.encode_encrypt_batch(z[::-1].copy())).drop_to(6)
    keys = client.make_evaluation_keys(rotations=(1, 3))
    pt = encoding.encode_plaintext(rng.standard_normal(ns) * 0.5, ctx, 6,
                                   float(ctx.q_list[5]), device="cpu")
    return {"client": client, "x": x, "y": y, "pt": pt,
            "df32": ServerEvaluator(ctx, keys),
            "f64": ServerEvaluator(ctx, keys, datapath="f64")}


def _op(ev, name, s):
    x, y, pt = s["x"], s["y"], s["pt"]
    if name == "add_ct":
        return [ev.add_ct(x, y)]
    if name == "add_pt":
        return [ev.add_pt(x, encoding.encode_plaintext(
            np.ones(s["client"].ctx.params.n_slots) * 0.25, s["client"].ctx,
            6, x.scale, device="cpu"))]
    if name == "mul_pt":
        return [ev.mul_pt(x, pt, rescale=False)]
    if name == "mul_pt_rescale":
        return [ev.mul_pt(x, pt)]
    if name == "rescale":
        return [ev.rescale(x)]
    if name == "mul_ct":
        return [ev.mul_ct(x, y)]
    if name == "rotate":
        return [ev.rotate(x, 1), ev.rotate(x, 3)]
    return list(ev.hoisted_rotations(x, [1, 3]).values())


@pytest.mark.parametrize("name", _OPS)
def test_server_f64_equals_df32(tinyboot_pair, name):
    ops.reset_launches()
    got = _op(tinyboot_pair["f64"], name, tinyboot_pair)
    want = _op(tinyboot_pair["df32"], name, tinyboot_pair)
    assert not any(ops.launches().values())
    for g, w in zip(got, want):
        assert (g.level, g.scale) == (w.level, w.scale)
        assert torch.equal(g.c0, w.c0) and torch.equal(g.c1, w.c1)
