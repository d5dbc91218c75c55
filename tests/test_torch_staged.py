"""The port's staged df32 client path and its kernels' plain versions
against the JAX package, bit for bit.

``FHEClient(pipeline='staged')`` splits each client operation into the
staged kernels: SpecialIFFT (K4) -> Delta-scale digits and RNS -> limb-
folded NTT (K1) -> folded encrypt (K2), and folded decrypt + INTT (K3) ->
CRT and /Delta -> SpecialFFT (K4). On the CPU each kernel is its plain
PyTorch version.

The JAX reference runs ONCE per session, in subprocesses started
together, under ``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (no FMA contraction of
the df32 multiply-adds; see ``test_torch_slice.py``): one per client runs
the JAX ``FHEClient(pipeline='staged', datapath='df32')`` on ``tiny`` B=3
(nonce base wrapping past 2^32) and B=1 (the JAX side pads the lone FFT
row to two; the port does not), or on a Delta=2^55 toy ring at B=2; one
dumps the JAX ``ops.ntt_limbs`` / ``intt_limbs`` / ``special_fft_planes`` /
``special_ifft_planes`` on seeded numpy inputs at ``tiny`` and ``test``.
``test`` B=2 is held against the port's megakernel path instead, which
``test_torch_slice.py`` holds against JAX. Tolerance everywhere: 0 words.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.context import CKKSParams, get_context
from repro_torch.core.encoder import boot_precision_bits
from repro_torch.core.encryptor import CiphertextBatch
from repro_torch.fhe_client.client import FHEClient
from repro_torch.kernels import common, ops

SRC = str(Path(__file__).resolve().parents[1] / "src")

TOY55 = dict(logn=6, n_limbs=4, decrypt_limbs=2, delta_bits=55)
SEED_B = 0x0123456789ABCDEF_FEDCBA9876543210

# (case id, profile, batch, client seed or None, nonce base, message seed)
CASES = [
    ("tiny_b3", "tiny", 3, None, 0xFFFFFFFE, 21),
    ("tiny_b1", "tiny", 1, None, 7, 22),
    ("toy55_b2", "toy55", 2, SEED_B, 5, 23),
]
OPS_PROFILES = ("tiny", "test")
OPS_ROWS = 3

_CLIENTS = r'''
import json, sys
import numpy as np
from repro.core.context import CKKSParams
from repro.fhe_client.client import FHEClient

cases, toy55, out_dir = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
clients = {}
for cid, profile, batch, seed, nonce0, mseed in cases:
    key = (profile, seed)
    if key not in clients:
        clients[key] = FHEClient(
            CKKSParams(**toy55) if profile == "toy55" else profile,
            seed=seed, pipeline="staged", datapath="df32")
    client = clients[key]
    ns = client.ctx.params.n_slots
    rng = np.random.default_rng(mseed)
    msgs = (rng.standard_normal((batch, ns))
            + 1j * rng.standard_normal((batch, ns))) * 0.5
    client.nonce = nonce0
    cts = client.encode_encrypt_batch(msgs)
    planes = client.decrypt_core(*client.decrypt_operands(cts.truncated(2)))
    np.savez(f"{out_dir}/{cid}.npz", msgs=msgs, c0=np.asarray(cts.c0),
             c1=np.asarray(cts.c1),
             planes=np.stack([np.asarray(p) for p in planes]))
'''

_OPS = r'''
import sys
import numpy as np
import jax.numpy as jnp
from repro.core.context import get_context
from repro.kernels import ops

profiles, rows, out_dir = sys.argv[1].split(","), int(sys.argv[2]), sys.argv[3]
for profile in profiles:
    ctx = get_context(profile)
    p = ctx.params
    rng = np.random.default_rng(p.logn)
    q = np.asarray(ctx.q_list, np.uint64)[:, None, None]
    x = (rng.integers(0, 1 << 32, (p.n_limbs, rows, p.n), dtype=np.uint64)
         % q).astype(np.uint32)
    z = (rng.standard_normal((rows, p.n_slots))
         + 1j * rng.standard_normal((rows, p.n_slots)))
    hi_re, hi_im = z.real.astype(np.float32), z.imag.astype(np.float32)
    planes = np.stack([hi_re, (z.real - hi_re).astype(np.float32),
                       hi_im, (z.imag - hi_im).astype(np.float32)])
    jp = tuple(jnp.asarray(a) for a in planes)
    np.savez(f"{out_dir}/{profile}_ops.npz", x=x, planes=planes,
             ntt=np.asarray(ops.ntt_limbs(jnp.asarray(x), ctx)),
             intt=np.asarray(ops.intt_limbs(jnp.asarray(x), ctx)),
             fft=np.stack([np.asarray(a) for a in
                           ops.special_fft_planes(jp, p.m)]),
             ifft=np.stack([np.asarray(a) for a in
                            ops.special_ifft_planes(jp, p.m)]))
'''


@pytest.fixture(scope="session")
def jax_staged(tmp_path_factory):
    """{case id or '<profile>_ops': npz} from no-FMA JAX subprocesses run
    side by side."""
    out = tmp_path_factory.mktemp("jax_staged")
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    # one process per reference client (its keygen and jit traces
    # dominate) and one for the kernel dumps, all at once
    by_client = {}
    for case in CASES:
        by_client.setdefault((case[1], case[3]), []).append(list(case))
    jobs = [(_CLIENTS, [json.dumps(cases), json.dumps(TOY55), str(out)])
            for cases in by_client.values()]
    jobs.append((_OPS, [",".join(OPS_PROFILES), str(OPS_ROWS), str(out)]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *args], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for code, args in jobs]
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"JAX reference failed:\n{stdout}\n"
                               f"{stderr[-4000:]}")
    names = [c[0] for c in CASES] + [f"{p}_ops" for p in OPS_PROFILES]
    return {name: np.load(out / f"{name}.npz") for name in names}


@pytest.fixture(scope="module")
def port_client():
    """Staged port clients on the CPU, one per (profile, seed)."""
    clients = {}

    def get(profile, seed, pipeline="staged"):
        key = (profile, seed, pipeline)
        if key not in clients:
            clients[key] = FHEClient(
                CKKSParams(**TOY55) if profile == "toy55" else profile,
                seed=seed, device="cpu", pipeline=pipeline)
        return clients[key]

    return get


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _bits(t) -> np.ndarray:
    return np.asarray(t, np.float32).view(np.uint32)


def _case(cid):
    return next(c for c in CASES if c[0] == cid)


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_staged_ciphertexts_bit_identical(jax_staged, port_client, cid):
    _, profile, batch, seed, nonce0, _ = _case(cid)
    ref = jax_staged[cid]
    client = port_client(profile, seed)
    client.nonce = nonce0
    cts = client.encode_encrypt_batch(ref["msgs"])
    assert client.nonce == nonce0 + batch
    assert cts.c0.dtype == torch.int32
    np.testing.assert_array_equal(_u32(cts.c0), ref["c0"])
    np.testing.assert_array_equal(_u32(cts.c1), ref["c1"])


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_staged_decoded_planes_bit_identical(jax_staged, port_client, cid):
    """The port's staged decrypt of the reference's own ciphertexts."""
    _, profile, _, seed, _, _ = _case(cid)
    ref = jax_staged[cid]
    client = port_client(profile, seed)
    cts = CiphertextBatch(
        c0=torch.tensor(ref["c0"].view(np.int32)),
        c1=torch.tensor(ref["c1"].view(np.int32)),
        n_limbs=ref["c0"].shape[1], scale=client.ctx.params.delta)
    planes = client.decrypt_planes(cts.truncated(2))
    got = np.stack([p.numpy() for p in planes])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(ref["planes"]))


@pytest.mark.parametrize("profile", OPS_PROFILES)
@pytest.mark.parametrize("mode,inverse", [
    ("ntt", False), ("ntt", True), ("fft", False), ("fft", True)])
def test_plain_kernel_matches_reference(jax_staged, profile, mode, inverse):
    """K1 (NTT / INTT) and K4 (SpecialFFT / IFFT) plain versions, through
    the Fourier engine's mode switch, on the reference's inputs."""
    ref = jax_staged[f"{profile}_ops"]
    ctx = get_context(profile)
    cfg = common.FourierConfig(mode=mode)
    if mode == "ntt":
        x = torch.tensor(ref["x"].view(np.int32))
        got = ops.fourier(x, ctx, cfg, inverse=inverse)
        assert got.dtype == torch.int32 and got.shape == x.shape
        np.testing.assert_array_equal(_u32(got),
                                      ref["intt" if inverse else "ntt"])
    else:
        planes = tuple(torch.tensor(p) for p in ref["planes"])
        got = np.stack([p.numpy() for p in
                        ops.fourier(planes, ctx, cfg, inverse=inverse)])
        np.testing.assert_array_equal(
            _bits(got), _bits(ref["ifft" if inverse else "fft"]))


@pytest.fixture(scope="module")
def test_b2(port_client):
    """`test` B=2 through both pipelines of the port, same seed and nonce
    base: (staged client, staged cts, megakernel cts)."""
    staged = port_client("test", SEED_B)
    mega = port_client("test", SEED_B, pipeline="megakernel")
    ns = staged.ctx.params.n_slots
    rng = np.random.default_rng(24)
    msgs = (rng.standard_normal((2, ns))
            + 1j * rng.standard_normal((2, ns))) * 0.5
    staged.nonce = mega.nonce = 40
    return (staged, msgs, staged.encode_encrypt_batch(msgs),
            mega.encode_encrypt_batch(msgs))


def test_staged_matches_megakernel_ciphertexts_on_test(test_b2):
    _, _, staged, mega = test_b2
    assert torch.equal(staged.c0, mega.c0)
    assert torch.equal(staged.c1, mega.c1)


def test_staged_matches_megakernel_planes_on_test(test_b2, port_client):
    client, msgs, staged, _ = test_b2
    mega = port_client("test", SEED_B, pipeline="megakernel")
    want = mega.decrypt_planes(staged.truncated(2))
    got = client.decrypt_planes(staged.truncated(2))
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    out = client.decrypt_results(got)
    assert boot_precision_bits(msgs, out) >= 19.29


def test_encrypt_decrypt_fused_squeeze_one_row(port_client):
    """ops.encrypt_fused / decrypt_fused take (L, N) as one row of a
    (1, L, N) batch, as the reference's do."""
    client = port_client("tiny", None)
    ctx = client.ctx
    L, n = ctx.params.n_limbs, ctx.params.n
    rng = np.random.default_rng(25)
    q = np.asarray(ctx.q_list, np.uint64)[:, None]
    pt = torch.tensor((rng.integers(0, 1 << 32, (L, n), dtype=np.uint64) % q
                       ).astype(np.uint32).view(np.int32))
    pkb, pka = client.keys.pk.b_mont, client.keys.pk.a_mont
    c0, c1 = ops.encrypt_fused(pt, pkb, pka, ctx, seed=client.seed, nonce0=9)
    b0, b1 = ops.encrypt_fused(pt[None], pkb, pka, ctx, seed=client.seed,
                               nonce0=9)
    assert c0.shape == (L, n) and torch.equal(c0, b0[0])
    assert torch.equal(c1, b1[0])
    s = client.keys.sk.s_mont
    m = ops.decrypt_fused(c0, c1, s, ctx)
    assert m.shape == (2, n)
    assert torch.equal(m, ops.decrypt_fused(b0, b1, s, ctx)[0])
