"""The CUDA kernels' source, compiled for the CPU, against the plain path.

``csrc/client_common.cuh`` keeps the kernels' arithmetic and block bodies
in code that also compiles as plain C++ (one thread per block, barriers as
no-ops; every phase is race-free, so that build computes what the kernel
computes). Here g++ builds every source that way (the megakernels
``encode_encrypt.cu`` / ``decrypt_decode.cu`` and the staged kernels
``ntt_limbs.cu``, ``client_pointwise.cu``, ``fft_df.cu`` (K1, K2, K3 and
K4 also under forced tile geometries of the tiled NTT / FFT block), the
server op set ``server_eval.cu``, and the per-prime kernels
``ntt_rows.cu`` (K12, a stage of the tiled NTT block under the shift-add
REDC), K13 in ``client_pointwise.cu`` (K13a, K2's tiled encrypt under the
shift-add REDC; K13b, K3's tiled INTT stage on one limb under the
shift-add REDC; each also under forced geometries and against K1 / K2 /
K3 on the same limb) and the four-step ``ntt_matmul.cu`` (K14: its A
strips and table slices, each warp's int8 mma emulated from its lanes'
fragment registers through the kernel's fragment maps, which are also
held against the PTX ISA's tables, and the 64-bit weight combination;
square, non-square and ragged tiles, forced k-slices, against K1 under
bit reversal)), with
``-ffp-contract=off`` (the host twin of ``--fmad=false``), and each
``_host`` entry's results must equal the plain
PyTorch version word for word, on both datapaths (K5 / K6's df32 and f64
branches; the server bodies, whose one u64 REDC must give the words of the
plain versions under either datapath's REDC engine). The
CUDA build itself, its launch and its agreement on the card are checked by
``chip_smoke.py``. Skips where no C++ compiler is installed.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import prng, rns
from repro_torch.core.context import get_context
from repro_torch.fhe_client.client import FHEClient
from repro_torch.fhe_server import keys as skeys
from repro_torch.core.ntt import make_plan
from repro_torch.kernels import (build, client_pointwise, client_stream,
                                 common, fft_df, ntt_butterfly, ntt_matmul,
                                 server_eval)

_P = ctypes.c_void_p


_SOURCES = ("encode_encrypt.cu", "decrypt_decode.cu", "ntt_limbs.cu",
            "client_pointwise.cu", "fft_df.cu", "server_eval.cu",
            "ntt_rows.cu", "ntt_matmul.cu")
_LL = ctypes.c_longlong
_I = ctypes.c_int
_U = ctypes.c_uint32
# host entry point -> (source, argtypes): the CUDA entry's without stream
_HOST_ENTRIES = {
    "encode_encrypt_stream_host": (
        "encode_encrypt.cu", [_P] * 17 + [_I] * 5 + [ctypes.c_double]
        + [_U] * 5 + [_I] * 6),
    "decrypt_decode_stream_host": (
        "decrypt_decode.cu", [_P, _P, _LL] + [_P] * 11 + [_I] * 4 + [_U] * 8
        + [ctypes.c_ulonglong] * 2 + [_I] * 6),
    "ntt_limbs_host": ("ntt_limbs.cu", [_P] * 4 + [_I] * 9),
    "ntt_limbs_loop_host": ("ntt_limbs.cu", [_P] * 3 + [_I] * 5),
    "encrypt_limbs_host": ("client_pointwise.cu",
                           [_P, _LL, _LL] + [_P] * 8 + [_I] * 4 + [_U] * 5
                           + [_I] * 3),
    "decrypt_limbs_host": ("client_pointwise.cu",
                           [_P, _P, _LL] + [_P] * 4 + [_I] * 8),
    "special_fft_host": ("fft_df.cu",
                         [_P] * 4 + [_LL] + [_P] * 5 + [_I] * 6),
    "server_pointwise_host": ("server_eval.cu",
                              [_I] + [_P] * 7 + [_I] * 4),
    "server_rescale_host": ("server_eval.cu", [_P] * 8 + [_I] * 9),
    "server_ks_decompose_host": ("server_eval.cu", [_P] * 5 + [_I] * 8),
    "server_ks_apply_rot_host": ("server_eval.cu", [_P] * 11 + [_I] * 9),
    "server_rotate_host": ("server_eval.cu", [_P] * 13 + [_I] * 9),
    "server_mul_ct_host": ("server_eval.cu", [_P] * 19 + [_I] * 11),
    "ntt_rows_host": ("ntt_rows.cu", [_P] * 5 + [_I] * 7),
    "encrypt_limb_host": ("client_pointwise.cu", [_P] * 10 + [_I] * 2
                          + [_U] * 5 + [_I] * 3),
    "decrypt_limb_host": ("client_pointwise.cu", [_P] * 7 + [_I] * 6),
    "ntt_mm_pow_table_host": ("ntt_matmul.cu", [_P] * 2 + [_I] * 3),
    "ntt_mm_host": ("ntt_matmul.cu", [_P] * 7 + [_I] * 7),
    "ntt_mm_frag_maps_host": ("ntt_matmul.cu", [_P]),
}


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{host entry point: ctypes function} of the g++ builds, all sources
    compiled at once."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of the kernels")
    out = tmp_path_factory.mktemp("csrc_host")
    libs = {}
    procs = []
    for src in _SOURCES:
        lib = out / src.replace(".cu", ".so")
        procs.append((src, lib, subprocess.Popen(
            [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
             "-fno-fast-math", "-shared", "-fPIC", "-I", str(build.CSRC),
             "-o", str(lib), str(build.CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for src, lib, proc in procs:
        log = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, log
        libs[src] = ctypes.CDLL(str(lib))
    fns = {}
    for name, (src, argtypes) in _HOST_ENTRIES.items():
        fn = getattr(libs[src], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# the tile geometry of a host call: (a, lc, lr) of the NTT, then of the FFT;
# -1 takes the CUDA entry's default (ntt_tiled.cuh: plan_geo)
_DEFAULT_GEO = (-1,) * 6


def _k5_host(host_libs, client, planes, nonce0, datapath,
             geo=_DEFAULT_GEO):
    """(c0, c1) of the host build of K5 (encode_encrypt.cu) on `planes`."""
    ctx, p = client.ctx, client.ctx.params
    batch = planes[0].shape[0]
    L, n, ns = p.n_limbs, p.n, p.n_slots
    kc, tw, _, rev = client_stream.stream_consts(ctx, L, inverse=True)
    keep = [np.ascontiguousarray(t.numpy()) for t in planes]
    dm = np.asarray(common.stacked_digit_consts(ctx.q_list[:L]), np.uint32)
    consts = [np.ascontiguousarray(x) for x in (
        tw, rev.astype(np.int32), kc.table, dm,
        client.keys.pk.b_mont.numpy(), client.keys.pk.a_mont.numpy())]
    c0 = np.zeros((batch, L, n), np.uint32)
    c1 = np.zeros_like(c0)
    scratch = (np.zeros((L, n), np.uint32), np.zeros((batch, 3, n), np.int8),
               np.zeros((batch, 4, ns), np.float32),
               np.zeros((batch, 3, n), np.int32),
               np.zeros((batch, L, n), np.uint32))
    err = host_libs["encode_encrypt_stream_host"](
        *(_ptr(a) for a in keep), *(_ptr(a) for a in consts), _ptr(c0),
        _ptr(c1), *(_ptr(a) for a in scratch), batch, L, p.logn,
        kc.n_scalars, int(datapath == "f64"), float(p.delta),
        *prng.seed_words(client.seed), nonce0, *geo)
    assert err == 0
    return c0, c1


def _k6_host(host_libs, client, c0, c1, scale, datapath, geo=_DEFAULT_GEO):
    """The four planes of the host build of K6 (decrypt_decode.cu) on the
    2-limb row-strided view of the (B, L, N) words c0 / c1; `scale` a
    (B,) float32 (df32) or float64 (f64) array."""
    ctx, p = client.ctx, client.ctx.params
    batch, L, n = c0.shape
    kc, tw, _, rev = client_stream.stream_consts(ctx, 2, inverse=False)
    consts = [np.ascontiguousarray(x) for x in (
        client.keys.sk.s_mont.numpy(), scale, tw, rev.astype(np.int32),
        kc.table)]
    outs = [np.zeros((batch, p.n_slots), np.float32) for _ in range(4)]
    m = np.zeros((batch, 2, n), np.uint32)
    ntt_tw = np.zeros((2, n), np.uint32)
    q0, q1 = ctx.q_list[0], ctx.q_list[1]
    k = rns.crt2_consts(q0, q1)
    err = host_libs["decrypt_decode_stream_host"](
        _ptr(c0), _ptr(c1), L * n, *(_ptr(a) for a in consts),
        *(_ptr(o) for o in outs), _ptr(m), _ptr(ntt_tw), batch, p.logn,
        kc.n_scalars, int(datapath == "f64"), q0, q1, k["g0_mont"],
        k["g1_mont"], k["qinv0"], k["qinv1"], *rns.crt2_inverses(q0, q1),
        (k["q_w"][0] << 32) | k["q_w"][1],
        (k["half_w"][0] << 32) | k["half_w"][1], *geo)
    assert err == 0
    return outs


def _assert_same_planes(outs, want):
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.numpy().view(np.uint32))


def _operands(client, batch, seed):
    ns = client.ctx.params.n_slots
    rng = np.random.default_rng(seed)
    msgs = (rng.standard_normal((batch, ns))
            + 1j * rng.standard_normal((batch, ns))) * 0.5
    return client.encrypt_operands(msgs)


@pytest.mark.parametrize("profile,batch,nonce0", [
    ("tiny", 3, 0xFFFFFFFF), ("test", 2, 9)])
def test_host_build_matches_plain(host_libs, profile, batch, nonce0):
    client = FHEClient(profile, seed=0xC0FFEE, device="cpu")
    ctx, p = client.ctx, client.ctx.params
    planes = _operands(client, batch, 5)
    pkb, pka = client.keys.pk.b_mont, client.keys.pk.a_mont
    ref0, ref1 = client_stream.encode_encrypt_stream_plain(
        planes, pkb, pka, ctx, client.seed, nonce0)
    c0, c1 = _k5_host(host_libs, client, planes, nonce0, "df32")
    np.testing.assert_array_equal(c0, ref0.numpy().view(np.uint32))
    np.testing.assert_array_equal(c1, ref1.numpy().view(np.uint32))

    # decrypt the (B, L, N) batch through its 2-limb row-strided view
    scale = torch.full((batch,), p.delta, dtype=torch.float32)
    want = client_stream.decrypt_decode_stream_plain(
        ref0[:, :2], ref1[:, :2], client.keys.sk.s_mont, ctx, scale)
    _assert_same_planes(_k6_host(host_libs, client, c0, c1, scale.numpy(),
                                 "df32"), want)


@pytest.mark.parametrize("profile,batch,nonce0", [
    ("tiny", 3, 0xFFFFFFFF), ("test", 2, 9)])
def test_host_build_f64_matches_plain(host_libs, profile, batch, nonce0):
    """K5 and K6's f64 branches (df64 Delta-scale round and its exact
    digits; u64 CRT and float64 /scale at scales that are not powers of
    two) against their plain versions; K5's words also equal its df32
    branch's."""
    client = FHEClient(profile, seed=0xC0FFEE, device="cpu")
    ctx, p = client.ctx, client.ctx.params
    planes = _operands(client, batch, 15)
    pkb, pka = client.keys.pk.b_mont, client.keys.pk.a_mont
    ref0, ref1 = client_stream.encode_encrypt_stream_plain(
        planes, pkb, pka, ctx, client.seed, nonce0, datapath="f64")
    d32 = client_stream.encode_encrypt_stream_plain(
        planes, pkb, pka, ctx, client.seed, nonce0)
    assert torch.equal(ref0, d32[0]) and torch.equal(ref1, d32[1])
    c0, c1 = _k5_host(host_libs, client, planes, nonce0, "f64")
    np.testing.assert_array_equal(c0, ref0.numpy().view(np.uint32))
    np.testing.assert_array_equal(c1, ref1.numpy().view(np.uint32))

    # per-row scales that are not powers of two (a rescale's q_l), B rows
    sc = np.array([p.delta, float(ctx.q_list[1]), p.delta * 0.75][:batch])
    want = client_stream.decrypt_decode_stream_plain(
        ref0[:, :2], ref1[:, :2], client.keys.sk.s_mont, ctx,
        torch.tensor(sc), datapath="f64")
    _assert_same_planes(_k6_host(host_libs, client, c0, c1, sc, "f64"),
                        want)


# forced tile geometries (a, lc, lr of the NTT, then of the FFT): uneven
# splits both ways, several tiles per pass, and one pass at an uneven split
_SPLITS = {
    "test": {"ntt3+7,fft3+6": (3, 2, 1, 3, 1, 1),
             "ntt7+3,fft6+3": (7, 1, 2, 6, 2, 2),
             "ntt5+5,fft5+4": (5, -1, -1, 5, -1, -1),
             "single-ntt3+7,fft6+3": (3, 7, 3, 6, 3, 6)},
    "tiny": {"ntt2+4,fft4+1": (2, 1, 0, 4, 0, 1),
             "ntt4+2,fft1+4": (4, 0, 2, 1, 2, 0)},
}


@functools.lru_cache(maxsize=None)
def _split_reference(profile, datapath):
    """A client, its K5 operands, and the plain K5 / K6 words on them (B=2;
    K6 at per-row scales of the datapath)."""
    client = FHEClient(profile, seed=0xC0FFEE, device="cpu")
    ctx, p = client.ctx, client.ctx.params
    planes = _operands(client, 2, 25)
    c0, c1 = client_stream.encode_encrypt_stream_plain(
        planes, client.keys.pk.b_mont, client.keys.pk.a_mont, ctx,
        client.seed, 77, datapath=datapath)
    scale = (torch.full((2,), p.delta, dtype=torch.float32)
             if datapath == "df32" else
             torch.tensor([float(ctx.q_list[1]), p.delta * 0.75],
                          dtype=torch.float64))
    planes_out = client_stream.decrypt_decode_stream_plain(
        c0[:, :2], c1[:, :2], client.keys.sk.s_mont, ctx, scale,
        datapath=datapath)
    return client, planes, (c0, c1), scale, planes_out


@pytest.mark.parametrize("datapath", ["df32", "f64"])
@pytest.mark.parametrize("profile,split", [
    (prof, name) for prof, cases in _SPLITS.items() for name in cases])
def test_host_build_forced_splits_match_plain(host_libs, profile, split,
                                              datapath):
    """K5 and K6 with forced tile geometries (several tiles per pass,
    uneven splits, one pass at an uneven split), both datapaths, against
    their plain versions."""
    geo = _SPLITS[profile][split]
    client, planes, (ref0, ref1), scale, want = _split_reference(profile,
                                                                 datapath)
    c0, c1 = _k5_host(host_libs, client, planes, 77, datapath, geo)
    np.testing.assert_array_equal(c0, ref0.numpy().view(np.uint32))
    np.testing.assert_array_equal(c1, ref1.numpy().view(np.uint32))
    _assert_same_planes(_k6_host(host_libs, client, c0, c1, scale.numpy(),
                                 datapath, geo), want)


# forced geometries (a, lc, lr, brev) of the tiled NTT block: several tiles
# per pass, uneven splits, one-stage lines (a = 1, b = 1), a forced single
# pass, and the chunk tiles in bit-reversed order (brev = 1; 0 on the card)
_NTT_GEOS = [
    ("tiny", (3, 1, 1, 0)), ("tiny", (2, 0, 2, 1)), ("tiny", (4, 2, 0, 1)),
    ("tiny", (1, 3, 1, 0)), ("tiny", (5, 1, 3, 1)),
    ("test", (3, 2, 1, 0)), ("test", (7, 1, 2, 1)), ("test", (5, 5, 5, 0)),
    ("test", (5, 3, 2, 1))]


def _k1_host(host_libs, ctx, x, inverse, geo=(-1, -1, -1, 0)):
    """The host build of K1 (ntt_limbs.cu's tiled schedule) on an (L, rows,
    N) uint32 stack under geometry (a, lc, lr, brev)."""
    kc = common.stacked_kernel_consts(ctx.plans[:x.shape[0]])
    L, rows, n = x.shape
    out, tw_heap = np.zeros_like(x), np.zeros((L, n), np.uint32)
    err = host_libs["ntt_limbs_host"](
        _ptr(x), _ptr(out), _ptr(np.ascontiguousarray(kc.table)),
        _ptr(tw_heap), L, rows, kc.logn, kc.n_scalars, int(inverse), *geo)
    assert err == 0
    return out


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("profile,geo", _NTT_GEOS)
def test_host_tiled_ntt_matches_stage_loop(host_libs, profile, geo, inverse):
    """K1's tiled schedule under a forced geometry (a, lc, lr, brev) on
    random residues of every limb, lines of odd and even stage counts
    (one-stage lines at a = 1 and b = 1): the words of the one-row stage
    loop rt::ntt_fwd / ntt_inv (K1 before its redesign; its inverse is
    K13b's loop still) and of the plain stage loops."""
    ctx = get_context(profile)
    L, n, rows = ctx.params.n_limbs, ctx.params.n, 3
    rng = np.random.default_rng(11)
    x = np.ascontiguousarray(
        _rand_residues(ctx, (rows, L, n), rng).transpose(1, 0, 2))
    kc = common.stacked_kernel_consts(ctx.plans)
    table = np.ascontiguousarray(kc.table)
    loop = np.zeros_like(x)
    assert host_libs["ntt_limbs_loop_host"](
        _ptr(x), _ptr(loop), _ptr(table), L, rows, kc.logn, kc.n_scalars,
        int(inverse)) == 0
    got = _k1_host(host_libs, ctx, x, inverse, geo)
    np.testing.assert_array_equal(got, loop)
    want = ntt_butterfly.limb_rows_plain(torch.tensor(x.view(np.int32)),
                                         ctx.plans, inverse)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))


@pytest.mark.parametrize("profile,geo", _NTT_GEOS + [
    ("tiny", (-1, -1, -1, 0)), ("test", (-1, -1, -1, 0)),
    ("test", (3, 7, 3, 0)), ("test", (8, 1, 3, 0))])
def test_host_ntt_limbs_forced_geometry_matches_plain(host_libs, profile,
                                                      geo):
    """K1's host entry both ways under forced geometries (and its default
    plan, and a single pass at an uneven split) on a stack of 5 rows
    against the plain versions; the inverse returns x."""
    ctx = get_context(profile)
    L, n = ctx.params.n_limbs, ctx.params.n
    x = _rand_residues(ctx, (5, L, n), np.random.default_rng(12))
    x = np.ascontiguousarray(x.transpose(1, 0, 2))
    fwd = _k1_host(host_libs, ctx, x, False, geo)
    want = ntt_butterfly.limb_rows_plain(_t(x), ctx.plans, False)
    np.testing.assert_array_equal(fwd, want.numpy().view(np.uint32))
    back = _k1_host(host_libs, ctx, fwd, True, geo)
    want = ntt_butterfly.limb_rows_plain(_t(fwd), ctx.plans, True)
    np.testing.assert_array_equal(back, want.numpy().view(np.uint32))
    np.testing.assert_array_equal(back, x)


def _rand_residues(ctx, shape, rng) -> np.ndarray:
    """Random uint32 residues, limb axis -2, each below its prime."""
    q = np.asarray(ctx.q_list[:shape[-2]], np.uint64)[:, None]
    return (rng.integers(0, 1 << 32, shape, dtype=np.uint64) % q
            ).astype(np.uint32)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("profile", ["tiny", "test"])
def test_host_ntt_limbs_matches_plain(host_libs, profile, inverse):
    ctx = FHEClient(profile, device="cpu").ctx
    L, n, rows = ctx.params.n_limbs, ctx.params.n, 3
    rng = np.random.default_rng(6)
    x = np.ascontiguousarray(
        _rand_residues(ctx, (rows, L, n), rng).transpose(1, 0, 2))
    want = ntt_butterfly.limb_rows_plain(torch.tensor(x.view(np.int32)),
                                         ctx.plans, inverse)
    out = _k1_host(host_libs, ctx, x, inverse)
    np.testing.assert_array_equal(out, want.numpy().view(np.uint32))


def _k2_host(host_libs, client, pt, nonce0, geo=(-1, -1, -1)):
    """(c0, c1) of the host build of K2 (client_pointwise.cu) on a (B, L, N)
    uint32 plaintext, any view whose (row, limb) rows are contiguous (read
    through its strides), under NTT geometry (a, lc, lr), with the
    client's public key and seed."""
    pk = [k.numpy().view(np.uint32)
          for k in (client.keys.pk.b_mont, client.keys.pk.a_mont)]
    return _k2_host_keys(host_libs, client.ctx, pk, client.seed, pt, nonce0,
                         geo)


def _k2_host_keys(host_libs, ctx, pk, seed, pt, nonce0, geo=(-1, -1, -1)):
    """``_k2_host`` with the (>= L, N) uint32 key rows pk = (b, a) and the
    seed given."""
    batch, L, n = pt.shape
    kc = common.stacked_kernel_consts(ctx.plans[:L])
    keys = [np.ascontiguousarray(k) for k in pk]
    c0, c1, v = (np.zeros((batch, L, n), np.uint32) for _ in range(3))
    scratch = (np.zeros((L, n), np.uint32), np.zeros((batch, 3, n), np.int8))
    row_stride, limb_stride, one = (st // pt.itemsize for st in pt.strides)
    assert one == 1
    err = host_libs["encrypt_limbs_host"](
        _ptr(pt), row_stride, limb_stride, *(_ptr(k) for k in keys),
        _ptr(np.ascontiguousarray(kc.table)), _ptr(c0), _ptr(c1), _ptr(v),
        *(_ptr(a) for a in scratch), batch, L, kc.logn, kc.n_scalars,
        *prng.seed_words(seed), nonce0, *geo)
    assert err == 0
    return c0, c1


@pytest.mark.parametrize("profile,batch,nonce0", [
    ("tiny", 3, 0xFFFFFFFE), ("test", 2, 9)])
def test_host_encrypt_decrypt_limbs_match_plain(host_libs, profile, batch,
                                                nonce0):
    client = FHEClient(profile, seed=0xC0FFEE, device="cpu")
    ctx = client.ctx
    L, n = ctx.params.n_limbs, ctx.params.n
    rng = np.random.default_rng(7)
    pt = _rand_residues(ctx, (batch, L, n), rng)
    pkb, pka = client.keys.pk.b_mont, client.keys.pk.a_mont
    ref0, ref1 = client_pointwise.encrypt_limbs_plain(
        torch.tensor(pt.view(np.int32)), pkb, pka, ctx, client.seed, nonce0)
    c0, c1 = _k2_host(host_libs, client, pt, nonce0)
    np.testing.assert_array_equal(c0, ref0.numpy().view(np.uint32))
    np.testing.assert_array_equal(c1, ref1.numpy().view(np.uint32))

    # decrypt the 2-limb row-strided view of the (B, L, N) batch
    want = client_pointwise.decrypt_limbs_plain(ref0[:, :2], ref1[:, :2],
                                                client.keys.sk.s_mont, ctx)
    m = _k3_host(host_libs, ctx, c0[:, :2], c1[:, :2],
                 client.keys.sk.s_mont.numpy().view(np.uint32))
    np.testing.assert_array_equal(m, want.numpy().view(np.uint32))


def _k3_host(host_libs, ctx, c0, c1, s_mont, geo=(-1, -1, -1, 0)):
    """The host build of K3 (client_pointwise.cu's INTT stage) on (B, L_dec,
    N) uint32 views whose rows share one stride and hold their limbs
    contiguously (the first limbs of a (B, L, N) batch), under NTT geometry
    (a, lc, lr, brev)."""
    batch, n_limbs, n = c0.shape
    assert c0.strides == c1.strides and c0.strides[1:] == (4 * n, 4)
    kc = common.stacked_kernel_consts(ctx.plans[:n_limbs])
    m = np.zeros((batch, n_limbs, n), np.uint32)
    tw_heap = np.zeros((n_limbs, n), np.uint32)
    err = host_libs["decrypt_limbs_host"](
        _ptr(c0), _ptr(c1), c0.strides[0] // 4,
        _ptr(np.ascontiguousarray(s_mont)),
        _ptr(np.ascontiguousarray(kc.table)), _ptr(m), _ptr(tw_heap), batch,
        n_limbs, kc.logn, kc.n_scalars, *geo)
    assert err == 0
    return m


# forced NTT geometries (a, lc, lr, brev) of K3 by case: (profile, batch,
# L_dec); the input is the L_dec-limb view of a (B, L, N) batch. One pass
# (the default at `test`), two at uneven splits, several tiles per pass,
# chunk tiles in bit-reversed order
_K3_CASES = {"test-B2-L2": ("test", 2, 2), "test-B2-L3": ("test", 2, 3),
             "n15-B1-L3": ("n15", 1, 3)}
_K3_GEOS = {
    "test": {"default": (-1, -1, -1, 0), "3+7": (3, 2, 1, 0),
             "7+3-brev": (7, 1, 2, 1), "single-3+7": (3, 7, 3, 0)},
    "n15": {"default": (-1, -1, -1, 0), "8+7-brev": (8, 3, 2, 1),
            "6+9": (6, 5, 3, 0)},
}


@pytest.mark.parametrize("case,geo", [
    (case, name) for case, (prof, _, _) in _K3_CASES.items()
    for name in _K3_GEOS[prof]])
def test_host_decrypt_limbs_forced_geometry_matches_plain(host_libs, case,
                                                          geo):
    """K3's host entry (an INTT stage on the tiled block) under forced
    geometries and its default plan, on the L_dec-limb row-strided view of
    a (B, L, N) batch of random words, L_dec = 2 and 3: the plain
    version's words."""
    profile, batch, n_limbs = _K3_CASES[case]
    ctx = get_context(profile)
    L, n = ctx.params.n_limbs, ctx.params.n
    rng = np.random.default_rng(14)
    c0, c1 = (_rand_residues(ctx, (batch, L, n), rng) for _ in range(2))
    s_mont = _rand_residues(ctx, (L, n), rng)
    want = client_pointwise.decrypt_limbs_plain(
        _t(c0)[:, :n_limbs], _t(c1)[:, :n_limbs], _t(s_mont), ctx)
    m = _k3_host(host_libs, ctx, c0[:, :n_limbs], c1[:, :n_limbs], s_mont,
                 _K3_GEOS[profile][geo])
    np.testing.assert_array_equal(m, want.numpy().view(np.uint32))


# forced NTT geometries (a, lc, lr) of K2, as K5's in _SPLITS; "T" runs
# on the (L, B, N) -> (B, L, N) transpose the staged client passes
_K2_GEOS = {
    "tiny": {"2+4": (2, 1, 0), "4+2": (4, 0, 2), "default-T": (-1, -1, -1)},
    "test": {"3+7": (3, 2, 1), "7+3-T": (7, 1, 2), "5+5": (5, -1, -1),
             "single-3+7": (3, 7, 3), "1+9": (1, 4, 1)},
}


@pytest.mark.parametrize("profile,split", [
    (prof, name) for prof, cases in _K2_GEOS.items() for name in cases])
def test_host_encrypt_limbs_forced_geometry_matches_plain(host_libs,
                                                          profile, split):
    """K2's host entry under forced NTT geometries (several tiles per pass,
    uneven splits, a single pass at an uneven split, one-stage columns)
    against its plain version, tiny B=3 / test B=2, nonce0 = 2^32 - 2 so
    that the nonce wraps inside the batch; on a transposed view too."""
    client = FHEClient(profile, seed=0xC0FFEE, device="cpu")
    ctx = client.ctx
    L, n = ctx.params.n_limbs, ctx.params.n
    batch, nonce0 = {"tiny": 3, "test": 2}[profile], 0xFFFFFFFE
    x = _rand_residues(ctx, (batch, L, n), np.random.default_rng(13))
    by_limb = np.ascontiguousarray(x.transpose(1, 0, 2))     # (L, B, N)
    pt = by_limb.transpose(1, 0, 2)                   # (B, L, N) view
    if not split.endswith("-T"):
        pt = np.ascontiguousarray(pt)
    ref0, ref1 = client_pointwise.encrypt_limbs_plain(
        _t(pt), client.keys.pk.b_mont, client.keys.pk.a_mont, ctx,
        client.seed, nonce0)
    c0, c1 = _k2_host(host_libs, client, pt, nonce0,
                      _K2_GEOS[profile][split])
    np.testing.assert_array_equal(c0, ref0.numpy().view(np.uint32))
    np.testing.assert_array_equal(c1, ref1.numpy().view(np.uint32))


def _k4_planes(ctx, rows, seed, view):
    """Four (rows, n_slots) float32 df planes of random slots: contiguous,
    or (view) the halves of (rows, N) arrays, as the staged decode passes
    them."""
    ns = ctx.params.n_slots
    z = np.random.default_rng(seed).standard_normal((2, rows, ns))
    hi = z.astype(np.float32)
    parts = (hi[0], (z[0] - hi[0]).astype(np.float32),
             hi[1], (z[1] - hi[1]).astype(np.float32))
    if not view:
        return [np.ascontiguousarray(a) for a in parts]
    full_hi = np.concatenate(parts[0::2], axis=1)
    full_lo = np.concatenate(parts[1::2], axis=1)
    return [full_hi[:, :ns], full_lo[:, :ns], full_hi[:, ns:],
            full_lo[:, ns:]]


def _k4_host(host_libs, ctx, planes, inverse, geo=(-1, -1, -1)):
    """The four output planes of the host build of K4 (fft_df.cu) on four
    (rows, n_slots) planes of one row stride, under FFT geometry (a, lc,
    lr)."""
    rows, ns = planes[0].shape
    assert all(p.strides == planes[0].strides for p in planes)
    m = ctx.params.m
    tw = np.ascontiguousarray(fft_df.packed_twiddles(ns, m, inverse)[0])
    outs = [np.zeros((rows, ns), np.float32) for _ in range(4)]
    err = host_libs["special_fft_host"](
        *(_ptr(p) for p in planes), planes[0].strides[0] // 4,
        *(_ptr(o) for o in outs), _ptr(tw), rows, ns.bit_length() - 1,
        int(inverse), *geo)
    assert err == 0
    return outs


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("profile", ["tiny", "test"])
def test_host_fft_rows_match_plain(host_libs, profile, inverse):
    """K4's host entry (the bit reversal in its loads and stores) at its
    default plan on contiguous planes: the plain version's words."""
    ctx = FHEClient(profile, device="cpu").ctx
    planes = _k4_planes(ctx, 3, 8, view=False)
    want = fft_df.special_fft_plain(tuple(torch.tensor(p) for p in planes),
                                    ctx.params.m, inverse)
    _assert_same_planes(_k4_host(host_libs, ctx, planes, inverse), want)


# forced FFT geometries (a, lc, lr) of K4 by (profile, rows): an odd
# log n_slots (`test`, 2^9) and an even one (`n15` B=1, 2^14), uneven
# splits, several tiles per pass, a single pass at an uneven split, and the
# default plan (one pass at `tiny`, two above)
_K4_CASES = {"tiny": 2, "test": 2, "n15": 1}
_K4_GEOS = {
    "tiny": {"default": (-1, -1, -1)},
    "test": {"default": (-1, -1, -1), "5+4": (5, 1, 2), "3+6": (3, 2, 0),
             "7+2": (7, 2, 3), "single-4+5": (4, 5, 4)},
    "n15": {"default": (-1, -1, -1), "7+7": (7, 3, 3), "9+5": (9, 1, 2)},
}


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("profile,geo", [
    (prof, name) for prof, cases in _K4_GEOS.items() for name in cases])
def test_host_special_fft_forced_geometry_matches_plain(host_libs, profile,
                                                        geo, inverse):
    """K4's host entry both ways under forced FFT geometries and its default
    plan, on the halves of (rows, N) arrays read through their row stride:
    the plain version's words (the torch gather and the stage pipeline)."""
    ctx = get_context(profile)
    planes = _k4_planes(ctx, _K4_CASES[profile], 9, view=True)
    want = fft_df.special_fft_plain(tuple(torch.tensor(p) for p in planes),
                                    ctx.params.m, inverse)
    _assert_same_planes(_k4_host(host_libs, ctx, planes, inverse,
                                 _K4_GEOS[profile][geo]), want)


@pytest.mark.parametrize("profile", ["tiny", "test", "paper"])
def test_kernel_table_offsets_match_host_layout(profile):
    """The kernels compute the seed-table and FFT-twiddle stage offsets in
    closed form (csrc/client_common.cuh: fwd_off, inv_off; csrc/
    ntt_tiled.cuh: the stage offsets of the FFT column and chunk loops);
    they must equal the host tables' offsets the wrappers upload."""
    from repro_torch.core.context import get_context
    ctx = get_context(profile)
    L, ns = ctx.params.n_limbs, ctx.params.n_slots
    for inverse in (True, False):
        kc, _, offsets, _ = client_stream.stream_consts(ctx, L, inverse)
        lg = kc.logn
        assert kc.fwd_off == tuple(3 + s * (s + 1) // 2 for s in range(lg))
        assert kc.inv_off == tuple(
            3 + lg * (lg + 1) // 2 + t * lg - t * (t - 1) // 2
            for t in range(lg))
        stages = range(ns.bit_length() - 1)
        want = (tuple(ns - (ns >> s) for s in stages) if inverse
                else tuple((1 << s) - 1 for s in stages))
        assert tuple(offsets) == want


# ---------------------------------------------------------------------------
# the server op set (server_eval.cu) against kernels/server_eval.py
# ---------------------------------------------------------------------------

_SERVER_OPS = ("add_ct", "add_pt", "mul_pt", "rescale", "mul_pt_rescale",
               "mul_ct", "rotate", "hoisted")


def _words(rng, q_rows, shape) -> np.ndarray:
    """Random uint32 residues of shape (..., rows, N), row r below
    q_rows[r]."""
    q = np.asarray(q_rows, np.uint64)[:, None]
    return (rng.integers(0, 1 << 32, shape, dtype=np.uint64) % q
            ).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a).view(np.int32))


def _zeros(*shape) -> np.ndarray:
    return np.zeros(shape, np.uint32)


# the ops whose host entries take a forced tile geometry (a, lc, lr, brev)
# of their transform stages: every op but K7's
_SERVER_TILED_OPS = ("rescale", "mul_pt_rescale", "mul_ct", "rotate",
                     "hoisted")
_SERVER_DEFAULT_GEO = (-1, -1, -1, 0)
# forced geometries at N = 2^6: several tiles per pass, an uneven a != b
# split with one column a tile and the chunk tiles in bit-reversed order,
# a = 1 (one-stage column lines), b = 1 (one-stage chunk lines), a single
# pass at an uneven split
_SERVER_GEOS = ((3, 1, 1, 0), (2, 0, 1, 1), (1, 2, 1, 0), (5, 1, 2, 1),
                (2, 4, 2, 0))


@functools.lru_cache(maxsize=None)
def _server_inputs(profile, level) -> dict:
    """Random words of the right ranges (the kernels' words do not depend on
    the keys being real keys): B=2 ciphertexts, an (l, N) plaintext,
    (l, l+1, N) keys, the r=3 Galois permutation."""
    ctx = get_context(profile)
    n, batch = ctx.n, 2
    sc = server_eval.server_consts(ctx, level)
    qs = [int(sc.table[i, common.OFF_Q]) for i in range(level + 1)]
    rng = np.random.default_rng(level)
    a0, a1, b0, b1 = (_words(rng, qs[:level], (batch, level, n))
                      for _ in range(4))
    pt = _words(rng, qs[:level], (level, n))
    kb, ka = (_words(rng, qs, (level, level + 1, n)) for _ in range(2))
    perm = skeys.galois_perm_ntt(skeys.galois_element(3, n), n
                                 ).reshape(1, n)
    return {"ctx": ctx, "sc": sc, "batch": batch, "a0": a0, "a1": a1,
            "b0": b0, "b1": b1, "pt": pt, "kb": kb, "ka": ka, "perm": perm,
            "table": np.ascontiguousarray(sc.table)}


@functools.lru_cache(maxsize=None)
def _server_plain(profile, level, op, datapath) -> tuple:
    """The plain version's words of one server op on _server_inputs, under
    `datapath`'s REDC engine (uint32 or u64); for "hoisted" K11a's digit
    stack, then K11b's pair, checked equal to the fused rotation's."""
    x = _server_inputs(profile, level)
    ctx = x["ctx"]
    ta0, ta1, tb0, tb1, tpt = (_t(x[k]) for k in ("a0", "a1", "b0", "b1",
                                                  "pt"))
    tkb, tka, tperm = _t(x["kb"]), _t(x["ka"]), torch.tensor(x["perm"])
    dp = {"datapath": datapath}
    if op in ("add_ct", "add_pt", "mul_pt"):
        args = ((ta0, ta1, tb0, tb1) if op == "add_ct" else (ta0, ta1, tpt))
        want = getattr(server_eval, op + "_plain")(
            *args, ctx, **(dp if op == "mul_pt" else {}))
    elif op in ("rescale", "mul_pt_rescale"):
        args = (ta0, ta1) if op == "rescale" else (ta0, ta1, tpt)
        want = getattr(server_eval, op + "_plain")(*args, ctx, **dp)
    elif op == "mul_ct":
        want = server_eval.mul_ct_relin_plain(ta0, ta1, tb0, tb1, tkb, tka,
                                              ctx, **dp)
    elif op == "rotate":
        want = server_eval.rotate_plain(ta0, ta1, tperm, tkb, tka, ctx, **dp)
    else:                                   # hoisted: K11a then K11b
        h = server_eval.ks_decompose_plain(ta1, ctx)
        pair = server_eval.ks_apply_rot_plain(ta0, h, tperm, tkb, tka, ctx,
                                              **dp)
        rot = server_eval.rotate_plain(ta0, ta1, tperm, tkb, tka, ctx, **dp)
        for a, b in zip(pair, rot):           # hoisted == fused
            assert torch.equal(a, b)
        want = (h, *pair)
    return tuple(t.numpy().view(np.uint32) for t in want)


def _server_host(host_libs, profile, level, op, geo) -> tuple:
    """The host build's words of one server op on _server_inputs, the
    transform stages under the tile geometry `geo` (a, lc, lr, brev)."""
    x = _server_inputs(profile, level)
    sc, batch, n = x["sc"], x["batch"], x["ctx"].n
    a0, a1, b0, b1, pt, kb, ka, perm, table = (
        x[k] for k in ("a0", "a1", "b0", "b1", "pt", "kb", "ka", "perm",
                       "table"))
    geo_args = (batch, level, sc.kc.logn, sc.ncols)
    o0, o1 = _zeros(batch, level, n), _zeros(batch, level, n)
    r0, r1 = _zeros(batch, level - 1, n), _zeros(batch, level - 1, n)
    tw = _zeros(2, level + 1, n)
    w = np.zeros((batch, 2, n), np.int32)
    digits = np.zeros((batch, level, n), np.int32)
    h = _zeros(batch, level + 1, level, n)
    acc = _zeros(batch, 2, level + 1, n)
    fn = {k.replace("server_", "").replace("_host", ""): v
          for k, v in host_libs.items() if k.startswith("server_")}

    if op in ("add_ct", "add_pt", "mul_pt"):
        assert geo == _SERVER_DEFAULT_GEO
        mode = _SERVER_OPS.index(op)
        err = fn["pointwise"](mode, _ptr(a0), _ptr(a1),
                              _ptr(b0 if mode == 0 else pt),
                              _ptr(b1 if mode == 0 else pt), _ptr(table),
                              _ptr(o0), _ptr(o1), *geo_args)
        got = (o0, o1)
    elif op in ("rescale", "mul_pt_rescale"):
        pm = pt if op == "mul_pt_rescale" else None
        err = fn["rescale"](_ptr(a0), _ptr(a1),
                            None if pm is None else _ptr(pm), _ptr(table),
                            _ptr(tw), _ptr(w), _ptr(r0), _ptr(r1), *geo_args,
                            sc.off_qdinv, *geo)
        got = (r0, r1)
    elif op == "mul_ct":
        d = [_zeros(batch, level, n) for _ in range(5)]
        err = fn["mul_ct"](_ptr(a0), _ptr(a1), _ptr(b0), _ptr(b1),
                           _ptr(kb), _ptr(ka), _ptr(table), _ptr(tw),
                           *(_ptr(t) for t in d[:3]), _ptr(digits), _ptr(h),
                           _ptr(acc), _ptr(w), _ptr(d[3]), _ptr(d[4]),
                           _ptr(r0), _ptr(r1), *geo_args, sc.off_r2,
                           sc.off_pinv, sc.off_qdinv, *geo)
        got = (r0, r1)
    elif op == "rotate":
        err = fn["rotate"](_ptr(a0), _ptr(a1), _ptr(perm), _ptr(kb),
                           _ptr(ka), _ptr(table), _ptr(tw), _ptr(digits),
                           _ptr(h), _ptr(acc), _ptr(w), _ptr(o0), _ptr(o1),
                           *geo_args, sc.off_pinv, *geo)
        got = (o0, o1)
    else:                                   # hoisted: K11a then K11b
        err = fn["ks_decompose"](_ptr(a1), _ptr(table), _ptr(tw),
                                 _ptr(digits), _ptr(h), *geo_args, *geo)
        assert err == 0
        err = fn["ks_apply_rot"](_ptr(a0), _ptr(h), _ptr(perm),
                                 _ptr(kb), _ptr(ka), _ptr(table), _ptr(tw),
                                 _ptr(acc), _ptr(w), _ptr(o0), _ptr(o1),
                                 *geo_args, sc.off_pinv, *geo)
        got = (h, o0, o1)
    assert err == 0
    return got


def _server_op_host(host_libs, profile, level, op, datapath,
                    geo=_SERVER_DEFAULT_GEO):
    """One server body of the host build and its plain version on
    `datapath` (the plain REDC engine: uint32 or u64) on _server_inputs.
    Returns (host words, plain words)."""
    return (_server_host(host_libs, profile, level, op, geo),
            _server_plain(profile, level, op, datapath))


@pytest.mark.parametrize("op", _SERVER_OPS)
@pytest.mark.parametrize("profile,level", [("tiny", 3), ("tinyboot", 6)])
def test_host_server_ops_match_plain(host_libs, profile, level, op):
    """Each server body against its plain version on the df32 datapath
    (the uint32 REDC)."""
    got, want = _server_op_host(host_libs, profile, level, op, "df32")
    for g, wnt in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, wnt)


@pytest.mark.parametrize("op", _SERVER_OPS)
@pytest.mark.parametrize("profile,level", [("tiny", 3), ("tinyboot", 6)])
def test_host_server_ops_match_plain_f64(host_libs, profile, level, op):
    """Each server body against its plain version on the f64 datapath (the
    u64 REDC): the one body gives the words of both."""
    got, want = _server_op_host(host_libs, profile, level, op, "f64")
    for g, wnt in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, wnt)


@pytest.mark.parametrize("datapath", ["df32", "f64"])
@pytest.mark.parametrize("geo", _SERVER_GEOS,
                         ids=["-".join(map(str, g)) for g in _SERVER_GEOS])
@pytest.mark.parametrize("op", _SERVER_TILED_OPS)
@pytest.mark.parametrize("profile,level", [("tiny", 3), ("tinyboot", 6)])
def test_host_server_ops_forced_geometry_match_plain(host_libs, profile,
                                                     level, op, geo,
                                                     datapath):
    """K8, K8b, K9, K10 and K11a + K11b with their transform stages (the
    lift's INTT, the base extension's and the scale-down's NTTs) under a
    forced tile geometry (a, lc, lr, brev) against the plain versions on
    both REDC engines; hoisted == fused is checked on the plain side."""
    got, want = _server_op_host(host_libs, profile, level, op, datapath, geo)
    for g, wnt in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, wnt)


# ---------------------------------------------------------------------------
# the per-prime kernels: K12 (ntt_rows.cu), K13 (client_pointwise.cu) and
# K14 (ntt_matmul.cu) against their plain versions
# ---------------------------------------------------------------------------


def _k12_host(host_libs, plan, x, inverse, geo=(-1, -1, -1, 0)):
    """The host build of K12 (ntt_rows.cu: a stage of the tiled NTT block
    under the shift-add REDC) on (rows, N) uint32 words of one prime, under
    NTT geometry (a, lc, lr, brev)."""
    kc = common.stacked_kernel_consts([plan])
    out, tw_heap = np.zeros_like(x), np.zeros((1, kc.n), np.uint32)
    err = host_libs["ntt_rows_host"](
        _ptr(x), _ptr(out), _ptr(np.ascontiguousarray(kc.table)),
        _ptr(np.ascontiguousarray(common.sa_table([plan]))), _ptr(tw_heap),
        x.shape[0], kc.logn, int(inverse), *geo)
    assert err == 0
    return out


def _k13a_host(host_libs, ctx, limb, pt_l, b_l, a_l, seed, nonce0,
               geo=(-1, -1, -1)):
    """(c0, c1) of the host build of K13a (client_pointwise.cu: K2's tiled
    encrypt on one limb under the shift-add REDC) on a (B, N) uint32
    plaintext of limb `limb`, key rows b_l / a_l (N,), under NTT geometry
    (a, lc, lr)."""
    plan = ctx.plans[limb]
    kc = common.stacked_kernel_consts([plan])
    batch, n = pt_l.shape
    c0, c1, v = (_zeros(batch, n) for _ in range(3))
    tw_heap, noise = _zeros(1, n), np.zeros((batch, 3, n), np.int8)
    err = host_libs["encrypt_limb_host"](
        _ptr(pt_l), *(_ptr(np.ascontiguousarray(k)) for k in (b_l, a_l)),
        _ptr(np.ascontiguousarray(kc.table)),
        _ptr(np.ascontiguousarray(common.sa_table([plan]))), _ptr(c0),
        _ptr(c1), _ptr(v), _ptr(tw_heap), _ptr(noise), batch, kc.logn,
        *prng.seed_words(seed), nonce0, *geo)
    assert err == 0
    return c0, c1


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("profile", ["tiny", "test"])
def test_host_ntt_rows_match_plain(host_libs, profile, inverse):
    """K12 (the tiled stage under the shift-add REDC), every limb's prime;
    its words also equal K1's (the same transform under the general
    REDC)."""
    ctx = get_context(profile)
    n, rows = ctx.n, 3
    rng = np.random.default_rng(9)
    x = _rand_residues(ctx, (ctx.params.n_limbs, rows, n), rng)
    k1 = ntt_butterfly.limb_rows_plain(_t(x), ctx.plans, inverse)
    for limb, plan in enumerate(ctx.plans):
        xl = np.ascontiguousarray(x[limb])
        want = ntt_butterfly.rows_plain(_t(xl), plan, inverse)
        out = _k12_host(host_libs, plan, xl, inverse)
        np.testing.assert_array_equal(out, want.numpy().view(np.uint32))
        np.testing.assert_array_equal(out, k1[limb].numpy().view(np.uint32))


def _k13b_host(host_libs, plan, c0, c1, s_mont, geo=(-1, -1, -1, 0)):
    """The host build of K13b (client_pointwise.cu: K3's INTT stage on one
    limb under the shift-add REDC) on (B, N) uint32 words of one prime and
    its (N,) key row, under NTT geometry (a, lc, lr, brev)."""
    kc = common.stacked_kernel_consts([plan])
    batch, n = c0.shape
    m, tw_heap = _zeros(batch, n), _zeros(1, n)
    err = host_libs["decrypt_limb_host"](
        *(_ptr(np.ascontiguousarray(a)) for a in (c0, c1, s_mont)),
        _ptr(np.ascontiguousarray(kc.table)),
        _ptr(np.ascontiguousarray(common.sa_table([plan]))), _ptr(m),
        _ptr(tw_heap), batch, kc.logn, *geo)
    assert err == 0
    return m


@pytest.mark.parametrize("profile,batch,nonce0", [
    ("tiny", 3, 0xFFFFFFFE), ("test", 2, 9)])
def test_host_encrypt_decrypt_limb_match_plain(host_libs, profile, batch,
                                               nonce0):
    """K13a / K13b on every limb against their plain versions."""
    client = FHEClient(profile, seed=0xC0FFEE, device="cpu")
    ctx = client.ctx
    n = ctx.n
    rng = np.random.default_rng(10)
    pt = _rand_residues(ctx, (batch, ctx.params.n_limbs, n), rng)
    keys = [client.keys.pk.b_mont, client.keys.pk.a_mont,
            client.keys.sk.s_mont]
    b_np, a_np, s_np = (k.numpy().view(np.uint32) for k in keys)
    for limb, plan in enumerate(ctx.plans):
        ptl = np.ascontiguousarray(pt[:, limb])
        w0, w1 = client_pointwise.encrypt_limb_plain(
            _t(ptl), keys[0][limb], keys[1][limb], ctx, limb, client.seed,
            nonce0)
        c0, c1 = _k13a_host(host_libs, ctx, limb, ptl, b_np[limb],
                            a_np[limb], client.seed, nonce0)
        np.testing.assert_array_equal(c0, w0.numpy().view(np.uint32))
        np.testing.assert_array_equal(c1, w1.numpy().view(np.uint32))
        want = client_pointwise.decrypt_limb_plain(w0, w1, keys[2][limb],
                                                   ctx, limb)
        m = _k13b_host(host_libs, plan, c0, c1, s_np[limb])
        np.testing.assert_array_equal(m, want.numpy().view(np.uint32))


# K12 / K13a by case: (profile, batch, NTT geometry (a, lc, lr, brev); K13a
# takes (a, lc, lr)). The default plan is one pass at `tiny` and `test`, two
# at `n15` (an uneven 2^8 x 2^7 split); forced splits at `test`, one with
# the chunk tiles in bit-reversed order.
_PER_PRIME_CASES = {
    "tiny-B3": ("tiny", 3, (-1, -1, -1, 0)),
    "test-B1-3+7": ("test", 1, (3, 2, 1, 0)),
    "test-B3-7+3-brev": ("test", 3, (7, 1, 2, 1)),
    "n15-B1": ("n15", 1, (-1, -1, -1, 0)),
    "n15-B3-6+9": ("n15", 3, (6, 5, 3, 0)),
}


def _case_limbs(ctx) -> list:
    """Every limb at `tiny` / `test`; the first and the last at `n15`."""
    L = ctx.params.n_limbs
    return list(range(L)) if ctx.n <= 1024 else [0, L - 1]


@pytest.mark.parametrize("case", list(_PER_PRIME_CASES))
def test_host_ntt_rows_forced_geometry_matches_plain(host_libs, case):
    """K12 both ways under forced geometries and its default plan (one pass,
    two at an odd log N), B = 1 and 3, on random residues of each limb's
    prime: the plain versions' words and K1's (ntt_limbs_host) on that
    limb; the inverse returns x."""
    profile, rows, geo = _PER_PRIME_CASES[case]
    ctx = get_context(profile)
    L, n = ctx.params.n_limbs, ctx.n
    x = _rand_residues(ctx, (rows, L, n), np.random.default_rng(15))
    x = np.ascontiguousarray(x.transpose(1, 0, 2))            # (L, B, N)
    k1 = _k1_host(host_libs, ctx, x, False)
    k1_back = _k1_host(host_libs, ctx, k1, True)
    for limb in _case_limbs(ctx):
        plan = ctx.plans[limb]
        fwd = _k12_host(host_libs, plan, x[limb], False, geo)
        want = ntt_butterfly.rows_plain(_t(x[limb]), plan, False)
        np.testing.assert_array_equal(fwd, want.numpy().view(np.uint32))
        np.testing.assert_array_equal(fwd, k1[limb])
        back = _k12_host(host_libs, plan, fwd, True, geo)
        want = ntt_butterfly.rows_plain(_t(fwd), plan, True)
        np.testing.assert_array_equal(back, want.numpy().view(np.uint32))
        np.testing.assert_array_equal(back, k1_back[limb])
        np.testing.assert_array_equal(back, x[limb])


@pytest.mark.parametrize("case", list(_PER_PRIME_CASES))
def test_host_encrypt_limb_forced_geometry_matches_plain(host_libs, case):
    """K13a under forced geometries and its default plan, B = 1 and 3,
    nonce0 = 2^32 - 2 (the nonce wraps inside a batch of 3), random key
    rows: the plain version's words and K2's (encrypt_limbs_host) on that
    limb."""
    profile, batch, geo = _PER_PRIME_CASES[case]
    ctx = get_context(profile)
    L, n = ctx.params.n_limbs, ctx.n
    seed, nonce0 = 0xC0FFEE, 0xFFFFFFFE
    rng = np.random.default_rng(16)
    pt = _rand_residues(ctx, (batch, L, n), rng)
    pk = [_rand_residues(ctx, (L, n), rng) for _ in range(2)]
    k2 = _k2_host_keys(host_libs, ctx, pk, seed, pt, nonce0)
    for limb in _case_limbs(ctx):
        ptl = np.ascontiguousarray(pt[:, limb])
        c0, c1 = _k13a_host(host_libs, ctx, limb, ptl, pk[0][limb],
                            pk[1][limb], seed, nonce0, geo[:3])
        w0, w1 = client_pointwise.encrypt_limb_plain(
            _t(ptl), _t(pk[0][limb]), _t(pk[1][limb]), ctx, limb, seed,
            nonce0)
        np.testing.assert_array_equal(c0, w0.numpy().view(np.uint32))
        np.testing.assert_array_equal(c1, w1.numpy().view(np.uint32))
        np.testing.assert_array_equal(c0, k2[0][:, limb])
        np.testing.assert_array_equal(c1, k2[1][:, limb])


@pytest.mark.parametrize("case", list(_PER_PRIME_CASES))
def test_host_decrypt_limb_forced_geometry_matches_plain(host_libs, case):
    """K13b under forced geometries and its default plan (one pass at
    `tiny`, two forced splits at `test`, two passes at `n15` B=1 and B=3)
    on random words of each limb: the plain version's words and K3's
    (decrypt_limbs_host) on that limb."""
    profile, batch, geo = _PER_PRIME_CASES[case]
    ctx = get_context(profile)
    L, n = ctx.params.n_limbs, ctx.n
    rng = np.random.default_rng(17)
    c0, c1 = (_rand_residues(ctx, (batch, L, n), rng) for _ in range(2))
    s_mont = _rand_residues(ctx, (L, n), rng)
    k3 = _k3_host(host_libs, ctx, c0, c1, s_mont)
    for limb in _case_limbs(ctx):
        c0l, c1l = (np.ascontiguousarray(c[:, limb]) for c in (c0, c1))
        m = _k13b_host(host_libs, ctx.plans[limb], c0l, c1l, s_mont[limb],
                       geo)
        want = client_pointwise.decrypt_limb_plain(
            _t(c0l), _t(c1l), _t(s_mont[limb]), ctx, limb)
        np.testing.assert_array_equal(m, want.numpy().view(np.uint32))
        np.testing.assert_array_equal(m, k3[:, limb])


def _k14_host(host_libs, plans, x, inverse, ksw=0):
    """The host build of K14 (ntt_matmul.cu) on an (L, rows, N) uint32 stack,
    limb l of plans[l]'s prime; ksw forces the table slice's packed words
    (8 or 16; 0: the CUDA entry's plan)."""
    L, rows, n = x.shape
    consts, fa, fb = (t.numpy() for t in ntt_matmul._device_tables(
        tuple(p.prime for p in plans), n, inverse, "cpu"))
    n1, n2 = ntt_matmul.split_n(n)
    out, y = np.zeros_like(x), np.zeros_like(x)
    tab = _zeros(L, 2 * n)
    assert host_libs["ntt_mm_pow_table_host"](
        _ptr(tab), _ptr(consts), L, n.bit_length() - 1, consts.shape[1]) == 0
    err = host_libs["ntt_mm_host"](
        _ptr(x), _ptr(out), _ptr(y), _ptr(tab), _ptr(fa), _ptr(fb),
        _ptr(consts), L, rows, n1.bit_length() - 1, n2.bit_length() - 1,
        consts.shape[1], int(inverse), ksw)
    assert err == 0
    return out


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("profile,n", [("tiny", 64), ("test", 1024),
                                       ("test", 512)],
                         ids=["tiny-8x8", "test-32x32", "test-n512-32x16"])
def test_host_ntt_mm_matches_plain(host_libs, profile, n, inverse):
    """K14 on an (L, 3, N) stack of the profile's primes: the pow table, the
    digit split, the mma tiles and the weight combination, square and
    non-square (N = 512: 32 x 16) splits."""
    ctx = get_context(profile)
    plans = [make_plan(p.prime, n) for p in ctx.plans]
    L, rows = len(plans), 3
    rng = np.random.default_rng(n)
    x = _rand_residues(ctx, (rows, L, n), rng).transpose(1, 0, 2).copy()
    want = ntt_matmul.limb_rows_mm_plain(_t(x), plans, inverse)
    out = _k14_host(host_libs, plans, x, inverse)
    np.testing.assert_array_equal(out, want.numpy().view(np.uint32))


def _bitrev(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    return np.array([int(format(i, f"0{logn}b")[::-1], 2) for i in range(n)])


# K14 by case: (profile, N, rows, forced table-slice words). K < 32 at
# `tiny` (8 x 8: zero-padded k, a strip of 8 of a block's 64 rows, an
# n-tile of 8 of 32 columns), 32 x 32 and 32 x 16 at `test`, one row of
# `n15` (256 x 128: K = 128 then 256, several strips, n-tiles and
# k-slices), also under the short slice
_K14_CASES = {
    "tiny-B3": ("tiny", 64, 3, 0),
    "test-B2": ("test", 1024, 2, 0),
    "test-n512-B2": ("test", 512, 2, 0),
    "n15-B1": ("n15", 1 << 15, 1, 0),
    "n15-B1-ksw8": ("n15", 1 << 15, 1, 8),
}


@pytest.mark.parametrize("case", list(_K14_CASES))
def test_host_ntt_mm_forced_geometry_matches_plain(host_libs, case):
    """K14 both ways on ragged and forced tiles (every limb at `tiny` /
    `test`, the first and the last at `n15`): the plain versions' words,
    K1's (ntt_limbs_host) under bit reversal, and the round trip."""
    profile, n, rows, ksw = _K14_CASES[case]
    ctx = get_context(profile)
    plans = [make_plan(ctx.plans[l].prime, n) for l in _case_limbs(ctx)]
    rng = np.random.default_rng(18)
    q = np.asarray([p.prime.q for p in plans], np.uint64)[:, None, None]
    x = (rng.integers(0, 1 << 32, (len(plans), rows, n), dtype=np.uint64)
         % q).astype(np.uint32)
    kc = common.stacked_kernel_consts(plans)
    k1, tw_heap = np.zeros_like(x), _zeros(len(plans), n)
    assert host_libs["ntt_limbs_host"](
        _ptr(x), _ptr(k1), _ptr(np.ascontiguousarray(kc.table)),
        _ptr(tw_heap), len(plans), rows, kc.logn, kc.n_scalars, 0,
        -1, -1, -1, 0) == 0
    fwd = _k14_host(host_libs, plans, x, False, ksw)
    want = ntt_matmul.limb_rows_mm_plain(_t(x), plans, False)
    np.testing.assert_array_equal(fwd, want.numpy().view(np.uint32))
    np.testing.assert_array_equal(fwd, k1[..., _bitrev(n)])
    back = _k14_host(host_libs, plans, fwd, True, ksw)
    want = ntt_matmul.limb_rows_mm_plain(_t(fwd), plans, True)
    np.testing.assert_array_equal(back, want.numpy().view(np.uint32))
    np.testing.assert_array_equal(back, x)


def test_mma_fragment_maps_match_ptx_isa(host_libs):
    """K14's fragment maps against the PTX ISA's element tables of
    mma.m16n8k32 with .s8 operands (groupID g = lane >> 2, threadID t =
    lane % 4): A element i of 16 (register i // 4, byte i % 4) at row g
    for i < 4 or 8 <= i < 12, else g + 8, column 4t + (i & 3) + 16 (i >=
    8); B element i of 8 at row 4t + (i & 3) + 16 (i >= 4), column g; C
    element i of 4 at row g + 8 (i >= 2), column 2t + (i & 1)."""
    maps = np.zeros((32, 20), np.int32)
    assert host_libs["ntt_mm_frag_maps_host"](_ptr(maps)) == 0
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        a_rc = {}
        for i in range(16):
            row = g if i < 4 or 8 <= i < 12 else g + 8
            col = 4 * t + (i & 3) + (16 if i >= 8 else 0)
            assert col % 4 == i % 4
            a_rc.setdefault(i // 4, set()).add((row, col // 4))
        b_rc = {}
        for i in range(8):
            k = 4 * t + (i & 3) + (16 if i >= 4 else 0)
            assert k % 4 == i % 4
            b_rc.setdefault(i // 4, set()).add((g, k // 4))
        m = maps[lane]
        for r in range(4):
            assert a_rc[r] == {(m[2 * r], m[2 * r + 1])}, (lane, r)
            row = g + 8 if r >= 2 else g
            assert (m[12 + 2 * r], m[13 + 2 * r]) == (row, 2 * t + (r & 1))
        for r in range(2):
            assert b_rc[r] == {(m[8 + 2 * r], m[9 + 2 * r])}, (lane, r)
