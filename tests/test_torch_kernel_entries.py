"""The kernel modules' entries under the reference's names, on the CPU.

Each of the 15 routed entries (``client_stream.encode_encrypt_stream`` /
``decrypt_decode_stream``, ``client_pointwise.encrypt_limbs`` /
``decrypt_limbs``, ``ntt_butterfly.ntt_limb_rows`` / ``intt_limb_rows`` and
the nine ``server_eval`` ops) is called as the reference's kernel module is
called, positional arguments in its order and its defaults ('f64' where it
takes a datapath), on CPU tensors, and must give the words of its
``_plain`` version: the client ones at ``tiny`` B=2 on a client's real
operands, the server ones at ``server`` level 4 B=1 on random words of the
right ranges. On CUDA tensors the same entries launch the kernels; the
chip run holds them there. ``ref.fourstep_permutation`` and
``PlanConsts.seed_scalar_count`` equal the reference's.
"""

import numpy as np
import pytest
import torch

from repro.kernels import common as ref_common
from repro.kernels import ref as ref_ref
from repro_torch.core.context import get_context
from repro_torch.fhe_client.client import FHEClient
from repro_torch.fhe_server import keys as skeys
from repro_torch.kernels import (client_pointwise, client_stream, common,
                                 ntt_butterfly, ops, ref, server_eval)

BATCH = 2
SERVER_LEVEL = 4
NONCE0 = 77


def _words(rng, qs, shape):
    """(..., rows, N) int32 words, row r below qs[r]."""
    q = np.asarray(qs[:shape[-2]], np.uint64).reshape(-1, 1)
    w = (rng.integers(0, 1 << 32, shape, dtype=np.uint64) % q).astype(
        np.uint32)
    return torch.from_numpy(w.view(np.int32))


@pytest.fixture(scope="module")
def calls():
    """{entry: (routed call, plain call)} on CPU operands."""
    client = FHEClient("tiny", device="cpu")
    ctx, p = client.ctx, client.ctx.params
    pkb, pka = client.keys.pk.b_mont, client.keys.pk.a_mont
    s_mont = client.keys.sk.s_mont
    rng = np.random.default_rng(3)
    msgs = (rng.uniform(-1, 1, (BATCH, p.n_slots))
            + 1j * rng.uniform(-1, 1, (BATCH, p.n_slots)))
    planes = client.encrypt_operands(msgs)
    c0, c1 = client_stream.encode_encrypt_stream_plain(
        planes, pkb, pka, ctx, client.seed, NONCE0, "df32")
    scale = torch.full((BATCH,), p.delta, dtype=torch.float64)
    pt = _words(rng, ctx.q_list, (BATCH, p.n_limbs, p.n))
    x = _words(rng, ctx.q_list, (p.n_limbs, 3, p.n))
    plans = ctx.plans[:p.n_limbs]
    cs, cp = client_stream, client_pointwise
    out = {
        "encode_encrypt_stream": (
            lambda: cs.encode_encrypt_stream(planes, pkb, pka, ctx,
                                             client.seed, NONCE0),
            lambda: cs.encode_encrypt_stream_plain(planes, pkb, pka, ctx,
                                                   client.seed, NONCE0,
                                                   "f64")),
        "decrypt_decode_stream": (
            lambda: cs.decrypt_decode_stream(c0[:, :2], c1[:, :2], s_mont,
                                             ctx, scale),
            lambda: cs.decrypt_decode_stream_plain(c0[:, :2], c1[:, :2],
                                                   s_mont, ctx, scale,
                                                   "f64")),
        "encrypt_limbs": (
            lambda: cp.encrypt_limbs(pt, pkb, pka, ctx, client.seed),
            lambda: cp.encrypt_limbs_plain(pt, pkb, pka, ctx, client.seed,
                                           0)),
        "decrypt_limbs": (
            lambda: cp.decrypt_limbs(c0, c1, s_mont, ctx),
            lambda: cp.decrypt_limbs_plain(c0, c1, s_mont, ctx)),
        "ntt_limb_rows": (
            lambda: ntt_butterfly.ntt_limb_rows(x, plans),
            lambda: ntt_butterfly.limb_rows_plain(x, plans, False)),
        "intt_limb_rows": (
            lambda: ntt_butterfly.intt_limb_rows(x, plans),
            lambda: ntt_butterfly.limb_rows_plain(x, plans, True)),
    }
    sctx = get_context("server")
    n, lv = sctx.n, SERVER_LEVEL
    qs = server_eval.server_consts(sctx, lv).table[:, common.OFF_Q]
    o = {k: _words(rng, qs, (1, lv, n)) for k in ("a0", "a1", "b0", "b1")}
    o["pt"], o["pm"] = _words(rng, qs, (lv, n)), _words(rng, qs, (lv, n))
    for k in ("kb", "ka"):
        o[k] = _words(rng, qs, (lv, lv + 1, n))
    o["perm"] = torch.from_numpy(skeys.galois_perm_ntt(
        skeys.galois_element(5, n), n).reshape(1, n))
    o["h"] = server_eval.ks_decompose_plain(o["a1"], sctx)
    se = server_eval
    a0, a1, b0, b1, kb, ka, perm = (o[k] for k in (
        "a0", "a1", "b0", "b1", "kb", "ka", "perm"))
    out.update({
        "add_ct": (lambda: se.add_ct(a0, a1, b0, b1, sctx),
                   lambda: se.add_ct_plain(a0, a1, b0, b1, sctx)),
        "add_pt": (lambda: se.add_pt(a0, a1, o["pt"], sctx),
                   lambda: se.add_pt_plain(a0, a1, o["pt"], sctx)),
        "mul_pt": (lambda: se.mul_pt(a0, a1, o["pm"], sctx),
                   lambda: se.mul_pt_plain(a0, a1, o["pm"], sctx, "f64")),
        "rescale": (lambda: se.rescale(a0, a1, sctx),
                    lambda: se.rescale_plain(a0, a1, sctx, "f64")),
        "mul_pt_rescale": (
            lambda: se.mul_pt_rescale(a0, a1, o["pm"], sctx),
            lambda: se.mul_pt_rescale_plain(a0, a1, o["pm"], sctx, "f64")),
        "mul_ct_relin": (
            lambda: se.mul_ct_relin(a0, a1, b0, b1, kb, ka, sctx),
            lambda: se.mul_ct_relin_plain(a0, a1, b0, b1, kb, ka, sctx,
                                          "f64")),
        "rotate": (lambda: se.rotate(a0, a1, perm, kb, ka, sctx),
                   lambda: se.rotate_plain(a0, a1, perm, kb, ka, sctx,
                                           "f64")),
        "ks_decompose": (lambda: se.ks_decompose(a1, sctx),
                         lambda: se.ks_decompose_plain(a1, sctx)),
        "ks_apply_rot": (
            lambda: se.ks_apply_rot(a0, o["h"], perm, kb, ka, sctx),
            lambda: se.ks_apply_rot_plain(a0, o["h"], perm, kb, ka, sctx,
                                          "f64")),
    })
    return out


ENTRIES = ("encode_encrypt_stream", "decrypt_decode_stream", "encrypt_limbs",
           "decrypt_limbs", "ntt_limb_rows", "intt_limb_rows", "add_ct",
           "add_pt", "mul_pt", "rescale", "mul_pt_rescale", "mul_ct_relin",
           "rotate", "ks_decompose", "ks_apply_rot")


def _tensors(r):
    return list(r) if isinstance(r, (tuple, list)) else [r]


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_equals_plain_on_cpu(calls, name):
    """The routed entry on CPU tensors == its plain version, word for
    word, and launches no kernel."""
    entry, plain = calls[name]
    ops.reset_launches()
    got, want = _tensors(entry()), _tensors(plain())
    assert not any(ops.launches().values())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == w.dtype
        assert torch.equal(g, w)


DATAPATH_ENTRIES = {
    "mul_pt": lambda c, x, pt, ctx, dp: server_eval.mul_pt(c, x, pt, ctx, dp),
    "rescale": lambda c, x, pt, ctx, dp: server_eval.rescale(c, x, ctx, dp),
    "mul_pt_rescale": lambda c, x, pt, ctx, dp: server_eval.mul_pt_rescale(
        c, x, pt, ctx, dp),
}


@pytest.mark.parametrize("name", sorted(DATAPATH_ENTRIES))
def test_server_entries_refuse_unknown_datapath(name):
    """``check_datapath`` runs on the entries' CPU route too."""
    ctx = get_context("server")
    c = torch.zeros((1, SERVER_LEVEL, ctx.n), dtype=torch.int32)
    pt = torch.zeros((SERVER_LEVEL, ctx.n), dtype=torch.int32)
    with pytest.raises(ValueError, match="datapath"):
        DATAPATH_ENTRIES[name](c, c, pt, ctx, "f32")


def test_ops_server_entries_call_the_routed_ones():
    """``ops.server_mul_pt`` (with and without the fused rescale) gives the
    routed entries' words."""
    sctx = get_context("server")
    rng = np.random.default_rng(8)
    qs = server_eval.server_consts(sctx, SERVER_LEVEL).table[:, common.OFF_Q]
    c0, c1 = (_words(rng, qs, (1, SERVER_LEVEL, sctx.n)) for _ in range(2))
    pm = _words(rng, qs, (SERVER_LEVEL, sctx.n))
    for rescale, entry in ((False, server_eval.mul_pt),
                           (True, server_eval.mul_pt_rescale)):
        got = ops.server_mul_pt(c0, c1, pm, sctx, "df32", rescale)
        want = entry(c0, c1, pm, sctx, "df32")
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n,n1", [(64, 8), (1024, 32), (1024, 16),
                                  (1 << 16, 256)])
def test_fourstep_permutation_equals_reference(n, n1):
    got = ref.fourstep_permutation(n, n1)
    want = ref_ref.fourstep_permutation(n, n1)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, np.arange(n))


@pytest.mark.parametrize("profile", ["tiny", "test", "server", "paper"])
def test_seed_scalar_count_equals_reference(profile):
    from repro.core.context import get_context as ref_get_context
    ctx, rctx = get_context(profile), ref_get_context(profile)
    got = [common.plan_consts(p).seed_scalar_count() for p in ctx.plans]
    want = [ref_common.plan_consts(p).seed_scalar_count()
            for p in rctx.plans]
    assert got == want
