"""The port's server-side CKKS op set, evaluation keys, f64 staged client
and encrypted-inference flow against the JAX package, bit for bit.

The JAX reference runs ONCE per session, in one subprocess under
``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (no FMA contraction; see
``test_torch_slice.py``), with the JAX ``ServerEvaluator`` in interpret
mode as its own tests run it. Interpret mode compiles each op once per
(op, level), so every op check runs at a level the flow also runs and
reuses the flow's compiles. At ``tinyboot`` (8 limbs, Delta=2^30), from
the staged f64 client of seed ``SEED``:

  * the encrypted linear + poly3 flow, d=4, level 6: its input and output
    ciphertexts, level, scale and the slots the client decodes from it;
  * evaluation keys for the flow's rotations (1, 2, 3), rotation 5 and
    relinearization; the key sets of ``KEY_OPTIONS`` (no relinearization
    key, a seed other than the profile's) and their wire bytes; a second
    fresh ciphertext and its f64 decrypt; two encoded plaintexts;
  * the outputs of add_ct, add_pt, mul_pt (raw and with its fused rescale),
    rescale, mul_ct and hoisted_rotations (1, 2, 5), each at the level
    ``OP_LEVEL`` names. The reference pins hoisted == fused rotation bit
    for bit, so the port's fused ``rotate`` is held against the hoisted
    words.

The port runs the same seeds and nonce bases on the CPU (every kernel its
plain PyTorch version). Tolerance: 0 differing words for every key,
ciphertext and op output; 0 differing bits for the decoded float64 slots.
"""

import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.fhe_client.client import (FHEClient,
                                           evaluation_keys_from_numpy,
                                           server_plaintext_from_numpy)
from repro_torch.fhe_server import encoding
from repro_torch.fhe_server import inference as inf
from repro_torch.fhe_server import keys as skeys
from repro_torch.fhe_server.ct import ServerCiphertext
from repro_torch.fhe_server.eval_ops import ServerEvaluator
from repro_torch.kernels import ops, server_eval

SRC = str(Path(__file__).resolve().parents[1] / "src")

SEED = 0x5EED
ROTATIONS = (1, 2, 5)
NONCE = 3
DIM, LEVEL = 4, 6
KEY_ROTATIONS = tuple(sorted(set(inf.matvec_rotations(DIM)) | set(ROTATIONS)))
POLY = (0.1, 0.5, -0.2, 0.05)
# the level of each op check: one the flow runs the same op at
OP_LEVEL = {"add_ct": LEVEL, "add_pt": LEVEL - 1, "mul_pt": LEVEL - 1,
            "mul_pt_rescale": LEVEL - 1, "rescale": LEVEL,
            "mul_ct": LEVEL - 2}
PT_LEVEL = LEVEL - 1
# make_evaluation_keys' options, each held against the reference's keys
KEY_SEED = 0xBEEF
KEY_OPTIONS = {
    "norelin": {"rotations": (2,), "include_relin": False, "seed": KEY_SEED},
    "seeded": {"rotations": (), "seed": KEY_SEED},
}

_REF = r"""
import sys
import numpy as np
from repro.fhe_client.client import FHEClient
from repro.fhe_server import ServerCiphertext, ServerEvaluator, encode_plaintext
from repro.fhe_server import inference as inf

seed, nonce, dim, level, pt_level = (int(a) for a in sys.argv[1:6])
key_rots, rots, op_level = (eval(a) for a in sys.argv[6:9])
poly = tuple(float(v) for v in sys.argv[9].split(","))
out = sys.argv[10]
key_options = eval(sys.argv[11])
c = FHEClient("tinyboot", seed=seed, pipeline="staged", datapath="f64")
ctx = c.ctx
ns = ctx.params.n_slots
rng = np.random.default_rng(7)
xv = rng.standard_normal(dim) * 0.5
w = rng.standard_normal((dim, dim)) * 0.4
bias = rng.standard_normal(dim) * 0.3
zy = (rng.standard_normal(ns) + 1j * rng.standard_normal(ns)) * 0.5
pa_z = rng.standard_normal(ns) * 0.5
pm_z = rng.standard_normal(ns) * 0.5
c.nonce = nonce
xb = c.encode_encrypt_batch(inf.replicate_slots(xv, ns)[None])
yb = c.encode_encrypt_batch(zy[None])
keys = c.make_evaluation_keys(rotations=key_rots)
ev = ServerEvaluator(ctx, keys, datapath="df32")
x = ServerCiphertext.from_batch(xb).drop_to(level)
y = ServerCiphertext.from_batch(yb).drop_to(level)
flow = inf.encrypted_linear_poly3(ev, x, w, bias, poly)
pa = encode_plaintext(pa_z, ctx, pt_level, x.scale)
pm = encode_plaintext(pm_z, ctx, pt_level, float(ctx.q_list[pt_level - 1]))
d = {"xv": xv, "w": w, "bias": bias, "zy": zy, "pa_z": pa_z, "pm_z": pm_z,
     "x0": xb.c0, "x1": xb.c1, "v0": yb.c0, "v1": yb.c1,
     "flow_c0": flow.c0, "flow_c1": flow.c1, "flow_level": flow.level,
     "flow_scale": flow.scale,
     "flow_got": c.decrypt_batch(list(flow.to_batch())),
     "dec_v": c.decrypt_batch(list(ServerCiphertext.from_batch(yb).to_batch())),
     "pa_data": pa.data, "pa_mont": pa.data_mont, "pa_scale": pa.scale,
     "pm_data": pm.data, "pm_mont": pm.data_mont, "pm_scale": pm.scale,
     "relin_b": keys.relin.b_mont, "relin_a": keys.relin.a_mont,
     "special_q": keys.special_q}
for r in keys.rotations:
    d[f"rot{r}_b"], d[f"rot{r}_a"] = keys.rot[r].b_mont, keys.rot[r].a_mont
from repro.fhe_client.service import wire
for tag, kw in key_options.items():
    kk = c.make_evaluation_keys(**kw)
    d[tag + "_has_relin"] = kk.relin is not None
    d[tag + "_rotations"] = np.asarray(kk.rotations, np.int64)
    d[tag + "_wire"] = np.frombuffer(wire.serialize_evaluation_keys(kk),
                                     np.uint8)
    for name, ksk in [("relin", kk.relin)] + [(f"rot{r}", kk.rot[r])
                                               for r in kk.rotations]:
        if ksk is not None:
            d[f"{tag}_{name}_b"], d[f"{tag}_{name}_a"] = ksk.b_mont, ksk.a_mont
at = {n: (x.drop_to(l), y.drop_to(l)) for n, l in op_level.items()}
outs = {"add_ct": ev.add_ct(*at["add_ct"]),
        "add_pt": ev.add_pt(at["add_pt"][0], pa),
        "mul_pt": ev.mul_pt(at["mul_pt"][0], pm, rescale=False),
        "mul_pt_rescale": ev.mul_pt(at["mul_pt_rescale"][0], pm),
        "rescale": ev.rescale(at["rescale"][0]),
        "mul_ct": ev.mul_ct(*at["mul_ct"])}
for r, ct in ev.hoisted_rotations(x, list(rots)).items():
    outs[f"hoisted{r}"] = outs[f"rotate{r}"] = ct
for name, ct in outs.items():
    d[name + "_c0"], d[name + "_c1"] = ct.c0, ct.c1
    d[name + "_scale"] = ct.scale
np.savez(out, **{k: np.asarray(v) for k, v in d.items()})
"""


@pytest.fixture(scope="session")
def jax_server(tmp_path_factory):
    """The npz of the no-FMA JAX reference subprocess."""
    out = tmp_path_factory.mktemp("jax_server") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    args = [str(SEED), str(NONCE), str(DIM), str(LEVEL), str(PT_LEVEL),
            repr(KEY_ROTATIONS), repr(ROTATIONS), repr(OP_LEVEL),
            ",".join(repr(c) for c in POLY), str(out), repr(KEY_OPTIONS)]
    proc = subprocess.run([sys.executable, "-c", _REF, *args], env=env,
                          text=True, capture_output=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX reference failed:\n{proc.stdout}\n"
                           f"{proc.stderr[-4000:]}")
    return np.load(out)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def boot(jax_server):
    """The port's tinyboot staged f64 client on the reference's seed, nonce
    base and inputs: the two fresh ciphertexts, the evaluation keys and
    evaluator, and the encrypted flow, all on the CPU."""
    ref = jax_server
    client = FHEClient("tinyboot", seed=SEED, device="cpu",
                       pipeline="staged", datapath="f64")
    ctx = client.ctx
    ns = ctx.params.n_slots
    client.nonce = NONCE
    xb = client.encode_encrypt_batch(
        inf.replicate_slots(ref["xv"], ns)[None])
    yb = client.encode_encrypt_batch(ref["zy"][None])
    keys = client.make_evaluation_keys(rotations=KEY_ROTATIONS)
    ev = ServerEvaluator(ctx, keys)
    x = ServerCiphertext.from_batch(xb).drop_to(LEVEL)
    y = ServerCiphertext.from_batch(yb).drop_to(LEVEL)
    ops.reset_launches()
    flow_y = inf.encrypted_linear_poly3(ev, x, ref["w"], ref["bias"], POLY)
    launches = ops.launches()
    got = client.decrypt_batch(list(flow_y.to_batch()))
    return {"ref": ref, "client": client, "xb": xb, "yb": yb, "keys": keys,
            "ev": ev, "x": x, "y": y, "flow_y": flow_y, "got": got,
            "launches": launches}


@pytest.fixture(scope="module")
def tiny():
    """A tiny staged f64 client, an encrypted pair (x, y reversed), its
    evaluation keys and evaluator, all on the CPU (the port-only tests)."""
    client = FHEClient("tiny", seed=SEED, device="cpu", pipeline="staged",
                       datapath="f64")
    ns = client.ctx.params.n_slots
    rng = np.random.default_rng(31)
    z = (rng.standard_normal((2, ns)) + 1j * rng.standard_normal((2, ns))
         ) * 0.5
    client.nonce = 11
    x = ServerCiphertext.from_batch(client.encode_encrypt_batch(z))
    y = ServerCiphertext(x.c0.flip(0), x.c1.flip(0), x.level, x.scale)
    keys = client.make_evaluation_keys(rotations=ROTATIONS)
    return {"client": client, "z": z, "x": x, "y": y, "keys": keys,
            "ev": ServerEvaluator(client.ctx, keys)}


def _plaintexts(ctx, ref, x):
    pa = encoding.encode_plaintext(ref["pa_z"], ctx, PT_LEVEL, x.scale,
                                   device="cpu")
    pm = encoding.encode_plaintext(ref["pm_z"], ctx, PT_LEVEL,
                                   float(ctx.q_list[PT_LEVEL - 1]),
                                   device="cpu")
    return pa, pm


def _run_op(ev, name, x, y, pa, pm):
    """The op check `name` at its level (rotations at the flow's)."""
    lvl = OP_LEVEL.get(name, x.level)
    x, y = x.drop_to(lvl), y.drop_to(lvl)
    if name == "add_ct":
        return ev.add_ct(x, y)
    if name == "add_pt":
        return ev.add_pt(x, pa)
    if name == "mul_pt":
        return ev.mul_pt(x, pm, rescale=False)
    if name == "mul_pt_rescale":
        return ev.mul_pt(x, pm)
    if name == "rescale":
        return ev.rescale(x)
    if name == "mul_ct":
        return ev.mul_ct(x, y)
    if name.startswith("rotate"):
        return ev.rotate(x, int(name[6:]))
    r = int(name[7:])                               # hoisted<r>
    return ev.hoisted_rotations(x, list(ROTATIONS))[r]


OPS = (["add_ct", "add_pt", "mul_pt", "mul_pt_rescale", "rescale",
        "mul_ct"] + [f"rotate{r}" for r in ROTATIONS]
       + [f"hoisted{r}" for r in ROTATIONS])


def test_fresh_ciphertexts_bit_identical(boot):
    ref = boot["ref"]
    np.testing.assert_array_equal(_u32(boot["yb"].c0), ref["v0"])
    np.testing.assert_array_equal(_u32(boot["yb"].c1), ref["v1"])


@pytest.mark.parametrize("key",
                         ["relin"] + [f"rot{r}" for r in KEY_ROTATIONS])
def test_evaluation_keys_bit_identical(boot, key):
    ref = boot["ref"]
    keys = boot["keys"]
    ctx = boot["client"].ctx
    L = ctx.params.n_limbs
    ksk = keys.relin if key == "relin" else keys.rot[int(key[3:])]
    assert ksk.b_mont.dtype == torch.int32
    assert ksk.b_mont.shape == (L, L + 1, ctx.n)
    np.testing.assert_array_equal(_u32(ksk.b_mont), ref[key + "_b"])
    np.testing.assert_array_equal(_u32(ksk.a_mont), ref[key + "_a"])
    assert keys.special_q == int(ref["special_q"])


@pytest.mark.parametrize("tag", list(KEY_OPTIONS))
def test_evaluation_key_options_bit_identical(boot, tag):
    """make_evaluation_keys(rotations, include_relin, seed) in the
    reference's order: without a relinearization key, and under a seed
    other than the profile's, the reference's keys word for word and its
    wire bytes byte for byte."""
    from repro_torch.fhe_client.service import wire
    ref = boot["ref"]
    client = boot["client"]
    kw = KEY_OPTIONS[tag]
    assert kw["seed"] != client.ctx.params.seed
    keys = client.make_evaluation_keys(**kw)
    assert (keys.relin is not None) == bool(ref[tag + "_has_relin"])
    assert keys.relin is None or kw.get("include_relin", True)
    assert keys.rotations == tuple(ref[tag + "_rotations"])
    for name, ksk in [("relin", keys.relin)] + [(f"rot{r}", keys.rot[r])
                                                 for r in keys.rotations]:
        if ksk is None:
            continue
        np.testing.assert_array_equal(_u32(ksk.b_mont),
                                      ref[f"{tag}_{name}_b"])
        np.testing.assert_array_equal(_u32(ksk.a_mont),
                                      ref[f"{tag}_{name}_a"])
    assert wire.serialize_evaluation_keys(keys) == ref[tag + "_wire"].tobytes()
    same = skeys.make_evaluation_keys(client.ctx, client.keys.sk, **kw)
    assert wire.serialize_evaluation_keys(same) == ref[tag + "_wire"].tobytes()


def test_encode_plaintext_bit_identical(boot):
    ref = boot["ref"]
    pa, pm = _plaintexts(boot["client"].ctx, ref, boot["x"])
    for pt, tag in ((pa, "pa"), (pm, "pm")):
        np.testing.assert_array_equal(_u32(pt.data), ref[tag + "_data"])
        np.testing.assert_array_equal(_u32(pt.data_mont),
                                      ref[tag + "_mont"])
        assert pt.scale == float(ref[tag + "_scale"])


@pytest.mark.parametrize("name", OPS)
def test_server_op_bit_identical(boot, name):
    ref = boot["ref"]
    x = boot["x"]
    pa, pm = _plaintexts(boot["client"].ctx, ref, x)
    out = _run_op(boot["ev"], name, x, boot["y"], pa, pm)
    np.testing.assert_array_equal(_u32(out.c0), ref[name + "_c0"])
    np.testing.assert_array_equal(_u32(out.c1), ref[name + "_c1"])
    assert out.scale == float(ref[name + "_scale"])


@pytest.mark.parametrize("name", ["mul_pt_rescale", "mul_ct", "rotate5",
                                  "hoisted2"])
def test_carried_keys_and_plaintexts_give_same_words(boot, name):
    """The JAX package's keys and plaintexts, carried across as numpy."""
    ref = boot["ref"]
    ctx = boot["client"].ctx
    keys = evaluation_keys_from_numpy(
        ctx.n, ctx.params.n_limbs, int(ref["special_q"]),
        (ref["relin_b"], ref["relin_a"]),
        {r: (ref[f"rot{r}_b"], ref[f"rot{r}_a"]) for r in KEY_ROTATIONS},
        "cpu")
    assert keys.rotations == KEY_ROTATIONS
    pa, pm = (server_plaintext_from_numpy(
        ref[t + "_data"], ref[t + "_mont"], PT_LEVEL,
        float(ref[t + "_scale"]), "cpu") for t in ("pa", "pm"))
    out = _run_op(ServerEvaluator(ctx, keys), name, boot["x"], boot["y"],
                  pa, pm)
    np.testing.assert_array_equal(_u32(out.c0), ref[name + "_c0"])
    np.testing.assert_array_equal(_u32(out.c1), ref[name + "_c1"])


def test_f64_decrypt_bit_identical(boot):
    ref = boot["ref"]
    got = boot["client"].decrypt_batch(
        list(ServerCiphertext.from_batch(boot["yb"]).to_batch()))
    assert got.dtype == np.complex128
    np.testing.assert_array_equal(got.view(np.uint64),
                                  ref["dec_v"].view(np.uint64))
    assert np.max(np.abs(got[0] - ref["zy"])) < 2.0 ** -19


@pytest.mark.parametrize("profile", ["tiny", "tinyboot"])
def test_f64_client_matches_df32_staged(profile):
    """datapath='f64' and 'df32' staged clients give the same ciphertexts
    for one seed and nonce base."""
    f64 = FHEClient(profile, seed=SEED, device="cpu", pipeline="staged",
                    datapath="f64")
    d32 = FHEClient(profile, seed=SEED, device="cpu", pipeline="staged")
    ns = f64.ctx.params.n_slots
    rng = np.random.default_rng(41)
    z = (rng.standard_normal((3, ns)) + 1j * rng.standard_normal((3, ns))
         ) * 0.5
    f64.nonce = d32.nonce = 0xFFFFFFFE
    a, b = f64.encode_encrypt_batch(z), d32.encode_encrypt_batch(z)
    assert torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)
    out = f64.decrypt_decode_batch(a.truncated(2))
    assert np.max(np.abs(out - z)) < 2.0 ** -19


def test_flow_input_bit_identical(boot):
    np.testing.assert_array_equal(_u32(boot["xb"].c0), boot["ref"]["x0"])
    np.testing.assert_array_equal(_u32(boot["xb"].c1), boot["ref"]["x1"])


def test_flow_output_bit_identical(boot):
    ref, y = boot["ref"], boot["flow_y"]
    assert y.level == int(ref["flow_level"]) == 2
    assert y.scale == float(ref["flow_scale"])
    np.testing.assert_array_equal(_u32(y.c0), ref["flow_c0"])
    np.testing.assert_array_equal(_u32(y.c1), ref["flow_c1"])


def test_flow_decoded_slots_bit_identical(boot):
    np.testing.assert_array_equal(boot["got"].view(np.uint64),
                                  boot["ref"]["flow_got"].view(np.uint64))


def test_flow_error_within_budget(boot):
    ref = boot["ref"]
    want = inf.reference_linear_poly3(ref["xv"], ref["w"], ref["bias"],
                                      POLY)
    err = np.max(np.abs(boot["got"][0].real[:DIM] - want))
    assert err < 2.0 ** -12


def test_flow_plain_path_counts_no_launch(boot):
    assert not any(boot["launches"].values()), boot["launches"]


def test_matvec_scale_is_exact(boot):
    """The diagonals are encoded at the dropped prime: after the matvec's
    rescale the scale equals the input's exactly."""
    x, ev, ref = boot["x"], boot["ev"], boot["ref"]
    y = inf.encrypted_matvec(ev, x, ref["w"], ref["bias"])
    assert y.level == x.level - 1
    assert y.scale == x.scale


def test_hoisted_equals_fused_at_depth(boot):
    x, ev = boot["x"], boot["ev"]
    hoisted = ev.hoisted_rotations(x, [0, 1, 3, 34])   # 34 = 2 mod 32 slots
    assert hoisted[0] is x
    for r in (1, 3, 34):
        fused = ev.rotate(x, r)
        assert torch.equal(hoisted[r].c0, fused.c0)
        assert torch.equal(hoisted[r].c1, fused.c1)


def test_rotation_moves_slots(tiny):
    """rotate(x, r) decrypts to the slots rolled left by r."""
    client, ev, x, z = tiny["client"], tiny["ev"], tiny["x"], tiny["z"]
    for r in ROTATIONS:
        got = client.decrypt_batch(list(ev.rotate(x, r).to_batch()))
        assert np.max(np.abs(got - np.roll(z, -r, axis=1))) < 2.0 ** -25


def test_galois_perm_matches_coefficient_oracle(tiny):
    """The NTT-order permutation applies X -> X^g, as the signed
    coefficient map does."""
    from repro_torch.core import ntt as nttmod
    ctx = tiny["client"].ctx
    n = ctx.n
    rng = np.random.default_rng(3)
    coeffs = rng.integers(-50, 50, n)
    sp = ctx.stacked_plans(1)
    q = int(sp.q[0])
    fwd = nttmod.ntt_stacked(torch.tensor(coeffs % q)[None], sp)[0]
    for r in ROTATIONS:
        g = skeys.galois_element(r, n)
        perm = torch.from_numpy(skeys.galois_perm_ntt(g, n).astype(np.int64))
        want = nttmod.ntt_stacked(torch.tensor(
            skeys.galois_apply_coeffs(coeffs, g, n) % q)[None], sp)[0]
        assert torch.equal(fwd[perm], want)


def test_unported_options_raise(tiny):
    """datapath='f64' constructs for both classes (the server's u64 REDC,
    the client's f64 megakernel); an unknown datapath raises."""
    ev = ServerEvaluator(tiny["client"].ctx, tiny["keys"], datapath="f64")
    assert ev.datapath == "f64"
    client = FHEClient("tiny", device="cpu", pipeline="megakernel",
                       datapath="f64")
    assert client.encrypt_impl == client._encrypt_core_mega_impl
    with pytest.raises(ValueError, match="datapath"):
        ServerEvaluator(tiny["client"].ctx, tiny["keys"], datapath="u64")
    with pytest.raises(ValueError, match="datapath"):
        FHEClient("tiny", device="cpu", datapath="u64")


def test_evaluator_bookkeeping_refuses_bad_inputs(tiny):
    """The reference's guards, with its types: its ``assert``s raise
    ``AssertionError`` (with its messages where it gives one), a missing
    rotation key ``KeyError``."""
    ev, x = tiny["ev"], tiny["x"]
    ctx = tiny["client"].ctx
    bad = re.escape(repr(x.scale * 2))
    with pytest.raises(AssertionError, match=bad):
        ev.add_ct(x, ServerCiphertext(x.c0, x.c1, x.level, x.scale * 2))
    with pytest.raises(AssertionError):
        ev.add_pt(x, encoding.encode_scalar(1.0, ctx, 2, x.scale,
                                                  device="cpu"))
    with pytest.raises(AssertionError, match="2-limb decrypt floor"):
        ev.rescale(x.drop_to(2))
    with pytest.raises(KeyError, match="r=3"):
        ev.rotate(x, 3)
    assert ev.rotate(x, ctx.params.n_slots) is x
    with pytest.raises(AssertionError):
        x.drop_to(1)


def test_ciphertext_list_interop(tiny):
    from repro_torch.core.encryptor import CiphertextBatch
    x = tiny["x"]
    rows = list(x.to_batch())
    assert len(rows) == 2 and rows[0].c0.shape == (3, tiny["client"].ctx.n)
    back = CiphertextBatch.from_cts(rows)
    assert torch.equal(back.c0, x.c0) and back.scale == x.scale
    with pytest.raises(ValueError, match="0 ciphertexts"):
        CiphertextBatch.from_cts([])


@pytest.mark.parametrize("name", ["add_ct", "add_pt", "mul_pt", "rescale",
                                  "mul_pt_rescale", "mul_ct", "rotate",
                                  "ks_decompose", "ks_apply_rot"])
def test_server_cuda_wrappers_refuse_cpu_tensors(tiny, name):
    ctx = tiny["client"].ctx
    x = torch.zeros((1, 3, ctx.n), dtype=torch.int32)
    pt = torch.zeros((3, ctx.n), dtype=torch.int32)
    key = torch.zeros((3, 4, ctx.n), dtype=torch.int32)
    perm = torch.zeros((1, ctx.n), dtype=torch.int32)
    h = torch.zeros((1, 4, 3, ctx.n), dtype=torch.int32)
    args = {"add_ct": (x, x, x, x), "add_pt": (x, x, pt),
            "mul_pt": (x, x, pt), "rescale": (x, x),
            "mul_pt_rescale": (x, x, pt),
            "mul_ct": (x, x, x, x, key, key),
            "rotate": (x, x, perm, key, key), "ks_decompose": (x,),
            "ks_apply_rot": (x, h, perm, key, key)}[name]
    fn = getattr(server_eval, ("mul_ct_relin" if name == "mul_ct" else name)
                 + "_cuda")
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args, ctx)


@pytest.mark.parametrize("name", ["mul_pt", "rescale", "mul_pt_rescale",
                                  "mul_ct", "rotate", "ks_apply_rot"])
def test_server_plain_versions_take_either_datapath(tiny, name):
    """The plain version of each op that multiplies runs the REDC engine
    its datapath names (the same words on both) and refuses an unknown
    datapath; the kernels take none (one u64 REDC serves both)."""
    ctx = tiny["client"].ctx
    rng = np.random.default_rng(5)
    q = torch.tensor([int(v) for v in ctx.q_list[:3]]).reshape(1, 3, 1)

    def words(*shape):
        w = torch.from_numpy(rng.integers(0, 2 ** 31, shape)) % q
        return w.to(torch.int32)

    x0, x1 = words(1, 3, ctx.n), words(1, 3, ctx.n)
    pt = words(1, 3, ctx.n)[0]
    key = torch.zeros((3, 4, ctx.n), dtype=torch.int32)
    perm = torch.arange(ctx.n, dtype=torch.int32).reshape(1, ctx.n)
    h = torch.zeros((1, 4, 3, ctx.n), dtype=torch.int32)
    args = {"mul_pt": (x0, x1, pt), "rescale": (x0, x1),
            "mul_pt_rescale": (x0, x1, pt),
            "mul_ct": (x0, x1, x1, x0, key, key),
            "rotate": (x0, x1, perm, key, key),
            "ks_apply_rot": (x0, h, perm, key, key)}[name]
    base = "mul_ct_relin" if name == "mul_ct" else name
    plain = getattr(server_eval, base + "_plain")
    for a, b in zip(plain(*args, ctx, datapath="f64"), plain(*args, ctx)):
        assert torch.equal(a, b)
    assert "datapath" not in inspect.signature(
        getattr(server_eval, base + "_cuda")).parameters
    with pytest.raises(ValueError, match="datapath"):
        plain(*args, ctx, datapath="u64")
