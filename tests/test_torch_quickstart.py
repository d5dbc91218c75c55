"""``repro_torch.launch.quickstart`` against the JAX package's quickstart.

The JAX side runs the operations of ``examples/quickstart.py`` (keygen,
encode, ``ops.encrypt_fused``, the 2-limb ``ops.decrypt_fused``,
``decode_coeff``, then ``FHEClient`` at B=4 from the same numpy generator)
ONCE per session, in one subprocess under ``XLA_FLAGS=--xla_cpu_max_isa=AVX``
(no FMA contraction of the df32 multiply-adds; see ``test_torch_slice.py``),
at ``tiny`` and ``test``, its kernels in interpret mode. The port's
quickstart runs on the CPU (``--device cpu``: every kernel's plain
version). Tolerance: 0 — plaintext words, ciphertext words, decrypted
residues, the decoded slots of both halves and both precisions are the
reference's exactly; both halves keep >= 19.29 bits.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import quickstart

SRC = str(Path(__file__).resolve().parents[1] / "src")
PROFILES = ("tiny", "test")

_REFERENCE = r'''
import json, sys
import numpy as np
from repro.core import (boot_precision_bits, decode_coeff, encode,
                        get_context, keygen)
from repro.fhe_client.client import FHEClient
from repro.kernels import ops as kops

profiles, out_dir = json.loads(sys.argv[1]), sys.argv[2]
for profile in profiles:
    ctx = get_context(profile)
    p = ctx.params
    sk, pk = keygen(ctx)
    rng = np.random.default_rng(0)
    z = (rng.standard_normal(p.n_slots)
         + 1j * rng.standard_normal(p.n_slots)) * 0.5
    pt = encode(z, ctx)
    c0, c1 = kops.encrypt_fused(pt.data, pk.b_mont, pk.a_mont, ctx)
    m_coeff = kops.decrypt_fused(c0[:2], c1[:2], sk.s_mont, ctx)
    z_got = decode_coeff(m_coeff, ctx, scale=pt.scale)
    client = FHEClient(profile=profile)
    msgs = (rng.standard_normal((4, p.n_slots))
            + 1j * rng.standard_normal((4, p.n_slots))) * 0.5
    cts = client.encode_encrypt_batch(msgs)
    z_batch = client.decrypt_decode_batch(cts.truncated(2))
    np.savez(f"{out_dir}/{profile}.npz", z=z, pt=np.asarray(pt.data),
             c0=np.asarray(c0), c1=np.asarray(c1),
             m_coeff=np.asarray(m_coeff), z_got=z_got,
             prec=boot_precision_bits(z, z_got), msgs=msgs,
             batch_c0=np.asarray(cts.c0), batch_c1=np.asarray(cts.c1),
             z_batch=z_batch, prec_batch=boot_precision_bits(msgs, z_batch),
             modulus_bits=ctx.modulus_bits())
    print(profile, "done", flush=True)
'''


@pytest.fixture(scope="session")
def jax_quickstart(tmp_path_factory):
    """{profile: npz} from one no-FMA JAX subprocess."""
    out = tmp_path_factory.mktemp("jax_quickstart")
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(PROFILES), str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX quickstart failed:\n{proc.stdout}\n"
                           f"{proc.stderr[-4000:]}")
    return {p: np.load(out / f"{p}.npz") for p in PROFILES}


@pytest.fixture(scope="module")
def port_runs():
    """The port's quickstart on the CPU, once per profile, through its
    CLI entry."""
    return {p: quickstart.main(["--profile", p, "--device", "cpu"])
            for p in PROFILES}


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("profile", PROFILES)
def test_single_ciphertext_half_matches_reference(jax_quickstart, port_runs,
                                                  profile):
    """encode -> K2 -> 2 limbs -> K3 -> decode_coeff: every word and slot
    is the reference's."""
    ref, got = jax_quickstart[profile], port_runs[profile]
    np.testing.assert_array_equal(got["z"], ref["z"])
    for name in ("pt", "c0", "c1", "m_coeff"):
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(_u32(got[name]), ref[name])
    np.testing.assert_array_equal(got["z_got"], ref["z_got"])
    assert got["prec"] == float(ref["prec"]) >= quickstart.BOOT_PREC_BITS


@pytest.mark.parametrize("profile", PROFILES)
def test_batched_half_matches_reference(jax_quickstart, port_runs, profile):
    """``FHEClient`` at B=4 (K5 / K6's plain versions): the reference's
    ciphertext words and decoded slots."""
    ref, got = jax_quickstart[profile], port_runs[profile]
    np.testing.assert_array_equal(got["msgs"], ref["msgs"])
    np.testing.assert_array_equal(_u32(got["batch_c0"]), ref["batch_c0"])
    np.testing.assert_array_equal(_u32(got["batch_c1"]), ref["batch_c1"])
    np.testing.assert_array_equal(got["z_batch"], ref["z_batch"])
    assert got["prec_batch"] == float(ref["prec_batch"]) \
        >= quickstart.BOOT_PREC_BITS


def test_prints_reference_lines(jax_quickstart, capsys):
    """The CLI prints the reference's header (logQ from
    ``CKKSContext.modulus_bits``) and ends with its OK line."""
    quickstart.main(["--profile", "tiny", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    bits = float(jax_quickstart["tiny"]["modulus_bits"])
    assert out[0].startswith(f"profile=tiny: N=2^6, 3 limbs, Delta=2^40, "
                             f"logQ={bits:.0f} bits")
    assert out[-1] == "OK — client round-trip verified"


def test_runs_on_the_card_by_default():
    """No ``--device``: the card; without CUDA the CLI raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main(["--profile", "tiny"])
