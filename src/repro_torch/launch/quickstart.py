"""Quickstart: the full CKKS client round-trip through the public API.

Port of ``examples/quickstart.py``; runs on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--profile test]

Walks the paper's Fig. 2a pipeline end to end:
  encode (SpecialIFFT + Delta-scale + RNS + NTT)
  -> encrypt (on-chip PRNG randomness, the limb-folded encrypt kernel, K2)
  -> [ship to server; server computes at high level, returns 2-limb ct]
  -> decrypt (c0 + c1*s and the INTT, K3)  -> decode (CRT + SpecialFFT)
and checks the recovered message against the original (Boot-precision
metric, paper Fig. 3c) — first through the per-ciphertext API, then
through the batched ``FHEClient`` pipeline (the default megakernel path:
one encode+encrypt launch, K5, and one decrypt+decode launch, K6).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (boot_precision_bits, decode_coeff, encode,
                              get_context, keygen)
from repro_torch.core.encryptor import Ciphertext
from repro_torch.kernels import common
from repro_torch.kernels import ops as kops

BOOT_PREC_BITS = 19.29


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(profile: str = "test", device=None) -> dict:
    """Both halves of the quickstart at ``profile`` on ``device`` (the card
    when None). Returns what each half computed and its host seconds."""
    dev = common.resolve_device(device, "quickstart")
    ctx = get_context(profile)
    p = ctx.params
    print(f"profile={profile}: N=2^{p.logn}, {p.n_limbs} limbs, "
          f"Delta=2^{p.delta_bits}, "
          f"logQ={ctx.modulus_bits():.0f} bits, device {dev}")

    sk, pk = keygen(ctx, device=dev)
    rng = np.random.default_rng(0)
    z = (rng.standard_normal(p.n_slots)
         + 1j * rng.standard_normal(p.n_slots)) * 0.5

    t0 = time.perf_counter()
    pt = encode(z, ctx, device=dev)
    _sync(dev)
    t_encode = time.perf_counter() - t0

    t0 = time.perf_counter()
    c0, c1 = kops.encrypt_fused(pt.data, pk.b_mont, pk.a_mont, ctx)
    _sync(dev)
    t_encrypt = time.perf_counter() - t0
    ct = Ciphertext(c0=c0, c1=c1, n_limbs=p.n_limbs, scale=pt.scale)

    # --- server boundary: homomorphic eval happens here (other papers');
    # the server returns a 2-limb ciphertext (paper §V-B traffic model) ----
    ct2 = Ciphertext(c0=ct.c0[:2], c1=ct.c1[:2], n_limbs=2, scale=ct.scale)

    t0 = time.perf_counter()
    m_coeff = kops.decrypt_fused(ct2.c0, ct2.c1, sk.s_mont, ctx)
    z_got = decode_coeff(m_coeff, ctx, scale=ct2.scale)
    t_decrypt = time.perf_counter() - t0

    prec = boot_precision_bits(z, z_got)
    print(f"encode   {t_encode * 1e3:8.1f} ms")
    print(f"encrypt  {t_encrypt * 1e3:8.1f} ms  (fused kernel, "
          f"{p.n_limbs} limbs, on-chip PRNG)")
    print(f"decrypt+decode {t_decrypt * 1e3:8.1f} ms  (2-limb)")
    print(f"message precision: {prec:.1f} bits "
          f"(paper requires >= {BOOT_PREC_BITS})")
    assert prec >= BOOT_PREC_BITS, \
        "round-trip precision below bootstrapping bar"

    # --- batched pipeline (FHEClient, the default megakernel path): one
    # launch per direction, no host FFT round-trip -------------------------
    from repro_torch.fhe_client.client import FHEClient

    client = FHEClient(profile=profile, device=dev)
    msgs = (rng.standard_normal((4, p.n_slots))
            + 1j * rng.standard_normal((4, p.n_slots))) * 0.5
    t0 = time.perf_counter()
    cts = client.encode_encrypt_batch(msgs)
    z_batch = client.decrypt_decode_batch(cts.truncated(2))
    t_batch = time.perf_counter() - t0
    prec_b = boot_precision_bits(msgs, z_batch)
    print(f"batched device-Fourier round-trip (B=4) {t_batch * 1e3:8.1f} ms"
          f"  precision: {prec_b:.1f} bits")
    assert prec_b >= BOOT_PREC_BITS, \
        "device-Fourier precision below bootstrapping bar"
    print("OK — client round-trip verified")
    return {"z": z, "pt": pt.data, "c0": c0, "c1": c1, "m_coeff": m_coeff,
            "z_got": z_got, "prec": prec, "msgs": msgs, "batch_c0": cts.c0,
            "batch_c1": cts.c1, "z_batch": z_batch, "prec_batch": prec_b,
            "single_s": t_encode + t_encrypt + t_decrypt,
            "batch_s": t_batch}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="test",
                    help="tiny (N=2^6, smoke) | test (N=2^10, CPU-fast) | "
                         "n14 | n15 | paper")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    return run(args.profile, args.device)


if __name__ == "__main__":
    main()
