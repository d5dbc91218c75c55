"""Encrypted inference, end to end: poly3(W @ x + b) evaluated on
ciphertexts, the server decrypting nothing.

The port's counterpart of ``examples/secure_inference.py --encrypted``:

  1. the client (``FHEClient(profile, pipeline='staged', datapath='f64')``:
     the f64 datapath decodes the non-power-of-two scales a ct x ct
     rescale leaves) encrypts the block-replicated input and makes the
     relinearization and matvec rotation keys, and ships both as wire
     payloads (``fhe_client.service.wire``: a ciphertext batch, kind 1;
     the evaluation keys, kind 4);
  2. the server parses the payloads, drops the ciphertext to `level` limbs
     and evaluates the linear layer and the degree-3 polynomial
     (``ServerEvaluator``, ``inference.encrypted_linear_poly3``: 4
     levels), and ships the result back as a wire payload (kind 1);
  3. the client parses it, decrypts the 2-limb result with a scale per
     row (``decrypt_batch``) and compares it with the plaintext model
     (``reference_linear_poly3``) against the 2^-12 budget.

The server's time (``server_s``) is the evaluation alone; the wire's
serialize and deserialize seconds are kept apart. Every step runs on
`device` (default ``cuda``; ``cpu`` runs the plain versions)::

    python -m repro_torch.fhe_server.encrypted_inference --profile server
    python -m repro_torch.fhe_server.encrypted_inference --profile boot

Prints the level trajectory, the payload sizes, the error beside the
budget and the times; exits 1 when the error misses the budget.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.fhe_client.client import FHEClient
from repro_torch.fhe_client.service import wire
from repro_torch.fhe_server import inference as inf
from repro_torch.fhe_server.ct import ServerCiphertext
from repro_torch.fhe_server.eval_ops import ServerEvaluator

NOISE_BUDGET_E2E = 2.0 ** -12
POLY = (0.1, 0.5, -0.2, 0.05)          # c0 + c1 y + c2 y^2 + c3 y^3


def workload(dim: int, seed: int):
    """The example's model: input x, weights W, bias b (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    xv = rng.standard_normal(dim) * 0.5
    w = rng.standard_normal((dim, dim)) * 0.4
    bias = rng.standard_normal(dim) * 0.3
    return xv, w, bias


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(profile: str = "server", dim: int = 8, level: int = 6,
        seed: int = 7, device=None) -> dict:
    """One encrypted-inference round trip over wire payloads; returns the
    levels, the error, the times (host clock, synchronized), the payload
    sizes and wire seconds, and the ciphertexts."""
    device = torch.device("cuda" if device is None else device)
    t, nbytes = {}, {}
    t0 = time.perf_counter()
    client = FHEClient(profile, device=device,
                       pipeline="staged", datapath="f64")
    ctx = client.ctx
    xv, w, bias = workload(dim, seed)
    _sync(device)
    t["client_setup_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cts = client.encode_encrypt_batch(
        inf.replicate_slots(xv, ctx.params.n_slots)[None])
    _sync(device)
    t["encrypt_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    keys = client.make_evaluation_keys(rotations=inf.matvec_rotations(dim))
    _sync(device)
    t["keygen_s"] = time.perf_counter() - t0

    # client -> server: the ciphertext and the one-time evaluation keys
    t0 = time.perf_counter()
    ct_up = wire.serialize_ciphertext_batch(cts)
    ek_up = wire.serialize_evaluation_keys(keys)
    t["serialize_up_s"] = time.perf_counter() - t0
    nbytes["upload_ct"], nbytes["upload_keys"] = len(ct_up), len(ek_up)

    # --- server: wire payloads in, a wire payload out -----------------------
    t0 = time.perf_counter()
    server_keys = wire.deserialize_evaluation_keys(ek_up, device=device)
    x_in = wire.deserialize_ciphertext_batch(ct_up, device=device)
    _sync(device)
    t["deserialize_up_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = ServerEvaluator(ctx, server_keys)
    x_ct = ServerCiphertext.from_batch(x_in)
    x_ct = x_ct.drop_to(min(x_ct.level, level))      # 4 levels needed
    y_ct = inf.encrypted_linear_poly3(ev, x_ct, w, bias, POLY)
    _sync(device)
    t["server_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ct_down = wire.serialize_ciphertext_batch(y_ct.to_batch())
    t["serialize_down_s"] = time.perf_counter() - t0
    nbytes["download_ct"] = len(ct_down)
    # ------------------------------------------------------------------------

    t0 = time.perf_counter()
    y_in = wire.deserialize_ciphertext_batch(ct_down, device=device)
    t["deserialize_down_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = np.asarray(client.decrypt_batch(list(y_in)))
    t["decrypt_s"] = time.perf_counter() - t0
    ref = inf.reference_linear_poly3(xv, w, bias, POLY)
    err = float(np.max(np.abs(got[0].real[:dim] - ref)))
    return {"profile": profile, "dim": dim, "levels": (x_ct.level,
                                                       y_ct.level),
            "err": err, "budget": NOISE_BUDGET_E2E, "times": t,
            "bytes": nbytes,
            "got": got, "x_ct": x_ct, "y_ct": y_ct, "client": client,
            "evaluator": ev, "workload": (xv, w, bias, POLY)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="server",
                    choices=("server", "boot", "tinyboot"))
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--level", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.profile, args.dim, args.level, args.seed, args.device)
    p = out["client"].ctx.params
    b, t = out["bytes"], out["times"]
    print(f"CKKS: N=2^{p.logn}, {p.n_limbs} limbs, delta=2^{p.delta_bits} "
          f"(profile={args.profile}), device {args.device}")
    print(f"upload: ciphertext {b['upload_ct'] / 1e3:.1f} KB, evaluation "
          f"keys {b['upload_keys'] / 1e6:.2f} MB (one-time); download "
          f"{b['download_ct'] / 1e3:.1f} KB")
    print(f"server: {out['levels'][0]} -> {out['levels'][1]} levels")
    print("wire: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items()
                               if "serialize" in k))
    print("times: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items()
                                if "serialize" not in k))
    ok = out["err"] < out["budget"]
    print(f"poly3(W @ x + b): encrypted vs plaintext max err "
          f"{out['err']:.3e} (budget {out['budget']:.3e}): "
          f"{'within' if ok else 'OVER'} budget")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
