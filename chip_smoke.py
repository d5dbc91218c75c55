"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (``src/repro_torch``, never the JAX package) on the card:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
     ``build/repro_torch_kernels/`` (nvcc, one process per source, all at
     once; rebuilt when a source changes) and prints the build time and
     ptxas' register / spill report;
  3. holds each kernel against its plain PyTorch version on the same CUDA
     tensors, bit for bit: ``test`` at B=16, ``paper`` at B=4 and B=16;
  4. drives the main path at the ``paper`` profile (N=2^16, 24 limbs,
     Delta=2^55), B=16: ``encode_encrypt_batch`` -> ``truncated(2)`` ->
     ``decrypt_decode_batch``, with every launch counter set to 0 just
     before and read just after; each kernel must have launched, and the
     round trip must keep >= 19.29 bits (the JAX quickstart's bar);
  5. profiles three main-path round trips (device time by CUDA kernel,
     device busy / idle share), then times both directions at ``paper``,
     B=1 and B=16 (CUDA events, after warm-up), and the plain versions at
     B=16;
  6. prints the ``kernels`` JSON line (launches, max_abs_err, times, the
     bound), then, as the last line, ``{"ok": true, "device": ...}``.

Any mismatch, failed build or failed launch ends the run with a non-zero
exit code and no result line. Needs a CUDA device; without one it exits 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BOOT_PREC_BITS = 19.29
MAIN_PROFILE, MAIN_BATCH = "paper", 16
SEED = 20261017

# Peaks of one H100 SXM at its 1.98 GHz boost clock and 700 W, per
# instruction: HBM 3.35 TB/s; float32 outside the tensor cores 33.5e12
# instructions/s (the data sheet's 67 TFLOP/s counts a fused multiply-add
# as two operations; these kernels are built with --fmad=false, so every
# float operation is its own instruction); int32 16.7e12 instructions/s
# (64 INT32 lanes per SM x 132 SMs x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
I32_OPS_PER_S = 64 * 132 * 1.98e9

# Operations per primitive, counted from csrc/client_common.cuh:
#   two_sum 6 f32, quick_two_sum 3, two_prod 17 (1 product, 2 splits of
#   4, 8 for the error), df_add 11, df_sub 13, df_mul 24, complex df
#   multiply 4*24 + 13 + 11 = 120; one FFT butterfly = add 22 + sub 26 +
#   multiply 120 = 168 f32.
#   redc_mul 11 int32 (2 mul.lo, 2 mul.hi, 2 add, carry select, compare,
#   subtract, select), addmod 4, submod 4, signed -> residue 3: one NTT
#   butterfly = 19 int32; Philox-4x32-10 = 10 rounds of 10 = 100 int32 per
#   word.
F32_FFT_BUTTERFLY = 168
I32_NTT_BUTTERFLY = 19
I32_REDC = 11
I32_ADDMOD = 4
I32_TO_RESIDUE = 3
I32_PHILOX = 100


def _ops_encode_encrypt(p, batch: int) -> tuple[float, float]:
    """(int32 ops, f32 ops) that one encode+encrypt call needs, whatever
    the kernel does again: the Philox draws (v, e0, e1: five words) once
    per (row, coefficient), as they do not depend on the limb; per (row,
    limb) three NTTs (pt + e0 is summed before one transform, which is
    linear mod q); the NTT twiddles once per limb."""
    n, ns, logn, L = p.n, p.n_slots, p.logn, p.n_limbs
    f32 = batch * ((logn - 1) * (ns // 2) * F32_FFT_BUTTERFLY
                   + n * (48 + 85))          # 1/n scale 2*df_mul + digits
    per_row = n * (5 * I32_PHILOX + 20)      # 5 words, zo + 2 cbd
    per_limb_coeff = (36                     # digits -> residue
                      + 3 * I32_TO_RESIDUE   # v, e0, e1
                      + 2 * I32_REDC + 3 * I32_ADDMOD)  # pt+e0, c0, c1
    per_row_limb = (n * per_limb_coeff
                    + 3 * logn * (n // 2) * I32_NTT_BUTTERFLY)
    i32 = batch * (per_row + L * per_row_limb) + L * n * I32_REDC
    return float(i32), float(f32)


def _ops_decrypt_decode(p, batch: int) -> tuple[float, float]:
    """As above for one decrypt+decode call of 2 limbs: the INTT twiddles
    once per limb, c0 + c1*s, INTT and N^-1 per (row, limb)."""
    n, ns, logn = p.n, p.n_slots, p.logn
    per_row_limb = (n * (2 * I32_REDC + I32_ADDMOD)      # c0 + c1*s, N^-1
                    + logn * (n // 2) * I32_NTT_BUTTERFLY)
    i32 = (batch * (2 * per_row_limb + n * 36)           # two-limb CRT
           + 2 * n * I32_REDC)                           # twiddles
    f32 = batch * ((logn - 1) * (ns // 2) * F32_FFT_BUTTERFLY + n * 35)
    return float(i32), float(f32)


def _bytes_encode_encrypt(p, batch: int) -> float:
    """Inputs read once, outputs written once (the bound's convention)."""
    n, ns, L = p.n, p.n_slots, p.n_limbs
    k = 3 + p.logn * (p.logn + 1)            # seed-table columns
    return float(4 * batch * ns * 4          # slot planes
                 + 2 * L * n * 4             # public key
                 + 4 * ns * 4 + ns * 4       # twiddles, bit-reversal
                 + L * k * 4 + L * 8         # seed table, digit consts
                 + 2 * batch * L * n * 4)    # c0, c1


def _bytes_decrypt_decode(p, batch: int) -> float:
    n, ns = p.n, p.n_slots
    return float(2 * batch * 2 * n * 4 + 2 * n * 4 + batch * 4
                 + 4 * ns * 4 + ns * 4 + 4 * batch * ns * 4)


def _bound_ms(nbytes: float, i32: float, f32: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(i32 / I32_OPS_PER_S, f32 / F32_OPS_PER_S)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def _messages(ns: int, batch: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, ns))
            + 1j * rng.standard_normal((batch, ns))) * 0.5


def _max_abs_err(got, want) -> float:
    import torch
    if got.dtype == torch.int32:          # uint32 words
        g = got.to(torch.int64) & 0xFFFFFFFF
        w = want.to(torch.int64) & 0xFFFFFFFF
        return float((g - w).abs().max().item())
    return float((got.double() - want.double()).abs().max().item())


def _same_bits(got, want) -> bool:
    import torch
    if got.dtype == torch.float32:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return torch.equal(got, want)


def _cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _profile_main_path(client, msgs, iters: int = 3) -> None:
    """Device time by CUDA kernel and the device's busy share over a
    window of `iters` main-path round trips (torch.profiler / CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def round_trip():
        client.decrypt_decode_batch(
            client.encode_encrypt_batch(msgs).truncated(2))

    round_trip()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            round_trip()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / iters, ev.count // iters, ev.key))
    busy = sum(r[0] for r in rows)
    per_trip = window_ms / iters
    if not rows:
        print("profile: the profiler saw no device time (not measured)",
              flush=True)
        return
    print(f"profile: paper B={len(msgs)} round trip {per_trip:.3f} ms host "
          f"clock, device busy {busy:.3f} ms ({100 * busy / per_trip:.1f}%, "
          f"idle {100 * (1 - busy / per_trip):.1f}%)", flush=True)
    for ms, cnt, name in sorted(rows, reverse=True)[:12]:
        print(f"  device {ms:9.3f} ms  x{cnt:<3d} {name[:90]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              flush=True)
        return 2
    from repro_torch.core.encoder import boot_precision_bits
    from repro_torch.fhe_client.client import FHEClient
    from repro_torch.kernels import build, client_stream

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {count}", flush=True)

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    build.load()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s ({len(logs)} sources compiled, "
          f"flags {' '.join(build.NVCC_FLAGS)})", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}", flush=True)

    dev = torch.device("cuda", 0)
    clients = {}

    def client_for(profile):
        if profile not in clients:
            clients[profile] = FHEClient(profile, seed=SEED, device=dev)
        return clients[profile]

    # --- 3. kernel vs plain, on the card ------------------------------------
    errs = {"encode_encrypt_stream": 0.0, "decrypt_decode_stream": 0.0}
    for profile, batch in (("test", 16), ("paper", 4), ("paper", 16)):
        c = client_for(profile)
        ctx, p = c.ctx, c.ctx.params
        planes = c.encrypt_operands(_messages(p.n_slots, batch, batch))
        pkb, pka = c.keys.pk.b_mont, c.keys.pk.a_mont
        k0, k1 = client_stream.encode_encrypt_stream_cuda(
            planes, pkb, pka, ctx, c.seed, 123)
        r0, r1 = client_stream.encode_encrypt_stream_plain(
            planes, pkb, pka, ctx, c.seed, 123)
        torch.cuda.synchronize()
        e = max(_max_abs_err(k0, r0), _max_abs_err(k1, r1))
        errs["encode_encrypt_stream"] = max(errs["encode_encrypt_stream"], e)
        if not (_same_bits(k0, r0) and _same_bits(k1, r1)):
            _fail(f"encode_encrypt_stream differs from its plain version "
                  f"at {profile} B={batch} (max abs err {e})")
        scale = torch.full((batch,), p.delta, dtype=torch.float32,
                           device=dev)
        kp = client_stream.decrypt_decode_stream_cuda(
            k0[:, :2], k1[:, :2], c.keys.sk.s_mont, ctx, scale)
        rp = client_stream.decrypt_decode_stream_plain(
            k0[:, :2], k1[:, :2], c.keys.sk.s_mont, ctx, scale)
        torch.cuda.synchronize()
        e = max(_max_abs_err(a, b) for a, b in zip(kp, rp))
        errs["decrypt_decode_stream"] = max(errs["decrypt_decode_stream"], e)
        if not all(_same_bits(a, b) for a, b in zip(kp, rp)):
            _fail(f"decrypt_decode_stream differs from its plain version "
                  f"at {profile} B={batch} (max abs err {e})")
        print(f"kernel == plain (bit-identical): {profile} B={batch}",
              flush=True)

    # --- 4. the main path at paper, B=16 ----------------------------------
    c = client_for(MAIN_PROFILE)
    p = c.ctx.params
    msgs = _messages(p.n_slots, MAIN_BATCH, 1)
    client_stream.reset_launches()
    t0 = time.perf_counter()
    cts = c.encode_encrypt_batch(msgs)
    out = c.decrypt_decode_batch(cts.truncated(2))
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = dict(client_stream.LAUNCHES)
    if any(v == 0 for v in launches.values()):
        _fail(f"a kernel of the main path never launched: {launches}")
    import numpy as np
    if out.shape != msgs.shape or not np.all(np.isfinite(out)):
        _fail(f"decoded output has shape {out.shape} or non-finite values")
    if tuple(cts.c0.shape) != (MAIN_BATCH, p.n_limbs, p.n):
        _fail(f"ciphertext shape {tuple(cts.c0.shape)}")
    bits = boot_precision_bits(msgs, out)
    print(f"main path: paper B={MAIN_BATCH} round trip {bits:.2f} bits "
          f"(bar {BOOT_PREC_BITS}), {e2e_s * 1e3:.1f} ms host clock "
          f"incl. transfers, launches {launches}", flush=True)
    if not bits >= BOOT_PREC_BITS:
        _fail(f"round-trip precision {bits} < {BOOT_PREC_BITS}")

    _profile_main_path(c, msgs)

    # --- 5. times -------------------------------------------------------------
    times = {}
    for batch in (1, MAIN_BATCH):
        planes = c.encrypt_operands(_messages(p.n_slots, batch, 2))
        pkb, pka = c.keys.pk.b_mont, c.keys.pk.a_mont
        k0, k1 = client_stream.encode_encrypt_stream_cuda(
            planes, pkb, pka, c.ctx, c.seed, 0)
        scale = torch.full((batch,), p.delta, dtype=torch.float32,
                           device=dev)
        s_mont = c.keys.sk.s_mont
        times[("enc", batch)] = _cuda_ms(
            lambda: client_stream.encode_encrypt_stream_cuda(
                planes, pkb, pka, c.ctx, c.seed, 0), iters=5)
        times[("dec", batch)] = _cuda_ms(
            lambda: client_stream.decrypt_decode_stream_cuda(
                k0[:, :2], k1[:, :2], s_mont, c.ctx, scale), iters=5)
        if batch == MAIN_BATCH:
            times[("enc_plain", batch)] = _cuda_ms(
                lambda: client_stream.encode_encrypt_stream_plain(
                    planes, pkb, pka, c.ctx, c.seed, 0), iters=1, warmup=1)
            times[("dec_plain", batch)] = _cuda_ms(
                lambda: client_stream.decrypt_decode_stream_plain(
                    k0[:, :2], k1[:, :2], s_mont, c.ctx, scale), iters=1,
                warmup=1)
    bounds = {}
    for batch in (1, MAIN_BATCH):
        bounds[("enc", batch)] = _bound_ms(_bytes_encode_encrypt(p, batch),
                                           *_ops_encode_encrypt(p, batch))
        bounds[("dec", batch)] = _bound_ms(_bytes_decrypt_decode(p, batch),
                                           *_ops_decrypt_decode(p, batch))
    for (what, batch), ms in sorted(times.items(), key=str):
        b = bounds.get((what, batch))
        bound = f", bound {b[0]:.4f} ms ({b[1]})" if b else ""
        print(f"time: {what} {MAIN_PROFILE} B={batch}: {ms:.3f} ms{bound}  "
              f"[{card}]", flush=True)

    # --- 6. result lines ------------------------------------------------------
    b_enc, b_dec = bounds[("enc", MAIN_BATCH)], bounds[("dec", MAIN_BATCH)]
    kernels = [
        {"name": "encode_encrypt_stream", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/encode_encrypt.cu",
         "replaces": "src/repro/kernels/client_stream.py:96",
         "cuda_kernels": ["encode_rows_kernel", "encrypt_limbs_kernel"],
         "matched_plain": True,
         "launches": launches["encode_encrypt_stream"],
         "max_abs_err": errs["encode_encrypt_stream"],
         "ms": times[("enc", MAIN_BATCH)],
         "plain_ms": times[("enc_plain", MAIN_BATCH)],
         "bound_ms": b_enc[0], "bound_by": b_enc[1], "library_ms": None},
        {"name": "decrypt_decode_stream", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decrypt_decode.cu",
         "replaces": "src/repro/kernels/client_stream.py:200",
         "cuda_kernels": ["decrypt_limbs_kernel", "decode_rows_kernel"],
         "matched_plain": True,
         "launches": launches["decrypt_decode_stream"],
         "max_abs_err": errs["decrypt_decode_stream"],
         "ms": times[("dec", MAIN_BATCH)],
         "plain_ms": times[("dec_plain", MAIN_BATCH)],
         "bound_ms": b_dec[0], "bound_by": b_dec[1], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
