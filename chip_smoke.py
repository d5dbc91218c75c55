"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (``src/repro_torch``, never the JAX package) on the card:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
     ``build/repro_torch_kernels/`` (nvcc, one process per source, all at
     once; rebuilt when a source changes) and prints the build time and
     ptxas' register / spill report;
  3. holds each kernel against its plain PyTorch version on the same CUDA
     tensors, bit for bit: ``test`` at B=16, ``paper`` at B=4 and B=16.
     The megakernels K5/K6 take the client's operands; the staged kernels
     K1 (NTT, INTT), K2, K3 and K4 (SpecialFFT, SpecialIFFT) take the real
     intermediates of a staged round trip. K5 / K6 also on both datapaths
     at ``paper`` B=1 and ``n15`` B=2 (odd logN: an uneven tile split of
     their two-pass NTT / FFT), and on the f64 datapath at ``test`` B=16
     and ``paper`` B=4, every row. K1 (both directions), K2, K3 and K4
     (both directions) also on random words at the shapes the tiled NTT's
     and FFT's planning reaches (``STAGED_SHAPES``: ``paper`` B=1, the
     encrypted flow's ``boot`` (6, 1, 2^16) stack (K1), ``n15`` B=2,
     ``server`` (one pass), K2 rows across the 2^32 nonce wrap), K2 on the
     transposed plaintext view the staged client passes and on its
     contiguous copy, K3 on the 2- and 3-limb views of a (B, L, N) batch,
     K4's forward on the halves of (B, N) rows;
  4. drives both client paths at the ``paper`` profile (N=2^16, 24 limbs,
     Delta=2^55), B=16: ``encode_encrypt_batch`` -> ``truncated(2)`` ->
     ``decrypt_decode_batch``, first the default megakernel path, then
     ``pipeline='staged'``, each with every launch counter set to 0 just
     before and read just after. Each kernel of the path must have
     launched, the round trip must keep >= 19.29 bits (the JAX quickstart's
     bar), and the staged ciphertexts must equal the megakernel client's
     for the same seed and nonce base, word for word;
  5. profiles three round trips of each path (device time by CUDA kernel,
     each of K5 / K6's device kernels under its own name, device busy /
     idle share), then times every kernel at ``paper``, B=1 and B=16 (CUDA
     events around 5 calls queued behind a spin, so the card never waits
     on the host; after warm-up), and the plain versions at B=16; prints
     the device kernels one K5 / K6 / K1 - K4 call launches, each with its
     time, and times K1 both ways at the flow's (6, 1, 2^16) stack beside
     its bound and its plain version;
  6. the server op set (K7-K11): holds each of its nine kernel bodies
     against its plain version, bit for bit, on ciphertexts of the
     staged f64 client and keys of its ``make_evaluation_keys``:
     ``server`` level 8 B=2 (the plain versions under both datapaths'
     REDC engines: the kernels' one u64 REDC gives the words of both),
     ``boot`` level 6 B=2 and level 24 B=1 (the df32 engine), and on
     random residues and random key words at ``n15`` level 6 B=2 (odd
     logN: an uneven 2^8 x 2^7 split of every transform stage; both
     engines); checks that hoisted rotations give the fused rotation's
     words at ``boot`` level 6;
  7. drives the encrypted-inference flow
     (``repro_torch.fhe_server.encrypted_inference.run``: encrypt, keys,
     both shipped as wire payloads, linear layer + poly3 on the server, the
     result shipped back, decrypt), d=8, level 6 -> 2, at
     ``server`` (error < 2^-12 asserted) and at ``boot`` (the flow's words
     held against the same flow through the plain versions on the card;
     error printed beside the budget), counters set to 0 just before each
     and read just after; profiles the server part of each flow, then
     times every server kernel at ``boot`` level 6 and 24, B=1, queued
     ahead as in 5 (and, printed beside it, as the host paces the calls),
     and prints the device kernels one call of each server kernel that
     transforms launches (the heaps, then its stages' passes), each with
     its time;
  8. the Fourier engine's per-prime entry points (K12-K14) at ``paper``
     on residues x of shape (24, 16, 2^16): ``ops.ntt_limbs`` /
     ``intt_limbs(path='matmul')`` (K14, one launch for the stack),
     ``ntt_butterfly.ntt_rows`` / ``intt_rows`` on each limb (K12),
     ``client_pointwise.encrypt_limb`` on each limb and ``decrypt_limb`` on
     limbs 0 and 1 (K13), counters set to 0 just before and read just
     after. K12 must equal K1 per limb, K13 K2 / K3 per limb, K14 K1 under
     bit reversal, the inverses must give x back, and each must equal its
     plain version on the first 4 rows of each limb; K14 also on one
     ``n15`` limb (256 x 128 split), B=2; K12 (both ways), K13a and K13b
     also on random words at ``paper`` B=1, ``n15`` B=2 (an uneven 8 + 7
     split) and ``server`` B=2 (one pass), every limb == K1 / K2 / K3,
     limbs 0 and L-1 == plain, K13a's rows across the 2^32 nonce wrap.
     Then each is timed (queued ahead, as in 5) beside its plain version,
     K12, K13a and K13b also at B=1, and the device kernels one K12 / K13
     / K14 call launches are printed, each with its time (K12, K13a, K13b:
     a heap or noise prologue and two passes at N=2^16; K14: its two
     products, one device kernel each); K12, K13a and K13b beside their
     control, K1 / K2 / K3 on the same limb and rows (the same tile plan
     under the general REDC), pass by pass;
  9. the f64 datapath: ``FHEClient('paper', datapath='f64')`` at B=16 and
     B=1 (K5 / K6's f64 branches), counters set to 0 just before and read
     just after, >= 19.29 bits; K5 / K6 f64 == their plain versions on the
     first 4 rows (K6 at scales that are not powers of two), c0 / c1 == the
     df32 megakernel's, decoded parts == the staged f64 client's; the host
     oracle client (``fourier='host'``) at B=16 (K1, K2, K3 launched,
     >= 19.29 bits); the seeded chain (encrypt_symmetric_seeded -> wire
     kind 2 -> expand_seeded -> decrypt) == the same chain on the CPU, its
     payload half a full one; ``ServerEvaluator(datapath='f64')`` on the
     ``server`` flow's deserialized inputs (counters as above: the same
     kernels) == the df32 flow, its result through the f64 megakernel ==
     the staged f64 decode; then times of K5 / K6 f64 (queued ahead, as
     in 5) beside the plain versions and the bounds;
 10. the client service at ``paper``: ``ClientService(FHEClient('paper'),
     n_streams=2, oversubscribe=True)`` (two CUDA streams on the card,
     ``DEFAULT_BUCKETS``, a tenant lane ``'t1'`` beside the default one),
     every (kind, bucket) shape warmed first, the counters set to 0 just
     after: (a) closed loop, 44 encrypts (jobs of 16, 16 and 16 with 12
     real rows) and 4 of the results decrypted, the dispatch log's modes
     == ``plan_rounds``; the same again without the profiler, timed: the
     closed-loop rate; (b) always on, 64 encrypts and 6 decrypts arriving
     as a seeded Poisson process (mean gap 1 ms, max wait 5 ms), then
     ``stop(drain=True)``: the offered rate (requests over the arrival
     span) beside the served requests/s (arrival-bound: the window is
     mostly the arrivals' gaps), p50 / p99 latency, jobs and rounds by
     mode; again under torch.profiler: the device busy share and
     whether the two streams' K5 kernels overlapped (reported, not
     asserted); (c) a launch fault on stream 0 (its job retried on stream
     1 under the same lease; ``stream_failed``, ``degraded``, ``requeue``
     logged), then a materialize fault (``retry_ok``); (d) 8 encrypts on the
     tenant lane beside 8 on the default one, 2 tenant decrypts. Then the
     counters must show one K5 launch per encrypt job launched (retries
     included) and one K6 per decrypt job, nothing else; the table-cache
     odometer must not have moved since warm-up; every encrypt row == the
     direct ``encode_encrypt_batch`` of its job's rows from the job's nonce
     base on a same-seed client of its lane (the tenant's: a solo client of
     seed ``tenant_seed``), 0 differing words; every decrypt == the direct
     ``decrypt_decode_batch``, >= 19.29 bits;
 11. the service mesh at ``paper``: ``MeshRouter(n_workers=2,
     profile='paper')`` with ``DEFAULT_BUCKETS``, both worker processes on
     the card (each a ``ClientService`` over ``FHEClient('paper')``,
     loading the kernels phase 2 built): (a) 40 encrypts on the default
     lane and 8 on tenant ``'t1'``, one flush, twice (the first pays the
     workers' client builds; the second gives the router's requests/s);
     (b) 4 of the results decrypted as 2-limb views (wire kind 1) and 2
     ``encrypt_symmetric_seeded`` ciphertexts (kind 2, half the submit
     bytes), each == the direct ``decrypt_decode_batch``, >= 19.29 bits,
     with the wire bytes per request by kind; (c) the relin key broadcast
     (the router requires byte-identical replies) == this process's
     ``make_evaluation_keys``; then no worker may have died; (d) 48
     encrypts dispatched, the worker with chunks outstanding killed, the
     flush re-sends them to the survivor under their leases (``requeues``
     >= 1, one ``worker_failed`` event). Every encrypt row == the port's
     solo ``ClientService`` in this process from the lane's lease base (the
     tenant's on a client of seed ``tenant_seed``), 0 differing words. The
     workers' launches are in their own processes, which this process's
     counters do not see: the phase prints its own JSON line, with each
     worker's time from spawn to HELLO and to its first result;
 12. the LM substrate's serving path (``repro_torch.models``, the serving
     engine, the serve launcher, the private-inference loop), random
     weights from a CUDA generator: (a) the private-inference loop
     (``fhe_client.private_inference.run``) at qwen2-vl-2b's full width
     and depth (28 layers, d_model 1536, 1.78 B params), x (2, 24,576) at
     ``paper`` through ``ClientService(buckets=(1, 2, 4, 8))``, counters
     set to 0 just before and read just after: K5 launches == encrypt
     jobs, K6 == decrypt jobs, nothing else, round trip < 1e-4 (the
     reference's assert); the stand-in server's prefill ms, the loop's
     seconds and the wire bytes up and down; (b) ``launch.serve.serve``
     on the same model, B=4, prompt 64, 16 tokens: prefill ms and decode
     tokens/s; (c) ``ServingEngine`` at hymba-1.5b's full size (32 layers,
     1.64 B params), 4 slots, cache 256, 6 requests of 32-96 tokens, 16
     new each: all finish, and one request through a 1-slot engine ==
     a direct prefill + ``decode_step`` loop on the card; (d) each of the
     10 archs at ``reduced_config``, the same params on the card and on
     the CPU: prefill logits and 3 decode steps within 3e-2 of the CPU
     logits' scale (the CPU tests' tolerance), greedy tokens equal where
     the CPU's top-2 margin exceeds it; prints the phase's JSON line;
 13. the LM substrate's training path (``repro_torch.training``,
     ``launch.train``, ``distributed.checkpoint``; it reaches no kernel of
     the port: every launch counter, set to 0 just before, must read 0
     just after): (a) ``launch.train`` as ``launch.train_lm`` drives it,
     mamba2-130m full (24 layers, d_model 768), batch 8 x 512, micro 2,
     ``--compress``, 8-bit AdamW, 20 steps: step ms and tokens/s; then 10
     steps without ``--compress``, ``--resume`` to 19, against 19 straight
     in another directory: the losses of steps 10-18 and the final
     checkpoints, bit-identical or their largest difference (loss within
     1e-3 of its scale); (b) qwen2-vl-2b full (1.78 B params), batch 4 x
     512, micro 2, remat, 8-bit AdamW lr 1e-3 warmup 5, 10 steps on one
     batch: the loss must fall by > 0.1; step ms, tokens/s, peak memory,
     a profile of one step; (c) each of the 10 archs at
     ``reduced_config``, the same params on the card and on the CPU:
     ``train_fwd`` gradients within 3e-2 of each leaf's CPU scale, every
     one finite, and one train step (8-bit, micro 2, compress) within
     2.01 lr of the CPU's, at most 2 % of the entries stepping otherwise;
     prints the phase's JSON line;
 14. the port's launchers that the earlier phases leave out: (a)
     ``launch.quickstart --profile paper`` on the card, every launch
     counter set to 0 just before and read just after: K2 and K3 (the
     per-ciphertext half: ``ops.encrypt_fused`` / ``decrypt_fused``) and
     K5 and K6 (``FHEClient`` at B=4) must each have launched, both halves
     >= 19.29 bits, the host ms of each half printed; (b) ``launch.dryrun``
     over the train_4k cell of each of the 10 archs on both production
     meshes (20 records into ``build/dryrun/``, no device); (c) the
     dry-run's per-device bytes of the params and the 8-bit AdamW state of
     the qwen2-vl-2b train cell on a one-device (1, 1) mesh == the summed
     ``nbytes`` of the params and state phase 13 (b) allocated on the card
     (the batch left out: its size is the cell's own); the dry-run reaches
     no kernel (the counters read 0 after (b) and (c)); prints the phase's
     JSON line;
 15. the contracts the CPU mirrors of the reference's tests hold
     (``tests/test_torch_{client_stream,device_fourier,ckks,server_ops,
     rules}.py``), on the card at ``paper`` / ``server`` / ``boot``, each
     with the counters set to 0 just before and read just after: (a) 16
     B=1 ``encode_encrypt_batch`` calls from nonce base 0 == one B=16 call,
     word for word, on the megakernel (K5, 17 launches) and the staged
     df32 client (K2, 17), and the two walked from nonce base 300 give the
     same words for 3 batches, both ending at 303; (b) ``decrypt_batch``
     of 4 two-limb ciphertexts, rows 1 and 3 at twice the message and
     twice the scale, through K6's per-row scale operand: within 1e-4;
     (c) a B=16 round trip calls the host SpecialFFT / SpecialIFFT
     (``core/fft.py``) and ``numpy.fft`` 0 times on both device pipelines
     and at least once with ``fourier='host'``, each >= 19.29 bits; (d)
     the megakernel's ciphertexts under a key of seed 0xDEADBEEF: < 5
     bits; (e) the ``server`` preset at level 4: add_ct < 2^-15, mul_ct <
     2^-13, rotate(1) < 2^-14 (``test_server_ops.py:669``), and at
     ``boot`` level 6 a raw mul_pt (K7) then rescale (K8) == the fused
     mul_pt + rescale (K8b), word for word; (f) on card tensors, rescale
     at level 2, ``drop_to(1)``, a scale mismatch and mul_ct without a
     relinearization key raise ``AssertionError`` (the reference's
     asserts), a missing rotation key ``KeyError``, and no kernel
     launches; prints the phase's JSON line;
 16. the paper's analytic models against the card, at ``paper``: (a)
     ``CKKSContext``'s four memory terms (twiddle tables, their OTF seeds,
     key material, mask and errors a ciphertext) beside the bytes of K5's
     and K6's device tables by part; K5's NTT seed table must equal its
     host table and stay under 0.5 % of the twiddle tables; (b) one K5
     call at B=16 after a warm-up, both in a private memory pool, the
     counters set to 0 just before: one launch, and its peak allocation
     above what was allocated before it (``reset_peak_memory_stats`` /
     ``max_memory_allocated``) within 1 MiB of its outputs and five
     scratch tensors reckoned from the shapes, its peak requested bytes
     equal to them;
     NTT(v)'s scratch printed beside 16 masks of ``mask_error_bytes``;
     (c) ``special_fft_quantized`` round trips (the reference bench's
     sweep: n = 2^12, mantissas 30-52; n_slots = 2^15 at 43 and the df32
     pair's 49 bits) beside K4's df32 round trip at n_slots = 2^15
     (``ops.special_ifft`` then ``special_fft``, seed 3, two launches),
     every row at 43 bits or more >= 19.29 bits; (d) each of the 15 routed
     entries under the reference's names (``client_stream``,
     ``client_pointwise``, ``ntt_butterfly``, ``server_eval``) on card
     tensors, with the reference's positional arguments, the client ones
     at ``test`` B=2, the server ones at ``server`` level 4 B=1 on random
     words: one launch of its kernel each, 0 words differing from its
     plain version; prints the phase's JSON line;
 17. prints the ``kernels`` JSON line (launches, max_abs_err, times, the
     bound; for K5 / K6, K1 - K4, the server kernels K8-K11 and K12 - K14
     also the device kernels per call; K5 / K6's launches include the
     service phase's, the private-inference loop's and the quickstart's,
     K1 - K3's the quickstart's), then, as the last line,
     ``{"ok": true, "device": ...}``.

Any mismatch, failed build or failed launch ends the run with a non-zero
exit code and no result line. Needs a CUDA device; without one it exits 2.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BOOT_PREC_BITS = 19.29
MAIN_PROFILE, MAIN_BATCH = "paper", 16
CHECKS = (("test", 16), ("paper", 4), ("paper", 16))
# K5 / K6 against their plain versions on every row beyond CHECKS:
# (profile, batch, datapaths). paper B=1 and n15 (odd logN: an uneven tile
# split) on both datapaths, the f64 branches at CHECKS' smaller shapes
# (paper B=16 f64: phase 9)
MEGA_CHECKS = (("test", 16, ("f64",)), ("paper", 1, ("df32", "f64")),
               ("paper", 4, ("f64",)), ("n15", 2, ("df32", "f64")))
SEED = 20261017
DEVICE = "cuda"

# Peaks of one H100 SXM at its 1.98 GHz boost clock and 700 W, per
# instruction: HBM 3.35 TB/s; float32 outside the tensor cores 33.5e12
# instructions/s (the data sheet's 67 TFLOP/s counts a fused multiply-add
# as two operations; these kernels are built with --fmad=false, so every
# float operation is its own instruction); int32 16.7e12 instructions/s
# (64 INT32 lanes per SM x 132 SMs x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
I32_OPS_PER_S = 64 * 132 * 1.98e9
# int8 products on the tensor cores, dense (data sheet; a multiply and an
# add count as two operations): the least time for K14's digit products
I8_TENSOR_OPS_PER_S = 1979e12

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


def _seed_cols(p) -> int:
    return 3 + p.logn * (p.logn + 1)        # seed-table columns


def _cost_ntt_limbs(p, rows: int, inverse: bool, n_limbs: int | None = None):
    """(bytes, int32 ops, f32 ops) of K1 on (L, rows, N) (L = n_limbs, the
    profile's limbs by default): logN * N/2 butterflies per (limb, row),
    N^-1 per coefficient (inverse), the twiddles (N - 1 doublings) once per
    limb."""
    n, logn = p.n, p.logn
    L = p.n_limbs if n_limbs is None else n_limbs
    per_row = logn * (n // 2) * I32_NTT_BUTTERFLY + (n * I32_REDC
                                                     if inverse else 0)
    i32 = L * rows * per_row + L * (n - 1) * I32_REDC
    return float(2 * L * rows * n * 4 + L * _seed_cols(p) * 4), float(i32), 0.0


def _cost_encrypt_limbs(p, batch: int):
    """K2 on (B, L, N): the five Philox words once per (row, coefficient),
    three NTTs and the pointwise ops per (row, limb), twiddles per limb."""
    n, logn, L = p.n, p.logn, p.n_limbs
    per_row = n * (5 * I32_PHILOX + 20)
    per_row_limb = (n * (3 * I32_TO_RESIDUE + 2 * I32_REDC + 3 * I32_ADDMOD)
                    + 3 * logn * (n // 2) * I32_NTT_BUTTERFLY)
    i32 = batch * (per_row + L * per_row_limb) + L * (n - 1) * I32_REDC
    nbytes = (batch * L * n * 4 + 2 * L * n * 4 + L * _seed_cols(p) * 4
              + 2 * batch * L * n * 4)
    return float(nbytes), float(i32), 0.0


def _cost_decrypt_limbs(p, batch: int):
    """K3 on a (B, 2, N) view: c0 + c1*s, one INTT and N^-1 per (row,
    limb), twiddles per limb."""
    n, logn = p.n, p.logn
    per_row_limb = (n * (2 * I32_REDC + I32_ADDMOD)
                    + logn * (n // 2) * I32_NTT_BUTTERFLY)
    i32 = batch * 2 * per_row_limb + 2 * (n - 1) * I32_REDC
    nbytes = (2 * batch * 2 * n * 4 + 2 * n * 4 + batch * 2 * n * 4
              + 2 * _seed_cols(p) * 4)
    return float(nbytes), float(i32), 0.0


def _cost_fft_rows(p, rows: int, inverse: bool):
    """K4 on four (rows, n_slots) planes: log2(n) * n/2 butterflies of 168
    f32 ops per row, plus the 1/n scale (two df multiplies per slot)."""
    ns = p.n_slots
    logns = ns.bit_length() - 1
    f32 = rows * (logns * (ns // 2) * F32_FFT_BUTTERFLY
                  + (ns * 48 if inverse else 0))
    return float(2 * rows * 4 * ns * 4 + 4 * ns * 4), 0.0, float(f32)


# --- the server op set (K7-K11) ------------------------------------------
# At level l, B ciphertexts of N coefficients: one N-point NTT is
# logN * N/2 butterflies; an INTT adds N REDCs (N^-1); the twiddles of one
# (prime, direction) are N-1 doublings, counted once per prime used.


def _ntt_ops(p) -> float:
    return p.logn * (p.n // 2) * I32_NTT_BUTTERFLY


def _intt_ops(p) -> float:
    return _ntt_ops(p) + p.n * I32_REDC


def _tw_ops(p, primes: int) -> float:
    return primes * (p.n - 1) * I32_REDC


I32_CENTER = 3      # compare, subtract, select


def _ks_parts(p, level: int, batch: int) -> dict:
    """int32 ops of the hybrid key switch's stages for B polys: digits (l
    INTTs + centre), base extension (l l residues + NTTs: digit j on its
    own row i == j comes back as the input limb, NTT_j(INTT_j(x_j)) = x_j,
    so it needs no work), the multiply-accumulate (2 (l+1) l REDC +
    addmod), the mod-down (2 INTTs of the special row, 2 l NTTs, submod +
    REDC)."""
    n, l = p.n, level
    return {
        "digits": batch * l * (_intt_ops(p) + n * I32_CENTER),
        "extend": batch * l * l * (_ntt_ops(p) + n * I32_TO_RESIDUE),
        "mac": batch * (l + 1) * l * n * 2 * (I32_REDC + I32_ADDMOD),
        "moddown": batch * 2 * (_intt_ops(p) + n * I32_CENTER
                                + l * (_ntt_ops(p) + n * (
                                    I32_TO_RESIDUE + I32_ADDMOD
                                    + I32_REDC))),
        "tw": _tw_ops(p, 2 * (l + 1)),
    }


def _rescale_ops(p, level: int, batch: int, fused_pt: bool,
                 twiddles: bool = True) -> float:
    """int32 ops of a rescale of B ciphertexts: the top row's INTT and
    centring, l-1 NTTs with their residue, submod and REDC per word, and
    the twiddles of the l primes it transforms with (one INTT prime, l-1
    NTT primes), unless a key switch before it made them (K9)."""
    n, l = p.n, level
    ops = batch * 2 * (_intt_ops(p) + n * I32_CENTER
                       + (l - 1) * (_ntt_ops(p) + n * (
                           I32_TO_RESIDUE + I32_ADDMOD + I32_REDC)))
    if fused_pt:
        ops += batch * 2 * l * n * I32_REDC
    return ops + (_tw_ops(p, l) if twiddles else 0.0)


def _cost_server(name: str, p, level: int, batch: int):
    """(bytes, int32 ops, f32 ops) of one server op at level l on B
    ciphertexts: inputs read once, outputs written once."""
    n, l = p.n, level
    ct = batch * l * n * 4                   # one (B, l, N) poly
    pt = l * n * 4
    key = 2 * l * (l + 1) * n * 4            # (b, a) key slices
    h = batch * (l + 1) * l * n * 4
    out_rs = 2 * batch * (l - 1) * n * 4
    ks = _ks_parts(p, l, batch)
    if name == "add_ct":
        return float(6 * ct), float(2 * batch * l * n * I32_ADDMOD), 0.0
    if name == "add_pt":
        return float(4 * ct + pt), float(batch * l * n * I32_ADDMOD), 0.0
    if name == "mul_pt":
        return float(4 * ct + pt), float(2 * batch * l * n * I32_REDC), 0.0
    if name == "rescale":
        return float(2 * ct + out_rs), float(_rescale_ops(p, l, batch,
                                                          False)), 0.0
    if name == "mul_pt_rescale":
        return (float(2 * ct + pt + out_rs),
                float(_rescale_ops(p, l, batch, True)), 0.0)
    if name == "mul_ct":
        tensor = batch * l * n * (6 * I32_REDC + I32_ADDMOD)
        ops = (tensor + sum(ks.values()) + 2 * batch * l * n * I32_ADDMOD
               + _rescale_ops(p, l, batch, False, twiddles=False))
        return float(4 * ct + key + out_rs), float(ops), 0.0
    if name == "rotate":
        ops = sum(ks.values()) + batch * l * n * I32_ADDMOD
        return float(4 * ct + key + n * 4), float(ops), 0.0
    if name == "ks_decompose":
        return (float(ct + h),
                float(ks["digits"] + ks["extend"] + _tw_ops(p, 2 * l + 1)),
                0.0)
    if name == "ks_apply_rot":
        ops = (ks["mac"] + ks["moddown"] + _tw_ops(p, l + 1)
               + batch * l * n * I32_ADDMOD)
        return float(3 * ct + h + key + n * 4), float(ops), 0.0
    raise ValueError(name)


# --- the per-prime kernels (K12-K14) -------------------------------------
# K12 and K13 compute what K1 and K2 / K3 compute for one limb, and K14
# what K1 computes, in natural order; their bounds count the least work for
# the same words: K1's cheaper REDC (11 int32 operations), not the
# shift-add REDC K12 / K13 run, and K1's butterflies, not K14's four-step
# int32 work.


def _cost_ntt_rows(p, rows: int, inverse: bool):
    """K12 on (rows, N) of one prime: logN * N/2 butterflies per row, N^-1
    per coefficient (inverse), the twiddles (N - 1 doublings) once."""
    n, logn = p.n, p.logn
    per_row = logn * (n // 2) * I32_NTT_BUTTERFLY + (n * I32_REDC
                                                     if inverse else 0)
    i32 = rows * per_row + (n - 1) * I32_REDC
    return float(2 * rows * n * 4 + _seed_cols(p) * 4 + 32), float(i32), 0.0


def _cost_encrypt_limb(p, batch: int):
    """K13a on (B, N) of one limb: K2's count with L = 1."""
    n, logn = p.n, p.logn
    i32 = (batch * (n * (5 * I32_PHILOX + 20)
                    + n * (3 * I32_TO_RESIDUE + 2 * I32_REDC
                           + 3 * I32_ADDMOD)
                    + 3 * logn * (n // 2) * I32_NTT_BUTTERFLY)
           + (n - 1) * I32_REDC)
    nbytes = batch * n * 4 + 2 * n * 4 + 2 * batch * n * 4 + _seed_cols(p) * 4
    return float(nbytes), float(i32), 0.0


def _cost_decrypt_limb(p, batch: int):
    """K13b on (B, N) of one limb: K3's count with one limb."""
    n, logn = p.n, p.logn
    i32 = (batch * (n * (2 * I32_REDC + I32_ADDMOD)
                    + logn * (n // 2) * I32_NTT_BUTTERFLY)
           + (n - 1) * I32_REDC)
    nbytes = 2 * batch * n * 4 + n * 4 + batch * n * 4 + _seed_cols(p) * 4
    return float(nbytes), float(i32), 0.0


def _cost_ntt_mm(p, rows: int, inverse: bool):
    """(bytes, int32 ops, f32 ops, int8 tensor ops) of K14 on an (L, rows,
    N) stack: the least work for the function it computes. K14 is K1 up to
    the order of the output words (the phase checks K14 == K1[..., bitrev]),
    so it counts K1's butterflies, and beside them its 16 int8 digit
    products per modular matmul (N1 N2^2 + N2 N1^2 multiply-adds each, two
    operations apiece) at the tensor cores' int8 peak; the larger binds.
    The four-step's own int32 work (digit split, Barretts, twist, T) is not
    counted: a butterfly NTT computes the same words without it."""
    n = p.n
    n1 = 1 << ((n.bit_length()) // 2)
    n2 = n // n1
    macs = 16 * (n1 * n2 * n2 + n2 * n1 * n1)
    return (*_cost_ntt_limbs(p, rows, inverse),
            float(2 * p.n_limbs * rows * macs))


def _bound_ms(nbytes: float, i32: float, f32: float,
              i8: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(i32 / I32_OPS_PER_S, f32 / F32_OPS_PER_S,
                i8 / I8_TENSOR_OPS_PER_S)
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


GPU_HZ = 1.98e9     # H100 SXM boost clock: what the spin's cycles count


def _device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call of a kernel wrapper `fn`, with the calls queued
    ahead: the stream first spins long enough for the host to enqueue all
    `iters` calls, so the card runs them back to back and never waits on
    the host's launch path. Fails if a spin, doubled twice, still ends
    before the last call is enqueued (a wrapper that blocks the host)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    spin_s = 4 * host_s + 2e-3
    for _ in range(3):
        torch.cuda._sleep(int(spin_s * GPU_HZ))
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(stop) / iters
        spin_s *= 2
    _fail("the spin ended before the timed calls were enqueued")


def _cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Time per call of `fn` as the host paces it (CUDA events around
    back-to-back calls): the plain versions, and wrappers' launch paths."""
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


# the staged kernels by counter name: (id, CUDA source, TPU kernel body)
STAGED = {
    "ntt_limbs": ("K1", "ntt_limbs.cu", "ntt_butterfly.py:70"),
    "intt_limbs": ("K1", "ntt_limbs.cu", "ntt_butterfly.py:76"),
    "encrypt_limbs": ("K2", "client_pointwise.cu", "client_pointwise.py:264"),
    "decrypt_limbs": ("K3", "client_pointwise.cu", "client_pointwise.py:321"),
    "special_fft": ("K4", "fft_df.cu", "fft_df.py:158"),
    "special_ifft": ("K4", "fft_df.cu", "fft_df.py:158"),
}


def _staged_chain(client, msgs, nonce0: int, errs=None) -> dict:
    """One staged round trip, step by step through the CUDA wrappers: the
    client's ``_encrypt_core_dev32_impl`` / ``_decrypt_core_dev32_impl``
    with each kernel's input kept. With `errs` (a dict by kernel), each
    kernel is also run as its plain version on the same input and must
    agree bit for bit. Returns the kernels' inputs and outputs."""
    import torch
    from repro_torch.core import dfloat as dfl
    from repro_torch.core import encoder, modmul, rns
    from repro_torch.kernels import (client_pointwise, fft_df,
                                     ntt_butterfly)
    ctx, p = client.ctx, client.ctx.params
    L, ns = p.n_limbs, p.n_slots
    plans = ctx.plans[:L]
    pkb, pka = client.keys.pk.b_mont, client.keys.pk.a_mont
    s_mont = client.keys.sk.s_mont

    def check(name, got, want):
        if errs is None:
            return
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        e = max(_max_abs_err(a, b) for a, b in zip(got, want))
        errs[name] = max(errs[name], e)
        if not all(_same_bits(a, b) for a, b in zip(got, want)):
            _fail(f"{name} differs from its plain version at {p.logn=} "
                  f"B={len(msgs)} (max abs err {e})")

    def plain(f, *args):
        return f(*args) if errs is not None else None

    x = {"enc_planes": client.encrypt_operands(msgs)}
    y = fft_df.special_fft_cuda(x["enc_planes"], p.m, True)
    check("special_ifft", y,
          plain(fft_df.special_fft_plain, x["enc_planes"], p.m, True))
    w = dfl.dfc_from_planes(y)
    digits = encoder.delta_scale_digits(encoder.planes_to_coeff_df(w),
                                        p.delta)
    x["residues"] = modmul.i64_to_u32(rns.digits_to_residues_stacked(
        *digits, ctx.q_list[:L])).contiguous()
    x["pt_ntt"] = ntt_butterfly.limb_rows_cuda(x["residues"], plans, False)
    check("ntt_limbs", x["pt_ntt"],
          plain(ntt_butterfly.limb_rows_plain, x["residues"], plans, False))
    back = ntt_butterfly.limb_rows_cuda(x["pt_ntt"], plans, True)
    check("intt_limbs", back,
          plain(ntt_butterfly.limb_rows_plain, x["pt_ntt"], plans, True))
    if not torch.equal(back, x["residues"]):
        _fail("INTT(NTT(x)) != x on the card")
    x["pt"] = x["pt_ntt"].transpose(0, 1).contiguous()
    c0, c1 = client_pointwise.encrypt_limbs_cuda(x["pt"], pkb, pka, ctx,
                                                 client.seed, nonce0)
    check("encrypt_limbs", (c0, c1),
          plain(client_pointwise.encrypt_limbs_plain, x["pt"], pkb, pka,
                ctx, client.seed, nonce0))
    x["c0"], x["c1"] = c0, c1
    m = client_pointwise.decrypt_limbs_cuda(c0[:, :2], c1[:, :2], s_mont,
                                            ctx)
    check("decrypt_limbs", m,
          plain(client_pointwise.decrypt_limbs_plain, c0[:, :2], c1[:, :2],
                s_mont, ctx))
    sign, vh, vl = rns.crt2_centered_u32(
        modmul.u32_to_i64(m[:, 0]), modmul.u32_to_i64(m[:, 1]),
        ctx.q_list[0], ctx.q_list[1])
    scale = torch.full((len(msgs), 1), p.delta, dtype=torch.float32,
                       device=m.device)
    v = rns.centered_to_df(sign, vh, vl, 1.0 / scale)
    # the halves of the (B, N) rows, views read through their row stride
    x["dec_planes"] = (v.hi[:, :ns], v.lo[:, :ns], v.hi[:, ns:],
                       v.lo[:, ns:])
    out = fft_df.special_fft_cuda(x["dec_planes"], p.m, False)
    check("special_fft", out,
          plain(fft_df.special_fft_plain, x["dec_planes"], p.m, False))
    # the chain is the client's staged path: same words as the client
    client.nonce = nonce0
    cts = client.encode_encrypt_batch(msgs)
    planes = client.decrypt_planes(cts.truncated(2))
    torch.cuda.synchronize()
    if not (torch.equal(cts.c0, c0) and torch.equal(cts.c1, c1)
            and all(_same_bits(a, b) for a, b in zip(planes, out))):
        _fail("the step-by-step staged chain differs from the client's")
    return x


# K1 - K4 against their plain versions beyond CHECKS, at the shapes the
# tiled NTT's and FFT's planning reaches: (profile, K1 stack (L, rows) or
# None, K2 batch or None, K2 nonce base, K3 / K4 batch or None)
STAGED_SHAPES = (
    ("paper", (24, 1), 1, 123, 1),    # B=1: the fewest blocks at N = 2^16
    ("boot", (6, 1), None, 0, None),  # the flow's plaintext encoder
    ("n15", (24, 2), 2, 123, 2),      # odd logN: an uneven 8 + 7 split
    ("server", (8, 2), 2, 123, 2),    # N = 2^10: one pass
    ("paper", None, 4, 0xFFFFFFFE, None),  # K2 rows across the nonce wrap
)
K3_LIMBS = (2, 3)    # K3 on the L_dec-limb views of a (B, L, N) batch
FLOW_K1_PROFILE, FLOW_K1_STACK = "boot", (6, 1)   # (L, rows) a flow call


def _rand_words(ctx, shape, seed: int, dev):
    """Random uint32 residues as int32 words on `dev`, limb axis 0."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q = np.asarray(ctx.q_list[:shape[0]], np.uint64).reshape(
        (-1,) + (1,) * (len(shape) - 1))
    w = (rng.integers(0, 1 << 32, shape, dtype=np.uint64) % q
         ).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(dev)


def _rand_planes(ns: int, rows: int, seed: int, dev):
    """Four (rows, 2 ns) float32 df planes of random values on `dev`."""
    import numpy as np
    import torch
    z = np.random.default_rng(seed).standard_normal((2, rows, 2 * ns))
    hi = z.astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        hi[0], (z[0] - hi[0]).astype(np.float32),
        hi[1], (z[1] - hi[1]).astype(np.float32)))


def _check_staged_shapes(dev, errs: dict) -> None:
    """K1 (both directions), K2, K3 and K4 (both directions) against their
    plain versions, bit for bit, on random words at STAGED_SHAPES; K2 on
    the (L, B, N) -> (B, L, N) transposed view (as the staged client passes
    it) and on its contiguous copy; K3 on the L_dec-limb views of a
    (B, L, N) batch (L_dec = 2, as the client decrypts, and 3); K4's
    forward on the halves of (B, N) rows (as the staged decode passes
    them), its inverse on contiguous planes. The kernels' words do not
    depend on the key rows being a real key, so K2 and K3 take random
    ones."""
    from repro_torch.core.context import get_context
    from repro_torch.kernels import client_pointwise, fft_df, ntt_butterfly
    for i, (profile, stack, batch, nonce0, k34) in enumerate(STAGED_SHAPES):
        ctx = get_context(profile)
        p = ctx.params
        done = []
        if stack is not None:
            L, rows = stack
            x = _rand_words(ctx, (L, rows, p.n), 60 + i, dev)
            plans = ctx.plans[:L]
            y = ntt_butterfly.limb_rows_cuda(x, plans, False)
            at = f"its plain version at {profile} ({L}, {rows}, {p.n})"
            _hold(errs, "ntt_limbs", y,
                  ntt_butterfly.limb_rows_plain(x, plans, False), at)
            back = ntt_butterfly.limb_rows_cuda(y, plans, True)
            _hold(errs, "intt_limbs", back,
                  ntt_butterfly.limb_rows_plain(y, plans, True), at)
            _hold(errs, "intt_limbs", back, x,
                  f"x: INTT(NTT(x)) at {profile} ({L}, {rows}, {p.n})")
            done.append(f"K1 ({L}, {rows}, {p.n})")
        if batch is not None:
            L = p.n_limbs
            by_limb = _rand_words(ctx, (L, batch, p.n), 70 + i, dev)
            pt = by_limb.transpose(0, 1)              # (B, L, N) view
            pkb, pka = (_rand_words(ctx, (L, p.n), 80 + i + k, dev)
                        for k in (0, 1))
            want = client_pointwise.encrypt_limbs_plain(
                pt.contiguous(), pkb, pka, ctx, SEED, nonce0)
            at = (f"its plain version at {profile} B={batch} nonce0 "
                  f"{nonce0:#x}")
            _hold(errs, "encrypt_limbs", client_pointwise.encrypt_limbs_cuda(
                pt, pkb, pka, ctx, SEED, nonce0), want, at + " (view)")
            _hold(errs, "encrypt_limbs", client_pointwise.encrypt_limbs_cuda(
                pt.contiguous(), pkb, pka, ctx, SEED, nonce0), want, at)
            done.append(f"K2 B={batch} nonce0 {nonce0:#x} (view and "
                        f"contiguous)")
        if k34 is not None:
            L, ns = p.n_limbs, p.n_slots
            c0, c1 = (_rand_words(ctx, (L, k34, p.n), 100 + i + k, dev
                                  ).transpose(0, 1).contiguous()
                      for k in (0, 1))
            s_mont = _rand_words(ctx, (L, p.n), 102 + i, dev)
            for n_limbs in K3_LIMBS:
                _hold(errs, "decrypt_limbs",
                      client_pointwise.decrypt_limbs_cuda(
                          c0[:, :n_limbs], c1[:, :n_limbs], s_mont, ctx),
                      client_pointwise.decrypt_limbs_plain(
                          c0[:, :n_limbs], c1[:, :n_limbs], s_mont, ctx),
                      f"its plain version at {profile} B={k34} on the "
                      f"{n_limbs}-limb view")
            full = _rand_planes(ns, k34, 110 + i, dev)
            halves = (full[0][:, :ns], full[1][:, :ns], full[2][:, ns:],
                      full[3][:, ns:])
            contiguous = tuple(h.contiguous() for h in halves)
            for name, inverse, planes in (("special_fft", False, halves),
                                          ("special_ifft", True,
                                           contiguous)):
                _hold(errs, name,
                      fft_df.special_fft_cuda(planes, p.m, inverse),
                      fft_df.special_fft_plain(planes, p.m, inverse),
                      f"its plain version at {profile} B={k34}")
            done.append(f"K3 B={k34} L_dec {K3_LIMBS} (views); K4 both "
                        f"ways B={k34} (forward on row halves)")
        print(f"kernel == plain (bit-identical), {profile}: "
              f"{'; '.join(done)}", flush=True)


def _profile_main_path(client, msgs, iters: int = 3) -> None:
    """Device time by CUDA kernel or copy and the device's busy share over
    a window of `iters` main-path round trips (torch.profiler / CUPTI)."""
    def round_trip():
        client.decrypt_decode_batch(
            client.encode_encrypt_batch(msgs).truncated(2))

    _profile(round_trip, iters, f"{client.pipeline} {MAIN_PROFILE} "
             f"B={len(msgs)} round trip")


def _profile(fn, iters: int, what: str) -> None:
    """Profile `iters` calls of `fn` after one warm-up: device time by CUDA
    kernel or copy, and the device's busy share of the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        # device activities only (kernels, copies): a CPU op's device time
        # is its kernels' again
        if ev.device_type != DeviceType.CUDA:
            continue
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
    print(f"profile: {what} {per_trip:.3f} ms host clock, device busy "
          f"{busy:.3f} ms ({100 * busy / per_trip:.1f}%, idle "
          f"{100 * (1 - busy / per_trip):.1f}%)", flush=True)
    for ms, cnt, name in sorted(rows, reverse=True)[:24]:
        print(f"  device {ms:9.3f} ms  x{cnt:<3d} {name[:90]}", flush=True)


def _device_kernels(fn, calls: int = 3) -> dict | None:
    """{device kernel name: (launches, device ms)} per call of `fn`, from
    `calls` calls under torch.profiler after one warm-up call: the kernels
    one entry point launches, each under its own name. A window the
    profiler returns empty, or with a kernel seen a number of times that
    is not a multiple of `calls` (records dropped), is taken again, twice
    at most; None if it stays empty (not measured), the last window if it
    stays partial."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            key = ev.key.lower()
            if ev.device_type != DeviceType.CUDA or "memcpy" in key \
                    or "memset" in key:
                continue
            m = re.search(r"(\w+_kernel)\b", ev.key)
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            name = m.group(1) if m else ev.key[:60]
            n = ev.count / calls
            out[name] = (int(n) if n == int(n) else n, dev_us / 1e3 / calls)
        if out and all(isinstance(n, int) for n, _ in out.values()):
            return out
    return out or None


def _device_kernel_fields(by_name: dict | None) -> dict:
    """The kernels line's fields for the device kernels of one entry call
    (None where the profiler saw none: not measured)."""
    if by_name is None:
        return {"device_kernels": None, "device_kernels_by_name": None}
    return {"device_kernels": sum(n for n, _ in by_name.values()),
            "device_kernels_by_name": {
                k: {"launches": n, "ms": ms}
                for k, (n, ms) in by_name.items()}}


def _print_device_kernels(name: str, what: str, kernels: dict | None,
                          card: str) -> None:
    if kernels is None:
        print(f"device kernels: {name} {what}: not measured (the profiler "
              f"returned no device activity)", flush=True)
        return
    parts = ", ".join(f"{k} x{n:g} {ms:.4f} ms"
                      for k, (n, ms) in kernels.items())
    print(f"device kernels: {name} {what}: "
          f"{sum(n for n, _ in kernels.values()):g} per call [{parts}]  "
          f"[{card}]", flush=True)


def _check_megakernels(dev, errs: dict) -> None:
    """K5 / K6 against their plain versions on every row at MEGA_CHECKS,
    bit for bit (K6 f64 at scales that are not powers of two); errs by
    counter name."""
    import torch
    from repro_torch.core import dfloat as dfl
    from repro_torch.fhe_client.client import FHEClient
    from repro_torch.kernels import client_stream
    for profile, batch, datapaths in MEGA_CHECKS:
        for dp in datapaths:
            c = FHEClient(profile, seed=SEED, device=dev, datapath=dp)
            ctx, p = c.ctx, c.ctx.params
            ops = c.encrypt_operands(_messages(p.n_slots, batch, 40 + batch))
            planes = ops if dp == "df32" else dfl.dfc_to_planes(
                dfl.dfc_from_parts(*ops))
            pkb, pka, s = c.keys.pk.b_mont, c.keys.pk.a_mont, c.keys.sk.s_mont
            suffix = "_f64" if dp == "f64" else ""
            at = f"its plain version at {profile} B={batch} ({dp})"
            want = client_stream.encode_encrypt_stream_plain(
                planes, pkb, pka, ctx, c.seed, 321, datapath=dp)
            _hold(errs, "encode_encrypt_stream" + suffix,
                  client_stream.encode_encrypt_stream_cuda(
                      planes, pkb, pka, ctx, c.seed, 321, datapath=dp),
                  want, at)
            if dp == "df32":
                scale = torch.full((batch,), p.delta, dtype=torch.float32,
                                   device=dev)
            else:
                row_scales = [p.delta, float(ctx.q_list[1]), 0.75 * p.delta,
                              3.0 * 2.0 ** 40]
                scale = torch.tensor([row_scales[i % 4] for i in range(batch)],
                                     dtype=torch.float64, device=dev)
            x0, x1 = want[0][:, :2], want[1][:, :2]
            _hold(errs, "decrypt_decode_stream" + suffix,
                  client_stream.decrypt_decode_stream_cuda(
                      x0, x1, s, ctx, scale, datapath=dp),
                  client_stream.decrypt_decode_stream_plain(
                      x0, x1, s, ctx, scale, datapath=dp), at)
            print(f"kernel == plain (bit-identical), K5 K6 {dp}: {profile} "
                  f"B={batch}", flush=True)


# the server kernels by counter name: (id, TPU kernel body); all in
# csrc/server_eval.cu
SERVER = {
    "add_ct": ("K7", "server_eval.py:243"),
    "add_pt": ("K7", "server_eval.py:249"),
    "mul_pt": ("K7", "server_eval.py:255"),
    "rescale": ("K8", "server_eval.py:267"),
    "mul_pt_rescale": ("K8b", "server_eval.py:277"),
    "mul_ct": ("K9", "server_eval.py:291"),
    "rotate": ("K10", "server_eval.py:319"),
    "ks_decompose": ("K11a", "server_eval.py:334"),
    "ks_apply_rot": ("K11b", "server_eval.py:340"),
}
# the ops whose bodies multiply: their plain versions take the datapath
# (the REDC engine); the kernels run the u64 REDC on both
SERVER_REDC = ("mul_pt", "rescale", "mul_pt_rescale", "mul_ct", "rotate",
               "ks_apply_rot")
# (profile, level, batch, plain datapaths) of the kernel-vs-plain checks
SERVER_CHECKS = (("server", 8, 2, ("df32", "f64")), ("boot", 6, 2, ("df32",)),
                 ("boot", 24, 1, ("df32",)))
# the same on random residues and random key words (no keygen): n15, odd
# logN, views each transform's rows as uneven 2^8 x 2^7 matrices
SERVER_RANDOM_CHECKS = (("n15", 6, 2, ("df32", "f64")),)
# the server kernels that transform (each on the tiled NTT block): their
# device kernels per call are printed where they are timed
SERVER_TILED = ("rescale", "mul_pt_rescale", "mul_ct", "rotate",
                "ks_decompose", "ks_apply_rot")
SERVER_ROTATIONS = (1, 2, 5)
FLOW_DIM, FLOW_LEVEL, FLOW_SEED = 8, 6, 7
FLOW_PROFILES = ("server", "boot")
FLOW_BUDGET_ASSERTED = ("server",)   # at boot the error is printed only
TIME_PROFILE, TIME_LEVELS = "boot", (6, 24)
# launches of each server kernel in one linear + poly3 flow at d
FLOW_LAUNCHES = {"ks_decompose": 1, "ks_apply_rot": FLOW_DIM - 1,
                 "mul_pt": FLOW_DIM, "add_ct": FLOW_DIM - 1, "rescale": 1,
                 "add_pt": 4, "mul_pt_rescale": 1, "mul_ct": 2, "rotate": 0}


@contextlib.contextmanager
def _plain_server_ops():
    """Route ``kernels.ops.server_*`` (through ``server_eval``'s routed
    entries) to the plain versions, also for CUDA tensors: the reference
    flow the kernel flow is held against."""
    from repro_torch.kernels import server_eval
    kernel_route = server_eval._routed

    def plain(cuda_fn, plain_fn, args, datapath=None):
        return plain_fn(*args) if datapath is None else plain_fn(*args,
                                                                 datapath)

    server_eval._routed = plain
    try:
        yield
    finally:
        server_eval._routed = kernel_route


def _server_operands(client, keys, ev, level: int, batch: int, seed: int):
    """The server kernels' operands at `level`: two encrypted batches
    (contiguous limb views), an (l, N) plaintext, the relin and r=5 key
    slices, the r=5 permutation and the hoisted digit stack of x."""
    import numpy as np
    import torch
    from repro_torch.fhe_server import encoding
    from repro_torch.kernels import server_eval
    ctx = client.ctx
    ns = ctx.params.n_slots
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((batch, ns)) * 0.5
    x = client.encode_encrypt_batch(z)
    y = client.encode_encrypt_batch(z[::-1].copy())
    dev = x.c0.device
    o = {"a0": x.c0[:, :level].contiguous(), "a1": x.c1[:, :level].contiguous(),
         "b0": y.c0[:, :level].contiguous(), "b1": y.c1[:, :level].contiguous()}
    pt = encoding.encode_plaintext(rng.standard_normal(ns) * 0.5, ctx, level,
                                   float(ctx.q_list[level - 1]), device=dev)
    o["pt"], o["pm"] = pt.data, pt.data_mont
    o["kb"], o["ka"] = ev._sliced_key(keys.relin, level)
    o["rb"], o["ra"] = ev._rot_key(5, level)
    o["perm"] = ev._perm(5, dev)
    o["h"] = server_eval.ks_decompose(o["a1"], ctx)
    torch.cuda.synchronize()
    return o


def _server_calls(o, ctx, datapath: str = "df32") -> dict:
    """{kernel: (cuda call, plain call)} on the operands `o`; the plain
    versions of the ops that multiply under `datapath`'s REDC engine."""
    from repro_torch.kernels import server_eval as se
    dp = {"datapath": datapath}
    return {
        "add_ct": (lambda: se.add_ct_cuda(o["a0"], o["a1"], o["b0"],
                                          o["b1"], ctx),
                   lambda: se.add_ct_plain(o["a0"], o["a1"], o["b0"],
                                           o["b1"], ctx)),
        "add_pt": (lambda: se.add_pt_cuda(o["a0"], o["a1"], o["pt"], ctx),
                   lambda: se.add_pt_plain(o["a0"], o["a1"], o["pt"], ctx)),
        "mul_pt": (lambda: se.mul_pt_cuda(o["a0"], o["a1"], o["pm"], ctx),
                   lambda: se.mul_pt_plain(o["a0"], o["a1"], o["pm"], ctx,
                                           **dp)),
        "rescale": (lambda: se.rescale_cuda(o["a0"], o["a1"], ctx),
                    lambda: se.rescale_plain(o["a0"], o["a1"], ctx, **dp)),
        "mul_pt_rescale": (
            lambda: se.mul_pt_rescale_cuda(o["a0"], o["a1"], o["pm"], ctx),
            lambda: se.mul_pt_rescale_plain(o["a0"], o["a1"], o["pm"], ctx,
                                            **dp)),
        "mul_ct": (lambda: se.mul_ct_relin_cuda(o["a0"], o["a1"], o["b0"],
                                                o["b1"], o["kb"], o["ka"],
                                                ctx),
                   lambda: se.mul_ct_relin_plain(o["a0"], o["a1"], o["b0"],
                                                 o["b1"], o["kb"], o["ka"],
                                                 ctx, **dp)),
        "rotate": (lambda: se.rotate_cuda(o["a0"], o["a1"], o["perm"],
                                          o["rb"], o["ra"], ctx),
                   lambda: se.rotate_plain(o["a0"], o["a1"], o["perm"],
                                           o["rb"], o["ra"], ctx, **dp)),
        "ks_decompose": (lambda: se.ks_decompose_cuda(o["a1"], ctx),
                         lambda: se.ks_decompose_plain(o["a1"], ctx)),
        "ks_apply_rot": (
            lambda: se.ks_apply_rot_cuda(o["a0"], o["h"], o["perm"],
                                         o["rb"], o["ra"], ctx),
            lambda: se.ks_apply_rot_plain(o["a0"], o["h"], o["perm"],
                                          o["rb"], o["ra"], ctx, **dp)),
    }


def _server_setup(profile: str, dev):
    """Staged f64 client, its evaluation keys (relin + rotations 1, 2, 5)
    and an evaluator, on the card."""
    import torch
    from repro_torch.fhe_client.client import FHEClient
    from repro_torch.fhe_server.eval_ops import ServerEvaluator
    client = FHEClient(profile, seed=SEED, device=dev, pipeline="staged",
                       datapath="f64")
    t0 = time.perf_counter()
    keys = client.make_evaluation_keys(rotations=SERVER_ROTATIONS)
    torch.cuda.synchronize()
    print(f"server keys: {profile} relin + rotations {SERVER_ROTATIONS}: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return client, keys, ServerEvaluator(client.ctx, keys)


def _random_server_operands(profile: str, level: int, batch: int,
                            seed: int, dev):
    """The server kernels' operands at `level` as random words of the right
    ranges (the kernels' words do not depend on the ciphertexts and keys
    being real ones, as in the host-build tests): two (B, l, N) ciphertexts,
    an (l, N) plaintext in both forms, the relin and rotation key slices
    (l, l+1, N), the r=5 permutation and the hoisted digit stack of x.
    Returns (context, operands)."""
    import numpy as np
    import torch
    from repro_torch.core.context import get_context
    from repro_torch.fhe_server import keys as skeys
    from repro_torch.kernels import common, server_eval
    ctx = get_context(profile)
    n = ctx.n
    sc = server_eval.server_consts(ctx, level)
    qs = sc.table[:, common.OFF_Q].astype(np.uint64)
    rng = np.random.default_rng(seed)

    def words(shape):
        """(..., rows, N) residues, row r below table row r's prime"""
        q = qs[:shape[-2]].reshape(-1, 1)
        w = (rng.integers(0, 1 << 32, shape, dtype=np.uint64) % q
             ).astype(np.uint32)
        return torch.from_numpy(w.view(np.int32)).to(dev)

    o = {k: words((batch, level, n)) for k in ("a0", "a1", "b0", "b1")}
    o["pt"], o["pm"] = words((level, n)), words((level, n))
    for k in ("kb", "ka", "rb", "ra"):
        o[k] = words((level, level + 1, n))
    perm = skeys.galois_perm_ntt(skeys.galois_element(5, n), n)
    o["perm"] = torch.from_numpy(perm.reshape(1, n)).to(dev)
    o["h"] = server_eval.ks_decompose(o["a1"], ctx)
    torch.cuda.synchronize()
    return ctx, o


def _hold_server_kernels(ctx, o, datapaths, what: str, errs: dict) -> None:
    """Each server kernel against its plain version on the operands `o`,
    under each plain REDC engine of `datapaths` (the ops without a REDC
    once)."""
    import torch
    for dp in datapaths:
        for name, (kernel, plain) in _server_calls(o, ctx, dp).items():
            if dp != datapaths[0] and name not in SERVER_REDC:
                continue                # no REDC: held once above
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            e = max(_max_abs_err(a, b) for a, b in zip(got, want))
            errs[name] = max(errs.get(name, 0.0), e)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                _fail(f"{name} differs from its plain version ({dp} REDC) "
                      f"at {what} (max abs err {e})")
    print(f"kernel == plain (bit-identical), K7 x3 K8 K8b K9 K10 K11a K11b: "
          f"{what}, plain REDC engines {datapaths}", flush=True)


def _check_server_kernels(setups, errs: dict, dev) -> None:
    """Each server kernel against its plain version at SERVER_CHECKS and
    SERVER_RANDOM_CHECKS, and hoisted == fused rotations at boot level
    6."""
    import numpy as np
    import torch
    from repro_torch.fhe_server.ct import ServerCiphertext
    for profile, level, batch, datapaths in SERVER_CHECKS:
        client, keys, ev = setups[profile]
        o = _server_operands(client, keys, ev, level, batch, seed=level)
        _hold_server_kernels(client.ctx, o, datapaths,
                             f"{profile} level {level} B={batch}", errs)
        del o
    for profile, level, batch, datapaths in SERVER_RANDOM_CHECKS:
        ctx, o = _random_server_operands(profile, level, batch, 40 + level,
                                         dev)
        _hold_server_kernels(ctx, o, datapaths,
                             f"{profile} level {level} B={batch} (random "
                             f"words)", errs)
        del o
    client, keys, ev = setups["boot"]
    ns = client.ctx.params.n_slots
    z = np.random.default_rng(3).standard_normal((2, ns)) * 0.5
    x = ServerCiphertext.from_batch(
        client.encode_encrypt_batch(z)).drop_to(6)
    hoisted = ev.hoisted_rotations(x, list(SERVER_ROTATIONS))
    for r in SERVER_ROTATIONS:
        fused = ev.rotate(x, r)
        torch.cuda.synchronize()
        if not (torch.equal(hoisted[r].c0, fused.c0)
                and torch.equal(hoisted[r].c1, fused.c1)):
            _fail(f"hoisted rotation r={r} differs from rotate at boot "
                  f"level 6")
    print(f"hoisted_rotations(x, {list(SERVER_ROTATIONS)}) == rotate(x, r) "
          f"word for word: boot level 6 B=2", flush=True)


def _server_flow(profile: str, dev) -> tuple[dict, dict]:
    """The encrypted-inference main path at `profile`, counters set to 0
    just before and read just after; then the same server evaluation
    through the plain versions on the card, word for word, and a profile of
    the server part. Returns (launches, the run's output)."""
    import numpy as np
    import torch
    from repro_torch.fhe_server import encrypted_inference as ei
    from repro_torch.fhe_server import inference as inf
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    out = ei.run(profile, dim=FLOW_DIM, level=FLOW_LEVEL, seed=FLOW_SEED,
                 device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    y, x = out["y_ct"], out["x_ct"]
    got = out["got"]
    if out["levels"] != (FLOW_LEVEL, FLOW_LEVEL - 4):
        _fail(f"{profile} flow levels {out['levels']}")
    if got.shape != (1, out["client"].ctx.params.n_slots) \
            or not np.all(np.isfinite(got)):
        _fail(f"{profile} flow decoded {got.shape} or non-finite values")
    for name, want in FLOW_LAUNCHES.items():
        if launches[name] != want:
            _fail(f"{profile} flow launched {name} {launches[name]} times, "
                  f"expected {want}: {launches}")
    for name in ("ntt_limbs", "encrypt_limbs", "decrypt_limbs",
                 "special_fft", "special_ifft"):
        if launches[name] == 0:
            _fail(f"{profile} flow never launched {name}: {launches}")
    used = {k: v for k, v in launches.items() if v}
    times = ", ".join(f"{k} {v:.3f}" for k, v in out["times"].items())
    wire = ", ".join(f"{k} {v} B" for k, v in out["bytes"].items())
    print(f"flow: {profile} d={FLOW_DIM} levels {out['levels'][0]} -> "
          f"{out['levels'][1]}, err {out['err']:.3e} (budget "
          f"{out['budget']:.3e}), wall {wall:.3f} s ({times}), wire "
          f"payloads {wire}, launches {used}", flush=True)
    xv, w, bias, poly = out["workload"]
    ev = out["evaluator"]
    if profile in FLOW_BUDGET_ASSERTED and not out["err"] < out["budget"]:
        _fail(f"{profile} flow error {out['err']} >= {out['budget']}")
    with _plain_server_ops():
        y_plain = inf.encrypted_linear_poly3(ev, x, w, bias, poly)
    torch.cuda.synchronize()
    if not (torch.equal(y.c0, y_plain.c0) and torch.equal(y.c1, y_plain.c1)
            and y.scale == y_plain.scale):
        _fail(f"{profile} flow: kernel flow differs from the plain flow")
    below = out["err"] < out["budget"]
    print(f"flow: {profile} kernel flow == plain flow word for word; err "
          f"{out['err']:.3e} {'<' if below else '>='} budget "
          f"{out['budget']:.3e}", flush=True)
    _profile(lambda: inf.encrypted_linear_poly3(ev, x, w, bias, poly), 1,
             f"server eval (linear + poly3) {profile} d={FLOW_DIM}")
    return launches, out


def _time_server_kernels(setups, card: str):
    """Device times of every server kernel at boot B=1, levels 6 and 24
    (queued ahead; host-paced printed beside), the plain versions once,
    and the bounds."""
    client, keys, ev = setups[TIME_PROFILE]
    p = client.ctx.params
    times = {}
    for level in TIME_LEVELS:
        o = _server_operands(client, keys, ev, level, 1, seed=100 + level)
        for name, (kernel, plain) in _server_calls(o, client.ctx).items():
            ms = _device_ms(kernel, iters=5)
            paced_ms = _cuda_ms(kernel, iters=5)
            plain_ms = _cuda_ms(plain, iters=1, warmup=1)
            bound = _bound_ms(*_cost_server(name, p, level, 1))
            print(f"time: {name} {TIME_PROFILE} level {level} B=1: "
                  f"{ms:.4f} ms queued ahead, {paced_ms:.4f} ms paced by "
                  f"the host, "
                  f"plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]})  [{card}]", flush=True)
            by_name = None
            if name in SERVER_TILED:
                by_name = _device_kernels(kernel)
                _print_device_kernels(name, f"{TIME_PROFILE} level {level} "
                                      f"B=1", by_name, card)
            times[name, level] = (ms, plain_ms, bound, by_name)
        del o
    return times


# the per-prime kernels by counter name: (id, CUDA source, TPU kernel body)
ENGINES = {
    "ntt_rows": ("K12", "ntt_rows.cu", "ntt_butterfly.py:38"),
    "intt_rows": ("K12", "ntt_rows.cu", "ntt_butterfly.py:42"),
    "encrypt_limb": ("K13a", "client_pointwise.cu", "client_pointwise.py:103"),
    "decrypt_limb": ("K13b", "client_pointwise.cu", "client_pointwise.py:150"),
    "ntt_rows_mm": ("K14", "ntt_matmul.cu", "ntt_matmul.py:142"),
    "intt_rows_mm": ("K14", "ntt_matmul.cu", "ntt_matmul.py:163"),
}
ENGINE_NONCE0 = 0xFFFFFFFE      # rows 2.. wrap past 2^32, inside the
                                # rows the plain checks compare
ENGINE_PLAIN_ROWS = 4           # K12 / K13 plain checks: the first 4 rows
ENGINE_DEC_LIMBS = 2
# K12 and K13 beyond the paper B=16 stack, at the shapes the tiled
# planning reaches: (profile, batch). paper B=1 (the fewest blocks at
# N = 2^16), n15 B=2 (odd logN: an uneven 8 + 7 split), server B=2
# (N = 2^10: one pass); row 1 of a B=2 batch encrypts across the 2^32
# nonce wrap
ENGINE_SHAPES = (("paper", 1), ("n15", 2), ("server", 2))
ENGINE_SHAPE_NONCE0 = 0xFFFFFFFF


def _engine_path(ctx, keys, seed: int, x) -> dict:
    """The slice-4 entry points on an (L, B, N) residue stack: the four-step
    NTT and its inverse (one call each for the stack), the butterfly NTT
    and INTT of each limb, encrypt of each limb (its NTT-domain rows as
    plaintext) and decrypt of limbs 0 and 1."""
    from repro_torch.kernels import client_pointwise, ntt_butterfly, ops
    out = {"mm": ops.ntt_limbs(x, ctx, path="matmul")}
    out["mm_back"] = ops.intt_limbs(out["mm"], ctx, path="matmul")
    out["rows"] = [ntt_butterfly.ntt_rows(x[l], plan)
                   for l, plan in enumerate(ctx.plans)]
    out["rows_back"] = [ntt_butterfly.intt_rows(y, plan)
                        for y, plan in zip(out["rows"], ctx.plans)]
    pkb, pka, s = keys.pk.b_mont, keys.pk.a_mont, keys.sk.s_mont
    out["enc"] = [client_pointwise.encrypt_limb(y, pkb[l], pka[l], ctx, l,
                                                seed, ENGINE_NONCE0)
                  for l, y in enumerate(out["rows"])]
    out["dec"] = [client_pointwise.decrypt_limb(c0, c1, s[l], ctx, l)
                  for l, (c0, c1) in enumerate(out["enc"][:ENGINE_DEC_LIMBS])]
    return out


def _check_engine_shapes(dev, errs: dict) -> None:
    """K12 (both directions), K13a and K13b on random words at
    ENGINE_SHAPES, on every limb: == K1 / K2 / K3 on that limb (their own
    launches) and, on the first and the last limb, == their plain versions.
    The kernels' words do not depend on the key rows being a real key, so
    K13a and K13b take random ones."""
    from repro_torch.core.context import get_context
    from repro_torch.kernels import client_pointwise, ntt_butterfly
    nonce0 = ENGINE_SHAPE_NONCE0
    for i, (profile, batch) in enumerate(ENGINE_SHAPES):
        ctx = get_context(profile)
        p = ctx.params
        L, plans = p.n_limbs, ctx.plans[:p.n_limbs]
        x = _rand_words(ctx, (L, batch, p.n), 120 + i, dev)
        pkb, pka = (_rand_words(ctx, (L, p.n), 130 + 2 * i + k, dev)
                    for k in (0, 1))
        k1 = ntt_butterfly.limb_rows_cuda(x, plans, False)
        k1_back = ntt_butterfly.limb_rows_cuda(k1, plans, True)
        k2 = client_pointwise.encrypt_limbs_cuda(k1.transpose(0, 1), pkb,
                                                 pka, ctx, SEED, nonce0)
        c0, c1 = (_rand_words(ctx, (L, batch, p.n), 140 + 2 * i + k,
                              dev).transpose(0, 1).contiguous()
                  for k in (0, 1))
        k3 = client_pointwise.decrypt_limbs_cuda(c0, c1, pkb, ctx)
        at = f"at {profile} B={batch}"
        for l, plan in enumerate(plans):
            y = ntt_butterfly.rows_cuda(x[l], plan, False)
            back = ntt_butterfly.rows_cuda(y, plan, True)
            enc = client_pointwise.encrypt_limb_cuda(y, pkb[l], pka[l], ctx,
                                                     l, SEED, nonce0)
            _hold(errs, "ntt_rows", y, k1[l], f"K1 on limb {l} {at}")
            _hold(errs, "intt_rows", back, k1_back[l], f"K1 on limb {l} {at}")
            _hold(errs, "intt_rows", back, x[l], f"x on limb {l} {at}")
            _hold(errs, "encrypt_limb", enc, (k2[0][:, l], k2[1][:, l]),
                  f"K2 on limb {l} {at}")
            c0l, c1l = c0[:, l].contiguous(), c1[:, l].contiguous()
            dec = client_pointwise.decrypt_limb_cuda(c0l, c1l, pkb[l], ctx, l)
            _hold(errs, "decrypt_limb", dec, k3[:, l], f"K3 on limb {l} {at}")
            if l not in (0, L - 1):
                continue
            plain = f"its plain version on limb {l} {at}"
            _hold(errs, "ntt_rows", y,
                  ntt_butterfly.rows_plain(x[l], plan, False), plain)
            _hold(errs, "intt_rows", back,
                  ntt_butterfly.rows_plain(y, plan, True), plain)
            _hold(errs, "encrypt_limb", enc,
                  client_pointwise.encrypt_limb_plain(
                      y, pkb[l], pka[l], ctx, l, SEED, nonce0), plain)
            _hold(errs, "decrypt_limb", dec,
                  client_pointwise.decrypt_limb_plain(c0l, c1l, pkb[l], ctx,
                                                      l), plain)
        print(f"kernel == K1 / K2 / K3 per limb (bit-identical), K12 both "
              f"ways, K13a and K13b, {profile} B={batch} nonce0 "
              f"{nonce0:#x}, every limb; == plain on limbs 0 and {L - 1}",
              flush=True)


def _engine_phase(client, card: str):
    """Slice 4 at `paper`: the entry points once with the counters set to 0
    just before and read just after, then every check against K1-K3 and
    the plain versions, the n15 limb, and the times. Returns (launches,
    max abs errors, {kernel: (ms, plain ms, bound, extra)})."""
    import torch
    from repro_torch.core import ntt as nttmod
    from repro_torch.core.context import get_context
    from repro_torch.kernels import (client_pointwise, ntt_butterfly,
                                     ntt_matmul, ops)
    ctx, p = client.ctx, client.ctx.params
    dev = client.keys.pk.b_mont.device
    L, n, batch = p.n_limbs, p.n, MAIN_BATCH
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    q = torch.tensor(ctx.q_list, dtype=torch.int64, device=dev)[:, None, None]
    x = (torch.randint(0, 1 << 31, (L, batch, n), generator=gen, device=dev,
                       dtype=torch.int64) % q).to(torch.int32)
    keys, seed = client.keys, client.seed
    torch.cuda.synchronize()

    ops.reset_launches()
    t0 = time.perf_counter()
    out = _engine_path(ctx, keys, seed, x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    for name in ENGINES:
        if launches[name] == 0:
            _fail(f"the slice-4 path never launched {name}: {launches}")
    used = {k: v for k, v in launches.items() if v}
    print(f"slice 4 path: {MAIN_PROFILE} x {tuple(x.shape)}: {wall * 1e3:.1f} "
          f"ms host clock, launches {used}", flush=True)

    # against K1-K3 (their own launches, outside the counted run)
    plans = ctx.plans
    brv = torch.tensor(nttmod.bitrev_indices(n), device=dev)
    k1 = ops.ntt_limbs(x, ctx)
    pt = torch.stack(out["rows"], dim=1)                  # (B, L, N)
    c0, c1 = client_pointwise.encrypt_limbs_cuda(
        pt, keys.pk.b_mont, keys.pk.a_mont, ctx, seed, ENGINE_NONCE0)
    k3 = client_pointwise.decrypt_limbs_cuda(
        c0[:, :ENGINE_DEC_LIMBS], c1[:, :ENGINE_DEC_LIMBS], keys.sk.s_mont,
        ctx)
    torch.cuda.synchronize()
    checks = {
        "K12 ntt_rows == K1 per limb": torch.equal(pt.transpose(0, 1), k1),
        "K12 intt_rows(ntt_rows(x)) == x": all(
            torch.equal(b, x[l]) for l, b in enumerate(out["rows_back"])),
        "K13a encrypt_limb == K2 per limb": all(
            torch.equal(e0, c0[:, l]) and torch.equal(e1, c1[:, l])
            for l, (e0, e1) in enumerate(out["enc"])),
        "K13b decrypt_limb == K3 per limb": all(
            torch.equal(m, k3[:, l]) for l, m in enumerate(out["dec"])),
        "K14 ntt_limbs(matmul) == K1[..., bitrev]": torch.equal(
            out["mm"], k1[..., brv]),
        "K14 intt_limbs(matmul) returns x": torch.equal(out["mm_back"], x),
    }
    for what, ok in checks.items():
        if not ok:
            _fail(f"{what} fails at {MAIN_PROFILE} B={batch}")
    print(f"slice 4 == K1-K3 (word for word): {', '.join(checks)}",
          flush=True)

    # against the plain versions on the first rows of every limb (the whole
    # stack through the plain versions would add about a minute)
    errs = {name: 0.0 for name in ENGINES}
    r = ENGINE_PLAIN_ROWS

    def hold(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        e = max(_max_abs_err(a, b) for a, b in zip(got, want))
        errs[name] = max(errs[name], e)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            _fail(f"{name} differs from its plain version at {MAIN_PROFILE} "
                  f"(max abs err {e})")

    t0 = time.perf_counter()
    for l, plan in enumerate(plans):
        hold("ntt_rows", out["rows"][l][:r],
             ntt_butterfly.rows_plain(x[l, :r], plan, False))
        hold("intt_rows", out["rows_back"][l][:r],
             ntt_butterfly.rows_plain(out["rows"][l][:r], plan, True))
        e0, e1 = out["enc"][l]
        hold("encrypt_limb", (e0[:r], e1[:r]),
             client_pointwise.encrypt_limb_plain(
                 out["rows"][l][:r], keys.pk.b_mont[l], keys.pk.a_mont[l],
                 ctx, l, seed, ENGINE_NONCE0))
        if l < ENGINE_DEC_LIMBS:
            hold("decrypt_limb", out["dec"][l][:r],
                 client_pointwise.decrypt_limb_plain(
                     e0[:r], e1[:r], keys.sk.s_mont[l], ctx, l))
    hold("ntt_rows_mm", out["mm"][:, :r],
         ntt_matmul.limb_rows_mm_plain(x[:, :r], plans, False))
    hold("intt_rows_mm", out["mm_back"][:, :r],
         ntt_matmul.limb_rows_mm_plain(out["mm"][:, :r], plans, True))
    print(f"kernel == plain (bit-identical), K12 K13a K13b K14 on the first "
          f"{r} rows of each limb: {MAIN_PROFILE} B={batch}, "
          f"{time.perf_counter() - t0:.1f} s of plain versions", flush=True)

    # K14 at an odd log N: one n15 limb (N1 x N2 = 256 x 128), B=2
    ctx15 = get_context("n15")
    plan15 = ctx15.plans[0]
    x15 = (torch.randint(0, plan15.prime.q, (2, ctx15.n), generator=gen,
                         device=dev, dtype=torch.int64)).to(torch.int32)
    y15 = ntt_matmul.ntt_rows_mm(x15, plan15)
    brv15 = torch.tensor(nttmod.bitrev_indices(ctx15.n), device=dev)
    hold("ntt_rows_mm", y15, ntt_matmul.rows_mm_plain(x15, plan15, False))
    hold("intt_rows_mm", ntt_matmul.intt_rows_mm(y15, plan15), x15)
    if not torch.equal(y15, ntt_butterfly.ntt_rows(x15, plan15)[:, brv15]):
        _fail("K14 differs from K12 under bit reversal at n15")
    print(f"K14 at n15 (split {ntt_matmul.split_n(ctx15.n)}), B=2: == plain, "
          f"== K12[:, bitrev], round trip", flush=True)
    _check_engine_shapes(dev, errs)

    # times: one call each at B=16 (K12 / K13: one limb; K14: the stack),
    # queued ahead; K12 also as the 24 launches of a stack; K12 and K13
    # also at B=1 (the first row of limb 0); the device kernels of one call
    y0, (e0, e1) = out["rows"][0], out["enc"][0]
    pkb, pka, s = keys.pk.b_mont, keys.pk.a_mont, keys.sk.s_mont
    x1, y1 = x[0, :1], y0[:1]
    at_b1 = {
        "ntt_rows": (lambda: ntt_butterfly.rows_cuda(x1, plans[0], False),
                     _cost_ntt_rows(p, 1, False)),
        "intt_rows": (lambda: ntt_butterfly.rows_cuda(y1, plans[0], True),
                      _cost_ntt_rows(p, 1, True)),
        "encrypt_limb": (
            lambda: client_pointwise.encrypt_limb_cuda(
                y1, pkb[0], pka[0], ctx, 0, seed, ENGINE_NONCE0),
            _cost_encrypt_limb(p, 1)),
        "decrypt_limb": (
            lambda: client_pointwise.decrypt_limb_cuda(e0[:1], e1[:1], s[0],
                                                       ctx, 0),
            _cost_decrypt_limb(p, 1)),
    }
    # the control: K1 / K2 / K3 on the same limb and rows, a (1, B, N) /
    # (B, 1, N) stack (the same tile plan under MontRedc), so that the
    # per-pass times show what the shift-add REDC costs
    same_limb = {
        "ntt_rows": ("ntt_limbs", lambda b: ntt_butterfly.limb_rows_cuda(
            x[:1, :b], plans[:1], False)),
        "intt_rows": ("intt_limbs", lambda b: ntt_butterfly.limb_rows_cuda(
            y0[None, :b], plans[:1], True)),
        "encrypt_limb": (
            "encrypt_limbs", lambda b: client_pointwise.encrypt_limbs_cuda(
                y0[:b, None], pkb, pka, ctx, seed, ENGINE_NONCE0)),
        "decrypt_limb": (
            "decrypt_limbs", lambda b: client_pointwise.decrypt_limbs_cuda(
                e0[:b, None], e1[:b, None], s, ctx)),
    }
    calls = {
        "ntt_rows": (lambda: ntt_butterfly.rows_cuda(x[0], plans[0], False),
                     lambda: ntt_butterfly.rows_plain(x[0], plans[0], False),
                     _cost_ntt_rows(p, batch, False)),
        "intt_rows": (lambda: ntt_butterfly.rows_cuda(y0, plans[0], True),
                      lambda: ntt_butterfly.rows_plain(y0, plans[0], True),
                      _cost_ntt_rows(p, batch, True)),
        "encrypt_limb": (
            lambda: client_pointwise.encrypt_limb_cuda(
                y0, pkb[0], pka[0], ctx, 0, seed, ENGINE_NONCE0),
            lambda: client_pointwise.encrypt_limb_plain(
                y0, pkb[0], pka[0], ctx, 0, seed, ENGINE_NONCE0),
            _cost_encrypt_limb(p, batch)),
        "decrypt_limb": (
            lambda: client_pointwise.decrypt_limb_cuda(e0, e1, s[0], ctx, 0),
            lambda: client_pointwise.decrypt_limb_plain(e0, e1, s[0], ctx,
                                                        0),
            _cost_decrypt_limb(p, batch)),
        "ntt_rows_mm": (
            lambda: ntt_matmul.limb_rows_mm_cuda(x, plans, False),
            lambda: ntt_matmul.limb_rows_mm_plain(x, plans, False),
            _cost_ntt_mm(p, batch, False)),
        "intt_rows_mm": (
            lambda: ntt_matmul.limb_rows_mm_cuda(out["mm"], plans, True),
            lambda: ntt_matmul.limb_rows_mm_plain(out["mm"], plans, True),
            _cost_ntt_mm(p, batch, True)),
    }
    times = {}
    for name, (kernel, plain, cost) in calls.items():
        ms = _device_ms(kernel, iters=5)
        plain_ms = _cuda_ms(plain, iters=1, warmup=1)
        bound = _bound_ms(*cost)
        extra = {}
        if name in ("ntt_rows", "intt_rows"):
            inv = name == "intt_rows"
            src = out["rows"] if inv else x
            extra["stack_ms"] = _device_ms(
                lambda: [ntt_butterfly.rows_cuda(src[l], plan, inv)
                         for l, plan in enumerate(plans)], iters=3)
            extra["stack_launches"] = L
        times[name] = (ms, plain_ms, bound, extra)
        # each call is one counted launch; K14's C entry point issues two
        # device kernels (the two products, each under its own name; the
        # psi^k table is built once)
        shape = (f"the {tuple(x.shape)} stack (1 launch per call: 2 device "
                 f"kernels)" if name.endswith("_mm")
                 else f"one limb, B={batch} (1 launch per call)")
        stack = (f", the stack's {L} launches {extra['stack_ms']:.3f} ms"
                 if extra else "")
        print(f"time: {name} {MAIN_PROFILE} {shape}: {ms:.4f} ms per launch"
              f"{stack}, plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]})  [{card}]", flush=True)
        by_name = _device_kernels(kernel)
        _print_device_kernels(
            name, f"{MAIN_PROFILE} the {tuple(x.shape)} stack"
            if name.endswith("_mm") else f"{MAIN_PROFILE} one limb "
            f"B={batch}", by_name, card)
        extra.update(_device_kernel_fields(by_name))
        if name not in at_b1:
            continue
        kernel1, cost1 = at_b1[name]
        ms1, bound1 = _device_ms(kernel1, iters=5), _bound_ms(*cost1)
        by_name = _device_kernels(kernel1)
        extra["at_batch_1"] = {"ms": ms1, "bound_ms": bound1[0],
                               "bound_by": bound1[1],
                               **_device_kernel_fields(by_name)}
        print(f"time: {name} {MAIN_PROFILE} one limb, B=1: {ms1:.4f} ms per "
              f"launch, bound {bound1[0]:.4f} ms ({bound1[1]})  [{card}]",
              flush=True)
        _print_device_kernels(name, f"{MAIN_PROFILE} one limb B=1", by_name,
                              card)
        control, fn = same_limb[name]
        extra["same_limb_control"] = {"kernel": control}
        for b in (batch, 1):
            ms_c = _device_ms(lambda b=b: fn(b), iters=5)
            by_name = _device_kernels(lambda b=b: fn(b))
            extra["same_limb_control"][f"B={b}"] = {
                "ms": ms_c, **_device_kernel_fields(by_name)}
            print(f"time: {name}'s control, {control} on the same limb, "
                  f"B={b}: {ms_c:.4f} ms  [{card}]", flush=True)
            _print_device_kernels(control, f"{MAIN_PROFILE} one limb B={b} "
                                  f"(the control of {name})", by_name, card)
    return launches, errs, times


# --- phase 9: the f64 datapath (K5 / K6 f64 branches, the u64 REDC) ------
# The bounds of the f64 branches are the least work for the words they
# compute: K5 f64 gives df32 K5's words (but for rare coefficients at
# Delta = 2^55) and K6 f64 the same planes up to its float64 /scale, so each
# is bounded by its df32 branch's count, with the FP64 operations of its own
# function beside it (64 FP64 lanes per SM: 64 x 132 x 1.98 GHz = 16.7e12
# FP64 instructions/s, each product and sum its own instruction under
# --fmad=false; a division counted as one). The library routines the
# kernels call for the RNS / CRT steps (double fmod, 64-bit %, __ddiv_rn)
# are loops of many instructions on the card; that is the kernel's cost,
# part of its gap to the bound, and not counted here.
F64_OPS_PER_S = 64 * 132 * 1.98e9
# per coefficient: collapse (1 add), two_prod (17), df_round (2 rint, 3
# add/sub, quick_two_sum 3)
F64_DELTA_ROUND = 26
# per coefficient of the f64 CRT: 2 two_prod (34), dd_add (11), 2 dd_sub
# (26), compares and selects (4), 2 divisions, 1 add, the df32 split (3)
F64_CRT = 34 + 11 + 26 + 4 + 2 + 1 + 3

# the f64 branches by counter name: (id, CUDA source, TPU kernel body)
F64_KERNELS = {
    "encode_encrypt_stream_f64": ("K5 f64", "encode_encrypt.cu",
                                  "client_stream.py:96"),
    "decrypt_decode_stream_f64": ("K6 f64", "decrypt_decode.cu",
                                  "client_stream.py:200"),
}
F64_BATCHES = (MAIN_BATCH, 1)
F64_PLAIN_ROWS = 4            # K5 / K6 f64 against plain: the first 4 rows
F64_NONCE0 = 4000
SEEDED_NONCE = 9


def _cost_encode_encrypt_f64(p, batch: int):
    """(bytes, int32 ops, f32 ops, 0, f64 ops) of K5's f64 branch: the df32
    branch's count, with the df64 Delta-scale round beside it."""
    i32, f32 = _ops_encode_encrypt(p, batch)
    f64 = batch * p.n * F64_DELTA_ROUND
    return _bytes_encode_encrypt(p, batch), i32, f32, 0.0, float(f64)


def _cost_decrypt_decode_f64(p, batch: int):
    """K6's f64 branch: the df32 branch's count (float64 scales), with the
    df64 CRT and /scale beside it."""
    i32, f32 = _ops_decrypt_decode(p, batch)
    f64 = batch * p.n * F64_CRT
    nbytes = _bytes_decrypt_decode(p, batch) + batch * 4   # float64 scales
    return nbytes, i32, f32, 0.0, float(f64)


def _bound5_ms(nbytes, i32, f32, i8, f64) -> tuple[float, str]:
    ms, by = _bound_ms(nbytes, i32, f32, i8)
    f64_ms = f64 / F64_OPS_PER_S * 1e3
    if by == "operations":
        return max(ms, f64_ms), by
    return (ms, by) if ms >= f64_ms else (f64_ms, "operations")


def _hold(errs: dict, name: str, got, want, what: str) -> None:
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    e = max(_max_abs_err(a, b) for a, b in zip(got, want))
    errs[name] = max(errs.get(name, 0.0), e)
    if not all(_same_bits(a, b) for a, b in zip(got, want)):
        _fail(f"{name} differs from {what} (max abs err {e})")


def _f64_client_phase(dev, mega32, card: str):
    """The f64 megakernel client at paper, B=16 and B=1, counters set to 0
    just before and read just after; K5 / K6 f64 against their plain
    versions (the first rows; K5 also the rows where the datapaths'
    Delta-scaled integers differ), c0 / c1 against the df32 megakernel's
    on every other row, decoded
    parts against the staged f64 client's; then the host oracle client and
    the seeded chain. Returns (launches, errs, times)."""
    import numpy as np
    import torch
    from repro_torch.core import dfloat as dfl
    from repro_torch.core.encoder import boot_precision_bits
    from repro_torch.fhe_client.client import FHEClient
    from repro_torch.kernels import client_stream, ops

    def k5_planes(batch):
        """K5's operands as the f64 core makes them: the df32 split of the
        float64 (re, im) parts, on the card."""
        return dfl.dfc_to_planes(dfl.dfc_from_parts(
            *f64.encrypt_operands(msgs[batch])))

    f64 = FHEClient(MAIN_PROFILE, seed=SEED, device=dev, datapath="f64")
    staged = FHEClient(MAIN_PROFILE, seed=SEED, device=dev,
                       pipeline="staged", datapath="f64")
    ctx, p = f64.ctx, f64.ctx.params
    msgs = {b: _messages(p.n_slots, b, 90 + b) for b in F64_BATCHES}
    runs = {}
    ops.reset_launches()
    t0 = time.perf_counter()
    for b in F64_BATCHES:
        f64.nonce = F64_NONCE0
        cts = f64.encode_encrypt_batch(msgs[b])
        runs[b] = (cts, f64.decrypt_decode_batch(cts.truncated(2)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    for name in F64_KERNELS:
        if launches[name] != len(F64_BATCHES):
            _fail(f"the f64 megakernel path launched {name} "
                  f"{launches[name]} times: {launches}")
    used = {k: v for k, v in launches.items() if v}
    for b in F64_BATCHES:
        cts, out = runs[b]
        bits = boot_precision_bits(msgs[b], out)
        if out.shape != msgs[b].shape or not np.all(np.isfinite(out)) \
                or not bits >= BOOT_PREC_BITS:
            _fail(f"f64 megakernel round trip at B={b}: {bits} bits")
        print(f"f64 megakernel path: {MAIN_PROFILE} B={b} round trip "
              f"{bits:.2f} bits (bar {BOOT_PREC_BITS})", flush=True)
    print(f"f64 megakernel path: B={F64_BATCHES} in {wall * 1e3:.1f} ms "
          f"host clock, launches {used}", flush=True)

    errs = {name: 0.0 for name in F64_KERNELS}
    cts, _ = runs[MAIN_BATCH]
    r = F64_PLAIN_ROWS
    planes = tuple(t[:r] for t in k5_planes(MAIN_BATCH))
    pkb, pka, s = f64.keys.pk.b_mont, f64.keys.pk.a_mont, f64.keys.sk.s_mont
    t0 = time.perf_counter()
    _hold(errs, "encode_encrypt_stream_f64", (cts.c0[:r], cts.c1[:r]),
          client_stream.encode_encrypt_stream_plain(
              planes, pkb, pka, ctx, f64.seed, F64_NONCE0, datapath="f64"),
          f"its plain version at {MAIN_PROFILE} (first {r} rows)")
    # row scales: Delta, then three that are not powers of two, repeated
    row_scales = [p.delta, float(ctx.q_list[1]), 0.75 * p.delta,
                  3.0 * 2.0 ** 40]
    scale = torch.tensor([row_scales[i % 4] for i in range(MAIN_BATCH)],
                         dtype=torch.float64, device=dev)
    got = client_stream.decrypt_decode_stream_cuda(
        cts.c0[:, :2], cts.c1[:, :2], s, ctx, scale, datapath="f64")
    _hold(errs, "decrypt_decode_stream_f64", tuple(g[:r] for g in got),
          client_stream.decrypt_decode_stream_plain(
              cts.c0[:r, :2], cts.c1[:r, :2], s, ctx, scale[:r],
              datapath="f64"),
          f"its plain version at {MAIN_PROFILE} (first {r} rows, scales "
          f"that are not powers of two)")
    print(f"kernel == plain (bit-identical), K5 f64 K6 f64 on the first {r} "
          f"rows: {MAIN_PROFILE} B={MAIN_BATCH}, "
          f"{time.perf_counter() - t0:.1f} s of plain versions", flush=True)

    mega32.nonce = F64_NONCE0
    want = mega32.encode_encrypt_batch(msgs[MAIN_BATCH])
    torch.cuda.synchronize()
    differ = [i for i in range(MAIN_BATCH)
              if not (torch.equal(cts.c0[i], want.c0[i])
                      and torch.equal(cts.c1[i], want.c1[i]))]
    rows, n_coeffs = _delta_scale_split(f64, msgs[MAIN_BATCH])
    # K5 f64 against its plain version on those rows too: they hold the
    # coefficients nearest a rounding tie, where df32 K5 is no witness
    t0 = time.perf_counter()
    planes_all = k5_planes(MAIN_BATCH)
    for i in rows:
        _hold(errs, "encode_encrypt_stream_f64",
              (cts.c0[i:i + 1], cts.c1[i:i + 1]),
              client_stream.encode_encrypt_stream_plain(
                  tuple(t[i:i + 1] for t in planes_all), pkb, pka, ctx,
                  f64.seed, F64_NONCE0 + i, datapath="f64"),
              f"its plain version at {MAIN_PROFILE} row {i}")
    print(f"kernel == plain (bit-identical), K5 f64 on rows {rows} (where "
          f"the datapaths' Delta-scaled integers differ): "
          f"{time.perf_counter() - t0:.1f} s of plain versions", flush=True)
    if differ != rows:
        _fail(f"f64 megakernel c0/c1 differ from the df32 megakernel's on "
              f"rows {differ}; the two datapaths' Delta-scaled integers "
              f"differ on rows {rows}")
    print(f"f64 megakernel c0/c1 == df32 megakernel's on "
          f"{MAIN_BATCH - len(rows)} of {MAIN_BATCH} rows; rows {rows} differ "
          f"exactly where the two datapaths' Delta-scaled integers do "
          f"({n_coeffs} coefficients: the df32 pair does not collapse to "
          f"float64 exactly at Delta=2^{p.delta_bits}, as in the JAX "
          f"reference)", flush=True)
    mine = f64.decrypt_planes(cts.truncated(2))
    theirs = staged.decrypt_planes(cts.truncated(2))
    torch.cuda.synchronize()
    if not all(_same_bits(a, b) for a, b in zip(mine, theirs)):
        _fail("f64 megakernel decoded parts differ from the staged f64 "
              "client's")
    print(f"f64 megakernel decoded parts == staged f64 client's (bit for "
          f"bit): {MAIN_PROFILE} B={MAIN_BATCH}", flush=True)

    # the host oracle client: host FFTs around K1 / K2 and K3
    host = FHEClient(MAIN_PROFILE, seed=SEED, device=dev, fourier="host")
    ops.reset_launches()
    t0 = time.perf_counter()
    out = host.decrypt_decode_batch(
        host.encode_encrypt_batch(msgs[MAIN_BATCH]).truncated(2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hl = ops.launches()
    for name in ("ntt_limbs", "encrypt_limbs", "decrypt_limbs"):
        if hl[name] == 0:
            _fail(f"the host oracle client never launched {name}: {hl}")
    bits = boot_precision_bits(msgs[MAIN_BATCH], out)
    if not bits >= BOOT_PREC_BITS:
        _fail(f"host oracle round trip {bits} bits")
    print(f"host oracle client (fourier='host'): {MAIN_PROFILE} "
          f"B={MAIN_BATCH} round trip {bits:.2f} bits, {wall * 1e3:.1f} ms "
          f"host clock, launches {dict((k, v) for k, v in hl.items() if v)}",
          flush=True)

    _seeded_chain(f64, msgs[1][0], dev)

    times = {}
    for b in F64_BATCHES:
        planes_b = k5_planes(b)
        k0, k1 = client_stream.encode_encrypt_stream_cuda(
            planes_b, pkb, pka, ctx, f64.seed, 0, datapath="f64")
        sc = torch.full((b,), p.delta * 0.75, dtype=torch.float64, device=dev)
        calls = {
            "encode_encrypt_stream_f64": (
                lambda: client_stream.encode_encrypt_stream_cuda(
                    planes_b, pkb, pka, ctx, f64.seed, 0, datapath="f64"),
                lambda: client_stream.encode_encrypt_stream_plain(
                    planes_b, pkb, pka, ctx, f64.seed, 0, datapath="f64"),
                _cost_encode_encrypt_f64(p, b)),
            "decrypt_decode_stream_f64": (
                lambda: client_stream.decrypt_decode_stream_cuda(
                    k0[:, :2], k1[:, :2], s, ctx, sc, datapath="f64"),
                lambda: client_stream.decrypt_decode_stream_plain(
                    k0[:, :2], k1[:, :2], s, ctx, sc, datapath="f64"),
                _cost_decrypt_decode_f64(p, b)),
        }
        for name, (kernel, plain, cost) in calls.items():
            ms = _device_ms(kernel, iters=5)
            plain_ms = (_cuda_ms(plain, iters=1, warmup=1)
                        if b == MAIN_BATCH else None)
            bound = _bound5_ms(*cost)
            by_name = _device_kernels(kernel)
            times[name, b] = (ms, plain_ms, bound, by_name)
            pm = f", plain {plain_ms:.1f} ms" if plain_ms is not None else ""
            print(f"time: {name} {MAIN_PROFILE} B={b}: {ms:.3f} ms{pm}, "
                  f"bound {bound[0]:.4f} ms ({bound[1]})  [{card}]",
                  flush=True)
            _print_device_kernels(name, f"{MAIN_PROFILE} B={b}", by_name,
                                  card)
    return launches, errs, times


def _delta_scale_split(client, msgs) -> tuple[list, int]:
    """Rows (and the number of coefficients) where the two datapaths'
    Delta-scaled integers differ for `msgs`, by the plain versions: df32
    rounds the exact df32 pair times Delta, f64 rounds its float64
    collapse times Delta, which drops bits of a pair spanning more than 53
    (the reference's two datapaths do the same)."""
    import torch
    from repro_torch.core import dfloat as dfl
    from repro_torch.core import encoder
    from repro_torch.kernels import fft_df
    p = client.ctx.params
    planes = dfl.dfc_to_planes(dfl.dfc_from_parts(
        *client.encrypt_operands(msgs)))
    w = dfl.dfc_from_planes(fft_df.bitrev_planes(
        fft_df.fft_rows_plain(planes, p.m, inverse=True)))
    d0, d1, d2 = encoder.delta_scale_digits(encoder.planes_to_coeff_df(w),
                                            p.delta)
    v32 = d0.long() + (d1.long() << 22) + (d2.long() << 44)
    coeffs = torch.cat([dfl.df_to_float(w.re), dfl.df_to_float(w.im)], -1)
    s = encoder.delta_scale_round(coeffs, p.delta)
    bad = v32 != s.hi.long() + s.lo.long()
    return bad.any(dim=1).nonzero().flatten().tolist(), int(bad.sum())


def _seeded_chain(client, z, dev) -> None:
    """encrypt_symmetric_seeded -> wire kind 2 -> deserialize ->
    expand_seeded -> decrypt on the card, against the same chain on the
    CPU (the plain versions), word for word; the payload is half a full
    one's."""
    import torch
    from repro_torch.core import encoder, encryptor
    from repro_torch.fhe_client.service import wire
    ctx = client.ctx
    sk_cpu = encryptor.SecretKey(client.keys.sk.s_mont.cpu(),
                                 client.keys.sk.s_coeffs.cpu())

    def chain(device, sk):
        pt = encoder.encode(z, ctx, device=device)
        sct = encryptor.encrypt_symmetric_seeded(pt, sk, ctx,
                                                 seed=client.seed,
                                                 nonce=SEEDED_NONCE)
        buf = wire.serialize_ciphertext_seeded(sct)
        got = wire.deserialize_ciphertext_seeded(buf, device=device)
        full = encryptor.expand_seeded(got, ctx, seed=client.seed)
        return buf, full, encryptor.decrypt(full, sk, ctx)

    t0 = time.perf_counter()
    buf, full, dec = chain(dev, client.keys.sk)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    buf_p, full_p, dec_p = chain("cpu", sk_cpu)
    plain_s = time.perf_counter() - t0
    full_buf = wire.serialize_ciphertext_batch(
        encryptor.CiphertextBatch(full.c0[None], full.c1[None],
                                  full.n_limbs, full.scale))
    if not (buf == buf_p and torch.equal(full.c1.cpu(), full_p.c1)
            and torch.equal(dec.cpu(), dec_p)):
        _fail("the seeded chain on the card differs from the plain chain")
    if (len(buf) - wire._HDR.size - wire._CT_SEEDED.size) * 2 != (
            len(full_buf) - wire._HDR.size - wire._CT_BATCH.size):
        _fail(f"seeded payload {len(buf)} B is not half of {len(full_buf)}")
    bits = encoder.boot_precision_bits(z, encoder.decode(dec, ctx))
    if not bits >= BOOT_PREC_BITS:
        _fail(f"seeded round trip {bits} bits")
    print(f"seeded chain (encrypt_symmetric_seeded -> wire kind 2 -> "
          f"expand_seeded -> decrypt): == plain chain word for word; payload "
          f"{len(buf)} B vs full {len(full_buf)} B; {bits:.2f} bits; card "
          f"{card_s:.2f} s, plain {plain_s:.2f} s", flush=True)


def _f64_server_phase(out, dev) -> None:
    """ServerEvaluator(datapath='f64') on the ``server`` flow's deserialized
    inputs, counters set to 0 just before and read just after: the flow's
    kernels, the df32 flow's words; its 2-limb result through the f64
    megakernel == its staged f64 decode."""
    import torch
    from repro_torch.fhe_client.client import FHEClient
    from repro_torch.fhe_server import inference as inf
    from repro_torch.fhe_server.eval_ops import ServerEvaluator
    from repro_torch.kernels import ops
    staged = out["client"]                      # default seed: same keys
    ev = ServerEvaluator(staged.ctx, out["evaluator"].keys, datapath="f64")
    xv, w, bias, poly = out["workload"]
    ops.reset_launches()
    t0 = time.perf_counter()
    y = inf.encrypted_linear_poly3(ev, out["x_ct"], w, bias, poly)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    for name, want in FLOW_LAUNCHES.items():
        if launches[name] != want:
            _fail(f"the f64 server evaluation launched {name} "
                  f"{launches[name]} times, expected {want}: {launches}")
    y32 = out["y_ct"]
    if not (torch.equal(y.c0, y32.c0) and torch.equal(y.c1, y32.c1)
            and y.scale == y32.scale):
        _fail("the f64 server evaluation differs from the df32 flow")
    used = {k: v for k, v in launches.items() if v}
    print(f"flow: server ServerEvaluator(datapath='f64') == the df32 flow "
          f"word for word; {wall * 1e3:.1f} ms host clock, launches {used}",
          flush=True)
    mega = FHEClient(staged.ctx.params, device=dev, datapath="f64")
    scale = staged._scale_operand([y.scale], y.batch)
    got = mega.decrypt_impl(y.c0[:, :2], y.c1[:, :2], scale)
    want = staged.decrypt_impl(y.c0[:, :2], y.c1[:, :2], scale)
    torch.cuda.synchronize()
    if not all(_same_bits(a, b) for a, b in zip(got, want)):
        _fail("the flow's result through the f64 megakernel differs from "
              "its staged f64 decode")
    print(f"flow: server 2-limb result (scale {y.scale!r}) through the f64 "
          f"megakernel == the staged f64 decode, bit for bit", flush=True)


# --- phase 10: the client service (K5 / K6 on two CUDA streams) ------------
# ``ClientService(FHEClient('paper'), n_streams=2, oversubscribe=True)``:
# two CUDA streams on the one card, DEFAULT_BUCKETS, a tenant lane beside
# the default one. The service's launches are counted first; then every
# encrypt row is held against the direct ``encode_encrypt_batch`` of its
# job's rows (padding included) from the job's nonce base on a same-seed
# client of its lane (0 differing words), and every decrypt against the
# direct ``decrypt_decode_batch`` of its rows, bit for bit.
SERVICE_ENC_A, SERVICE_DEC_A = 44, 4          # (a) closed loop
SERVICE_ENC_B, SERVICE_DEC_B = 64, 6          # (b) always on, Poisson
SERVICE_GAP_S, SERVICE_MAX_WAIT_S = 0.001, 0.005
SERVICE_ENC_C = 32                            # (c) a launch fault
SERVICE_ENC_C2 = 16                           # (c) a materialize fault
SERVICE_TENANT, SERVICE_ENC_D, SERVICE_DEC_D = "t1", 8, 2   # (d) per lane
# K5's device kernels (encode_encrypt.cu, encrypt_tiled.cuh): enc_*_kernel
K5_DEVICE_KERNEL = r"\benc_\w*kernel\b"


class _ServiceRun:
    """What the phase submitted and got back, by request id, for the
    checks that follow the counted part."""

    def __init__(self):
        self.lane, self.msg, self.row = {}, {}, {}
        self.dec_src, self.dec_out = {}, {}

    def enc(self, svc, m, lane="default", **kw):
        rid = svc.submit_encrypt(m, **kw)
        self.lane[rid], self.msg[rid] = lane, m
        return rid

    def dec(self, svc, ct, lane="default", **kw):
        rid = svc.submit_decrypt(ct, **kw)
        self.lane[rid], self.dec_src[rid] = lane, ct
        return rid

    def collect(self, svc, rids, timeout=120.0):
        for rid in rids:
            out = svc.result(rid, timeout=timeout)
            if rid in self.dec_src:
                self.dec_out[rid] = out
            else:
                self.row[rid] = out


def _service_differing_words(svc, run: _ServiceRun, twins) -> tuple:
    """(differing words, jobs checked): each encrypt job of the dispatch
    log against the direct path of its lane from its nonce base. A job's
    launches (retries too) must all carry its one nonce base."""
    import numpy as np
    jobs = {}
    for rec in svc.dispatch_log:
        if rec.kind == "enc" and jobs.setdefault(
                rec.rids, rec).nonce0 != rec.nonce0:
            _fail(f"service job {rec.rids} launched under two nonce bases")
    differ = 0
    for rids, rec in jobs.items():
        twin = twins[run.lane[rids[0]]]
        msgs = np.stack([run.msg[r] for r in rids])
        pad = np.zeros((rec.bucket - len(rids), msgs.shape[1]), complex)
        twin.nonce = rec.nonce0
        direct = twin.encode_encrypt_batch(np.concatenate([msgs, pad]))
        for i, rid in enumerate(rids):
            row = run.row[rid]
            differ += int((row.c0 != direct.c0[i]).sum().item())
            differ += int((row.c1 != direct.c1[i]).sum().item())
    return differ, len(jobs)


def _service_decrypts_match(run: _ServiceRun, twins) -> tuple:
    """(rows that differ from the direct decode, precision bits of the
    rows whose message is known)."""
    import numpy as np
    from repro_torch.core.encoder import boot_precision_bits
    from repro_torch.core.encryptor import CiphertextBatch
    bad, want, got = 0, [], []
    for rid, ct in run.dec_src.items():
        twin = twins[run.lane[rid]]
        direct = twin.decrypt_decode_batch(
            CiphertextBatch.from_cts([ct]).truncated(2))[0]
        bad += int(not np.array_equal(direct, run.dec_out[rid]))
        src = next((r for r, row in run.row.items() if row is ct), None)
        if src is not None:
            want.append(run.msg[src])
            got.append(run.dec_out[rid])
    bits = boot_precision_bits(np.stack(want), np.stack(got)) if want \
        else float("nan")
    return bad, bits


def _intervals_union(iv) -> list:
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _trace_device_activity(path) -> dict:
    """From a torch.profiler Chrome trace: the device's busy time (union of
    kernels and copies) and K5's kernels by CUDA stream, with the time the
    two streams' K5 kernels overlapped."""
    import re
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    busy, k5 = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        iv = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        busy.append(iv)
        if e["cat"] == "kernel" and re.search(K5_DEVICE_KERNEL, e["name"]):
            k5.setdefault(e.get("args", {}).get("stream"), []).append(iv)
    streams = sorted(k5, key=str)
    unions = [_intervals_union(k5[s]) for s in streams]
    overlap_us = sum(_overlap(unions[i], unions[j])
                     for i in range(len(unions))
                     for j in range(i + 1, len(unions)))
    return {"busy_ms": sum(e - s for s, e in _intervals_union(busy)) / 1e3,
            "k5_kernels_by_stream": {str(s): len(k5[s]) for s in streams},
            "k5_overlap_ms": overlap_us / 1e3}


def _service_phase(dev, card: str) -> dict:
    """Phase 10: (a) closed loop, (b) always on under Poisson arrivals
    (twice: once for the numbers, once under the profiler), (c) a launch
    fault and a materialize fault, (d) a tenant lane beside the default
    one; then the checks. Returns the service's K5 / K6 launches and the
    numbers for the result lines."""
    import tempfile
    from collections import Counter
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import scheduler as policy
    from repro_torch.core.context import PROFILES
    from repro_torch.fhe_client.client import FHEClient
    from repro_torch.fhe_client.service import (ClientService,
                                                FaultInjector, FaultSpec,
                                                tenant_seed)
    from repro_torch.kernels import ops
    from repro_torch.telemetry import table_cache_entries

    params = PROFILES[MAIN_PROFILE]
    ns = params.n_slots
    t_seed = tenant_seed(params, SERVICE_TENANT)
    client = FHEClient(MAIN_PROFILE, device=dev)
    twins = {"default": FHEClient(MAIN_PROFILE, device=dev),
             SERVICE_TENANT: FHEClient(params, seed=t_seed, device=dev)}
    svc = ClientService(client, n_streams=2, oversubscribe=True,
                        max_wait_s=SERVICE_MAX_WAIT_S)
    svc.registry.get(SERVICE_TENANT, params)
    t0 = time.perf_counter()
    n_warm = svc.warm_up()
    warm_s = time.perf_counter() - t0
    warm_entries = table_cache_entries(svc.lane_clients())
    print(f"service: {MAIN_PROFILE}, {svc.scheduler.n_streams} CUDA streams "
          f"on one card, buckets {svc.batcher.buckets}, lanes default + "
          f"tenant; warm-up {n_warm} launches in {warm_s:.2f} s, "
          f"table-cache entries {warm_entries}  [{card}]", flush=True)
    # host time of one encrypt job's launch on a stream, by part (before
    # the counters are set to 0: not the service's path)
    st = svc.scheduler.streams[0].streams[0]
    m16 = _messages(ns, MAIN_BATCH, SEED + 9)
    parts = {"operands": [], "launch": [], "device": []}
    for _ in range(5):
        nonce0 = svc._take_nonces(None, MAIN_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.stream(st):
            ops_ = client.encrypt_operands(m16)
            t1 = time.perf_counter()
            client.encrypt_impl(*ops_, nonce0)
            t2 = time.perf_counter()
        (st.synchronize if st is not None else torch.cuda.synchronize)()
        t3 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(v * 1e3)
    host = {k: float(np.median(v)) for k, v in parts.items()}
    print(f"service: one encrypt job B={MAIN_BATCH} on a stream, host "
          f"clock (median of 5): operands (df split + 4 pageable H2D) "
          f"{host['operands']:.3f} ms, K5 launch call "
          f"{host['launch']:.3f} ms, then waiting for the stream "
          f"{host['device']:.3f} ms  [{card}]", flush=True)
    ops.reset_launches()
    run = _ServiceRun()
    out = {"encrypt_job_host_ms": host}

    # (a) closed loop: 44 encrypts, flush; 4 of the results decrypted
    msgs = _messages(ns, SERVICE_ENC_A, SEED + 10)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rids = [run.enc(svc, m) for m in msgs]
            svc.flush()
            run.collect(svc, rids)
            n_enc_jobs = len(svc.dispatch_log)
            drids = [run.dec(svc, run.row[r]) for r in rids[:SERVICE_DEC_A]]
            svc.flush()
            run.collect(svc, drids)
            a_s = time.perf_counter() - t0
        trace = Path(tmp) / "service_trace.json"
        prof.export_chrome_trace(str(trace))
        act_a = _trace_device_activity(trace)
    executed = svc.scheduler.modes_executed()
    want = policy.plan_rounds(n_enc_jobs, 0, 2) + policy.plan_rounds(
        0, len(svc.dispatch_log) - n_enc_jobs, 2)
    if executed != want:
        _fail(f"service modes {executed} != plan_rounds {want}")
    buckets = [r.bucket for r in svc.dispatch_log]
    print(f"service (a) closed loop: {SERVICE_ENC_A} encrypts + "
          f"{SERVICE_DEC_A} decrypts in {a_s * 1e3:.1f} ms host clock "
          f"(under the profiler), jobs (bucket) {buckets}, modes "
          f"{[m.value for m, _k in executed]} == plan_rounds; device busy "
          f"{act_a['busy_ms']:.3f} ms, K5 kernels by stream "
          f"{act_a['k5_kernels_by_stream']}, overlap of the two streams' "
          f"K5 kernels {act_a['k5_overlap_ms']:.4f} ms  [{card}]",
          flush=True)
    out["a"] = {"buckets": buckets, "host_ms": a_s * 1e3,
                "modes": [m.value for m, _k in executed], **act_a}

    # (a) again without the profiler: the closed-loop rate, every request
    # queued before the flush (the rate the service sustains when arrivals
    # never leave it idle)
    msgs = _messages(ns, SERVICE_ENC_A, SEED + 15)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids2 = [run.enc(svc, m) for m in msgs]
    svc.flush()
    run.collect(svc, rids2)
    drids = [run.dec(svc, run.row[r]) for r in rids2[:SERVICE_DEC_A]]
    svc.flush()
    run.collect(svc, drids)
    a2_s = time.perf_counter() - t0
    n_a2 = SERVICE_ENC_A + SERVICE_DEC_A
    out["a_closed_loop"] = {"requests": n_a2, "wall_ms": a2_s * 1e3,
                            "requests_per_s": n_a2 / a2_s}
    print(f"service (a) closed loop, no profiler: {n_a2} requests in "
          f"{a2_s * 1e3:.1f} ms host clock: {n_a2 / a2_s:.1f} requests/s "
          f"(closed-loop rate)  [{card}]", flush=True)

    # (b) always on: Poisson arrivals (mean gap 1 ms), deadline 5 ms
    rng = np.random.default_rng(SEED + 11)
    kinds = ["enc"] * SERVICE_ENC_B + ["dec"] * SERVICE_DEC_B
    rng.shuffle(kinds)
    gaps = rng.exponential(SERVICE_GAP_S, len(kinds))
    msgs_b = _messages(ns, SERVICE_ENC_B, SEED + 12)
    dec_src = [run.row[r] for r in rids[SERVICE_DEC_A:SERVICE_DEC_A
                                        + SERVICE_DEC_B]]

    def always_on():
        start = len(svc.dispatch_log)
        svc.telemetry.reset()           # the stage histograms of this run
        svc.start()
        sub, ie, idd = [], 0, 0
        t_start = time.perf_counter()
        for kind, gap in zip(kinds, gaps):
            time.sleep(float(gap))
            if kind == "enc":
                sub.append(run.enc(svc, msgs_b[ie]))
                ie += 1
            else:
                sub.append(run.dec(svc, dec_src[idd]))
                idd += 1
        span = time.perf_counter() - t_start
        svc.stop(drain=True)
        wall = time.perf_counter() - t_start
        run.collect(svc, sub)
        lat = np.array([svc.latency(r) for r in sub]) * 1e3
        log = svc.dispatch_log[start:]
        return {"requests": len(sub), "wall_ms": wall * 1e3,
                "arrival_span_ms": span * 1e3,
                "offered_per_s": len(sub) / span,
                "requests_per_s": len(sub) / wall,
                "latency_p50_ms": float(np.percentile(lat, 50)),
                "latency_p99_ms": float(np.percentile(lat, 99)),
                "jobs_by_kind": dict(Counter(r.kind for r in log)),
                "jobs_by_stream": dict(Counter(r.stream for r in log)),
                "job_buckets": dict(Counter(r.bucket for r in log)),
                "rounds_by_mode": dict(Counter(
                    m.value for m, _k in svc.scheduler.modes_executed(
                        start))),
                "stages": svc.telemetry.stage_summaries()}

    b = always_on()
    print(f"service (b) always on: {b['requests']} requests (Poisson, mean "
          f"gap {SERVICE_GAP_S * 1e3:g} ms, max wait "
          f"{SERVICE_MAX_WAIT_S * 1e3:g} ms) offered at "
          f"{b['offered_per_s']:.1f} requests/s over "
          f"{b['arrival_span_ms']:.1f} ms, served in {b['wall_ms']:.1f} ms: "
          f"{b['requests_per_s']:.1f} requests/s (arrival-bound), latency "
          f"p50 "
          f"{b['latency_p50_ms']:.2f} ms p99 {b['latency_p99_ms']:.2f} ms; "
          f"jobs {b['jobs_by_kind']} by stream {b['jobs_by_stream']} "
          f"buckets {b['job_buckets']}, rounds by mode "
          f"{b['rounds_by_mode']}; stages (p50 / p99 ms) "
          + ", ".join(f"{k} {v['p50_s'] * 1e3:.2f} / {v['p99_s'] * 1e3:.2f}"
                      for k, v in b["stages"].items())
          + f"  [{card}]", flush=True)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bp = always_on()
        trace = Path(tmp) / "service_trace.json"
        prof.export_chrome_trace(str(trace))
        act = _trace_device_activity(trace)
    bp.update(act)
    bp["busy_share"] = act["busy_ms"] / bp["wall_ms"]
    overlapped = act["k5_overlap_ms"] > 0
    print(f"service (b) under the profiler: offered "
          f"{bp['offered_per_s']:.1f}, served {bp['requests_per_s']:.1f} "
          f"requests/s (arrival-bound), p50 {bp['latency_p50_ms']:.2f} ms p99 "
          f"{bp['latency_p99_ms']:.2f} ms; device busy "
          f"{act['busy_ms']:.3f} ms of {bp['wall_ms']:.1f} ms "
          f"({100 * bp['busy_share']:.1f}%); K5 kernels by stream "
          f"{act['k5_kernels_by_stream']}, the two streams' K5 kernels "
          f"{'overlapped' if overlapped else 'did not overlap'} "
          f"({act['k5_overlap_ms']:.4f} ms)  [{card}]", flush=True)
    out["b"], out["b_profiled"] = b, bp

    # (c) a launch fault on stream 0, then a materialize fault
    svc.scheduler.faults = FaultInjector([FaultSpec(stream=0, kind="error",
                                                    after=0, count=1)])
    msgs_c = _messages(ns, SERVICE_ENC_C + SERVICE_ENC_C2, SEED + 13)
    ev0 = len(svc.events)
    crids = [run.enc(svc, m) for m in msgs_c[:SERVICE_ENC_C]]
    svc.flush()
    run.collect(svc, crids)
    kinds_c = [e.kind for e in svc.events.replay()[ev0:]]
    if not {"stream_failed", "degraded", "requeue"} <= set(kinds_c):
        _fail(f"launch fault: events {kinds_c}")
    if svc.scheduler.alive_streams != [1]:
        _fail(f"launch fault: alive streams {svc.scheduler.alive_streams}")
    svc.scheduler.revive_all()
    svc.scheduler.faults = FaultInjector([FaultSpec(
        stream=0, kind="result_error", after=0, count=1)])
    ev0 = len(svc.events)
    crids = [run.enc(svc, m) for m in msgs_c[SERVICE_ENC_C:]]
    svc.flush()
    run.collect(svc, crids)
    kinds_c2 = [e.kind for e in svc.events.replay()[ev0:]]
    retried = [r for r in svc.dispatch_log if r.attempt > 0]
    if "retry_ok" not in kinds_c2 or not retried:
        _fail(f"materialize fault: events {kinds_c2}")
    svc.scheduler.revive_all()
    svc.scheduler.faults = None
    print(f"service (c) faults: launch fault events {kinds_c}; materialize "
          f"fault events {kinds_c2}, retry on stream {retried[-1].stream} "
          f"attempt {retried[-1].attempt}  [{card}]", flush=True)

    # (d) a tenant lane beside the default one
    msgs_d = _messages(ns, 2 * SERVICE_ENC_D, SEED + 14)
    drids = []
    for i in range(SERVICE_ENC_D):
        drids.append(run.enc(svc, msgs_d[2 * i], SERVICE_TENANT,
                             tenant=SERVICE_TENANT, params=params))
        drids.append(run.enc(svc, msgs_d[2 * i + 1]))
    svc.flush()
    run.collect(svc, drids)
    trids = [run.dec(svc, run.row[r], SERVICE_TENANT, tenant=SERVICE_TENANT,
                     params=params) for r in drids[:2 * SERVICE_DEC_D:2]]
    svc.flush()
    run.collect(svc, trids)

    # the service's launches: one K5 per encrypt job launched (retries
    # included), one K6 per decrypt job, nothing else
    counts = ops.launches()
    n_enc = sum(r.kind == "enc" for r in svc.dispatch_log)
    n_dec = sum(r.kind == "dec" for r in svc.dispatch_log)
    other = {k: v for k, v in counts.items() if v and k not in (
        "encode_encrypt_stream", "decrypt_decode_stream")}
    if (counts["encode_encrypt_stream"], counts["decrypt_decode_stream"]) \
            != (n_enc, n_dec) or other:
        _fail(f"service launches {counts} != {n_enc} encrypt / {n_dec} "
              f"decrypt jobs")
    entries = table_cache_entries(svc.lane_clients())
    if entries != warm_entries:
        _fail(f"table-cache entries moved on the warm path: {warm_entries} "
              f"-> {entries}")

    # the checks (direct calls launch K5 / K6 too: after the counts)
    differ, n_jobs = _service_differing_words(svc, run, twins)
    bad, bits = _service_decrypts_match(run, twins)
    torch.cuda.synchronize()
    print(f"service checks: {len(run.row)} encrypt rows in {n_jobs} jobs == "
          f"the direct path from each job's nonce base ({differ} differing "
          f"words, tenant lane against a solo client of seed "
          f"tenant_seed({MAIN_PROFILE}, {SERVICE_TENANT!r})); "
          f"{len(run.dec_out)} "
          f"decrypts == direct decode ({bad} differ), {bits:.2f} bits (bar "
          f"{BOOT_PREC_BITS}); launches K5 {n_enc} K6 {n_dec} == jobs; "
          f"table-cache entries {entries} unchanged  [{card}]", flush=True)
    if differ or bad:
        _fail(f"service results differ from the direct path: {differ} "
              f"words, {bad} decrypts")
    if not bits >= BOOT_PREC_BITS:
        _fail(f"service round-trip precision {bits} < {BOOT_PREC_BITS}")
    out.update({"encode_encrypt_stream": n_enc,
                "decrypt_decode_stream": n_dec, "differing_words": differ,
                "precision_bits": bits, "jobs": n_jobs})
    return out


# --- phase 11: the service mesh (K5 / K6 in two worker processes) ---------
# ``MeshRouter(n_workers=2, profile='paper')`` with DEFAULT_BUCKETS, both
# workers on the one card (each a fresh interpreter running a full
# ``ClientService``, loading the kernels phase 2 built). The workers'
# launches are in their own processes: this process's counters cannot see
# them, so the phase prints its own line. Every encrypt row is held
# against the port's solo ``ClientService`` in this process from the same
# lease base (0 differing words), every decrypt against the direct call.
MESH_WORKERS = 2
MESH_ENC, MESH_ENC_TENANT = 40, 8         # (a) default lane, tenant lane
MESH_DEC_FULL, MESH_DEC_SEEDED = 4, 2     # (b) kind 1, kind 2
MESH_ENC_KILL = 48                        # (d) three chunks of 16
MESH_TENANT = "t1"
MESH_TIMEOUT_S = 120.0                    # start-up, and each flush


def _mesh_rows_differ(rows, solo) -> int:
    """Words in which mesh result rows differ from a solo batch's rows."""
    return sum(int((r.c0 != solo.c0[i]).sum().item())
               + int((r.c1 != solo.c1[i]).sum().item())
               for i, r in enumerate(rows))


def _mesh_transport_ms(rows, mesh, dev) -> dict:
    """Host milliseconds of each step one enc chunk's results take between
    a worker's service and the router's ``Ciphertext`` rows, each step
    timed alone on its real input (median of 3): the worker's stack and
    serialize (D2H included), its tenant envelope and frame, the frame
    over a localhost TCP socket (``send_frame`` / ``recv_frame``), and on
    the router the envelope parse and the deserialize onto the card (H2D
    included)."""
    import socket
    import threading
    import numpy as np
    import torch
    from repro_torch.core.encryptor import CiphertextBatch
    from repro_torch.fhe_client.service import lane_wire_identity, wire
    from repro_torch.fhe_client.service.mesh import (OP_RESULT, recv_frame,
                                                     send_frame)
    tid, p = lane_wire_identity(None, mesh.params)
    state = {}

    def stack_serialize():
        state["inner"] = wire.serialize_ciphertext_batch(CiphertextBatch(
            c0=torch.stack([r.c0 for r in rows]),
            c1=torch.stack([r.c1 for r in rows]),
            n_limbs=rows[0].n_limbs, scale=rows[0].scale))

    def envelope():
        state["env"] = wire.serialize_tenant_envelope(tid, p, state["inner"])

    def tcp():
        got = []
        reader = threading.Thread(target=lambda: got.append(
            recv_frame(state["b"])))
        reader.start()
        send_frame(state["a"], OP_RESULT, state["env"])
        reader.join()
        state["payload"] = got[0][4]

    def parse():
        state["parsed"] = wire.deserialize_tenant_envelope(
            state["payload"])[2]

    def deserialize():
        wire.deserialize_ciphertext_batch(state["parsed"], device=dev)
        torch.cuda.synchronize()

    lst = socket.create_server(("127.0.0.1", 0))
    state["a"] = socket.create_connection(lst.getsockname())
    state["b"], _ = lst.accept()
    out = {}
    try:
        for name, fn in (("stack_serialize", stack_serialize),
                         ("envelope", envelope),
                         ("frame_over_localhost_tcp", tcp),
                         ("envelope_parse", parse),
                         ("deserialize_h2d", deserialize)):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            out[name] = float(np.median(times))
    finally:
        for sock in (state["a"], state["b"], lst):
            sock.close()
    out["frame_bytes"] = len(state["env"])
    return out


def _mesh_phase(dev, card: str) -> dict:
    """Phase 11: (a) 40 encrypts on the default lane and 8 on a tenant
    lane, twice (the first round pays the workers' client builds); (b)
    kind-1 and seeded kind-2 decrypts; (c) the evaluation-key broadcast;
    (d) a worker killed with chunks outstanding. Returns the numbers for
    the phase's result line."""
    import numpy as np
    import torch
    from repro_torch.core import encoder, encryptor
    from repro_torch.core.context import PROFILES
    from repro_torch.core.encryptor import CiphertextBatch
    from repro_torch.fhe_client.client import FHEClient
    from repro_torch.fhe_client.service import (DEFAULT_BUCKETS,
                                                ClientService, MeshRouter,
                                                tenant_seed, wire)

    params = PROFILES[MAIN_PROFILE]
    ns = params.n_slots
    t_seed = tenant_seed(params, MESH_TENANT)
    solo = {lane: ClientService(c, buckets=DEFAULT_BUCKETS, devices=[dev],
                                n_streams=1)
            for lane, c in (
                ("default", FHEClient(MAIN_PROFILE, device=dev)),
                (MESH_TENANT, FHEClient(params, seed=t_seed, device=dev)))}
    seeds = {"default": params.seed, MESH_TENANT: t_seed}
    out = {"workers": MESH_WORKERS, "profile": MAIN_PROFILE,
           "buckets": list(DEFAULT_BUCKETS)}
    differ = 0
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    mesh = MeshRouter(n_workers=MESH_WORKERS, profile=MAIN_PROFILE,
                      buckets=DEFAULT_BUCKETS, device=dev,
                      startup_timeout_s=MESH_TIMEOUT_S,
                      flush_timeout_s=MESH_TIMEOUT_S)
    with mesh:
        out["hello_all_s"] = time.perf_counter() - t0

        def enc_round(seed):
            """One round: MESH_ENC default + MESH_ENC_TENANT tenant
            encrypts, one flush; rows held against the solo services from
            each lane's lease base. Returns (seconds, differing words,
            rows by lane, messages by lane)."""
            msgs = {"default": _messages(ns, MESH_ENC, seed),
                    MESH_TENANT: _messages(ns, MESH_ENC_TENANT, seed + 1)}
            base = {lane: mesh.ledger.watermark(s)
                    for lane, s in seeds.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rids = {"default": [mesh.submit_encrypt(m)
                                for m in msgs["default"]],
                    MESH_TENANT: [mesh.submit_encrypt(
                        m, tenant=MESH_TENANT, params=params)
                        for m in msgs[MESH_TENANT]]}
            mesh.flush()
            rows = {lane: [mesh.result(r) for r in rs]
                    for lane, rs in rids.items()}
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            bad = 0
            for lane, svc in solo.items():
                svc.client.nonce = base[lane]
                bad += _mesh_rows_differ(rows[lane],
                                         svc.encrypt_many(msgs[lane]))
            return dt, bad, rows, msgs

        # (a) twice: the first flush waits for each worker's client build
        first_s, bad, _, _ = enc_round(SEED + 20)
        differ += bad
        a_s, bad, rows, msgs = enc_round(SEED + 22)
        differ += bad
        n_a = MESH_ENC + MESH_ENC_TENANT
        out["a"] = {"requests": n_a, "first_flush_s": first_s,
                    "flush_s": a_s, "requests_per_s": n_a / a_s,
                    "differing_words": differ}
        print(f"mesh (a): {MESH_WORKERS} workers on one card, {MESH_ENC} "
              f"encrypts default lane + {MESH_ENC_TENANT} tenant "
              f"{MESH_TENANT!r}: first flush {first_s:.2f} s (the workers' "
              f"client builds), then {a_s * 1e3:.1f} ms host clock: "
              f"{n_a / a_s:.1f} requests/s; {differ} differing words against "
              f"the solo service from each lane's lease base  [{card}]",
              flush=True)
        if differ:
            _fail(f"mesh encrypts differ from the solo service: {differ} "
                  f"words")

        # where the round's time goes: one chunk of 16 results through the
        # transport's host steps, each timed alone (host clock, median of 3)
        out["a"]["chunk16_host_ms"] = _mesh_transport_ms(
            rows["default"][:16], mesh, dev)
        print(f"mesh (a): one chunk of 16 results, host clock by step (ms): "
              f"{out['a']['chunk16_host_ms']}  [{card}]", flush=True)

        # (b) kind-1 decrypts of 2-limb views, kind-2 seeded decrypts
        client = solo["default"].client
        ctx = client.ctx
        wb = mesh.telemetry.wire_bytes

        def sent(kind):
            return sum(wb.value(worker=w, kind=kind, dir="send")
                       for w in mesh.workers)

        sent0 = {k: sent(k) for k in (wire.KIND_CT_BATCH,
                                      wire.KIND_CT_SEEDED)}
        full = [rows["default"][i] for i in range(MESH_DEC_FULL)]
        z_s = _messages(ns, MESH_DEC_SEEDED, SEED + 24)
        seeded = [encryptor.encrypt_symmetric_seeded(
            encoder.encode(z, ctx, n_limbs=2, device=dev), client.keys.sk,
            ctx, seed=client.seed, nonce=SEEDED_NONCE + 1 + i)
            for i, z in enumerate(z_s)]
        rids = [mesh.submit_decrypt((ct.c0[:2], ct.c1[:2], ct.scale))
                for ct in full] + [mesh.submit_decrypt(s) for s in seeded]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.flush()
        b_s = time.perf_counter() - t0
        got = [mesh.result(r) for r in rids]
        direct = [client.decrypt_decode_batch(
            CiphertextBatch.from_cts([ct]).truncated(2))[0] for ct in full]
        direct += [client.decrypt_decode_batch(CiphertextBatch.from_cts(
            [encryptor.expand_seeded(s, ctx, seed=client.seed)]))[0]
            for s in seeded]
        bad_dec = sum(not np.array_equal(g, d) for g, d in zip(got, direct))
        want = np.concatenate([msgs["default"][:MESH_DEC_FULL], z_s])
        bits = encoder.boot_precision_bits(want, np.stack(got))
        per = {"kind1": (sent(wire.KIND_CT_BATCH)
                         - sent0[wire.KIND_CT_BATCH]) / MESH_DEC_FULL,
               "kind2": (sent(wire.KIND_CT_SEEDED)
                         - sent0[wire.KIND_CT_SEEDED]) / MESH_DEC_SEEDED}
        ratio = per["kind2"] / per["kind1"]
        recv_enc = sum(wb.value(worker=w, kind=wire.KIND_CT_BATCH,
                                dir="recv") for w in mesh.workers)
        sent_enc = sum(wb.value(worker=w, kind=wire.KIND_RESULT, dir="send")
                       for w in mesh.workers)
        n_enc_total = 2 * n_a
        out["b"] = {"decrypts": len(rids), "flush_s": b_s,
                    "differ_from_direct": bad_dec, "precision_bits": bits,
                    "submit_bytes_per_request": {
                        "enc_kind3": sent_enc / n_enc_total,
                        "dec_kind1": per["kind1"],
                        "dec_kind2": per["kind2"]},
                    "enc_result_bytes_per_request": recv_enc / n_enc_total,
                    "kind2_over_kind1": ratio,
                    "wire": mesh.stats()["wire"]}
        print(f"mesh (b): {MESH_DEC_FULL} kind-1 decrypts (truncated(2)) + "
              f"{MESH_DEC_SEEDED} seeded kind-2 in {b_s * 1e3:.1f} ms: "
              f"{bad_dec} differ from the direct decrypt_decode_batch, "
              f"{bits:.2f} bits (bar {BOOT_PREC_BITS}); submit bytes per "
              f"request: encrypt (kind 3) {sent_enc / n_enc_total:.0f}, "
              f"decrypt kind 1 {per['kind1']:.0f}, kind 2 "
              f"{per['kind2']:.0f} ({ratio:.4f} of kind 1); encrypt result "
              f"(kind 1) {recv_enc / n_enc_total:.0f} B/request; wire "
              f"totals {out['b']['wire']}  [{card}]", flush=True)
        if bad_dec:
            _fail(f"mesh decrypts differ from the direct path: {bad_dec}")
        if not bits >= BOOT_PREC_BITS:
            _fail(f"mesh round-trip precision {bits} < {BOOT_PREC_BITS}")
        if not 0.49 <= ratio <= 0.51:
            _fail(f"a kind-2 submit is {ratio:.4f} of a kind-1 submit, not "
                  f"half")

        # (c) the evaluation-key broadcast: the router byte-compares the
        # workers' replies; they must equal this process's own keys
        recv0 = sum(wb.value(worker=w, kind=wire.KIND_EVAL_KEYS,
                             dir="recv") for w in mesh.workers)
        t0 = time.perf_counter()
        keys = mesh.evaluation_keys(rotations=(), include_relin=True)
        torch.cuda.synchronize()
        c_s = time.perf_counter() - t0
        key_bytes = (sum(wb.value(worker=w, kind=wire.KIND_EVAL_KEYS,
                                  dir="recv") for w in mesh.workers)
                     - recv0) / MESH_WORKERS
        t0 = time.perf_counter()
        ours = client.make_evaluation_keys((), include_relin=True,
                                           seed=client.seed)
        torch.cuda.synchronize()
        local_s = time.perf_counter() - t0
        same = wire.serialize_evaluation_keys(keys) == \
            wire.serialize_evaluation_keys(ours)
        del keys, ours
        out["c"] = {"broadcast_s": c_s,
                    "local_keygen_s": local_s,
                    "reply_bytes_per_worker": key_bytes,
                    "equal_to_local": same}
        print(f"mesh (c): evaluation keys (relin only) from "
              f"{MESH_WORKERS} workers byte-identical (checked by the "
              f"router), == this process's make_evaluation_keys: {same}; "
              f"broadcast {c_s:.2f} s host clock ({key_bytes:.0f} B a "
              f"worker), local keygen {local_s:.2f} s  [{card}]",
              flush=True)
        if not same:
            _fail("mesh evaluation keys differ from the local client's")

        # no worker may have died on its own: a worker that failed to build
        # its client on the card must fail the run, not be recovered from
        if mesh.alive_workers != list(range(MESH_WORKERS)) or \
                mesh.events.replay(kind="worker_failed"):
            _fail(f"a mesh worker died before the deliberate kill: alive "
                  f"{mesh.alive_workers}, events "
                  f"{[e.detail for e in mesh.events.replay()]}")

        # (d) a worker killed with chunks outstanding
        msgs_d = _messages(ns, MESH_ENC_KILL, SEED + 25)
        base = mesh.ledger.watermark(params.seed)
        rids = [mesh.submit_encrypt(m) for m in msgs_d]
        mesh._pump()
        victim = max((w for w in mesh.workers.values() if w.alive),
                     key=lambda w: (w.outstanding, w.id))
        outstanding = victim.outstanding
        mesh.kill_worker(victim.id)
        mesh.flush()
        rows_d = [mesh.result(r) for r in rids]
        solo["default"].client.nonce = base
        bad_d = _mesh_rows_differ(rows_d,
                                  solo["default"].encrypt_many(msgs_d))
        st = mesh.stats()
        failed = mesh.events.replay(kind="worker_failed")
        out["d"] = {"victim": victim.id, "outstanding": outstanding,
                    "requeues": st["requeues"], "worker_failed": len(failed),
                    "differing_words": bad_d}
        print(f"mesh (d): worker {victim.id} killed with {outstanding} "
              f"chunks outstanding: {st['requeues']} requeued under their "
              f"leases, {len(failed)} worker_failed event, alive "
              f"{st['alive_workers']}; {bad_d} differing words against the "
              f"solo service  [{card}]", flush=True)
        if bad_d or st["requeues"] < 1 or len(failed) != 1 \
                or st["failed_requests"]:
            _fail(f"mesh recovery: {bad_d} differing words, "
                  f"{st['requeues']} requeues, {len(failed)} worker "
                  f"failures, {st['failed_requests']} failed requests")
        out["startup_s"] = {str(k): v for k, v in st["startup_s"].items()}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"mesh: workers from spawn to HELLO / to their first result "
          + ", ".join(f"{k}: {v['hello']:.2f} / {v['first_reply']:.2f} s"
                      for k, v in out["startup_s"].items())
          + f"; phase {out['phase_s']:.1f} s  [{card}]", flush=True)
    return out


# --- phase 12: the LM substrate's serving path (K5 / K6 in the private-
# inference loop) -------------------------------------------------------------
# Full width and depth: qwen2-vl-2b (28 layers, d_model 1536, 12 / 2 heads,
# vocab 151,936, M-RoPE: 1.78 B params, 7.1 GB in f32) for the loop and the
# serve launcher, hymba-1.5b (32 layers, attention + SSM heads, SWA 1024 with
# global layers: 1.64 B params) for the engine. Random weights from a CUDA
# generator seeded with SEED. The 10 reduced archs hold the card against the
# CPU at tests/test_torch_models.py's logit tolerance.

LM_VL = "qwen2-vl-2b"
LM_ENGINE = "hymba-1.5b"
LM_LOOP = (2, 16)                      # (a) batch, seq: x is (2, 24,576)
LM_SERVE = (4, 64, 16)                 # (b) batch, prompt, gen
LM_PROMPTS = (32, 48, 64, 80, 96, 40)  # (c) six requests, 4 slots
LM_SLOTS, LM_CACHE, LM_NEW = 4, 256, 16
LM_CHECK = (2, 32, 3)                  # (d) batch, prompt, decode steps
LM_LOGIT_TOL = 3e-2                    # of max |CPU logits|


def _free_card() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _lm_card_vs_cpu(dev, card: str) -> dict:
    """(d) each reduced arch's prefill logits and LM_CHECK[2] decode steps
    on the card == on the CPU, same params (drawn on the CPU, copied)."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import model as M
    from repro_torch.models.archs import ARCHS, get_arch, reduced_config

    batch, prompt, steps = LM_CHECK
    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for name in sorted(ARCHS):
        cfg = reduced_config(get_arch(name))
        params = M.init_params(cfg, torch.Generator().manual_seed(SEED),
                               device=cpu)
        on_card = M.tree_map(lambda t: t.to(dev), params)
        data = synth_batch(cfg, 0, batch, prompt + steps, SEED)
        key = "embeds" if cfg.frontend else "tokens"
        sides = {"cpu": (cpu, params), "card": (dev, on_card)}
        logits = {side: [] for side in sides}
        caches = {}
        for side, (where, p) in sides.items():
            pre = {k: torch.as_tensor(v[:, :prompt], device=where)
                   for k, v in data.items() if k != "labels"}
            lg, caches[side] = M.prefill(p, pre, cfg,
                                         cache_len=prompt + steps,
                                         q_chunk=32, kv_chunk=32)
            logits[side].append(lg)
        for i in range(steps):
            if cfg.frontend:
                step = data["embeds"][:, prompt + i: prompt + i + 1]
            else:    # both sides take the CPU's greedy token
                step = logits["cpu"][-1][:, -1, : cfg.vocab].argmax(
                    -1, keepdim=True).numpy()
            for side, (where, p) in sides.items():
                lg, caches[side] = M.decode_step(
                    p, caches[side], {key: torch.as_tensor(step,
                                                           device=where)},
                    prompt + i, cfg)
                logits[side].append(lg)
        worst, checked = 0.0, 0
        for a, b in zip(logits["cpu"], logits["card"]):
            a = a[:, -1, : cfg.vocab].float().numpy()
            b = b[:, -1, : cfg.vocab].float().cpu().numpy()
            if not (np.isfinite(b).all() and b.shape == a.shape):
                _fail(f"card logits of {name} not finite or of shape "
                      f"{b.shape}")
            rel = float(np.abs(a - b).max() / np.abs(a).max())
            worst = max(worst, rel)
            top = np.sort(a, -1)
            clear = top[:, -1] - top[:, -2] > LM_LOGIT_TOL * np.abs(a).max()
            if (a.argmax(-1) != b.argmax(-1))[clear].any():
                _fail(f"{name}: greedy tokens differ between card and CPU "
                      f"where the CPU's margin is clear")
            checked += int(clear.sum())
        if worst > LM_LOGIT_TOL:
            _fail(f"{name}: card logits {worst:.3g} of max |CPU| away "
                  f"(tolerance {LM_LOGIT_TOL})")
        out[name] = {"max_rel_diff": worst, "greedy_checked": checked}
        del params, on_card, sides, logits, caches
    torch.set_num_threads(threads)
    print("lm (d) card vs CPU, reduced archs (max |card - cpu| / max |cpu| "
          "over prefill and 3 decodes; tolerance "
          f"{LM_LOGIT_TOL}): " + ", ".join(
              f"{n} {v['max_rel_diff']:.4f}" for n, v in out.items())
          + f"  [{card}]", flush=True)
    return out


def _lm_phase(dev, card: str) -> dict:
    """Phase 12: (a) the private-inference loop through the client service
    at qwen2-vl-2b's full size, counters set to 0 just before and read just
    after; (b) ``launch.serve.serve`` on the same model; (c) the serving
    engine at hymba-1.5b's full size; (d) the card against the CPU on the
    10 reduced archs. Returns (K5 / K6 launches of (a), the numbers)."""
    import numpy as np
    import torch
    from repro_torch.fhe_client import private_inference as pi
    from repro_torch.fhe_client.client import FHEClient
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.archs import get_arch
    from repro_torch.serving.engine import Request, ServingEngine

    t_phase = time.perf_counter()
    out = {}
    # (a) the private-inference loop
    cfg = get_arch(LM_VL)
    batch, seq = LM_LOOP
    client = FHEClient(MAIN_PROFILE, seed=SEED, device=dev)
    # a first run pays the card's one-time costs (lazy kernel loading,
    # cuBLAS handles); the second is the one counted and checked
    _, cold = pi.run(cfg, MAIN_PROFILE, batch=batch, seq=seq, seed=SEED,
                     device=dev, client=client)
    _free_card()
    torch.cuda.synchronize()
    ops.reset_launches()
    y, st = pi.run(cfg, MAIN_PROFILE, batch=batch, seq=seq, seed=SEED,
                   device=dev, client=client)
    torch.cuda.synchronize()
    launches = ops.launches()
    k5, k6 = (launches["encode_encrypt_stream"],
              launches["decrypt_decode_stream"])
    others = {k: v for k, v in launches.items() if v and k not in (
        "encode_encrypt_stream", "decrypt_decode_stream")}
    if k5 != st["jobs"]["enc"] or k6 != st["jobs"]["dec"] or others:
        _fail(f"private-inference launches {launches} != jobs {st['jobs']}")
    if not k5 or not k6:
        _fail("the private-inference loop launched no K5 or no K6")
    if not st["roundtrip_err"] < pi.ROUNDTRIP_BOUND:
        _fail(f"private-inference round trip {st['roundtrip_err']} >= "
              f"{pi.ROUNDTRIP_BOUND}")
    if y.shape != (batch, cfg.d_model) or not np.isfinite(y).all():
        _fail(f"served output of shape {y.shape} or not finite")
    out["private_inference"] = {
        "arch": LM_VL, "params": cfg.param_count(), "x": [batch,
                                                          seq * cfg.d_model],
        "profile": MAIN_PROFILE, "roundtrip_err": st["roundtrip_err"],
        "server_prefill_ms": st["serve_s"][0] * 1e3, "loop_s": st["loop_s"],
        "first_run": {"server_prefill_ms": cold["serve_s"][0] * 1e3,
                      "loop_s": cold["loop_s"]},
        "jobs": st["jobs"], "launches": {"encode_encrypt_stream": k5,
                                         "decrypt_decode_stream": k6},
        "upload_bytes": st["upload_bytes"],
        "download_bytes": st["download_bytes"]}
    print(f"lm (a) private inference, {LM_VL} full ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.param_count() / 1e9:.2f} B params), "
          f"x ({batch}, {seq * cfg.d_model}), {MAIN_PROFILE} via the "
          f"service: round trip {st['roundtrip_err']:.3e} (bound "
          f"{pi.ROUNDTRIP_BOUND}); server prefill {st['serve_s'][0] * 1e3:.2f}"
          f" ms (host clock, with its H2D / D2H); loop {st['loop_s']:.3f} s "
          f"(first run: {cold['serve_s'][0] * 1e3:.2f} ms, "
          f"{cold['loop_s']:.3f} s); "
          f"K5 {k5} / K6 {k6} launches == jobs {st['jobs']}; wire "
          f"{st['upload_bytes']} B up, {st['download_bytes']} B down  "
          f"[{card}]", flush=True)
    del y, st, cold, client
    _free_card()

    # (b) the serve launcher on the same model
    b, prompt, gen = LM_SERVE
    toks, sst = serve.serve(cfg, b, prompt, gen, seed=SEED, device=dev)
    if toks.shape != (b, gen) or not ((0 <= toks) & (toks < cfg.vocab)).all():
        _fail(f"serve returned tokens of shape {toks.shape} or out of range")
    out["serve"] = {"arch": LM_VL, "batch": b, "prompt_len": prompt,
                    "gen": gen, "prefill_ms": sst["prefill_s"] * 1e3,
                    "decode_s": sst["decode_s"],
                    "decode_tok_per_s": sst["tok_per_s"]}
    print(f"lm (b) serve {LM_VL} full, batch {b}, prompt {prompt}, gen "
          f"{gen}: prefill {sst['prefill_s'] * 1e3:.2f} ms, decode "
          f"{sst['tok_per_s']:.1f} tokens/s ({gen - 1} steps in "
          f"{sst['decode_s']:.3f} s; host clock, synchronized)  [{card}]",
          flush=True)
    _free_card()

    # (c) the serving engine at hymba-1.5b's full size
    hcfg = get_arch(LM_ENGINE)
    params = M.init_params(hcfg, torch.Generator(device=dev)
                           .manual_seed(SEED), device=dev)
    n_params = sum(t.numel() for t in M.tree_leaves(params))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, hcfg.vocab, n, dtype=np.int32)
               for n in LM_PROMPTS]
    eng = ServingEngine(hcfg, params, slots=LM_SLOTS, cache_len=LM_CACHE,
                        device=dev)
    reqs = [Request(rid=i, tokens=p, max_new=LM_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while steps < 8 * LM_NEW and (eng.step() or eng.queue):
        steps += 1
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    if not all(r.done and len(r.out) == LM_NEW for r in reqs):
        _fail(f"engine: {sum(not r.done for r in reqs)} of {len(reqs)} "
              f"requests unfinished after {steps} steps")
    new_tokens = sum(len(r.out) for r in reqs)
    # one request through a 1-slot engine == a direct prefill + decode loop
    one = Request(rid=0, tokens=prompts[0], max_new=LM_NEW)
    solo = ServingEngine(hcfg, params, slots=1, cache_len=LM_CACHE,
                         device=dev)
    solo.submit(one)
    solo.run(max_steps=4 * LM_NEW)
    lg, cache = M.prefill(params, {"tokens": torch.as_tensor(
        prompts[0], device=dev)[None]}, hcfg, cache_len=LM_CACHE,
        q_chunk=64, kv_chunk=64)
    direct = [int(torch.argmax(lg[0, -1, : hcfg.vocab]))]
    for i in range(LM_NEW - 1):
        lg, cache = M.decode_step(params, cache, {"tokens": torch.tensor(
            [[direct[-1]]], device=dev)}, len(prompts[0]) + i, hcfg)
        direct.append(int(torch.argmax(lg[0, -1, : hcfg.vocab])))
    if one.out != direct:
        _fail(f"engine tokens {one.out} != direct decode {direct}")
    # where a step's time goes: device busy share and top device kernels
    rows = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device=dev)
    cache = M.zeros_cache(M.cache_spec(hcfg, LM_SLOTS, LM_CACHE, 1), dev)
    _profile(lambda: M.decode_step(params, cache, {"tokens": rows},
                                   LM_PROMPTS[2], hcfg), 3,
             f"{LM_ENGINE} decode_step, {LM_SLOTS} rows  [{card}]")
    prompt = torch.as_tensor(prompts[2], device=dev)[None]
    _profile(lambda: M.prefill(params, {"tokens": prompt}, hcfg,
                               cache_len=LM_CACHE, q_chunk=64, kv_chunk=64),
             2, f"{LM_ENGINE} prefill, {len(prompts[2])} tokens  [{card}]")
    out["engine"] = {"arch": LM_ENGINE, "params": n_params,
                     "slots": LM_SLOTS, "cache_len": LM_CACHE,
                     "prompts": list(LM_PROMPTS), "max_new": LM_NEW,
                     "steps": steps, "engine_s": engine_s,
                     "new_tokens_per_s": new_tokens / engine_s,
                     "solo_equals_direct": True}
    print(f"lm (c) engine {LM_ENGINE} full ({hcfg.n_layers} layers, "
          f"{n_params / 1e9:.2f} B params), {LM_SLOTS} slots, cache "
          f"{LM_CACHE}, {len(prompts)} requests (prompts "
          f"{'/'.join(map(str, LM_PROMPTS))}, {LM_NEW} new each): all "
          f"finished in {steps} steps, {engine_s:.3f} s, "
          f"{new_tokens / engine_s:.1f} new tokens/s (host clock, "
          f"synchronized); a request through one slot == direct decode, "
          f"{LM_NEW} tokens  [{card}]", flush=True)
    del params, eng, solo, cache, lg
    _free_card()

    # (d) card against CPU, the 10 reduced archs
    out["card_vs_cpu"] = _lm_card_vs_cpu(dev, card)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"lm phase {out['phase_s']:.1f} s  [{card}]", flush=True)
    return out


# --- phase 13: the LM substrate's training path ------------------------------
# (a) the training launcher as examples/train_lm.py drives it: mamba2-130m
# full (24 layers, d_model 768), batch 8 x 512, --micro 2 --compress, 8-bit
# AdamW; then resume without --compress (the reference checkpoints no
# compression residual): 10 steps, --resume to 19, against 19 straight (the
# launcher's warmup is steps // 10 + 1: 10 and 19 give 2, 20 would give 3).
# (b) qwen2-vl-2b full (phase 12's model) on one fixed batch, the system
# test's settings. (c) the 10 reduced archs' gradients and one train step on
# the card against the CPU. The path reaches no kernel of the port.

TRAIN_ARCH = "mamba2-130m"
TRAIN_RUN = (8, 512, 2, 20)            # (a) batch, seq, micro, steps
TRAIN_RESUME = (10, 19)                # (a) first leg, resumed end
TRAIN_RESUME_LOSS_TOL = 1e-3           # (a) of the loss, if not bit-equal
TRAIN_BIG = (4, 512, 2, 10)            # (b) batch, seq, micro, steps
TRAIN_BIG_ADAM = dict(lr=1e-3, warmup=5)
TRAIN_CHECK = ((2, 64), (4, 64))       # (c) gradient batch, step batch
TRAIN_GRAD_TOL = 3e-2                  # (c) of each leaf's max |CPU grad|
TRAIN_FLIP_SHARE = 2e-2                # (c) entries whose step differs


def _host_npz(directory, step: int) -> dict:
    import numpy as np
    with np.load(Path(directory) / f"step_{step:08d}" / "host0.npz") as z:
        return {k: z[k] for k in z.files}


def _train_card_vs_cpu(dev, card: str) -> dict:
    """(c) each reduced arch's ``train_fwd`` gradients and one train step
    (8-bit, micro 2, compress) on the card == on the CPU, same params."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import model as M
    from repro_torch.models.archs import ARCHS, get_arch, reduced_config
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    from repro_torch.training import tree as T

    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    adam = opt.AdamWConfig(**TRAIN_BIG_ADAM)
    out = {}
    for name in sorted(ARCHS):
        cfg = reduced_config(get_arch(name))
        params = M.init_params(cfg, torch.Generator().manual_seed(SEED),
                               device=cpu)
        sides = {"cpu": (cpu, params),
                 "card": (dev, M.tree_map(lambda t: t.to(dev), params))}
        grads, news, lrs = {}, {}, {}
        (gb, gs), (sb, ss) = TRAIN_CHECK
        for side, (where, p) in sides.items():
            def on(batch, where=where):
                return {k: torch.as_tensor(v, device=where)
                        for k, v in batch.items()}
            _, g = ts.value_and_grad(p, on(synth_batch(cfg, 0, gb, gs, SEED)),
                                     cfg, q_chunk=32, kv_chunk=32)
            grads[side] = [t.cpu().numpy() for t in T.leaves(g)]
            step = ts.build_train_step(cfg, adam, n_micro=2, compress=True,
                                       q_chunk=32, kv_chunk=32)
            p2, _, m, _ = step(p, opt.adamw_init(p, adam),
                               on(synth_batch(cfg, 0, sb, ss, SEED)),
                               opt.compress_init(p))
            news[side] = [t.cpu().numpy() for t in T.leaves(p2)]
            lrs[side] = float(m["lr"])
        worst = 0.0
        for (path, _), a, b in zip(T.flatten_with_path(params), grads["cpu"],
                                   grads["card"]):
            where = "/".join(map(str, path))
            if not np.isfinite(b).all():
                _fail(f"{name}: card gradient {where} not finite")
            scale = float(np.abs(a).max())
            if scale == 0:
                if np.any(b):
                    _fail(f"{name}: card gradient {where} not 0 where the "
                          f"CPU's is")
                continue
            worst = max(worst, float(np.abs(a - b).max()) / scale)
        if worst > TRAIN_GRAD_TOL:
            _fail(f"{name}: card gradients {worst:.3g} of max |CPU| away "
                  f"(tolerance {TRAIN_GRAD_TOL})")
        lr = lrs["cpu"]
        moved = entries = 0
        for a, b in zip(news["cpu"], news["card"]):
            d = np.abs(a.astype(np.float64) - b)
            if not np.isfinite(b).all() or d.max() > 2.01 * lr:
                _fail(f"{name}: a card train step's params {d.max() / lr:.3g}"
                      f" lr from the CPU's (bound 2.01 lr)")
            moved += int((d > lr / 2).sum())
            entries += a.size
        if moved > TRAIN_FLIP_SHARE * entries or lrs["card"] != lr:
            _fail(f"{name}: {moved} of {entries} entries stepped otherwise "
                  f"on the card")
        out[name] = {"grad_max_rel_diff": worst,
                     "step_entries_moved_otherwise": moved,
                     "step_entries": entries}
        del params, sides, grads, news
    torch.set_num_threads(threads)
    print("train (c) card vs CPU, reduced archs (gradients: max |card - cpu| "
          f"/ max |cpu| per leaf, tolerance {TRAIN_GRAD_TOL}; one 8-bit "
          "compressed step: entries whose step differs > lr/2): " + ", ".join(
              f"{n} {v['grad_max_rel_diff']:.4f} / "
              f"{v['step_entries_moved_otherwise']}" for n, v in out.items())
          + f"  [{card}]", flush=True)
    return out


def _train_phase(dev, card: str) -> dict:
    """Phase 13: (a) ``launch.train`` at mamba2-130m's full size with
    train_lm's settings, then a resume against a straight run; (b) 10 train
    steps of qwen2-vl-2b at full size on one batch: the loss must fall by
    > 0.1; (c) the card against the CPU on the 10 reduced archs. Every
    launch counter stays 0: the training path reaches no kernel."""
    import shutil
    import statistics
    import numpy as np
    import torch
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models.archs import get_arch
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    from repro_torch.training import tree as T

    t_phase = time.perf_counter()
    out = {}
    root = ROOT / "build" / "train_phase"
    shutil.rmtree(root, ignore_errors=True)
    _free_card()
    torch.cuda.synchronize()
    ops.reset_launches()

    # (a) the launcher, train_lm's flags
    b, s, micro, n_steps = TRAIN_RUN
    common = ["--arch", TRAIN_ARCH, "--batch", str(b), "--seq", str(s),
              "--micro", str(micro), "--ckpt-every", "100",
              "--log-every", "10", "--device", str(dev)]
    t0 = time.perf_counter()
    losses, st = train_cli.run(common + ["--steps", str(n_steps),
                                         "--compress", "--ckpt-dir",
                                         str(root / "example")])
    run_s = time.perf_counter() - t0
    if len(losses) != n_steps or not np.isfinite(losses).all():
        _fail(f"train (a): losses {losses}")
    warm = st["step_s"][1:]
    step_ms = statistics.median(warm) * 1e3
    out["example"] = {
        "arch": TRAIN_ARCH, "batch": b, "seq": s, "micro": micro,
        "compress": True, "steps": n_steps, "first_loss": losses[0],
        "last_loss": losses[-1], "first_step_ms": st["step_s"][0] * 1e3,
        "step_ms_median": step_ms, "step_ms_min": min(warm) * 1e3,
        "tokens_per_s": b * s / (step_ms / 1e3), "run_s": run_s}
    print(f"train (a) launch.train {TRAIN_ARCH} full, batch {b} x {s}, micro "
          f"{micro}, --compress, 8-bit AdamW, {n_steps} steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; step {step_ms:.1f} ms "
          f"(median of steps 1-{n_steps - 1}, min {min(warm) * 1e3:.1f}; "
          f"first {st['step_s'][0] * 1e3:.1f}), {b * s / (step_ms / 1e3):.0f}"
          f" tokens/s; run {run_s:.1f} s with init and checkpoint  [{card}]",
          flush=True)
    first, end = TRAIN_RESUME
    r1 = train_cli.main(common + ["--steps", str(first), "--ckpt-dir",
                                 str(root / "resumed")])
    r2, st2 = train_cli.run(common + ["--steps", str(end), "--resume",
                                     "--ckpt-dir", str(root / "resumed")])
    whole = train_cli.main(common + ["--steps", str(end), "--ckpt-dir",
                                    str(root / "straight")])
    if st2["start"] != first or len(r1) + len(r2) != end:
        _fail(f"train (a): resumed at {st2['start']}, {len(r1)} + {len(r2)}"
              f" steps")
    a_ck, b_ck = (_host_npz(root / d, end) for d in ("resumed", "straight"))
    if list(a_ck) != list(b_ck):
        _fail("train (a): the two checkpoints name different leaves")
    same_params = all(a_ck[k].tobytes() == b_ck[k].tobytes() for k in a_ck)
    loss_diff = max(abs(x - y) for x, y in zip(r2, whole[first:]))
    param_diff = max(float(np.abs(a_ck[k].astype(np.float64)
                                  - b_ck[k]).max()) for k in a_ck)
    bit_equal = same_params and r2 == whole[first:]
    if not bit_equal and not loss_diff <= TRAIN_RESUME_LOSS_TOL * max(
            abs(x) for x in whole):
        _fail(f"train (a): resumed losses {r2} != straight {whole[first:]}")
    out["resume"] = {"first_leg": first, "end": end, "bit_identical":
                     bit_equal, "max_loss_diff": loss_diff,
                     "max_param_or_state_diff": param_diff,
                     "loss_tol_if_not_bit_equal": TRAIN_RESUME_LOSS_TOL}
    print(f"train (a) resume, no --compress: {first} steps, --resume to "
          f"{end}, against {end} straight: losses of steps {first}-{end - 1} "
          f"and the final params and state "
          f"{'bit-identical' if bit_equal else 'differ'} (max |loss diff| "
          f"{loss_diff:.3g}, max |param / state diff| {param_diff:.3g})  "
          f"[{card}]", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    _free_card()

    # (b) qwen2-vl-2b at full size, one fixed batch
    cfg = get_arch(LM_VL)
    b, s, micro, n_steps = TRAIN_BIG
    adam = opt.AdamWConfig(**TRAIN_BIG_ADAM)
    torch.cuda.reset_peak_memory_stats(dev)
    params, state, _ = ts.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(SEED), adam, device=dev)
    state_bytes = torch.cuda.memory_allocated(dev)
    nbytes = {"params": sum(t.nbytes for t in T.leaves(params)),
              "opt_state": sum(t.nbytes for t in T.leaves(state))}
    step = ts.build_train_step(cfg, adam, n_micro=micro, q_chunk=s,
                               kv_chunk=s)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synth_batch(cfg, 0, b, s, SEED).items()}
    losses, times = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        params, state, m, _ = step(params, state, batch, None)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0] - 0.1:
        _fail(f"train (b): {LM_VL} loss {losses[0]} -> {losses[-1]}, not "
              f"down by > 0.1")
    step_ms = statistics.median(times[1:]) * 1e3
    out["big"] = {
        "arch": LM_VL, "params": cfg.param_count(), "batch": b, "seq": s,
        "micro": micro, "remat": True, "steps": n_steps, "losses": losses,
        "first_step_ms": times[0] * 1e3, "step_ms_median": step_ms,
        "tokens_per_s": b * s / (step_ms / 1e3),
        "state_bytes": state_bytes, "peak_bytes": peak,
        "nbytes": nbytes}
    print(f"train (b) {LM_VL} full ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_count() / 1e9:.2f} B params), batch "
          f"{b} x {s}, micro {micro}, remat, 8-bit AdamW lr "
          f"{adam.lr} warmup {adam.warmup}, {n_steps} steps on one batch: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; step {step_ms:.1f} ms "
          f"(median of steps 1-{n_steps - 1}; first {times[0] * 1e3:.1f}), "
          f"{b * s / (step_ms / 1e3):.0f} tokens/s; params + state "
          f"{state_bytes / 1e9:.2f} GB, peak {peak / 1e9:.2f} GB "
          f"(max_memory_allocated)  [{card}]", flush=True)
    _profile(lambda: step(params, state, batch, None), 1,
             f"{LM_VL} train step, batch {b} x {s}, micro {micro}  [{card}]")
    del params, state, batch, m
    _free_card()

    # (c) card against CPU, the 10 reduced archs
    out["card_vs_cpu"] = _train_card_vs_cpu(dev, card)
    torch.cuda.synchronize()
    used = {k: v for k, v in ops.launches().items() if v}
    if used:
        _fail(f"the training path launched port kernels: {used}")
    out["port_kernel_launches"] = 0
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"train phase {out['phase_s']:.1f} s, port kernel launches 0 (the "
          f"path reaches no pallas_call)  [{card}]", flush=True)
    return out


# --- phase 14: the quickstart on the card, the dry-run ------------------------
# (a) launch.quickstart at paper (K2 / K3, then K5 / K6 at B=4); (b) the
# dry-run's train_4k cell of every arch on the single- and the multi-pod
# mesh; (c) its per-device bytes on a one-device mesh against the params
# and state phase 13 (b) allocated.

QUICKSTART_KERNELS = ("encrypt_limbs", "decrypt_limbs",
                      "encode_encrypt_stream", "decrypt_decode_stream")
DRYRUN_SHAPE = "train_4k"


def _launch_phase(dev, card: str, train_big: dict) -> dict:
    """Phase 14: (a) ``launch.quickstart --profile paper`` on the card with
    K2, K3, K5 and K6 launched, both halves >= 19.29 bits; (b)
    ``launch.dryrun`` over DRYRUN_SHAPE for every arch on both production
    meshes; (c) the dry-run's params + state bytes of the qwen2-vl-2b
    train cell on a (1, 1) mesh == phase 13's real allocation."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, quickstart
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.archs import ARCHS

    t_phase = time.perf_counter()
    out = {}
    _free_card()
    torch.cuda.synchronize()
    ops.reset_launches()
    r = quickstart.main(["--profile", MAIN_PROFILE, "--device", str(dev)])
    torch.cuda.synchronize()
    launches = ops.launches()
    missing = [k for k in QUICKSTART_KERNELS if not launches[k]]
    if missing:
        _fail(f"quickstart: {missing} never launched ({launches})")
    for what, bits in (("per-ciphertext", r["prec"]),
                       ("batched", r["prec_batch"])):
        if not bits >= BOOT_PREC_BITS:
            _fail(f"quickstart {what} half: {bits} bits < {BOOT_PREC_BITS}")
    if not (np.all(np.isfinite(r["z_got"])) and np.all(np.isfinite(
            r["z_batch"])) and r["z_batch"].shape == r["msgs"].shape):
        _fail("quickstart: decoded slots not finite or of the wrong shape")
    used = {k: v for k, v in launches.items() if v}
    out["quickstart"] = {
        "profile": MAIN_PROFILE, "launches": used,
        "bits": r["prec"], "bits_batch": r["prec_batch"],
        "single_ms": r["single_s"] * 1e3, "batch_ms": r["batch_s"] * 1e3}
    print(f"quickstart {MAIN_PROFILE} on the card: per-ciphertext half "
          f"(encode, K2, 2 limbs, K3, decode) {r['single_s'] * 1e3:.1f} ms "
          f"host, {r['prec']:.2f} bits; FHEClient B=4 round trip (K5, K6) "
          f"{r['batch_s'] * 1e3:.1f} ms host, {r['prec_batch']:.2f} bits "
          f"(first calls, incl. table uploads); launches {used}  [{card}]",
          flush=True)
    del r
    _free_card()

    # (b) the dry-run: no device
    ops.reset_launches()
    t0 = time.perf_counter()
    recs = [dryrun.run_cell(arch, DRYRUN_SHAPE, mk)
            for arch in sorted(ARCHS) for mk in ("single", "multi")]
    dry_s = time.perf_counter() - t0
    if any(not (x["flops"] > 0 and x["memory"]["argument_size_in_bytes"]
                > 0) for x in recs):
        _fail("dryrun: a record without flops or bytes")
    out["dryrun"] = {"cells": len(recs), "shape": DRYRUN_SHAPE,
                     "seconds": dry_s,
                     "records": {f"{x['arch']} {x['mesh']}": {
                         "flops": x["flops"],
                         "argument_bytes":
                             x["memory"]["argument_size_in_bytes"],
                         "collective_bytes":
                             x["collectives"]["total_bytes"]}
                         for x in recs}}
    print(f"dryrun: {len(recs)} records ({DRYRUN_SHAPE}, 10 archs x single "
          f"/ multi) in {dry_s:.1f} s on the host, e.g. {LM_VL} single "
          f"{recs[2 * sorted(ARCHS).index(LM_VL)]['flops']:.4g} FLOPs a "
          f"device", flush=True)

    # (c) exact bytes against phase 13's allocation
    one = dryrun.run_cell(LM_VL, DRYRUN_SHAPE, "one", save=False,
                          mesh=make_mesh((1, 1), ("data", "model")))
    by_part = one["memory"]["argument_bytes_by_part"]
    real = train_big["nbytes"]
    if (by_part["params"], by_part["opt_state"]) != (real["params"],
                                                      real["opt_state"]):
        _fail(f"dryrun bytes {by_part} != the card's {real}")
    torch.cuda.synchronize()
    used = {k: v for k, v in ops.launches().items() if v}
    if used:
        _fail(f"the dry-run launched port kernels: {used}")
    out["bytes_check"] = {"arch": LM_VL, "mesh": "(1, 1)",
                          "dryrun": {k: by_part[k] for k in real},
                          "card_nbytes": real}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"dryrun bytes on a (1, 1) mesh, {LM_VL} {DRYRUN_SHAPE}: params "
          f"{by_part['params']} + 8-bit AdamW state {by_part['opt_state']} "
          f"B == phase 13's nbytes on the card, exactly; phase "
          f"{out['phase_s']:.1f} s  [{card}]", flush=True)
    return out



# --- phase 15: the reference tests' contracts on the card ---------------------
# What tests/test_torch_{client_stream,device_fourier,ckks,server_ops,rules}.py
# hold at tiny / test on the CPU, held on the card at the sizes users run:
# (a) the nonce layout, (b) per-row scales, (c) no host FFT on the device
# pipelines, (d) a wrong key, (e) the server preset sweep and raw mul_pt +
# rescale == the fused K8b, (f) the reference's guards.

MIRROR_NONCE_BASE, MIRROR_WALK = 300, 3     # (a) test_client_stream.py:239
MIRROR_SCALED_ROWS = (1, 3)                 # (b) rows at twice the scale
MIRROR_WRONG_SEED = 0xDEADBEEF              # (d) test_ckks.py:119
MIRROR_WRONG_BITS = 5
MIRROR_SWEEP_LEVEL = 4                      # (e) test_server_ops.py:669
MIRROR_SWEEP_BUDGET = {"add_ct": 2.0 ** -15, "mul_ct": 2.0 ** -13,
                       "rotate": 2.0 ** -14}
MIRROR_BOOT_LEVEL = 6                       # (e) the boot flow's level
HOST_FFTS = ("fft", "ifft", "rfft", "irfft", "fftn", "ifftn", "fft2", "ifft2")


class _Raised:
    """Lets an exception raised in its block go no further and records its
    type: what (f) holds against the reference's. A check that fails still
    ends the run through ``_fail``."""

    type = None

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.type = et
        return et is not None and issubclass(et, Exception)


@contextlib.contextmanager
def _count_host_ffts():
    """Counts calls of the port's host SpecialFFT / SpecialIFFT
    (``core/fft.py``) and of ``numpy.fft``'s transforms while it is open."""
    import numpy as np
    from repro_torch.core import fft as fftmod
    calls = {"special_fft": 0, "special_ifft": 0, "numpy.fft": 0}
    saved = [(fftmod, n, getattr(fftmod, n))
             for n in ("special_fft", "special_ifft")]
    saved += [(np.fft, n, getattr(np.fft, n)) for n in HOST_FFTS]

    def counting(mod, name, fn):
        key = name if mod is fftmod else "numpy.fft"

        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    for mod, name, fn in saved:
        setattr(mod, name, counting(mod, name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _mirror_phase(dev, card: str, mega, staged, setups) -> dict:
    """Phase 15: the CPU mirrors' contracts on the card. (a) 16 B=1
    ``encode_encrypt_batch`` calls from nonce base 0 == one B=16 call on
    the megakernel (K5) and the staged df32 (K2) client at ``paper``, and
    the two walked from base 300 give the same words, both ending at 303;
    (b) ``decrypt_batch`` of 2-limb ciphertexts with per-row scales (K6's
    scale operand) within 1e-4; (c) a B=16 round trip makes 0 host FFT
    calls on both device pipelines, >= 1 with ``fourier='host'``; (d) a
    key of another seed < 5 bits, the right key >= 19.29; (e) the
    ``server`` sweep at level 4 within the reference's budgets, and at
    ``boot`` level 6 a raw mul_pt then rescale == the fused K8b; (f)
    ``AssertionError`` at the reference's asserts, ``KeyError`` for a
    missing rotation key, on card tensors, with no kernel launched."""
    import numpy as np
    import torch
    from repro_torch.core import encryptor
    from repro_torch.core.encoder import boot_precision_bits
    from repro_torch.fhe_client.client import FHEClient
    from repro_torch.fhe_server import (ServerCiphertext, ServerEvaluator,
                                        encode_plaintext)
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    out = {"launches": {}}

    def counted(fn):
        """fn() with every counter set to 0 just before, read just after."""
        torch.cuda.synchronize()
        ops.reset_launches()
        r = fn()
        torch.cuda.synchronize()
        used = {k: v for k, v in ops.launches().items() if v}
        for k, v in used.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        return r, used

    def needs(used: dict, want: dict, what: str) -> None:
        for k, n in want.items():
            if used.get(k, 0) < n:
                _fail(f"{what}: {k} launched {used.get(k, 0)} times, "
                      f"expected {n} ({used})")

    p = mega.ctx.params
    ns, b = p.n_slots, MAIN_BATCH

    # (a) the nonce layout, K5 and K2
    msgs = _messages(ns, b, 11)
    out["nonce_layout"] = {}
    for c, kernel in ((mega, "encode_encrypt_stream"),
                      (staged, "encrypt_limbs")):
        def rows_then_full(c=c):
            c.nonce = 0
            rows = [c.encode_encrypt_batch(msgs[i:i + 1]) for i in range(b)]
            c.nonce = 0
            return rows, c.encode_encrypt_batch(msgs)
        (rows, full), used = counted(rows_then_full)
        needs(used, {kernel: b + 1}, f"nonce layout ({c.pipeline})")
        differ = (int((torch.cat([r.c0 for r in rows]) != full.c0).sum())
                  + int((torch.cat([r.c1 for r in rows]) != full.c1).sum()))
        if differ:
            _fail(f"{c.pipeline}: 16 B=1 calls differ from one B=16 call "
                  f"in {differ} words")
        out["nonce_layout"][c.pipeline] = {"kernel": kernel,
                                           "launches": used.get(kernel, 0),
                                           "differing_words": differ}
        del rows, full
    mega.nonce = staged.nonce = MIRROR_NONCE_BASE
    walk = 0
    for k in range(MIRROR_WALK):
        one = _messages(ns, 1, 20 + k)
        bs, bm = staged.encode_encrypt_batch(one), mega.encode_encrypt_batch(
            one)
        walk += int((bs.c0 != bm.c0).sum()) + int((bs.c1 != bm.c1).sum())
    if walk or not staged.nonce == mega.nonce == MIRROR_NONCE_BASE \
            + MIRROR_WALK:
        _fail(f"walk from nonce {MIRROR_NONCE_BASE}: {walk} differing "
              f"words, nonces {staged.nonce} / {mega.nonce}")
    out["nonce_walk"] = {"from": MIRROR_NONCE_BASE, "batches": MIRROR_WALK,
                         "end": mega.nonce, "differing_words": walk}

    # (b) per-row scales through K6's scale operand
    rows4 = _messages(ns, 4, 5)
    cts = []
    for i in range(4):
        twice = i in MIRROR_SCALED_ROWS
        ct = mega.encode_encrypt_batch(rows4[i:i + 1] * (2 if twice else 1))
        cts.append(encryptor.Ciphertext(
            c0=ct.c0[0, :2], c1=ct.c1[0, :2], n_limbs=2,
            scale=ct.scale * (2 if twice else 1)))
    got, used = counted(lambda: mega.decrypt_batch(cts))
    needs(used, {"decrypt_decode_stream": 1}, "per-row scales")
    err = float(np.max(np.abs(got - rows4)))
    if not err < 1e-4:
        _fail(f"per-row scales: max error {err} >= 1e-4")
    out["per_row_scales"] = {"rows": 4, "scales": [ct.scale for ct in cts],
                             "max_err": err}
    del cts

    # (c) no host FFT on the device pipelines; (d) a wrong key
    host = FHEClient(MAIN_PROFILE, seed=SEED, fourier="host", device=dev)
    out["host_fft_calls"] = {}
    for c in (mega, staged, host):
        name = c.pipeline if c.fourier == "device" else "host"
        with _count_host_ffts() as calls:
            def round_trip(c=c):
                x = c.encode_encrypt_batch(msgs)
                return x, c.decrypt_decode_batch(x.truncated(2))
            (x, z), _ = counted(round_trip)
        bits = boot_precision_bits(msgs, z)
        n_calls = sum(calls.values())
        if not bits >= BOOT_PREC_BITS:
            _fail(f"{name} round trip {bits} bits < {BOOT_PREC_BITS}")
        if (name == "host") != (n_calls > 0):
            _fail(f"{name} round trip made {calls} host FFT calls")
        out["host_fft_calls"][name] = dict(calls)
        out["round_trip_bits"] = dict(out.get("round_trip_bits", {}),
                                      **{name: bits})
        if c is mega:
            mega_cts = x
        del x, z
    other = FHEClient(MAIN_PROFILE, seed=MIRROR_WRONG_SEED, device=dev)
    wrong = boot_precision_bits(
        msgs, other.decrypt_decode_batch(mega_cts.truncated(2)))
    right = out["round_trip_bits"]["megakernel"]
    if not (wrong < MIRROR_WRONG_BITS and right >= BOOT_PREC_BITS):
        _fail(f"wrong key: {wrong} bits (bar < {MIRROR_WRONG_BITS}), right "
              f"key {right}")
    out["wrong_key"] = {"seed": MIRROR_WRONG_SEED, "bits": wrong,
                        "right_key_bits": right}
    del host, other, mega_cts

    # (e) the server preset sweep; raw mul_pt + rescale == fused at boot
    client, keys, ev = setups["server"]
    sctx = client.ctx
    rng = np.random.default_rng(41)
    za = rng.uniform(-1, 1, sctx.params.n_slots)
    zb = rng.uniform(-1, 1, sctx.params.n_slots)

    def enc(cl, z):
        return ServerCiphertext.from_batch(cl.encode_encrypt_batch(z[None]))

    def dec(cl, ct):
        return np.asarray(cl.decrypt_batch(list(ct.to_batch())))[0]

    x = enc(client, za).drop_to(MIRROR_SWEEP_LEVEL)
    y = enc(client, zb).drop_to(MIRROR_SWEEP_LEVEL)
    sweep, used = counted(lambda: {
        "add_ct": np.max(np.abs(dec(client, ev.add_ct(x, y)) - (za + zb))),
        "mul_ct": np.max(np.abs(dec(client, ev.mul_ct(x, y)) - za * zb)),
        "rotate": np.max(np.abs(dec(client, ev.rotate(x, 1))
                                - np.roll(za, -1)))})
    needs(used, {"add_ct": 1, "mul_ct": 1, "rotate": 1}, "server sweep")
    for op, e in sweep.items():
        if not e < MIRROR_SWEEP_BUDGET[op]:
            _fail(f"server sweep: {op} error {e} >= "
                  f"{MIRROR_SWEEP_BUDGET[op]}")
    out["server_sweep"] = {"level": MIRROR_SWEEP_LEVEL,
                           "err": {k: float(v) for k, v in sweep.items()},
                           "budget": MIRROR_SWEEP_BUDGET}
    bclient, _, bev = setups["boot"]
    bctx = bclient.ctx
    brng = np.random.default_rng(10)
    bx = enc(bclient, brng.standard_normal(bctx.params.n_slots) * 0.5
             ).drop_to(MIRROR_BOOT_LEVEL)
    pt = encode_plaintext(
        (brng.standard_normal(bctx.params.n_slots) * 0.5).astype(
            np.complex128), bctx, MIRROR_BOOT_LEVEL,
        float(bctx.q_list[MIRROR_BOOT_LEVEL - 1]), device=dev)
    (fused, stepped), used = counted(lambda: (
        bev.mul_pt(bx, pt), bev.rescale(bev.mul_pt(bx, pt, rescale=False))))
    needs(used, {"mul_pt_rescale": 1, "mul_pt": 1, "rescale": 1},
          "raw mul_pt + rescale")
    if not (torch.equal(fused.c0, stepped.c0)
            and torch.equal(fused.c1, stepped.c1)
            and fused.scale == stepped.scale
            and fused.level == stepped.level):
        _fail("boot: raw mul_pt then rescale differs from the fused K8b")
    out["raw_then_rescale"] = {"profile": "boot", "level": MIRROR_BOOT_LEVEL,
                               "words_equal": True, "scale": fused.scale}

    # (f) the reference's guards, on card tensors
    x8 = enc(client, za)
    norelin = ServerEvaluator(sctx, client.make_evaluation_keys(
        rotations=(), include_relin=False))
    guards = {
        "rescale_at_level_2": (AssertionError,
                               lambda: ev.rescale(x8.drop_to(2))),
        "drop_to_1": (AssertionError, lambda: x8.drop_to(1)),
        "add_ct_scale_mismatch": (AssertionError, lambda: ev.add_ct(
            x8, ServerCiphertext(x8.c0, x8.c1, x8.level, 2 * x8.scale))),
        "mul_ct_without_relin_key": (AssertionError,
                                     lambda: norelin.mul_ct(x8, x8)),
        "rotate_missing_key": (KeyError, lambda: ev.rotate(x8, 3)),
    }
    raised = {}

    def run_guards():
        for name, (want, fn) in guards.items():
            with _Raised() as r:
                fn()
            raised[name] = r.type
            if r.type is not want:
                _fail(f"guard {name}: raised {r.type}, expected {want}")
    _, used = counted(run_guards)
    if used:
        _fail(f"the guards launched kernels: {used}")
    out["guards"] = {k: v.__name__ for k, v in raised.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    fft = {k: sum(v.values()) for k, v in out["host_fft_calls"].items()}
    print(f"mirrors on the card: nonce layout 16 x B=1 == B=16 (K5 "
          f"{out['nonce_layout']['megakernel']['launches']}, K2 "
          f"{out['nonce_layout']['staged']['launches']} launches, 0 "
          f"differing words), walk {MIRROR_NONCE_BASE} -> "
          f"{out['nonce_walk']['end']}; "
          f"per-row scales max err {err:.3g}; host FFT calls megakernel "
          f"{fft['megakernel']}, staged {fft['staged']}, host "
          f"{fft['host']}; wrong key {wrong:.2f} bits (right {right:.2f}); "
          f"server l{MIRROR_SWEEP_LEVEL} add_ct {sweep['add_ct']:.3g} "
          f"mul_ct {sweep['mul_ct']:.3g} rotate {sweep['rotate']:.3g}; boot "
          f"l{MIRROR_BOOT_LEVEL} raw mul_pt + rescale == fused; guards "
          f"{out['guards']}; phase {out['phase_s']:.1f} s  [{card}]",
          flush=True)
    return out


# --- phase 16: the analytic models against the card ----------------------------
# The paper's models that the port's ``core`` carries (the memory terms of
# §IV-B / Fig. 6b, the Fig. 3c quantized FFT, the df pair's mantissa) beside
# what the port keeps and writes on the card, and the kernel modules' routed
# entries under the reference's names: (a) the memory terms against K5's and
# K6's device tables, (b) what one K5 call allocates, (c) the precision model
# against K4's df32 round trip, (d) each routed entry launches its kernel
# once and gives its plain version's words.

ANALYTIC_SEED_SHARE = 5e-3               # (a) seed table / twiddle tables
ANALYTIC_PEAK_TOL = 1 << 20              # (b) bytes, peak vs the shapes
ANALYTIC_SWEEP_N = 1 << 12               # (c) bench_precision.py's sweep
ANALYTIC_SWEEP_MBITS = (30, 35, 40, 43, 45, 48, 52)
ANALYTIC_MBITS_BAR = 43                  # (c) rows from here: >= 19.29 bits
ANALYTIC_SWEEP_SEED, ANALYTIC_K4_SEED = 7, 3
ENTRY_CLIENT = ("test", 2)               # (d) profile, batch
ENTRY_SERVER = ("server", 4, 1)          # (d) profile, level, batch
ENTRY_COUNTERS = {
    "encode_encrypt_stream": "encode_encrypt_stream",
    "decrypt_decode_stream": "decrypt_decode_stream",
    "encrypt_limbs": "encrypt_limbs", "decrypt_limbs": "decrypt_limbs",
    "ntt_limb_rows": "ntt_limbs", "intt_limb_rows": "intt_limbs",
    "add_ct": "add_ct", "add_pt": "add_pt", "mul_pt": "mul_pt",
    "rescale": "rescale", "mul_pt_rescale": "mul_pt_rescale",
    "mul_ct_relin": "mul_ct", "rotate": "rotate",
    "ks_decompose": "ks_decompose", "ks_apply_rot": "ks_apply_rot"}


def _quantized_round_trip_bits(n: int, mbits: int) -> float:
    """bench_precision.py's round trip: SpecialIFFT then SpecialFFT of n
    seeded slots with every operation rounded to `mbits` mantissa bits."""
    import numpy as np
    from repro_torch.core import fft as fftmod
    from repro_torch.core.encoder import boot_precision_bits
    rng = np.random.default_rng(ANALYTIC_SWEEP_SEED)
    z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    w = fftmod.special_fft_quantized(z, 4 * n, mbits, inverse=True)
    return boot_precision_bits(
        z, fftmod.special_fft_quantized(w, 4 * n, mbits))


def _differing_words(got, want) -> int:
    import torch
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    n = 0
    for g, w in zip(got, want, strict=True):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        n += int((g != w).sum())
    return n


def _entry_calls(dev) -> dict:
    """(d): {entry: (routed call with the reference's positional arguments,
    plain call on the same tensors)}; the client entries at ``test`` B=2,
    the server ones at ``server`` level 4 B=1 on random words."""
    import torch
    from repro_torch.fhe_client.client import FHEClient
    from repro_torch.kernels import client_pointwise as cp
    from repro_torch.kernels import client_stream as cs
    from repro_torch.kernels import ntt_butterfly as nb
    from repro_torch.kernels import server_eval as se
    profile, b = ENTRY_CLIENT
    c = FHEClient(profile, seed=SEED, device=dev)
    ctx, p = c.ctx, c.ctx.params
    pkb, pka, s = c.keys.pk.b_mont, c.keys.pk.a_mont, c.keys.sk.s_mont
    planes = c.encrypt_operands(_messages(p.n_slots, b, 31))
    c0, c1 = cs.encode_encrypt_stream_plain(planes, pkb, pka, ctx, c.seed, 5)
    scale = torch.full((b,), p.delta, dtype=torch.float32, device=dev)
    pt = _rand_words(ctx, (p.n_limbs, b, p.n), 32, dev).transpose(0, 1)
    x = _rand_words(ctx, (p.n_limbs, b, p.n), 33, dev)
    plans = ctx.plans[:p.n_limbs]
    calls = {
        "encode_encrypt_stream": (
            lambda: cs.encode_encrypt_stream(planes, pkb, pka, ctx, c.seed,
                                             5, "df32"),
            lambda: cs.encode_encrypt_stream_plain(planes, pkb, pka, ctx,
                                                   c.seed, 5, "df32")),
        "decrypt_decode_stream": (
            lambda: cs.decrypt_decode_stream(c0[:, :2], c1[:, :2], s, ctx,
                                             scale, "df32"),
            lambda: cs.decrypt_decode_stream_plain(c0[:, :2], c1[:, :2], s,
                                                   ctx, scale, "df32")),
        "encrypt_limbs": (
            lambda: cp.encrypt_limbs(pt, pkb, pka, ctx, c.seed),
            lambda: cp.encrypt_limbs_plain(pt.contiguous(), pkb, pka, ctx,
                                           c.seed, 0)),
        "decrypt_limbs": (lambda: cp.decrypt_limbs(c0, c1, s, ctx),
                          lambda: cp.decrypt_limbs_plain(c0, c1, s, ctx)),
        "ntt_limb_rows": (lambda: nb.ntt_limb_rows(x, plans),
                          lambda: nb.limb_rows_plain(x, plans, False)),
        "intt_limb_rows": (lambda: nb.intt_limb_rows(x, plans),
                           lambda: nb.limb_rows_plain(x, plans, True)),
    }
    sprof, level, sb = ENTRY_SERVER
    sctx, o = _random_server_operands(sprof, level, sb, 34, dev)
    a0, a1, b0, b1, kb, ka, rb, ra, perm, h = (o[k] for k in (
        "a0", "a1", "b0", "b1", "kb", "ka", "rb", "ra", "perm", "h"))
    calls.update({
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
        "rotate": (lambda: se.rotate(a0, a1, perm, rb, ra, sctx),
                   lambda: se.rotate_plain(a0, a1, perm, rb, ra, sctx,
                                           "f64")),
        "ks_decompose": (lambda: se.ks_decompose(a1, sctx),
                         lambda: se.ks_decompose_plain(a1, sctx)),
        "ks_apply_rot": (
            lambda: se.ks_apply_rot(a0, h, perm, rb, ra, sctx),
            lambda: se.ks_apply_rot_plain(a0, h, perm, rb, ra, sctx,
                                          "f64")),
    })
    return calls


def _analytic_phase(dev, card: str, mega) -> dict:
    """Phase 16: the analytic models against the card, at ``paper`` (the
    client ``mega``'s context): (a) the four ``CKKSContext`` memory terms
    and the bytes of K5's and K6's device tables, the NTT seed table ==
    its host table and < 0.5 % of ``twiddle_table_bytes()``; (b) the peak
    allocation of one K5 call at B=16 after a warm-up == its outputs and
    five scratch tensors reckoned from the shapes, within 1 MiB (its
    requested bytes exactly), one launch; NTT(v)'s scratch beside 16 masks
    of ``mask_error_bytes()``;
    (c) ``special_fft_quantized`` round trips (bench_precision.py's sweep
    at n = 2^12; 43 and the df32 pair's 49 bits at n_slots = 2^15) beside
    K4's df32 round trip at n_slots = 2^15 (two launches), every row at 43
    bits or more >= 19.29 bits; (d) each of the 15 routed entries on card
    tensors: one launch of its kernel, 0 words differing from its plain
    version."""
    import numpy as np
    import torch
    from repro_torch.core import dfloat as dfl
    from repro_torch.core.encoder import boot_precision_bits
    from repro_torch.kernels import client_stream, ops

    t_phase = time.perf_counter()
    ctx, p = mega.ctx, mega.ctx.params
    L, n, ns = p.n_limbs, p.n, p.n_slots
    out = {"profile": MAIN_PROFILE, "card": card}

    # (a) the memory terms against the device tables
    terms = {t: getattr(ctx, t)() for t in (
        "twiddle_table_bytes", "twiddle_seed_bytes", "key_material_bytes",
        "mask_error_bytes")}
    parts = ("fft_twiddles", "bitrev", "seed_table", "digit_consts")
    k5 = client_stream.device_tables(ctx, L, True, dev)
    k6 = client_stream.device_tables(ctx, 2, False, dev)
    tables = {name: {part: t.nbytes for part, t in zip(parts, ts)}
              for name, ts in (("K5", k5), ("K6", k6))}
    for t in tables.values():
        t["total"] = sum(t.values())
    host_seed = client_stream.stream_consts(ctx, L, True)[0].table.nbytes
    share = tables["K5"]["seed_table"] / terms["twiddle_table_bytes"]
    if tables["K5"]["seed_table"] != host_seed:
        _fail(f"K5's seed table holds {tables['K5']['seed_table']} B on "
              f"the card, {host_seed} B on the host")
    if not share < ANALYTIC_SEED_SHARE:
        _fail(f"seed table / twiddle tables {share} >= {ANALYTIC_SEED_SHARE}")
    out["memory_terms"] = terms
    out["device_tables"] = tables
    out["seed_share"] = share

    # (b) what one K5 call allocates, after a warm-up
    planes = mega.encrypt_operands(_messages(ns, MAIN_BATCH, 41))
    pkb, pka = mega.keys.pk.b_mont, mega.keys.pk.a_mont

    def k5_call():
        return client_stream.encode_encrypt_stream(planes, pkb, pka, ctx,
                                                   mega.seed, 0, "df32")
    # In a private pool: its segments hold nothing but this call's blocks,
    # so each block is the size it asked for (a free block of the shared
    # pool, left split by earlier phases, can hand a request up to 1 MiB
    # more). The warm-up lays the segments out; the call takes its blocks
    # back at their sizes.
    pool = torch.cuda.MemPool()
    with torch.cuda.use_mem_pool(pool):
        k5_call()                              # warm-up, outputs dropped
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        requested = torch.cuda.memory_stats(dev)[
            "requested_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        c0, c1 = k5_call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        requested = torch.cuda.memory_stats(dev)[   # the requests' own
            "requested_bytes.all.peak"] - requested  # bytes, unrounded
        k5_used = {k: v for k, v in ops.launches().items() if v}
        del c0, c1
    del pool
    torch.cuda.empty_cache()
    b = MAIN_BATCH
    shapes = {"c0_c1": 2 * b * L * n * 4, "ntt_twiddle_heaps": L * n * 4,
              "noise_int8": b * 3 * n, "fft_points": b * 4 * ns * 4,
              "digits": b * 3 * n * 4, "ntt_v": b * L * n * 4}
    want = sum(shapes.values())
    if k5_used != {"encode_encrypt_stream": 1}:
        _fail(f"one K5 call launched {k5_used}")
    if not abs(peak - want) <= ANALYTIC_PEAK_TOL:
        _fail(f"one K5 call allocated {peak} B at its peak, the shapes "
              f"{want} B ({shapes})")
    if requested != want:
        _fail(f"one K5 call requested {requested} B at its peak, the "
              f"shapes {want} B ({shapes})")
    masks = b * terms["mask_error_bytes"]
    out["k5_call"] = {"batch": b, "peak_bytes": peak,
                      "peak_requested_bytes": requested,
                      "shapes_bytes": want, "by_tensor": shapes,
                      "launches": k5_used,
                      "masks_if_fetched_bytes": masks,
                      "ntt_v_over_masks": shapes["ntt_v"] / masks}
    del planes

    # (c) precision: the quantized model beside K4's df32 round trip
    sweep = {mb: _quantized_round_trip_bits(ANALYTIC_SWEEP_N, mb)
             for mb in ANALYTIC_SWEEP_MBITS}
    df_bits = dfl.effective_mantissa_bits(torch.float32)
    at_ns = {mb: _quantized_round_trip_bits(ns, mb)
             for mb in (ANALYTIC_MBITS_BAR, df_bits)}
    rng = np.random.default_rng(ANALYTIC_K4_SEED)
    z = rng.standard_normal((1, ns)) + 1j * rng.standard_normal((1, ns))
    torch.cuda.synchronize()
    ops.reset_launches()
    back = ops.special_fft(ops.special_ifft(z, 4 * ns, dev), 4 * ns, dev)
    torch.cuda.synchronize()
    k4_used = {k: v for k, v in ops.launches().items() if v}
    k4_bits = boot_precision_bits(z, back)
    if k4_used != {"special_fft": 1, "special_ifft": 1}:
        _fail(f"K4's round trip launched {k4_used}")
    rows = [(f"n=2^{ANALYTIC_SWEEP_N.bit_length() - 1} {mb}b", mb, bits)
            for mb, bits in sweep.items()]
    rows += [(f"n=2^{ns.bit_length() - 1} {mb}b", mb, bits)
             for mb, bits in at_ns.items()]
    rows.append((f"K4 df32 n=2^{ns.bit_length() - 1}", df_bits, k4_bits))
    for what, mb, bits in rows:
        if mb >= ANALYTIC_MBITS_BAR and not bits >= BOOT_PREC_BITS:
            _fail(f"precision {what}: {bits} bits < {BOOT_PREC_BITS}")
    out["precision"] = {"sweep_n": ANALYTIC_SWEEP_N, "sweep_bits": sweep,
                        "n_slots": ns, "model_bits_at_n_slots": at_ns,
                        "effective_mantissa_bits": df_bits,
                        "k4_df32_bits": k4_bits, "k4_launches": k4_used}

    # (d) the routed entries on card tensors
    entries = {}
    for name, (entry, plain) in _entry_calls(dev).items():
        torch.cuda.synchronize()
        ops.reset_launches()
        got = entry()
        torch.cuda.synchronize()
        used = {k: v for k, v in ops.launches().items() if v}
        differ = _differing_words(got, plain())
        if used != {ENTRY_COUNTERS[name]: 1} or differ:
            _fail(f"routed entry {name}: launched {used}, {differ} words "
                  f"differ from its plain version")
        entries[name] = {"kernel": ENTRY_COUNTERS[name],
                         "launches": used.get(ENTRY_COUNTERS[name], 0),
                         "differing_words": differ}
    out["entries"] = entries
    out["phase_s"] = time.perf_counter() - t_phase
    t5 = tables["K5"]
    print(f"analytic models at {MAIN_PROFILE}: twiddle tables "
          f"{terms['twiddle_table_bytes']} B, seeds "
          f"{terms['twiddle_seed_bytes']} B, key material "
          f"{terms['key_material_bytes']} B, mask + errors "
          f"{terms['mask_error_bytes']} B a ciphertext; on the card K5 "
          f"tables {t5['total']} B (FFT twiddles {t5['fft_twiddles']}, bit "
          f"reversal {t5['bitrev']}, seed table {t5['seed_table']}, digit "
          f"consts {t5['digit_consts']}), K6 {tables['K6']['total']} B; "
          f"seed table / twiddle tables {share:.3e}  [{card}]", flush=True)
    print(f"K5 call at {MAIN_PROFILE} B={b}: peak {peak} B allocated "
          f"({requested} B requested), the shapes {want} B (outputs "
          f"{shapes['c0_c1']}, scratch {want - shapes['c0_c1']}), launches "
          f"{k5_used}; NTT(v) scratch "
          f"{shapes['ntt_v']} B beside {b} masks fetched "
          f"{masks} B ({shapes['ntt_v'] / masks:.4f})  [{card}]", flush=True)
    print("precision (Fig. 3c): " + ", ".join(
        f"{what} {bits:.2f}" for what, _, bits in rows)
        + f" bits; K4 launches {k4_used}  [{card}]", flush=True)
    print(f"routed entries on the card: {len(entries)} entries, each one "
          f"launch, 0 differing words; phase {out['phase_s']:.1f} s  "
          f"[{card}]", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              flush=True)
        return 2
    from repro_torch.core.encoder import boot_precision_bits
    from repro_torch.fhe_client.client import FHEClient
    from repro_torch.kernels import (build, client_pointwise,
                                     client_stream, fft_df, ntt_butterfly,
                                     ops)

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
            # per kernel: its (mangled) name, then its spills and registers
            if ("Function properties" in line or "registers" in line
                    or "spill" in line):
                print(f"  ptxas {src}: {line.strip()}", flush=True)

    dev = torch.device(DEVICE, 0)
    clients = {}

    def client_for(profile, pipeline="megakernel"):
        if (profile, pipeline) not in clients:
            clients[profile, pipeline] = FHEClient(
                profile, seed=SEED, device=dev, pipeline=pipeline)
        return clients[profile, pipeline]

    # --- 3. kernel vs plain, on the card ------------------------------------
    errs = {"encode_encrypt_stream": 0.0, "decrypt_decode_stream": 0.0}
    errs.update({name: 0.0 for name in STAGED})
    for profile, batch in CHECKS:
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
        staged = _staged_chain(client_for(profile, "staged"),
                               _messages(p.n_slots, batch, batch), 123,
                               errs)
        if not (torch.equal(staged["c0"], k0)
                and torch.equal(staged["c1"], k1)):
            _fail(f"staged and megakernel ciphertexts differ at {profile} "
                  f"B={batch}")
        print(f"kernel == plain (bit-identical), K5 K6 K1 K2 K3 K4: "
              f"{profile} B={batch}", flush=True)
    mega_errs = {}
    _check_megakernels(dev, mega_errs)
    _check_staged_shapes(dev, errs)

    # --- 4. the main paths at paper, B=16 ---------------------------------
    import numpy as np
    runs = {}
    for pipeline, needed in (
            ("megakernel", ("encode_encrypt_stream",
                            "decrypt_decode_stream")),
            ("staged", ("ntt_limbs", "encrypt_limbs", "decrypt_limbs",
                        "special_fft", "special_ifft"))):
        c = client_for(MAIN_PROFILE, pipeline)
        p = c.ctx.params
        msgs = _messages(p.n_slots, MAIN_BATCH, 1)
        c.nonce = 1000
        ops.reset_launches()
        t0 = time.perf_counter()
        cts = c.encode_encrypt_batch(msgs)
        out = c.decrypt_decode_batch(cts.truncated(2))
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = ops.launches()
        if any(launches[k] == 0 for k in needed):
            _fail(f"a kernel of the {pipeline} path never launched: "
                  f"{launches}")
        if out.shape != msgs.shape or not np.all(np.isfinite(out)):
            _fail(f"decoded output has shape {out.shape} or non-finite "
                  f"values")
        if tuple(cts.c0.shape) != (MAIN_BATCH, p.n_limbs, p.n):
            _fail(f"ciphertext shape {tuple(cts.c0.shape)}")
        bits = boot_precision_bits(msgs, out)
        used = {k: v for k, v in launches.items() if v}
        print(f"main path ({pipeline}): {MAIN_PROFILE} B={MAIN_BATCH} round "
              f"trip {bits:.2f} bits (bar {BOOT_PREC_BITS}), "
              f"{e2e_s * 1e3:.1f} ms host clock incl. transfers, launches "
              f"{used}", flush=True)
        if not bits >= BOOT_PREC_BITS:
            _fail(f"round-trip precision {bits} < {BOOT_PREC_BITS}")
        runs[pipeline] = (c, msgs, cts, out, launches)
    (mc, msgs, mcts, mout, mega_launches) = runs["megakernel"]
    (sc, _, scts, sout, staged_launches) = runs["staged"]
    if not (torch.equal(scts.c0, mcts.c0) and torch.equal(scts.c1, mcts.c1)):
        _fail("staged c0/c1 differ from the megakernel client's for the "
              "same seed and nonce base")
    print(f"staged == megakernel ciphertexts (word for word); decoded "
          f"planes max abs diff {float(np.max(np.abs(sout - mout)))}",
          flush=True)

    _profile_main_path(mc, msgs)
    _profile_main_path(sc, msgs)

    # --- 6. the server op set: kernel vs plain, on the card ---------------
    setups = {profile: _server_setup(profile, dev)
              for profile in ("server", "boot")}
    _check_server_kernels(setups, errs, dev)

    # --- 7. the encrypted-inference flows (main path of the server slice) -
    flow_launches = {}
    for profile in FLOW_PROFILES:
        flow_launches[profile], out = _server_flow(profile, dev)
        if profile == "server":
            server_out = out        # phase 9 evaluates it again, f64
        del out
    server_times = _time_server_kernels(setups, card)

    # --- 8. the Fourier engine's per-prime entry points (K12-K14) ---------
    engine_launches, engine_errs, engine_times = _engine_phase(
        client_for(MAIN_PROFILE, "staged"), card)

    # --- 9. the f64 datapath: K5 / K6 f64 branches, the f64 server ----------
    f64_launches, f64_errs, f64_times = _f64_client_phase(
        dev, client_for(MAIN_PROFILE), card)
    for name, e in mega_errs.items():
        into = f64_errs if name.endswith("_f64") else errs
        into[name] = max(into[name], e)
    _f64_server_phase(server_out, dev)

    # --- 10. the client service: K5 / K6 on two CUDA streams ---------------
    service = _service_phase(dev, card)
    print(json.dumps({"service": service}), flush=True)

    # --- 11. the service mesh: K5 / K6 in two worker processes -------------
    print(json.dumps({"mesh": _mesh_phase(dev, card)}), flush=True)

    # --- 12. the LM substrate: the private-inference loop (K5 / K6) --------
    lm = _lm_phase(dev, card)
    print(json.dumps({"lm": lm}), flush=True)
    lm_launches = lm["private_inference"]["launches"]

    # --- 13. the LM substrate's training path (no port kernel) ---------------
    train = _train_phase(dev, card)
    print(json.dumps({"train": train}), flush=True)

    # --- 14. the quickstart on the card (K2, K3, K5, K6), the dry-run -------
    launch = _launch_phase(dev, card, train["big"])
    print(json.dumps({"launch": launch}), flush=True)
    qs_launches = launch["quickstart"]["launches"]

    # --- 15. the reference tests' contracts on the card ---------------------
    print(json.dumps({"mirrors": _mirror_phase(
        dev, card, client_for(MAIN_PROFILE),
        client_for(MAIN_PROFILE, "staged"), setups)}), flush=True)

    # --- 16. the analytic models against the card ---------------------------
    print(json.dumps({"analytic": _analytic_phase(
        dev, card, client_for(MAIN_PROFILE))}), flush=True)

    # --- 5. times -------------------------------------------------------------
    p = mc.ctx.params
    ctx = mc.ctx
    plans = ctx.plans[:p.n_limbs]
    pkb, pka = mc.keys.pk.b_mont, mc.keys.pk.a_mont
    s_mont = mc.keys.sk.s_mont
    times, bounds, dkernels = {}, {}, {}
    for batch in (1, MAIN_BATCH):
        planes = mc.encrypt_operands(_messages(p.n_slots, batch, 2))
        k0, k1 = client_stream.encode_encrypt_stream_cuda(
            planes, pkb, pka, ctx, mc.seed, 0)
        scale = torch.full((batch,), p.delta, dtype=torch.float32,
                           device=dev)
        x = _staged_chain(sc, _messages(p.n_slots, batch, 2), 0)
        calls = {
            "encode_encrypt_stream": (
                lambda: client_stream.encode_encrypt_stream_cuda(
                    planes, pkb, pka, ctx, mc.seed, 0),
                lambda: client_stream.encode_encrypt_stream_plain(
                    planes, pkb, pka, ctx, mc.seed, 0),
                (_bytes_encode_encrypt(p, batch),
                 *_ops_encode_encrypt(p, batch))),
            "decrypt_decode_stream": (
                lambda: client_stream.decrypt_decode_stream_cuda(
                    k0[:, :2], k1[:, :2], s_mont, ctx, scale),
                lambda: client_stream.decrypt_decode_stream_plain(
                    k0[:, :2], k1[:, :2], s_mont, ctx, scale),
                (_bytes_decrypt_decode(p, batch),
                 *_ops_decrypt_decode(p, batch))),
        }
        for name, inverse, key in (("ntt_limbs", False, "residues"),
                                   ("intt_limbs", True, "pt_ntt")):
            calls[name] = (
                lambda i=inverse, k=key: ntt_butterfly.limb_rows_cuda(
                    x[k], plans, i),
                lambda i=inverse, k=key: ntt_butterfly.limb_rows_plain(
                    x[k], plans, i),
                _cost_ntt_limbs(p, batch, inverse))
        calls["encrypt_limbs"] = (
            lambda: client_pointwise.encrypt_limbs_cuda(
                x["pt"], pkb, pka, ctx, mc.seed, 0),
            lambda: client_pointwise.encrypt_limbs_plain(
                x["pt"], pkb, pka, ctx, mc.seed, 0),
            _cost_encrypt_limbs(p, batch))
        calls["decrypt_limbs"] = (
            lambda: client_pointwise.decrypt_limbs_cuda(
                x["c0"][:, :2], x["c1"][:, :2], s_mont, ctx),
            lambda: client_pointwise.decrypt_limbs_plain(
                x["c0"][:, :2], x["c1"][:, :2], s_mont, ctx),
            _cost_decrypt_limbs(p, batch))
        for name, inverse, key in (("special_fft", False, "dec_planes"),
                                   ("special_ifft", True, "enc_planes")):
            calls[name] = (
                lambda i=inverse, k=key: fft_df.special_fft_cuda(x[k], p.m,
                                                                 i),
                lambda i=inverse, k=key: fft_df.special_fft_plain(x[k], p.m,
                                                                  i),
                _cost_fft_rows(p, batch, inverse))
        for name, (kernel, plain_fn, cost) in calls.items():
            times[name, batch] = _device_ms(kernel, iters=5)
            bounds[name, batch] = _bound_ms(*cost)
            if batch == MAIN_BATCH:
                times[name + "_plain", batch] = _cuda_ms(plain_fn, iters=1,
                                                         warmup=1)
        for name in ("encode_encrypt_stream", "decrypt_decode_stream",
                     "ntt_limbs", "intt_limbs", "encrypt_limbs",
                     "decrypt_limbs", "special_fft", "special_ifft"):
            dkernels[name, batch] = _device_kernels(calls[name][0])
            _print_device_kernels(name, f"{MAIN_PROFILE} B={batch}",
                                  dkernels[name, batch], card)
    # K1 at the shape of the encrypted flow's plaintext encoder, where most
    # of its launches run: (6, 1, 2^16) at boot, both directions
    from repro_torch.core.context import get_context
    fctx = get_context(FLOW_K1_PROFILE)
    fp = fctx.params
    L, rows = FLOW_K1_STACK
    xf = _rand_words(fctx, (L, rows, fp.n), 90, dev)
    flow_k1 = {}
    for name, inverse in (("ntt_limbs", False), ("intt_limbs", True)):
        fn = lambda i=inverse: ntt_butterfly.limb_rows_cuda(  # noqa: E731
            xf, fctx.plans[:L], i)
        ms = _device_ms(fn, iters=5)
        plain_ms = _cuda_ms(lambda i=inverse: ntt_butterfly.limb_rows_plain(
            xf, fctx.plans[:L], i), iters=1, warmup=1)
        bound = _bound_ms(*_cost_ntt_limbs(fp, rows, inverse, L))
        by_name = _device_kernels(fn)
        flow_k1[name] = {"shape": f"{FLOW_K1_PROFILE} ({L}, {rows}, {fp.n})",
                         "launches_in_flow":
                             flow_launches[FLOW_K1_PROFILE][name],
                         "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound[0], "bound_by": bound[1],
                         **_device_kernel_fields(by_name)}
        print(f"time: {name} {FLOW_K1_PROFILE} ({L}, {rows}, {fp.n}) (the "
              f"flow's encoder): {ms:.4f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound[0]:.4f} ms ({bound[1]})  [{card}]", flush=True)
        _print_device_kernels(name, f"{FLOW_K1_PROFILE} ({L}, {rows}, "
                              f"{fp.n})", by_name, card)
    for (what, batch), ms in sorted(times.items(), key=str):
        b = bounds.get((what, batch))
        bound = f", bound {b[0]:.4f} ms ({b[1]})" if b else ""
        print(f"time: {what} {MAIN_PROFILE} B={batch}: {ms:.3f} ms{bound}  "
              f"[{card}]", flush=True)

    # --- 6. result lines ------------------------------------------------------
    def entry(name, id_, source, replaces, launches):
        b = bounds[name, MAIN_BATCH]
        return {"name": name, "id": id_, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": f"src/repro/kernels/{replaces}",
                "matched_plain": True, "launches": launches,
                "max_abs_err": errs[name], "ms": times[name, MAIN_BATCH],
                "plain_ms": times[name + "_plain", MAIN_BATCH],
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None}

    def at_batch_1(e: dict) -> None:
        e["at_batch_1"] = {"ms": times[e["name"], 1],
                           "bound_ms": bounds[e["name"], 1][0],
                           "bound_by": bounds[e["name"], 1][1]}

    kernels = [
        entry("encode_encrypt_stream", "K5", "encode_encrypt.cu",
              "client_stream.py:96", mega_launches["encode_encrypt_stream"]
              + service["encode_encrypt_stream"]
              + lm_launches["encode_encrypt_stream"]
              + qs_launches.get("encode_encrypt_stream", 0)),
        entry("decrypt_decode_stream", "K6", "decrypt_decode.cu",
              "client_stream.py:200", mega_launches["decrypt_decode_stream"]
              + service["decrypt_decode_stream"]
              + lm_launches["decrypt_decode_stream"]
              + qs_launches.get("decrypt_decode_stream", 0)),
    ]
    for k in kernels:
        k.update(_device_kernel_fields(dkernels[k["name"], MAIN_BATCH]))
        k["launches_by_path"] = {"megakernel": mega_launches[k["name"]],
                                 "service": service[k["name"]],
                                 "private_inference": lm_launches[k["name"]],
                                 "quickstart": qs_launches.get(k["name"], 0)}
        at_batch_1(k)
    for fwd, inv in (("ntt_limbs", "intt_limbs"),
                     ("encrypt_limbs", None), ("decrypt_limbs", None),
                     ("special_fft", "special_ifft")):
        id_, source, replaces = STAGED[fwd]
        qs = qs_launches.get(fwd, 0) + (qs_launches.get(inv, 0) if inv
                                        else 0)
        k = entry(fwd, id_, source, replaces, staged_launches[fwd]
                  + (staged_launches[inv] if inv else 0) + qs)
        k["launches_by_path"] = {"staged": k["launches"] - qs,
                                 "quickstart": qs}
        if inv:
            # the top-level numbers are the forward direction's
            k["launches_by_direction"] = {fwd: staged_launches[fwd]
                                          + qs_launches.get(fwd, 0),
                                          inv: staged_launches[inv]
                                          + qs_launches.get(inv, 0)}
            k["inverse"] = entry(inv, *STAGED[inv], staged_launches[inv])
            del k["inverse"]["launches"]
        for e in (k, k.get("inverse")):
            if e is None:
                continue
            at_batch_1(e)
            if (e["name"], MAIN_BATCH) in dkernels:
                e.update(_device_kernel_fields(
                    dkernels[e["name"], MAIN_BATCH]))
            if e["name"] in flow_k1:
                e["at_flow_shape"] = flow_k1[e["name"]]
        kernels.append(k)
    for name, (id_, replaces) in SERVER.items():
        ms, plain_ms, bound, by_name = server_times[name, 6]
        ms24, plain24, bound24, by_name24 = server_times[name, 24]
        extra = {}
        if name in SERVER_TILED:
            extra = _device_kernel_fields(by_name)
        kernels.append({
            "name": name, "id": id_, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/server_eval.cu",
            "replaces": f"src/repro/kernels/{replaces}",
            "matched_plain": True,
            "launches": flow_launches["boot"][name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "shape": "boot level 6 B=1",
            "at_level_24": {"ms": ms24, "plain_ms": plain24,
                            "bound_ms": bound24[0], "bound_by": bound24[1],
                            **(_device_kernel_fields(by_name24)
                               if extra else {})},
            **extra,
        })
    for fwd, inv in (("ntt_rows", "intt_rows"), ("encrypt_limb", None),
                     ("decrypt_limb", None), ("ntt_rows_mm", "intt_rows_mm")):
        entries = []
        for name in (fwd, inv) if inv else (fwd,):
            id_, source, replaces = ENGINES[name]
            ms, plain_ms, bound, extra = engine_times[name]
            entries.append({
                "name": name, "id": id_, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": f"src/repro/kernels/{replaces}",
                "matched_plain": True, "launches": engine_launches[name],
                "max_abs_err": engine_errs[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None,
                "shape": (f"{MAIN_PROFILE} (L, B, N) stack, B={MAIN_BATCH}, "
                          f"one launch" if name.endswith("_mm")
                          else f"{MAIN_PROFILE} one limb B={MAIN_BATCH}, "
                          f"one launch"), **extra})
        k = entries[0]
        if inv:
            # the top-level numbers are the forward direction's
            k["launches"] += entries[1]["launches"]
            k["launches_by_direction"] = {fwd: engine_launches[fwd],
                                          inv: engine_launches[inv]}
            k["inverse"] = entries[1]
            del k["inverse"]["launches"]
        kernels.append(k)
    for name, (id_, source, replaces) in F64_KERNELS.items():
        ms, plain_ms, bound, by_name = f64_times[name, MAIN_BATCH]
        ms1, _, bound1, _ = f64_times[name, 1]
        kernels.append({
            "name": name, "id": id_, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "matched_plain": True, "launches": f64_launches[name],
            "max_abs_err": f64_errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "shape": f"{MAIN_PROFILE} B={MAIN_BATCH}",
            "at_batch_1": {"ms": ms1, "bound_ms": bound1[0],
                           "bound_by": bound1[1]},
            **_device_kernel_fields(by_name),
        })
    print("library_ms: none; no single PyTorch call computes a negacyclic "
          "NTT, a Philox RLWE encrypt, the rotation-group-ordered df32 "
          "SpecialFFT, an RNS rescale or a key switch", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
