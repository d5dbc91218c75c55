"""Where K14's time goes: time copies of ``ntt_matmul.cu``, each with one
phase taken out, on the same ``paper`` stack, in one process on one card.

    python3 tools/k14_phases.py [--rows 16] [--reps 5]

Builds this checkout's ``ntt_matmul.cu`` and copies of it with one phase
removed (the words of the copies are wrong: only their time is read) into
``build/k14_phases/`` with nvcc under the flags of
``repro_torch.kernels.build``, all at once, and prints ptxas' register
count of each. Then, for each direction on an (24, rows, 2^16) stack of
random residues, it checks that the unchanged build gives the plain
version's words on the first row of every limb, and times every build with
``chip_smoke.py``'s queued-ahead timer (calls behind a spin), each stage's
device kernel (``mm_stage1_kernel`` / ``mm_stage2_kernel``) by
torch.profiler. The copies:

  * ``no_mma``: the int8 mma replaced by a xor-add of the fragments (the
    tensor-core products);
  * ``no_table_copy``: no table slice copied into shared memory;
  * ``no_strip_load``: the A strip made of zeros, no global load or twist;
  * ``no_combine``: the seven weight sums xor-ed instead of combined;
  * ``no_factor``: no T / T^-1 / psi^-n multiplication in the epilogue;
  * ``no_store``: no output stored.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def _variants(src: str) -> dict[str, str]:
    def sub(text, old, new):
        if old not in text:
            raise SystemExit(f"ntt_matmul.cu changed: {old[:60]!r} not found")
        return text.replace(old, new)

    mma = src[src.index("  asm volatile(\n      \"mma.sync"):]
    mma = mma[:mma.index(";\n") + 2]
    return {
        "full": src,
        "no_mma": sub(src, mma, "  d[0] += a[0][0] ^ b[0][0];\n"
                      "  d[1] += a[0][1] ^ b[0][1];\n"
                      "  d[2] += a[0][2];\n  d[3] += a[0][3];\n"),
        "no_table_copy": sub(
            src, "for (int it = RT_TID; it < ND * BN * per_col;",
            "for (int it = RT_TID; it < 0;"),
        "no_strip_load": sub(
            src, "const bool in = it < items && m0 + m < st.M && kk < st.K;",
            "const bool in = it < items && m0 + m < st.M && kk < st.K && "
            "st.M < 0;"),
        "no_combine": sub(
            src, "uint32_t v = combine(s, k);",
            "uint32_t v = (uint32_t)(s[0] ^ s[1] ^ s[2] ^ s[3] ^ s[4] ^ "
            "s[5] ^ s[6]);"),
        "no_factor": sub(
            src, "if (st.epi != EPI_NONE) v = rt::redc(k.sa, v, f[r]);",
            "v ^= f[r];"),
        "no_store": sub(
            src, "if (m < st.M && n < st.Nc) dst[",
            "if (m < st.M && n < st.Nc && v == 0x12345u) dst["),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.core.context import get_context
    from repro_torch.kernels import build, ntt_matmul

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    out = ROOT / "build" / "k14_phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in _variants(
            (build.CSRC / "ntt_matmul.cu").read_text()).items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        print(f"{name}: registers {re.findall(r'Used (\d+) registers', log)}"
              f", spills {sorted(set(re.findall(r'(\d+) bytes spill', log)))}",
              flush=True)
        fn = ctypes.CDLL(str(out / f"{name}.so")).ntt_mm_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn

    dev = "cuda"
    ctx = get_context("paper")
    L, n, plans = ctx.params.n_limbs, ctx.n, ctx.plans
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    q = torch.tensor(ctx.q_list, dtype=torch.int64, device=dev)[:, None,
                                                                   None]
    x = (torch.randint(0, 1 << 31, (L, args.rows, n), generator=gen,
                       device=dev, dtype=torch.int64) % q).to(torch.int32)
    primes = tuple(p.prime for p in plans)
    n1, n2 = ntt_matmul.split_n(n)
    tab = ntt_matmul._device_pow_table(primes, n, dev)
    res, scratch = torch.empty_like(x), torch.empty_like(x)
    for inverse in (False, True):
        consts, fa, fb = ntt_matmul._device_tables(primes, n, inverse, dev)
        src = ntt_matmul.limb_rows_mm_cuda(x, plans, False) if inverse else x
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(src.data_ptr(), res.data_ptr(), scratch.data_ptr(),
                         tab.data_ptr(), fa.data_ptr(), fb.data_ptr(),
                         consts.data_ptr(), L, args.rows,
                         n1.bit_length() - 1, n2.bit_length() - 1,
                         consts.shape[1], int(inverse),
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            if name == "full":
                want = ntt_matmul.limb_rows_mm_plain(src[:, :1], plans,
                                                     inverse)
                torch.cuda.synchronize()
                if not torch.equal(res[:, :1], want):
                    raise SystemExit("the unchanged build differs from the "
                                     "plain version")
            ms = cs._device_ms(call, iters=args.reps)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
            stages = {}
            for ev in prof.key_averages():
                m = re.search(r"(mm_stage\d_kernel)", ev.key)
                if m:
                    stages[m.group(1)] = getattr(
                        ev, "self_device_time_total", 0) / 1e3 / 3
            parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(
                stages.items()))
            print(f"{'intt' if inverse else 'ntt'}_rows_mm paper "
                  f"{tuple(x.shape)} {name}: {ms:.4f} ms [{parts}]  "
                  f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
