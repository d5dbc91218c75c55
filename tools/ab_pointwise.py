"""Time K7 (``server_pointwise_launch``) built from two copies of
``server_eval.cu`` on the same tensors, in one process on one card.

    python3 tools/ab_pointwise.py OTHER_CSRC_DIR [--levels 6 24] [--reps 8]

Builds ``OTHER_CSRC_DIR/server_eval.cu`` (for example the ``csrc`` of a
``git archive`` of another commit) and this checkout's with nvcc, under the
flags of ``repro_torch.kernels.build``, into ``build/ab_pointwise/``. For
each mode (add_ct, add_pt, mul_pt) and level of the ``boot`` profile it
checks that both builds give the same words, then times each with
``chip_smoke.py``'s queued-ahead timer (5 calls behind a spin), the two
builds alternating which goes first, and prints the median, least and
largest time of each. Inputs and outputs are allocated once and shared, so
both builds see the same addresses and the same cache state: a difference
is the kernel's, not where the caching allocator put a call's outputs.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

MODES = ("add_ct", "add_pt", "mul_pt")


def _build(csrc: Path, out: Path):
    """nvcc process building csrc/server_eval.cu into out."""
    from repro_torch.kernels import build
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
         str(csrc / "server_eval.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--levels", type=int, nargs="+", default=[6, 24])
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.context import get_context
    from repro_torch.kernels import build, common, server_eval

    out = ROOT / "build" / "ab_pointwise"
    out.mkdir(parents=True, exist_ok=True)
    csrcs = {"other": args.other_csrc.resolve(), "this": build.CSRC}
    procs = {k: (_build(d, out / f"{k}.so"), out / f"{k}.so")
             for k, d in csrcs.items()}
    fns = {}
    for k, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"nvcc failed for {csrcs[k]}:\n{log}", file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(lib)).server_pointwise_launch
        fn.argtypes = build.ENTRY_POINTS["server_pointwise_launch"][1]
        fn.restype = ctypes.c_int
        fns[k] = fn
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)

    ctx = get_context("boot")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for level in args.levels:
        sc = server_eval.server_consts(ctx, level)
        table = server_eval._device_table(sc, "cuda")
        qs = sc.table[:level, common.OFF_Q].astype(np.uint64).reshape(-1, 1)
        rng = np.random.default_rng(level)

        def words(shape):
            w = (rng.integers(0, 1 << 32, shape, dtype=np.uint64) % qs
                 ).astype(np.uint32)
            return torch.from_numpy(w.view(np.int32)).to(dev)

        a0, a1, b0, b1 = (words((1, level, ctx.n)) for _ in range(4))
        pt = words((level, ctx.n))
        o0, o1 = torch.empty_like(a0), torch.empty_like(a0)
        for mode, name in enumerate(MODES):
            c0, c1 = (b0, b1) if mode == 0 else (pt, pt)

            def call(fn, mode=mode, c0=c0, c1=c1):
                err = fn(mode, a0.data_ptr(), a1.data_ptr(), c0.data_ptr(),
                         c1.data_ptr(), table.data_ptr(), o0.data_ptr(),
                         o1.data_ptr(), 1, level, ctx.params.logn, sc.ncols,
                         stream)
                if err != 0:
                    raise RuntimeError(f"server_pointwise_launch: {err}")

            words_of = {}
            for k, fn in fns.items():
                call(fn)
                torch.cuda.synchronize()
                words_of[k] = (o0.clone(), o1.clone())
            if not all(torch.equal(x, y) for x, y in
                       zip(words_of["other"], words_of["this"])):
                print(f"{name} l={level}: the two builds differ",
                      file=sys.stderr)
                return 1
            times = {k: [] for k in fns}
            for rep in range(args.reps):
                for k in (("other", "this") if rep % 2 == 0
                          else ("this", "other")):
                    times[k].append(cs._device_ms(
                        lambda fn=fns[k]: call(fn), iters=5))
            for k, v in times.items():
                print(f"{name} boot level {level} B=1, {k} build: median "
                      f"{statistics.median(v):.5f} ms, least {min(v):.5f}, "
                      f"largest {max(v):.5f} ({len(v)} runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
