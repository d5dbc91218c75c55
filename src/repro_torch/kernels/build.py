"""Build and load the CUDA kernels: nvcc into shared libraries with a plain
C interface, bound with ctypes.

Each ``csrc/*.cu`` entry file builds into its own ``.so`` under
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of its sources and the flags, so a changed
source rebuilds and an unchanged one loads. All builds start together, one
``nvcc`` process per source; ``build()`` returns each compiler's output,
ptxas' register and spill report included. Nothing is built at import: the
first launch builds (or ``load()`` does, ahead of time).

The flags keep the float code IEEE-exact: ``--fmad=false`` (no
multiply-add contraction: the df32 error-free transforms need every product
rounded on its own), IEEE division (``-prec-div=true``), no flush-to-zero
(``-ftz=false``), and never ``-use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "--fmad=false", "-prec-div=true", "-ftz=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_U32 = ctypes.c_uint32
_I32 = ctypes.c_int

# entry point -> (source, ctypes argtypes); pointers and the stream are
# c_void_p (a pointer passed without argtypes is cut to 32 bits)
ENTRY_POINTS = {
    "encode_encrypt_stream_launch": (
        "encode_encrypt.cu",
        [_P] * 17 + [_I32] * 5 + [ctypes.c_double] + [_U32] * 5 + [_P]),
    "decrypt_decode_stream_launch": (
        "decrypt_decode.cu",
        [_P, _P, ctypes.c_longlong] + [_P] * 11 + [_I32] * 4 + [_U32] * 8
        + [ctypes.c_ulonglong] * 2 + [_P]),
    "ntt_limbs_launch": ("ntt_limbs.cu", [_P] * 4 + [_I32] * 5 + [_P]),
    "encrypt_limbs_launch": (
        "client_pointwise.cu",
        [_P, ctypes.c_longlong, ctypes.c_longlong] + [_P] * 8 + [_I32] * 4
        + [_U32] * 5 + [_P]),
    "decrypt_limbs_launch": (
        "client_pointwise.cu",
        [_P, _P, ctypes.c_longlong] + [_P] * 4 + [_I32] * 4 + [_P]),
    "special_fft_launch": (
        "fft_df.cu",
        [_P] * 4 + [ctypes.c_longlong] + [_P] * 5 + [_I32] * 3 + [_P]),
    "server_pointwise_launch": (
        "server_eval.cu", [_I32] + [_P] * 7 + [_I32] * 4 + [_P]),
    "server_rescale_launch": (
        "server_eval.cu", [_P] * 8 + [_I32] * 5 + [_P]),
    "server_ks_decompose_launch": (
        "server_eval.cu", [_P] * 5 + [_I32] * 4 + [_P]),
    "server_ks_apply_rot_launch": (
        "server_eval.cu", [_P] * 11 + [_I32] * 5 + [_P]),
    "server_rotate_launch": (
        "server_eval.cu", [_P] * 13 + [_I32] * 5 + [_P]),
    "server_mul_ct_launch": (
        "server_eval.cu", [_P] * 19 + [_I32] * 7 + [_P]),
    "ntt_rows_launch": ("ntt_rows.cu", [_P] * 5 + [_I32] * 3 + [_P]),
    "encrypt_limb_launch": (
        "client_pointwise.cu", [_P] * 10 + [_I32] * 2 + [_U32] * 5 + [_P]),
    "decrypt_limb_launch": (
        "client_pointwise.cu", [_P] * 7 + [_I32] * 2 + [_P]),
    "ntt_mm_pow_table": ("ntt_matmul.cu", [_P] * 2 + [_I32] * 3 + [_P]),
    "ntt_mm_launch": ("ntt_matmul.cu", [_P] * 7 + [_I32] * 6 + [_P]),
}

# headers every source includes (a change rebuilds every library)
HEADERS = ("client_common.cuh", "server_common.cuh", "ntt_tiled.cuh",
           "encrypt_tiled.cuh")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[str, dict] = {}
# sources compiled by this process (the service's warm-path odometer,
# ``telemetry.probe.table_cache_entries``, counts them)
_BUILT = {"sources": 0}


def builds() -> int:
    """nvcc compiles this process has run (a source whose library was
    already built is loaded, not counted)."""
    return _BUILT["sources"]


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def source_hash(source: str) -> str:
    h = hashlib.sha256()
    for f in (source,) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(source: str, build_dir: Path) -> Path:
    return build_dir / f"{Path(source).stem}_{source_hash(source)}.so"


def build(build_dir: Path = BUILD_DIR) -> dict:
    """Compile every source whose library is missing, all nvcc processes at
    once. Returns {source: compiler output} for the sources built."""
    build_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted({src for src, _ in ENTRY_POINTS.values()})
    procs = {}
    for src in sources:
        out = _lib_path(src, build_dir)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        logs[src] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{src}:\n{logs[src]}")
        else:
            os.replace(tmp, out)
            _BUILT["sources"] += 1
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(build_dir: Path = BUILD_DIR) -> dict[str, ctypes._CFuncPtr]:
    """Build what is missing, load the libraries, and return the C entry
    points with argtypes/restype set."""
    with _LOCK:
        fns = _FNS.get(str(build_dir))
        if fns is not None:
            return fns
        build(build_dir)
        fns = {}
        for name, (src, argtypes) in ENTRY_POINTS.items():
            path = str(_lib_path(src, build_dir))
            if path not in _LIBS:
                _LIBS[path] = ctypes.CDLL(path)
            fn = getattr(_LIBS[path], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        _FNS[str(build_dir)] = fns
        return fns
