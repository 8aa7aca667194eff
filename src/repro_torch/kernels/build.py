"""Build the CUDA kernels with ``nvcc`` on first use and load them.

Each source in ``kernels/csrc/`` (the ZO kernels, the axpys, RMSNorm,
flash attention, the Philox bit generator) is compiled on its own into a shared library with a plain C
interface, and the libraries are loaded with ``ctypes``: no PyTorch
headers are involved, so a build takes seconds. All sources compile in
parallel, one ``nvcc`` each. The libraries go to
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources and flags, so a changed
source is rebuilt and an unchanged one is reused.

Flags: ``sm_90a`` (Hopper), ``-O3``, ``--fmad=false`` (keeps ``x + a·g`` a
multiply and an add, in the plain versions' order, so the sign kind matches
bitwise) and never ``--use_fast_math`` (its ``__logf``/``__cosf`` would break
Box-Muller parity). ``-Xptxas=-v`` reports registers and spills in the build
log.

Nothing here runs when the package is imported: the first kernel launch
calls ``load()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
SOURCES = ("zo_axpy.cu", "zo_aircomp.cu", "axpy.cu", "rmsnorm.cu",
           "flash_attention.cu", "philox.cu")
HEADERS = ("threefry.cuh", "philox.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v")

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_L, _UL = ctypes.c_longlong, ctypes.c_ulonglong
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures of the launchers (every pointer and the stream as c_void_p)
SIGNATURES = {
    "zo_axpy": {
        "zo_walk_launch": [_P, _P, _P, _P, _U, _U, _I, _I, _I, _P],
        "zo_replay_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "zo_dirnorms_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "zo_dirnorms_finish_launch": [_P, _P, _I, _I, _P],
    },
    "zo_aircomp": {
        "aircomp_geometry": [_I, _IP, _IP],
        "aircomp_reduce_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _P],
        "aircomp_twopass_block_cols": [],
        "aircomp_twopass_max_rows": [],
        "aircomp_reduce_twopass_launch": [_P, _P, _P, _P, _P, _I, _I, _I,
                                          _P],
    },
    "axpy": {
        "zo_axpy_launch": [_P, _P, _P, _P, _L, _I, _I, _P],
        "zo_axpy2_launch": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _P],
    },
    "rmsnorm": {
        "rmsnorm_launch": [_P, _P, _P, _I, _I, _F, _I, _I, _I, _L, _P],
    },
    "flash_attention": {
        "flash_head_dim_ok": [_I, _I, _I],
        "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _F, _I, _P],
    },
    "philox": {
        "philox_bits_launch": [_P, _U, _U, _U, _U, _UL, _UL, _P],
    },
}

_LIBS: dict = {}
BUILD_LOG: dict = {}


def nvcc_path() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels are built on a machine with the "
                           "CUDA toolkit")
    return cand


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def lib_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_digest()}.so"


def build_all() -> dict:
    """Compile every source that has no library for the current hash, all
    in parallel. Returns {stem: library path}; raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for src in SOURCES:
        out = lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[src] = log
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    return {Path(s).stem: lib_path(s) for s in SOURCES}


def load() -> dict:
    """{stem: ctypes.CDLL} with argtypes set, building first if needed."""
    if not _LIBS:
        for stem, path in build_all().items():
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[stem].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[stem] = lib
    return _LIBS
