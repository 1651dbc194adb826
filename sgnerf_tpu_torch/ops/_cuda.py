"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each `csrc/<name>.cu` exposes a plain C interface. It is compiled for
sm_90a at first use into `<repo>/build/kernels/` (listed in .gitignore),
under a name that carries a hash of the source and flags, so an edited
source is rebuilt. No `--use_fast_math`: the aggregator takes sin/cos of
arguments up to 2^(freqs-1) times the input, where the fast intrinsics
lose accuracy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (every entry returns a cudaError_t as int)
_SIGNATURES = {
    "fused_knn": {
        # rows, delta, slot_ok, r2, M, C, K, out, stream
        "fused_knn_select": [_P, _P, _P, _F, _I, _I, _I, _P, _P],
    },
    "fused_agg": {
        # feat, d, w, W, b, n_layers, wa, ba, M, K, F, nf, Dd, df, C, bf16,
        # out, stream
        "fused_block1_alpha": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P, _P],
    },
}

_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the kernels")
    return path


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless a build of this exact source exists;
    returns the library path. nvcc's resource report (-Xptxas -v) goes to
    build/kernels/<lib>.log."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    with open(so[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, so)        # atomic: a concurrent build never sees a stub
    return so


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        lib.sgnerf_error_string.argtypes = [ctypes.c_int]
        lib.sgnerf_error_string.restype = ctypes.c_char_p
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def build_all() -> float:
    """Build and load every kernel library; returns the seconds it took."""
    t0 = time.perf_counter()
    for name in ("fused_knn", "fused_agg"):
        load(name)
    return time.perf_counter() - t0


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib.sgnerf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
